// Denominator forward-backward of LF-MMI on the dense Moore graph: kernels
// K9f (forward) and K9b (backward), CUDA C++ for sm_90a.
//
// Replaces the fused Pallas kernels of torchain_tpu/ops/den_pallas.py:
//   K9f  dense_den_forward  -> _fwd_kernel (den_forward,  pallas_call :118)
//   K9b  dense_den_backward -> _bwd_kernel (den_backward, pallas_call :160)
//
// Math (probability space, per-frame renormalisation, leaky HMM; S original
// states, E expanded states, e enters original state orig(e); pe_t = p_t @
// P_mat is computed by the caller for all frames at once):
//   forward, frame t (s_hat starts at init):
//       sig[t] = s_hat                      (the carry at entry, unleaked)
//       sigma  = s_hat + leaky * sum(s_hat) * init
//       alpha  = (sigma @ V) * pe_t;  c = sum(alpha);  logc_t = log c
//       s_hat'[s] = sum of alpha[e] / c over the real e with orig(e) == s
//   backward, frame t (reverse; bh starts at 1, G at log1p(leaky)):
//       sigma   = sig[t] + leaky * sum(sig[t]) * init
//       gout[t] = pe_t * (sigma @ V) * bh * exp(fscale_t + G)
//       v = (pe_t * bh) @ V^T;  v += leaky * sum(v * init)
//       nb[e] = v[orig(e)] for the real e, 0 for the padded ones
//       d = max(nb) (1 if <= 0);  bh = nb / d;  G += ymax_t + log d
//
// Where the TPU kernel multiplies the one-hot E_mat [E, S] (and its
// transpose), these kernels index: the forward sums over the list of each
// original state's expanded states, the backward reads orig_of_exp.  E_mat
// has all-zero rows for the padded expanded states while orig_of_exp points
// them at state 0, so the backward takes nb = 0 there explicitly: otherwise
// d = max(nb), and with it G, would see v[0] once per padded state.
//
// What bounds it on the H100: the [B, S] x [S, E] products, two per frame
// backward and one forward (2*B*S*E FLOP each, f32 on the SIMT cores, 67
// TFLOP/s peak).  V is read once per product, but at the trigram graph
// (37 MB) it sits in the 50 MB L2, so device-memory bytes are not the limit;
// pe, sig and gout stream through device memory once.  The TPU kernel keeps
// the whole T loop in one program with everything in VMEM.  Nothing carries
// between blocks on the GPU, so the frame recursion is a host loop (inside
// this library, one call per pass) of the tiled SIMT product of
// den_tiles.cuh, with the emission product and the row sums fused into its
// epilogue, plus one small per-row kernel for the normalisation and the
// carry.  c, d and the leak's row sums are reductions over a whole row that
// several blocks produce: per-tile partial sums (`cpart`, `vpart`) are added
// by the per-row kernel in a fixed order.  No atomics: results repeat bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>

#include "den_tiles.cuh"

namespace {

using namespace den_tiles;

// acc = A[m0.., :] @ V[:, n0..] for row-major A [B, S] and V [S, E]
__device__ __forceinline__ void product_tile(const float* __restrict__ A,
                                             const float* __restrict__ V, int B, int S, int E,
                                             int m0, int n0, float (*As)[LDA], float (*Bs)[LDB],
                                             float acc[TM][TN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < S; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < B && gk < S) ? A[(size_t)gm * S + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < S && gn < E) ? V[(size_t)gk * E + gn] : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }
}

// K9f (a): alpha = (sigma @ V) * pe_t for one frame; per-tile row sums of
// alpha into cpart[b, blockIdx.x].
// sigma [B, S] (leaked), V [S, E], pe_t [B, E], alpha out [B, E]
__global__ void __launch_bounds__(NTHREADS)
dense_fwd_gemm(const float* __restrict__ sigma, const float* __restrict__ V,
               const float* __restrict__ pe_t, float* __restrict__ alpha,
               float* __restrict__ cpart, int B, int S, int E) {
  __shared__ float As[BK][LDA];
  __shared__ float Bs[BK][LDB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  product_tile(sigma, V, B, S, E, m0, n0, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    float rs = 0.0f;
    if (gm < B) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < E) {
          const float a = acc[i][j] * pe_t[(size_t)gm * E + gn];
          alpha[(size_t)gm * E + gn] = a;
          rs += a;
        }
      }
    }
    // the 16 threads of one ty are 16 aligned lanes of a warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
    if (tx == 0 && gm < B) cpart[(size_t)gm * gridDim.x + blockIdx.x] = rs;
  }
}

// K9f (b): one block per sequence b.  c = sum of the tile row sums,
// logc_t[b] = log c, s_hat'[s] = sum of alpha[e] / c over the expanded
// states of s; s_hat' goes to sig_next (the next frame's residual, where
// there is one) and, leaked, to sigma (the next product's operand).
__global__ void __launch_bounds__(ROW_THREADS)
dense_fwd_norm(const float* __restrict__ alpha, const float* __restrict__ cpart, int ncpart,
               const int* __restrict__ orig_off, const int* __restrict__ orig_exps,
               const float* __restrict__ init, float* __restrict__ sigma,
               float* __restrict__ sig_next, float* __restrict__ logc_t, int S, int E,
               float leaky) {
  __shared__ float red[ROW_THREADS];
  __shared__ float c_sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    float c = 0.0f;
    for (int j = 0; j < ncpart; ++j) c += cpart[(size_t)b * ncpart + j];
    c_sh = c;
    logc_t[b] = logf(c);
  }
  __syncthreads();
  const float c = c_sh;
  const float* row = alpha + (size_t)b * E;
  float* sig = sigma + (size_t)b * S;
  float part = 0.0f;
  for (int s = tid; s < S; s += ROW_THREADS) {
    float sh = 0.0f;
    for (int j = orig_off[s]; j < orig_off[s + 1]; ++j) sh += row[orig_exps[j]] / c;
    sig[s] = sh;
    if (sig_next != nullptr) sig_next[(size_t)b * S + s] = sh;
    part += sh;
  }
  if (leaky > 0.0f) {
    const float tot = block_sum(part, red);  // also orders the sig writes
    for (int s = tid; s < S; s += ROW_THREADS) sig[s] += leaky * tot * init[s];
  }
}

// K9b (a): one block per sequence.  sigma = sig_t + leaky * sum(sig_t) * init
__global__ void __launch_bounds__(ROW_THREADS)
dense_bwd_leak(const float* __restrict__ sig_t, const float* __restrict__ init,
               float* __restrict__ sigma, int S, float leaky) {
  __shared__ float red[ROW_THREADS];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* in = sig_t + (size_t)b * S;
  float* out = sigma + (size_t)b * S;
  float part = 0.0f;
  for (int s = tid; s < S; s += ROW_THREADS) part += in[s];
  const float tot = leaky > 0.0f ? block_sum(part, red) : 0.0f;
  for (int s = tid; s < S; s += ROW_THREADS) out[s] = in[s] + leaky * tot * init[s];
}

// K9b (b): gout_t = pe_t * (sigma @ V) * bh * exp(fscale_t + G)
__global__ void __launch_bounds__(NTHREADS)
dense_bwd_gout(const float* __restrict__ sigma, const float* __restrict__ V,
               const float* __restrict__ pe_t, const float* __restrict__ bh,
               const float* __restrict__ fscale_t, const float* __restrict__ G,
               float* __restrict__ gout_t, int B, int S, int E) {
  __shared__ float As[BK][LDA];
  __shared__ float Bs[BK][LDB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  product_tile(sigma, V, B, S, E, m0, n0, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= B) continue;
    const float scale = expf(fscale_t[gm] + G[gm]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < E) {
        const size_t at = (size_t)gm * E + gn;
        gout_t[at] = pe_t[at] * acc[i][j] * bh[at] * scale;
      }
    }
  }
}

// K9b (c): partial v = (pe_t * bh) @ V^T over the depth range of blockIdx.z.
// pe_t * bh is formed while loading the tile.  vpart [splits, B, S].
__global__ void __launch_bounds__(NTHREADS)
dense_bwd_gemm(const float* __restrict__ pe_t, const float* __restrict__ bh,
               const float* __restrict__ V, float* __restrict__ vpart, int B, int S, int E,
               int kchunk) {
  __shared__ float As[BK][LDA];
  __shared__ float Bs[BK][LDB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(E, kbeg + kchunk);
  float acc[TM][TN] = {};
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      float w = 0.0f;
      if (gm < B && gk < kend) w = pe_t[(size_t)gm * E + gk] * bh[(size_t)gm * E + gk];
      As[k][m] = w;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int n = idx / BK, k = idx % BK;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < kend && gn < S) ? V[(size_t)gn * E + gk] : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  float* out = vpart + (size_t)blockIdx.z * B * S;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < S) out[(size_t)gm * S + gn] = acc[i][j];
    }
  }
}

// K9b (d): one block per sequence.  v = sum of the partials (fixed order),
// leaky transpose, nb[e] = v[orig(e)] (0 for e >= real_exp), d = max(nb) (1
// if <= 0), bh = nb / d, G += ymax_t + log d.  The row of v is kept in the
// first partial's slot, which only this block touches.
__global__ void __launch_bounds__(ROW_THREADS)
dense_bwd_norm(float* __restrict__ vpart, int splits, const float* __restrict__ init,
               const int* __restrict__ orig_of_exp, const float* __restrict__ ymax_t,
               float* __restrict__ bh, float* __restrict__ G, int B, int S, int E,
               int real_exp, float leaky) {
  __shared__ float red[ROW_THREADS];
  const int b = blockIdx.x, tid = threadIdx.x;
  float* v = vpart + (size_t)b * S;
  float dot = 0.0f;
  for (int s = tid; s < S; s += ROW_THREADS) {
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z) acc += vpart[((size_t)z * B + b) * S + s];
    v[s] = acc;
    dot += acc * init[s];
  }
  // block_sum's barriers also make the row of v visible to every thread
  const float add = leaky * block_sum(dot, red);
  float* row = bh + (size_t)b * E;
  float mx = -INFINITY;
  for (int e = tid; e < E; e += ROW_THREADS) {
    const float nb = e < real_exp ? v[orig_of_exp[e]] + add : 0.0f;
    row[e] = nb;
    mx = fmaxf(mx, nb);
  }
  float d = block_max(mx, red);
  d = d > 0.0f ? d : 1.0f;
  for (int e = tid; e < E; e += ROW_THREADS) row[e] = row[e] / d;
  if (tid == 0) G[b] += ymax_t[b] + logf(d);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K9f: the whole forward pass, T frames, on `stream`.
//   pe [T, B, E]; V [S, E]; orig_off [S + 1] / orig_exps: the real expanded
//   states of each original state; init [S]; sigma [B, S] holds the leaked
//   carry of frame 0 on entry (scratch after); alpha [B, E] and cpart
//   [B, ceil(E / 64)] scratch.  Out: logc [T, B] and sig [T, B, S], whose
//   frame 0 (= init) the caller has filled.
int dense_den_forward(const float* pe, const float* V, const int* orig_off,
                      const int* orig_exps, const float* init, float* sigma, float* alpha,
                      float* cpart, float* logc, float* sig, int T, int B, int S, int E,
                      float leaky, cudaStream_t stream) {
  const dim3 ggrid((E + BN - 1) / BN, (B + BM - 1) / BM);
  for (int t = 0; t < T; ++t) {
    dense_fwd_gemm<<<ggrid, NTHREADS, 0, stream>>>(sigma, V, pe + (size_t)t * B * E, alpha,
                                                   cpart, B, S, E);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* sig_next = t + 1 < T ? sig + (size_t)(t + 1) * B * S : nullptr;
    dense_fwd_norm<<<B, ROW_THREADS, 0, stream>>>(alpha, cpart, (int)ggrid.x, orig_off,
                                                  orig_exps, init, sigma, sig_next,
                                                  logc + (size_t)t * B, S, E, leaky);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K9b: the whole backward pass, frames T-1 .. 0, on `stream`.
//   sig [T, B, S], fscale and ymax [T, B]; bh [B, E] = 1 and G [B] =
//   log1p(leaky) on entry (scratch after); sigma [B, S] and vpart
//   [splits, B, S] scratch.  Out: gout [T, B, E].
int dense_den_backward(const float* pe, const float* V, const int* orig_of_exp,
                       const float* init, const float* sig, const float* fscale,
                       const float* ymax, float* bh, float* G, float* sigma, float* vpart,
                       float* gout, int T, int B, int S, int E, int real_exp, int splits,
                       float leaky, cudaStream_t stream) {
  int kchunk = (E + splits - 1) / splits;
  kchunk = (kchunk + BK - 1) / BK * BK;
  const dim3 fgrid((E + BN - 1) / BN, (B + BM - 1) / BM);
  const dim3 bgrid((S + BN - 1) / BN, (B + BM - 1) / BM, splits);
  for (int t = T - 1; t >= 0; --t) {
    const float* pe_t = pe + (size_t)t * B * E;
    dense_bwd_leak<<<B, ROW_THREADS, 0, stream>>>(sig + (size_t)t * B * S, init, sigma, S,
                                                  leaky);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dense_bwd_gout<<<fgrid, NTHREADS, 0, stream>>>(sigma, V, pe_t, bh, fscale + (size_t)t * B,
                                                   G, gout + (size_t)t * B * E, B, S, E);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (t == 0) break;  // the pullback past frame 0 feeds nothing
    dense_bwd_gemm<<<bgrid, NTHREADS, 0, stream>>>(pe_t, bh, V, vpart, B, S, E, kchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dense_bwd_norm<<<B, ROW_THREADS, 0, stream>>>(vpart, splits, init, orig_of_exp,
                                                  ymax + (size_t)t * B, bh, G, B, S, E,
                                                  real_exp, leaky);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
