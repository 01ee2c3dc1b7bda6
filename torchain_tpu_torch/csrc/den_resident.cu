// Denominator forward-backward of LF-MMI on the slot-dense graph:
// kernels K1 (forward) and K2 (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/den_resident.py:
//   K1  den_forward  -> _fwd_kernel_inkernel / _fwd_body (pallas_call :565)
//   K2  den_backward -> _bwd_kernel                      (pallas_call :615)
//
// Math (probability space, per-frame renormalisation, leaky HMM):
//   forward, frame t:   sigma = s_hat + leaky * sum(s_hat) * init
//                       alpha = (sigma @ V) * pe_t,  pe_t[e] = p_t[pdf(e)]
//                       c = sum(alpha); logc_t = log c; ah_t = alpha / c
//                       s_hat' = sum over the K slot slices of ah_t
//   backward, frame t (reverse; bh starts at 1, G at log1p(leaky)):
//                       occ = ah_t * bh * exp(F_t + G - logZ)
//                       gamma_t[p] = sum of occ over the live slots of pdf p
//                       v = (pe_t * bh) @ V^T;  v += leaky * sum(v * init)
//                       d = max(v) (1 if <= 0); bh = v / d in every slice
//                       G += ymax_t + log d
//
// What bounds it on the H100: the two [B, S] x [S, K*S] products per frame
// (2*B*S*KS FLOP each, f32 on the SIMT cores, 67 TFLOP/s peak).  V is read
// once per frame, but at the trigram graph (38 MB) it sits in the 50 MB L2,
// so device-memory bytes are not the limit.  Nothing carries between blocks
// on the GPU, so the frame recursion is a host loop (inside this library,
// one call per pass) of a tiled SIMT GEMM with the emission product and the
// row sums fused into its epilogue (forward) or the pe*bh operand formed
// while loading its tile (backward), plus one small per-row kernel for the
// normalisation/carry.  The backward product has only S output columns, so
// it is split over K into `splits` partial sums that the per-row kernel adds
// in a fixed order: no atomics, the result is deterministic.  The pdf
// occupancies read a host-built CSR of live slots per pdf, also without
// atomics.  Dead slots (slot_pdf < 0) get pe = 0 exactly.

#include <cuda_runtime.h>
#include <math.h>

#include "den_tiles.cuh"

namespace {

using namespace den_tiles;

__device__ __forceinline__ float emission(const float* p_row, const int* slot_pdf, int e) {
  const int q = slot_pdf[e];
  return q >= 0 ? p_row[q] : 0.0f;
}

// K1 (a): alpha = (sigma @ V) * pe_t for one frame; per-tile row sums of
// alpha into cpart[b, blockIdx.x].
// sigma [B, S], V [S, KS], p_t [B, P], alpha out [B, KS], cpart [B, gridDim.x]
__global__ void __launch_bounds__(NTHREADS)
fwd_gemm(const float* __restrict__ sigma, const float* __restrict__ V,
         const float* __restrict__ p_t, const int* __restrict__ slot_pdf,
         float* __restrict__ alpha, float* __restrict__ cpart,
         int B, int S, int KS, int P) {
  __shared__ float As[BK][LDA];
  __shared__ float Bs[BK][LDB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < S; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < B && gk < S) ? sigma[(size_t)gm * S + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < S && gn < KS) ? V[(size_t)gk * KS + gn] : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    float rs = 0.0f;
    if (gm < B) {
      const float* prow = p_t + (size_t)gm * P;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < KS) {
          const float a = acc[i][j] * emission(prow, slot_pdf, gn);
          alpha[(size_t)gm * KS + gn] = a;
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

// K1 (b): one block per sequence b.  c = sum of the tile row sums,
// logc_t[b] = log c, ah_t = alpha / c (in place), next sigma (leaky).
__global__ void __launch_bounds__(ROW_THREADS)
fwd_norm(float* __restrict__ ah_t, const float* __restrict__ cpart, int ncpart,
         const float* __restrict__ init, float* __restrict__ sigma,
         float* __restrict__ logc_t, int S, int K, float leaky) {
  __shared__ float red[ROW_THREADS];
  const int b = blockIdx.x, tid = threadIdx.x;
  __shared__ float c_sh;
  if (tid == 0) {
    float c = 0.0f;
    for (int j = 0; j < ncpart; ++j) c += cpart[(size_t)b * ncpart + j];
    c_sh = c;
    logc_t[b] = logf(c);
  }
  __syncthreads();
  const float c = c_sh;
  float* row = ah_t + (size_t)b * K * S;
  float* sig = sigma + (size_t)b * S;
  float part = 0.0f;
  for (int s = tid; s < S; s += ROW_THREADS) {
    float sh = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float a = row[k * S + s] / c;
      row[k * S + s] = a;
      sh += a;
    }
    sig[s] = sh;
    part += sh;
  }
  if (leaky > 0.0f) {
    const float tot = block_sum(part, red);  // also orders the sig writes
    for (int s = tid; s < S; s += ROW_THREADS) sig[s] += leaky * tot * init[s];
  }
}

// K2 (a): pdf occupancies of frame t, straight into gamma [B, T, P].
__global__ void __launch_bounds__(128)
bwd_gamma(const float* __restrict__ ah_t, const float* __restrict__ bh,
          const float* __restrict__ F_t, const float* __restrict__ G,
          const float* __restrict__ logz, const int* __restrict__ pdf_off,
          const int* __restrict__ pdf_slot, float* __restrict__ gamma,
          int t, int T, int P, int S, int K) {
  const int b = blockIdx.x;
  const float scale = expf(F_t[b] + G[b] - logz[b]);
  const float* arow = ah_t + (size_t)b * K * S;
  const float* brow = bh + (size_t)b * S;
  float* grow = gamma + ((size_t)b * T + t) * P;
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    float acc = 0.0f;
    for (int j = pdf_off[q]; j < pdf_off[q + 1]; ++j) {
      const int e = pdf_slot[j];
      acc += arow[e] * brow[e % S] * scale;
    }
    grow[q] = acc;
  }
}

// K2 (b): partial v = (pe_t * bh) @ V^T over the depth range of blockIdx.z.
// pe_t*bh is formed while loading the tile.  vpart [splits, B, S].
__global__ void __launch_bounds__(NTHREADS)
bwd_gemm(const float* __restrict__ p_t, const int* __restrict__ slot_pdf,
         const float* __restrict__ bh, const float* __restrict__ V,
         float* __restrict__ vpart, int B, int S, int KS, int P, int kchunk) {
  __shared__ float As[BK][LDA];
  __shared__ float Bs[BK][LDB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(KS, kbeg + kchunk);
  float acc[TM][TN] = {};
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      float w = 0.0f;
      if (gm < B && gk < kend)
        w = emission(p_t + (size_t)gm * P, slot_pdf, gk) * bh[(size_t)gm * S + gk % S];
      As[k][m] = w;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / NTHREADS; ++r) {
      const int idx = tid + r * NTHREADS;
      const int n = idx / BK, k = idx % BK;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < kend && gn < S) ? V[(size_t)gn * KS + gk] : 0.0f;
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

// K2 (c): one block per sequence.  v = sum of the partials (fixed order),
// leaky transpose, d = rowmax (1 if <= 0), bh = v / d, G += ymax_t + log d.
__global__ void __launch_bounds__(ROW_THREADS)
bwd_norm(const float* __restrict__ vpart, int splits, const float* __restrict__ init,
         const float* __restrict__ ymax_t, float* __restrict__ bh,
         float* __restrict__ G, int B, int S, float leaky) {
  __shared__ float red[ROW_THREADS];
  const int b = blockIdx.x, tid = threadIdx.x;
  float* row = bh + (size_t)b * S;
  float dot = 0.0f;
  for (int s = tid; s < S; s += ROW_THREADS) {
    float v = 0.0f;
    for (int z = 0; z < splits; ++z) v += vpart[((size_t)z * B + b) * S + s];
    row[s] = v;
    dot += v * init[s];
  }
  float add = 0.0f;
  if (leaky > 0.0f) add = leaky * block_sum(dot, red);
  float mx = -INFINITY;
  for (int s = tid; s < S; s += ROW_THREADS) {
    const float v = row[s] + add;
    row[s] = v;
    mx = fmaxf(mx, v);
  }
  float d = block_max(mx, red);
  d = d > 0.0f ? d : 1.0f;
  for (int s = tid; s < S; s += ROW_THREADS) row[s] = row[s] / d;
  if (tid == 0) G[b] += ymax_t[b] + logf(d);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1: the whole forward pass, T frames, on `stream`.
//   p [T, B, P] = exp(y - ymax), V [S, K*S], slot_pdf [K*S] (-1 = dead),
//   init [S]; sigma [B, S] holds sigma of frame 0 on entry (scratch after);
//   cpart [B, ceil(K*S / 64)] scratch.  Out: ah [T, B, K*S], logc [T, B].
int den_forward(const float* p, const float* V, const int* slot_pdf, const float* init,
                float* sigma, float* ah, float* cpart, float* logc,
                int T, int B, int P, int S, int K, float leaky, cudaStream_t stream) {
  const int KS = K * S;
  const dim3 ggrid((KS + BN - 1) / BN, (B + BM - 1) / BM);
  for (int t = 0; t < T; ++t) {
    float* ah_t = ah + (size_t)t * B * KS;
    fwd_gemm<<<ggrid, NTHREADS, 0, stream>>>(sigma, V, p + (size_t)t * B * P, slot_pdf,
                                             ah_t, cpart, B, S, KS, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fwd_norm<<<B, ROW_THREADS, 0, stream>>>(ah_t, cpart, (int)ggrid.x, init, sigma,
                                            logc + (size_t)t * B, S, K, leaky);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K2: the whole backward pass, frames T-1 .. 0, on `stream`.
//   F, ymax [T, B]; logz [B]; pdf_off [P+1] / pdf_slot: live slots per pdf;
//   bh [B, S] = 1 and G [B] = log1p(leaky) on entry (scratch after);
//   vpart [splits, B, S] scratch.  Out: gamma [B, T, P].
int den_backward(const float* p, const float* ah, const float* F, const float* ymax,
                 const float* logz, const float* V, const int* slot_pdf,
                 const int* pdf_off, const int* pdf_slot, const float* init,
                 float* bh, float* G, float* vpart, float* gamma,
                 int T, int B, int P, int S, int K, int splits, float leaky,
                 cudaStream_t stream) {
  const int KS = K * S;
  int kchunk = (KS + splits - 1) / splits;
  kchunk = (kchunk + BK - 1) / BK * BK;
  const dim3 ggrid((S + BN - 1) / BN, (B + BM - 1) / BM, splits);
  for (int t = T - 1; t >= 0; --t) {
    bwd_gamma<<<B, 128, 0, stream>>>(ah + (size_t)t * B * KS, bh, F + (size_t)t * B, G, logz,
                                     pdf_off, pdf_slot, gamma, t, T, P, S, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (t == 0) break;  // the pullback past frame 0 feeds nothing
    bwd_gemm<<<ggrid, NTHREADS, 0, stream>>>(p + (size_t)t * B * P, slot_pdf, bh, V, vpart,
                                             B, S, KS, P, kchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bwd_norm<<<B, ROW_THREADS, 0, stream>>>(vpart, splits, init, ymax + (size_t)t * B, bh, G,
                                            B, S, leaky);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
