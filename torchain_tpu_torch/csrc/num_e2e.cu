// Flat-start (e2e) numerator recursions of LF-MMI: kernels K8f (forward)
// and K8b (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/num_resident.py:
//   K8f  e2e_forward  -> _e2e_fwd_kernel (e2e_forward_resident,  pallas_call :319)
//   K8b  e2e_backward -> _e2e_bwd_kernel (e2e_backward_resident, pallas_call :356)
//
// Math (log semiring; one cyclic graph per sequence whose tables do not
// change over time: arc slot (s, k) enters state s from state src[s, k] with
// weight logw[s, k]; src < 0 marks a pad slot; ylocal[t, s, k] is the arc's
// emission log-probability at frame t):
//   K8f, alpha_0 = (0, -inf, ...), frames t = 0 .. T-1:
//       alpha_{t+1}[s] = lse_k(alpha_t[src[s, k]] + logw[s, k] + ylocal[t, s, k])
//   K8b, the frames in reverse, beta_T = final_logw:
//       arc_w[s, k]  = (logw[s, k] + ylocal[t, s, k]) + beta_{t+1}[s]
//       post[t, s, k] = exp(alpha_t[src[s, k]] + arc_w[s, k] - logp)
//       beta_t[s']   = lse of arc_w over the arcs with src == s'
//   with logp = +inf for a sequence whose log-probability is not finite, so
//   that its posteriors are exactly 0.  A log-sum-exp over no arcs (or over
//   arcs that are all -inf) is -inf, never NaN: the maximum is tested before
//   anything is subtracted from it, and pad slots are never added up.  No
//   fast-math: the recursion relies on expf(-inf) == 0 and on exact -inf
//   arithmetic.
//
// What bounds it on the H100: bytes.  Of ylocal only the live slots are
// needed (6% of 66 MB at B=128, T=50, S=55, K=47), and backward, post is
// written in full (66 MB, its pad slots zeros: 20 microseconds of device
// memory time), against a few exp/log per live arc; but the T frames depend
// on each other, which sets a latency floor the bound does not see.  The TPU kernel keeps the batch on the lanes
// ([K, S, B] tiles) and selects alpha[src] with an S-long loop of comparison
// masks, because it cannot gather.  Here sequences are independent, so one
// thread block owns one sequence and loops over all frames inside one launch:
// alpha (or beta) is double-buffered in shared memory, because the graphs are
// cyclic and a frame's result must not land in the buffer the frame still
// reads; arcs index it directly; the tables are taken in their natural
// [B, S, K] layout, so the large ylocal is never transposed.  One warp takes
// one state at a time, its lanes the state's arc slots, and reduces with
// shuffles in a fixed order.  The sequence's own tables (src, logw, the
// by-source list) are read from device memory every frame: they are at most
// tens of KB per block and stay in L1/L2, so a copy in shared memory gains
// nothing (measured level on an H100 at both shapes the port serves) and
// would bound S * K.
//
// Pad slots: the wrapper passes nk[s], one past the last live slot of state
// s (6% of the slots are live at the trigram shape), and the forward reads
// neither tables nor ylocal beyond it.  K8b's reduction by SOURCE state uses
// no atomics and repeats bit for bit: the wrapper prepares, once per batch,
// each sequence's live slots in source order (by_off [S + 1], by_arc), and
// one warp per source state adds them up in that order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// m + log(sum of exp(v_i - m)) from the warp's maximum m and each lane's
// sum of exp(v_i - m); -inf when there was nothing to add
__device__ __forceinline__ float warp_lse(float m, float lane_sum) {
  const float total = warp_sum(lane_sum);
  return m > -INFINITY ? m + logf(total) : -INFINITY;
}

// K8f.  One block per sequence b.  Dynamic shared memory: 2 S floats.
// ylocal [B, T, S, K]; src, logw [B, S, K]; nk [B, S]; out [T, B, S].
__global__ void e2e_fwd_kernel(const float* __restrict__ ylocal, const int* __restrict__ src,
                               const float* __restrict__ logw, const int* __restrict__ nk,
                               float* __restrict__ out, int B, int T, int S, int K) {
  extern __shared__ float sh[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int A = S * K;
  float* alpha_sh = sh;  // [2][S]
  const int* src_b = src + (size_t)b * A;
  const float* logw_b = logw + (size_t)b * A;
  const int* nk_b = nk + (size_t)b * S;
  for (int s = tid; s < S; s += nt) alpha_sh[s] = s == 0 ? 0.0f : -INFINITY;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = alpha_sh + (t & 1) * S;
    float* nxt = alpha_sh + ((t + 1) & 1) * S;
    const float* yl = ylocal + ((size_t)b * T + t) * A;
    for (int s = warp; s < S; s += nwarps) {
      const int n = nk_b[s];
      const int row = s * K;
      float m = -INFINITY;
      for (int k = lane; k < n; k += 32) {
        const int sp = src_b[row + k];
        if (sp >= 0) m = fmaxf(m, (cur[sp] + logw_b[row + k]) + yl[row + k]);
      }
      m = warp_max(m);
      float sum = 0.0f;
      if (m > -INFINITY)
        for (int k = lane; k < n; k += 32) {
          const int sp = src_b[row + k];
          if (sp >= 0) sum += expf((cur[sp] + logw_b[row + k]) + yl[row + k] - m);
        }
      const float r = warp_lse(m, sum);
      if (lane == 0) {
        nxt[s] = r;
        out[((size_t)t * B + b) * S + s] = r;
      }
    }
    __syncthreads();  // nxt is complete, and every warp has left cur
  }
}

// K8b.  One block per sequence b.  Dynamic shared memory: 3 S floats (beta
// twice, alpha_t).
// alphas [T, B, S] (frames 0 .. T-1); final_logw [B, S]; logp [B];
// by_off [B, S + 1]; by_arc [B, L]; post out [B, T, S, K].
__global__ void e2e_bwd_kernel(const float* __restrict__ ylocal, const float* __restrict__ alphas,
                               const int* __restrict__ src, const float* __restrict__ logw,
                               const float* __restrict__ final_logw,
                               const float* __restrict__ logp_in, const int* __restrict__ by_off,
                               const int* __restrict__ by_arc, float* __restrict__ post, int B,
                               int T, int S, int K, int L) {
  extern __shared__ float sh[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int A = S * K;
  float* beta_sh = sh;           // [2][S]
  float* alpha_sh = sh + 2 * S;  // [S]
  const int* src_b = src + (size_t)b * A;
  const float* logw_b = logw + (size_t)b * A;
  const int* off_b = by_off + (size_t)b * (S + 1);
  const int* arc_b = by_arc + (size_t)b * L;
  const float lp = logp_in[b];
  const float logp = isfinite(lp) ? lp : INFINITY;
  for (int s = tid; s < S; s += nt) beta_sh[s] = final_logw[(size_t)b * S + s];
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const float* cur = beta_sh + (i & 1) * S;
    float* nxt = beta_sh + ((i + 1) & 1) * S;
    const float* yl = ylocal + ((size_t)b * T + t) * A;
    float* po = post + ((size_t)b * T + t) * A;
    const float* arow = alphas + ((size_t)t * B + b) * S;
    for (int s = tid; s < S; s += nt) alpha_sh[s] = arow[s];
    __syncthreads();  // cur (written last frame) and alpha_sh are in place
    // per-arc posteriors, every slot of the frame written (0 on pads)
    for (int a = tid; a < A; a += nt) {
      const int sp = src_b[a];
      float p = 0.0f;
      if (sp >= 0) {
        const float aw = (logw_b[a] + yl[a]) + cur[a / K];
        // alpha or aw may be -inf and logp +inf: the sum is then -inf (never
        // inf - inf), and expf(-inf) is exactly 0
        p = expf(alpha_sh[sp] + aw - logp);
      }
      po[a] = p;
    }
    // beta of the source states: one warp per source state, its live slots
    // in the prepared order
    for (int sp = warp; sp < S; sp += nwarps) {
      const int j0 = off_b[sp], j1 = off_b[sp + 1];
      float m = -INFINITY;
      for (int j = j0 + lane; j < j1; j += 32) {
        const int a = arc_b[j];
        m = fmaxf(m, (logw_b[a] + yl[a]) + cur[a / K]);
      }
      m = warp_max(m);
      float sum = 0.0f;
      if (m > -INFINITY)
        for (int j = j0 + lane; j < j1; j += 32) {
          const int a = arc_b[j];
          sum += expf((logw_b[a] + yl[a]) + cur[a / K] - m);
        }
      const float r = warp_lse(m, sum);
      if (lane == 0) nxt[sp] = r;
    }
    __syncthreads();  // every thread has left cur and alpha_sh; nxt is complete
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most dynamic shared memory a block of these kernels may ask for on the
// current device (opt-in limit), in bytes.
int e2e_shared_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return limit;
}

// K8f: alphas of frames 1 .. T, on `stream`.  The wrapper has held the
// 2 S floats of shared memory against e2e_shared_limit().
int e2e_forward(const float* ylocal, const int* src, const float* logw, const int* nk,
                float* out, int B, int T, int S, int K, int threads, cudaStream_t stream) {
  if (B == 0 || T == 0) return 0;
  const int smem = 2 * S * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(e2e_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  e2e_fwd_kernel<<<B, threads, smem, stream>>>(ylocal, src, logw, nk, out, B, T, S, K);
  return (int)cudaGetLastError();
}

// K8b: per-arc posteriors of frames 0 .. T-1, on `stream` (3 S floats of
// shared memory).
int e2e_backward(const float* ylocal, const float* alphas, const int* src, const float* logw,
                 const float* final_logw, const float* logp, const int* by_off,
                 const int* by_arc, float* post, int B, int T, int S, int K, int L, int threads,
                 cudaStream_t stream) {
  if (B == 0 || T == 0) return 0;
  const int smem = 3 * S * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(e2e_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  e2e_bwd_kernel<<<B, threads, smem, stream>>>(ylocal, alphas, src, logw, final_logw, logp,
                                               by_off, by_arc, post, B, T, S, K, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
