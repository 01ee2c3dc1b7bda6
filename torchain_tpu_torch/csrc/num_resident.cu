// Numerator steady-frame recursions of LF-MMI: kernels K3 (forward) and K4
// (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/num_resident.py:
//   K3  num_steady_forward  -> _fwd_kernel (steady_forward,  pallas_call :158)
//   K4  num_steady_backward -> _bwd_kernel (steady_backward, pallas_call :207)
//
// Math (log semiring; arc slot (s, k) of frame t enters state s from state
// src[s, k] with weight logw[s, k] and emits vocabulary slot lpdf[s, k];
// src < 0 marks a pad slot):
//   K3, frame t = 0 .. T-2 of the steady tables (frames 1 .. T-1 of the
//   chunk):
//       next[s] = lse_k(alpha[src[s, k]] + logw[s, k] + ysm[t, lpdf[s, k]])
//   K4, the same frames in reverse, beta starting at the final weights:
//       arc_w[s, k] = logw[s, k] + ysm[t, lpdf[s, k]] + beta[s]
//       post[s, k]  = exp(alpha_t[src[s, k]] + arc_w[s, k] - logp)
//       gsm[t, w]   = sum of post over the arcs with lpdf == w
//       beta'[s']   = lse of arc_w over the arcs with src == s'
//   with logp = +inf for a sequence whose log-probability is not finite, so
//   that its occupancies are exactly 0.  A log-sum-exp over no arcs (or over
//   arcs that are all -inf) is -inf, never NaN: the maximum is tested before
//   anything is subtracted from it.  No fast-math: the recursion relies on
//   expf(-inf) == 0 and on exact -inf arithmetic.
//
// What bounds it on the H100: neither bytes nor operations but latency.  The
// tables are read once (about 18 MB at B=128, T=50, S=20, Kr=12: microseconds
// of device memory time) and the arithmetic is a few hundred exp/log per
// frame, but the T-1 frames depend on each other.  The TPU kernel keeps the
// batch on the lanes ([Kr, S, B] tiles) and selects alpha[src] and ysm[lpdf]
// with S- and W-long loops of comparison masks, because it cannot gather.
// Here sequences are independent, so one thread block owns one sequence and
// loops over all frames inside one launch: alpha (or beta) lives in shared
// memory, arcs index it directly, and a frame costs two __syncthreads().
// Nothing carries between blocks.  The next frame's table rows are
// prefetched into L2 while the current frame computes.
//
// K4's two reductions use no atomics and repeat bit for bit: one thread per
// source state scans the frame's arc slots in shared memory in slot order
// (maximum, then sum of exp), and one thread per vocabulary slot sums the
// posteriors likewise.  Pad slots are read like any other (97% of the slots
// are pads at the trigram shapes); a compact list of live arcs per frame is
// the later optimisation.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// K3.  One block per sequence b; dynamic shared memory (S + W + S*Kr) floats.
// src, lpdf, logw [B, Tm1, S, Kr]; ysm rows at b * ys_b + t * ys_t, W wide;
// alpha1 [B, S]; out [Tm1, B, S].
__global__ void steady_fwd_kernel(const int* __restrict__ src, const int* __restrict__ lpdf,
                                  const float* __restrict__ logw, const float* __restrict__ ysm,
                                  long long ys_b, long long ys_t,
                                  const float* __restrict__ alpha1, float* __restrict__ out,
                                  int B, int Tm1, int S, int Kr, int W) {
  extern __shared__ float sh[];
  float* alpha_sh = sh;          // [S]
  float* ysm_sh = alpha_sh + S;  // [W]
  float* val_sh = ysm_sh + W;    // [S * Kr]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int A = S * Kr;
  for (int s = tid; s < S; s += nt) alpha_sh[s] = alpha1[(size_t)b * S + s];
  for (int t = 0; t < Tm1; ++t) {
    const size_t base = ((size_t)b * Tm1 + t) * A;
    const float* yrow = ysm + (size_t)b * ys_b + (size_t)t * ys_t;
    for (int w = tid; w < W; w += nt) ysm_sh[w] = yrow[w];
    if (t + 1 < Tm1)
      for (int i = tid; i < A; i += nt) {
        prefetch_l2(src + base + A + i);
        prefetch_l2(lpdf + base + A + i);
        prefetch_l2(logw + base + A + i);
      }
    __syncthreads();  // alpha_sh and ysm_sh of this frame are in place
    for (int i = tid; i < A; i += nt) {
      const int sp = src[base + i];
      float v = -INFINITY;
      if (sp >= 0) v = alpha_sh[sp] + (logw[base + i] + ysm_sh[lpdf[base + i]]);
      val_sh[i] = v;
    }
    __syncthreads();  // every arc has read alpha_sh; val_sh is complete
    for (int s = tid; s < S; s += nt) {
      const float* v = val_sh + s * Kr;
      float m = -INFINITY;
      for (int k = 0; k < Kr; ++k) m = fmaxf(m, v[k]);
      float r = -INFINITY;
      if (m > -INFINITY) {
        float sum = 0.0f;
        for (int k = 0; k < Kr; ++k) sum += expf(v[k] - m);
        r = m + logf(sum);
      }
      alpha_sh[s] = r;
      out[((size_t)t * B + b) * S + s] = r;
    }
  }
}

// K4.  One block per sequence b; dynamic shared memory (2 S + W + 2 S*Kr)
// floats and 2 S*Kr ints.  alphas [Tm1, B, S] are the alphas of each frame's
// SOURCE states; final [B, S]; logp [B]; gsm out [Tm1, B, W]; beta1 out
// [B, S]: the beta after the earliest frame's step.
__global__ void steady_bwd_kernel(const int* __restrict__ src, const int* __restrict__ lpdf,
                                  const float* __restrict__ logw, const float* __restrict__ ysm,
                                  long long ys_b, long long ys_t,
                                  const float* __restrict__ alphas,
                                  const float* __restrict__ final_logw,
                                  const float* __restrict__ logp_in, float* __restrict__ gsm,
                                  float* __restrict__ beta1, int B, int Tm1, int S, int Kr,
                                  int W) {
  extern __shared__ float sh[];
  const int A = S * Kr;
  float* beta_sh = sh;            // [S]
  float* alpha_sh = beta_sh + S;  // [S]
  float* ysm_sh = alpha_sh + S;   // [W]
  float* arcw_sh = ysm_sh + W;    // [A]
  float* post_sh = arcw_sh + A;   // [A]
  int* src_sh = reinterpret_cast<int*>(post_sh + A);  // [A]
  int* lpdf_sh = src_sh + A;                          // [A]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float lp = logp_in[b];
  const float logp = isfinite(lp) ? lp : INFINITY;
  for (int s = tid; s < S; s += nt) beta_sh[s] = final_logw[(size_t)b * S + s];
  for (int t = Tm1 - 1; t >= 0; --t) {
    const size_t base = ((size_t)b * Tm1 + t) * A;
    const float* yrow = ysm + (size_t)b * ys_b + (size_t)t * ys_t;
    const float* arow = alphas + ((size_t)t * B + b) * S;
    for (int w = tid; w < W; w += nt) ysm_sh[w] = yrow[w];
    for (int s = tid; s < S; s += nt) alpha_sh[s] = arow[s];
    if (t > 0)
      for (int i = tid; i < A; i += nt) {
        prefetch_l2(src + base - A + i);
        prefetch_l2(lpdf + base - A + i);
        prefetch_l2(logw + base - A + i);
      }
    __syncthreads();  // beta_sh, alpha_sh and ysm_sh of this frame are in place
    for (int i = tid; i < A; i += nt) {
      const int sp = src[base + i];
      const int l = lpdf[base + i];
      float aw = -INFINITY, po = 0.0f;
      if (sp >= 0) {
        aw = (logw[base + i] + ysm_sh[l]) + beta_sh[i / Kr];
        // alpha or aw may be -inf and logp +inf: the sum is then -inf (never
        // inf - inf), and expf(-inf) is exactly 0
        po = expf(alpha_sh[sp] + aw - logp);
      }
      src_sh[i] = sp;
      lpdf_sh[i] = l;
      arcw_sh[i] = aw;
      post_sh[i] = po;
    }
    __syncthreads();  // every arc has read beta_sh; the arc arrays are complete
    // the lowest threads take the source states, the highest the vocabulary
    // slots, so that the two scans run in different warps
    for (int sp = tid; sp < S; sp += nt) {
      float m = -INFINITY;
      for (int a = 0; a < A; ++a)
        if (src_sh[a] == sp) m = fmaxf(m, arcw_sh[a]);
      float r = -INFINITY;
      if (m > -INFINITY) {
        float sum = 0.0f;
        for (int a = 0; a < A; ++a)
          if (src_sh[a] == sp) sum += expf(arcw_sh[a] - m);
        r = m + logf(sum);
      }
      beta_sh[sp] = r;
    }
    for (int w = nt - 1 - tid; w < W; w += nt) {
      float acc = 0.0f;
      for (int a = 0; a < A; ++a)
        if (lpdf_sh[a] == w) acc += post_sh[a];
      gsm[((size_t)t * B + b) * W + w] = acc;
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += nt) beta1[(size_t)b * S + s] = beta_sh[s];
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K3: alphas of frames 1 .. T-1, on `stream`, `threads` threads per block.
int num_steady_forward(const int* src, const int* lpdf, const float* logw, const float* ysm,
                       long long ys_b, long long ys_t, const float* alpha1, float* out,
                       int B, int Tm1, int S, int Kr, int W, int threads, cudaStream_t stream) {
  if (B == 0 || Tm1 == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)S + W + (size_t)S * Kr);
  steady_fwd_kernel<<<B, threads, smem, stream>>>(src, lpdf, logw, ysm, ys_b, ys_t, alpha1, out,
                                                  B, Tm1, S, Kr, W);
  return (int)cudaGetLastError();
}

// K4: vocabulary-space occupancies of frames 1 .. T-1 and beta1, on `stream`.
int num_steady_backward(const int* src, const int* lpdf, const float* logw, const float* ysm,
                        long long ys_b, long long ys_t, const float* alphas,
                        const float* final_logw, const float* logp, float* gsm, float* beta1,
                        int B, int Tm1, int S, int Kr, int W, int threads,
                        cudaStream_t stream) {
  if (B == 0 || Tm1 == 0) return 0;
  const size_t smem = sizeof(float) * (2 * (size_t)S + W + 4 * (size_t)S * Kr);
  steady_bwd_kernel<<<B, threads, smem, stream>>>(src, lpdf, logw, ysm, ys_b, ys_t, alphas,
                                                  final_logw, logp, gsm, beta1, B, Tm1, S, Kr,
                                                  W);
  return (int)cudaGetLastError();
}

}  // extern "C"
