// Fused multi-head self-attention with relative-position bias:
// kernels K7f (forward) and K7b (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/attention.py:
//   K7f  attention_forward  -> _fwd_kernel (pallas_call :219)
//   K7b  attention_backward -> _bwd_kernel (pallas_call :258)
//
//   out[b, t, h*dh + d] = sum_s softmax_s(scale * q_h[t] . k_h[s] + bias[h, t, s]) * v_h[s, d]
//
// with q_h, k_h, v_h the [T, dh] slices of qkv [B, T, 3D] at columns
// h*dh + {0, D, 2D}.  qkv, out, g and dqkv are float32 or bfloat16; every
// product and the softmax are float32, and the probabilities are not
// rounded before the product with v.  The backward recomputes the softmax.
//
// What bounds them on the H100: bytes, by a wide margin (at B=128, T=50,
// H=4, dh=64 the forward reads 9.8 MB of bf16 qkv for 0.33 GFLOP), and at
// that size latency: each head is a handful of [50, 64] x [64, 50]
// products.  The TPU kernel stacks the heads block-diagonally to fill its
// matrix unit and masks the cross-head blocks; none of that is needed here.
// Design: one thread block per (batch row, head) pair, 512 blocks for 132
// SMs at the sizes above.  The block copies its q, k, v (and g) slices into
// shared memory as float32, rows padded by one float so that a warp reading
// one column of 32 rows hits 32 banks, computes the [T, T] logits there,
// runs the softmax with one warp per row, and writes its [T, dh] results
// straight into out[b, :, h*dh:(h+1)*dh] (dqkv likewise): no padding of T,
// no mask, no transposes outside.  The bias gradient is a sum over the
// batch, that is over blocks: each block writes its [T, T] logit gradient
// into a [B, H, T, T] scratch and a second kernel of the same entry point
// adds the B slices in batch order.  No atomics: the results repeat bit for
// bit.  The shared memory a block needs grows with T*dh and T*T;
// attention_shared_bytes states it and the entry points refuse what the
// card cannot give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy the head's [T, dh] slice at `src` (row stride `stride`) into shared
// memory as float32 with row stride ld.
template <typename T>
__device__ __forceinline__ void load_head(float* dst, const T* src, long long stride, int Tn,
                                          int dh, int ld) {
  for (int i = threadIdx.x; i < Tn * dh; i += THREADS) {
    const int t = i / dh, d = i - t * dh;
    dst[t * ld + d] = to_f32(src[t * stride + d]);
  }
}

// In place, one warp per row: p[r, :] = softmax(p[r, :]).
__device__ __forceinline__ void softmax_row(float* row, int Tn, int lane) {
  float m = -INFINITY;
  for (int c = lane; c < Tn; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  float s = 0.0f;
  for (int c = lane; c < Tn; c += 32) {
    const float e = expf(row[c] - m);
    row[c] = e;
    s += e;
  }
  s = warp_sum(s);
  for (int c = lane; c < Tn; c += 32) row[c] = row[c] / s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, T* __restrict__ out,
                int Tn, int H, int dh, float scale) {
  extern __shared__ float sm[];
  const int ld = dh + 1;
  float* q = sm;
  float* k = q + Tn * ld;
  float* v = k + Tn * ld;
  float* p = v + Tn * ld;  // [Tn, Tn]
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh;
  const long long stride = 3LL * D;
  const T* base = qkv + (long long)b * Tn * stride + h * dh;
  load_head(q, base, stride, Tn, dh, ld);
  load_head(k, base + D, stride, Tn, dh, ld);
  load_head(v, base + 2 * D, stride, Tn, dh, ld);
  __syncthreads();

  const float* bh = bias + (long long)h * Tn * Tn;
  for (int i = threadIdx.x; i < Tn * Tn; i += THREADS) {
    const int r = i / Tn, c = i - r * Tn;
    const float* qr = q + r * ld;
    const float* kc = k + c * ld;
    float acc = 0.0f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kc[d], acc);
    p[i] = acc * scale + bh[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < Tn; r += THREADS / 32) softmax_row(p + r * Tn, Tn, lane);
  __syncthreads();

  T* ob = out + (long long)b * Tn * D + h * dh;
  for (int i = threadIdx.x; i < Tn * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    const float* pr = p + r * Tn;
    float acc = 0.0f;
    for (int s = 0; s < Tn; ++s) acc = fmaf(pr[s], v[s * ld + d], acc);
    ob[(long long)r * D + d] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                const T* __restrict__ g, T* __restrict__ dqkv, float* __restrict__ dl_all,
                int Tn, int H, int dh, float scale) {
  extern __shared__ float sm[];
  const int ld = dh + 1;
  float* q = sm;
  float* k = q + Tn * ld;
  float* v = k + Tn * ld;
  float* go = v + Tn * ld;
  float* p = go + Tn * ld;  // [Tn, Tn]
  float* dl = p + Tn * Tn;  // [Tn, Tn]: dp, then the logit gradient
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh;
  const long long stride = 3LL * D;
  const long long off = (long long)b * Tn * stride + h * dh;
  load_head(q, qkv + off, stride, Tn, dh, ld);
  load_head(k, qkv + off + D, stride, Tn, dh, ld);
  load_head(v, qkv + off + 2 * D, stride, Tn, dh, ld);
  load_head(go, g + (long long)b * Tn * D + h * dh, (long long)D, Tn, dh, ld);
  __syncthreads();

  // logits and dp = g v^T
  const float* bh = bias + (long long)h * Tn * Tn;
  for (int i = threadIdx.x; i < Tn * Tn; i += THREADS) {
    const int r = i / Tn, c = i - r * Tn;
    const float* qr = q + r * ld;
    const float* gr = go + r * ld;
    const float* kc = k + c * ld;
    const float* vc = v + c * ld;
    float acc = 0.0f, accp = 0.0f;
    for (int d = 0; d < dh; ++d) {
      acc = fmaf(qr[d], kc[d], acc);
      accp = fmaf(gr[d], vc[d], accp);
    }
    p[i] = acc * scale + bh[i];
    dl[i] = accp;
  }
  __syncthreads();

  // softmax, then dl = p * (dp - sum_s dp * p), one warp per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dl_out = dl_all + (long long)blockIdx.x * Tn * Tn;  // [B, H, Tn, Tn]
  for (int r = warp; r < Tn; r += THREADS / 32) {
    float* pr = p + r * Tn;
    float* dr = dl + r * Tn;
    softmax_row(pr, Tn, lane);
    float s = 0.0f;
    for (int c = lane; c < Tn; c += 32) s += dr[c] * pr[c];
    s = warp_sum(s);
    for (int c = lane; c < Tn; c += 32) {
      const float x = pr[c] * (dr[c] - s);
      dr[c] = x;
      dl_out[r * Tn + c] = x;
    }
  }
  __syncthreads();

  // dq = scale * dl k, dk = scale * dl^T q, dv = p^T g
  T* db = dqkv + off;
  for (int i = threadIdx.x; i < Tn * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    const float* dlr = dl + r * Tn;
    float aq = 0.0f, ak = 0.0f, av = 0.0f;
    for (int s = 0; s < Tn; ++s) {
      aq = fmaf(dlr[s], k[s * ld + d], aq);
      ak = fmaf(dl[s * Tn + r], q[s * ld + d], ak);
      av = fmaf(p[s * Tn + r], go[s * ld + d], av);
    }
    T* row = db + (long long)r * stride + d;
    row[0] = from_f32<T>(aq * scale);
    row[D] = from_f32<T>(ak * scale);
    row[2 * D] = from_f32<T>(av);
  }
}

// dbias[i] = sum over b, in batch order, of dl_all[b, i]; i over H*Tn*Tn
__global__ void dbias_reduce_kernel(const float* __restrict__ dl_all, float* __restrict__ dbias,
                                    int B, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += dl_all[b * n + i];
  dbias[i] = acc;
}

long long shared_bytes(int Tn, int dh, int backward) {
  const long long head = (long long)Tn * (dh + 1), sq = (long long)Tn * Tn;
  return 4 * (backward ? 4 * head + 2 * sq : 3 * head + sq);
}

int shared_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return limit;
}

template <typename K>
int allow_shared(K kernel, long long bytes) {
  if (bytes > shared_limit()) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int forward(const void* qkv, const float* bias, void* out, int B, int Tn, int H, int dh,
            float scale, cudaStream_t stream) {
  const long long bytes = shared_bytes(Tn, dh, 0);
  const int err = allow_shared(attn_fwd_kernel<T>, bytes);
  if (err) return err;
  attn_fwd_kernel<T><<<B * H, THREADS, bytes, stream>>>((const T*)qkv, bias, (T*)out, Tn, H, dh,
                                                        scale);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* qkv, const float* bias, const void* g, void* dqkv, float* dl_all,
             float* dbias, int B, int Tn, int H, int dh, float scale, cudaStream_t stream) {
  const long long bytes = shared_bytes(Tn, dh, 1);
  int err = allow_shared(attn_bwd_kernel<T>, bytes);
  if (err) return err;
  attn_bwd_kernel<T><<<B * H, THREADS, bytes, stream>>>((const T*)qkv, bias, (const T*)g,
                                                        (T*)dqkv, dl_all, Tn, H, dh, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)H * Tn * Tn;
  dbias_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(dl_all, dbias, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shared memory per block, in bytes, that the forward (backward = 0) or the
// backward (1) kernel asks for at sequence length T and head width dh.
int attention_shared_bytes(int T, int dh, int backward) {
  const long long bytes = shared_bytes(T, dh, backward);
  return bytes > 0x7fffffffLL ? 0x7fffffff : (int)bytes;
}

// The most shared memory a block may ask for on the current device.
int attention_shared_limit() { return shared_limit(); }

// K7f: qkv [B, T, 3*H*dh], bias [H, T, T] f32 -> out [B, T, H*dh]; qkv and
// out float32 (is_bf16 = 0) or bfloat16 (1).
int attention_forward(const void* qkv, const float* bias, void* out, int B, int T, int H, int dh,
                      float scale, int is_bf16, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0 || dh == 0) return 0;
  return is_bf16 ? forward<__nv_bfloat16>(qkv, bias, out, B, T, H, dh, scale, stream)
                 : forward<float>(qkv, bias, out, B, T, H, dh, scale, stream);
}

// K7b: + g [B, T, H*dh] -> dqkv [B, T, 3*H*dh], dbias [H, T, T] f32, through
// the scratch dl_all [B, H, T, T] f32.
int attention_backward(const void* qkv, const float* bias, const void* g, void* dqkv,
                       float* dl_all, float* dbias, int B, int T, int H, int dh, float scale,
                       int is_bf16, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0 || dh == 0) return 0;
  return is_bf16
             ? backward<__nv_bfloat16>(qkv, bias, g, dqkv, dl_all, dbias, B, T, H, dh, scale,
                                       stream)
             : backward<float>(qkv, bias, g, dqkv, dl_all, dbias, B, T, H, dh, scale, stream);
}

}  // extern "C"
