// Per-frame pdf-vocabulary gather and scatter of the numerator:
// kernels K5 and K6, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/num_scan.py:
//   K5  vocab_gather  -> _gather_vocab  (pallas_call :140)
//   K6  vocab_scatter -> _scatter_vocab (pallas_call :179)
//
//   K5: ysmall[b, t, w] = y[b, t, vocab[b, t, w]]
//   K6: gamma[b, t, p]  = sum over w with vocab[b, t, w] == p of gsm[t, b, w]
//
// What bounds them on the H100: bytes.  Each does one multiply-free pass
// (K5 reads B*T*W indices and as many scattered y values; K6 reads the
// [T, B, W] occupancies and indices and writes the whole [B, T, P] output),
// a few MB at the trigram shapes, i.e. microseconds of device memory time;
// at that size a launch costs as much as the work.  Design: one thread per
// output element, neighbouring threads on neighbouring output addresses.
// K6 writes every element of gamma (zero where no vocabulary slot names the
// pdf), so no separate memset is needed, and it ACCUMULATES over the W
// slots like the TPU kernel: pad slots repeat pdf 0 with a value of exactly
// 0, so a real pdf-0 occupancy in the same row is never overwritten.  No
// atomics: the result does not depend on the order threads run in.

#include <cuda_runtime.h>

namespace {

__global__ void vocab_gather_kernel(const float* __restrict__ y, const int* __restrict__ vocab,
                                    float* __restrict__ out, long long n_rows, int P, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * W) return;
  const long long row = i / W;  // row = b * T + t
  out[i] = y[row * P + vocab[i]];
}

__global__ void vocab_scatter_kernel(const float* __restrict__ gsm, const int* __restrict__ vocab,
                                     float* __restrict__ gamma, int B, int T, int P, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * T * P) return;
  const int q = (int)(i % P);
  const long long bt = i / P;
  const int t = (int)(bt % T), b = (int)(bt / T);
  const int* v = vocab + bt * W;                    // vocab [B, T, W]
  const float* g = gsm + ((long long)t * B + b) * W;  // gsm [T, B, W]
  float acc = 0.0f;
  for (int w = 0; w < W; ++w)
    if (v[w] == q) acc += g[w];
  gamma[i] = acc;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K5: y [B, T, P] f32, vocab [B, T, W] int32 -> out [B, T, W] f32
int vocab_gather(const float* y, const int* vocab, float* out, int B, int T, int P, int W,
                 cudaStream_t stream) {
  const long long n = (long long)B * T * W;
  if (n == 0) return 0;
  const int threads = 256;
  vocab_gather_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      y, vocab, out, (long long)B * T, P, W);
  return (int)cudaGetLastError();
}

// K6: gsm [T, B, W] f32, vocab [B, T, W] int32 -> gamma [B, T, P] f32
int vocab_scatter(const float* gsm, const int* vocab, float* gamma, int B, int T, int P, int W,
                  cudaStream_t stream) {
  const long long n = (long long)B * T * P;
  if (n == 0) return 0;
  const int threads = 256;
  vocab_scatter_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      gsm, vocab, gamma, B, T, P, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
