// Per-frame pdf-vocabulary gather and scatter of the numerator:
// kernels K5 and K6, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/num_scan.py:
//   K5  vocab_gather  -> _gather_vocab  (pallas_call :140)
//   K6  vocab_scatter -> _scatter_vocab (pallas_call :179)
//
//   K5: ysmall[b, t, w] = y[b, t, vocab[b, t, w]]
//   K6: gamma[b, t, p]  = sum over w with vocab[b, t, w] == p of gsm[t, b, w],
//                         in slot order (0.0 where no slot names p)
//
// A row is one (b, t): W vocabulary slots (a sorted run of distinct pdfs,
// padded with repeats of pdf 0 whose occupancy is exactly 0.0) against P
// pdfs, W << P.
//
// What bounds them on the H100.  K5 reads B*T*W indices, one 32-byte
// sector of y per index at most, and writes B*T*W values: under 5 MB at
// the production shapes (B=128, T=50, W=16, P=1680), about a microsecond
// of device memory time, so a launch and two dependent loads are its
// floor.  Design: a half-warp per row (a block of 16 x 16 threads takes 16
// rows), each lane one slot: one 64-byte index load per row, W read-only
// gathers, one 64-byte store; no division.  K6 writes the whole
// [B, T, P] output (43 MB at production, 13 us at 3.35 TB/s) of which at
// most W entries a row are not zero: it is bound by that write.  Design: a
// 2-D grid, a block per (tile of ROWS frames, sequence), so that its rows
// are one contiguous stretch of gamma.  The block stages its rows' W
// indices and occupancies in shared memory, writes the stretch as zeros
// with 16-byte streaming stores (a scalar head and tail where P is not a
// multiple of 4 and the stretch is not 16-byte aligned), and after the
// block's barrier the first slot naming each distinct pdf of a row (its
// leader) stores that pdf's sum over the row's slots in slot order.  No
// atomics and no per-element loop over W: the result equals the plain
// scatter-add bit for bit and repeats from run to run.  An index outside
// [0, P) gathers NaN (K5) or is skipped (K6), never read or written out of
// bounds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GATHER_LANES = 16;  // a half-warp per row
constexpr int GATHER_ROWS = 16;   // rows per block of 256 threads
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_ROWS = 8;   // frames per block
constexpr int MAX_W = 768;        // staged slots: 2 * SCATTER_ROWS * W * 4 bytes <= 48 KiB

__global__ void __launch_bounds__(GATHER_LANES * GATHER_ROWS)
vocab_gather_kernel(const float* __restrict__ y, const int* __restrict__ vocab,
                    float* __restrict__ out, int n_rows, int P, int W) {
  const int row = blockIdx.x * GATHER_ROWS + threadIdx.y;
  if (row >= n_rows) return;
  const float* yr = y + (long long)row * P;
  const long long o = (long long)row * W;
  for (int w = threadIdx.x; w < W; w += GATHER_LANES) {
    const int p = __ldg(vocab + o + w);
    out[o + w] = (unsigned)p < (unsigned)P ? __ldg(yr + p) : __int_as_float(0x7fc00000);
  }
}

__global__ void __launch_bounds__(SCATTER_THREADS)
vocab_scatter_kernel(const float* __restrict__ gsm, const int* __restrict__ vocab,
                     float* __restrict__ gamma, int B, int T, int P, int W) {
  extern __shared__ int staged[];
  int* sv = staged;                                     // [ROWS, W] pdfs
  float* sg = (float*)(staged + SCATTER_ROWS * W);      // [ROWS, W] occupancies
  const int b = blockIdx.y, t0 = blockIdx.x * SCATTER_ROWS;
  const int rows = min(SCATTER_ROWS, T - t0);
  const int slots = rows * W;
  const long long row0 = (long long)b * T + t0;
  for (int i = threadIdx.x; i < slots; i += SCATTER_THREADS) {
    const int r = i / W, w = i - r * W;
    sv[i] = __ldg(vocab + row0 * W + i);                     // vocab [B, T, W]
    sg[i] = __ldg(gsm + ((long long)(t0 + r) * B + b) * W + w);  // gsm [T, B, W]
  }

  // zeros over the block's stretch gamma[b, t0 : t0 + rows, :]
  float* out = gamma + row0 * P;
  const int n = rows * P;
  const int head = min((int)((16 - ((uintptr_t)out & 15)) & 15) / 4, n);
  const int n4 = (n - head) / 4;
  const int tail = head + 4 * n4;
  if (threadIdx.x < head) __stcs(out + threadIdx.x, 0.0f);
  float4* body = (float4*)(out + head);
  for (int i = threadIdx.x; i < n4; i += SCATTER_THREADS)
    __stcs(body + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  if (threadIdx.x < n - tail) __stcs(out + tail + threadIdx.x, 0.0f);
  __syncthreads();  // the zeros of the block's threads come before the sums

  for (int i = threadIdx.x; i < slots; i += SCATTER_THREADS) {
    const int r = i / W, w = i - r * W;
    const int* v = sv + r * W;
    const float* g = sg + r * W;
    const int p = v[w];
    bool leader = (unsigned)p < (unsigned)P;
    for (int u = 0; u < w; ++u) leader = leader && v[u] != p;
    if (!leader) continue;
    float acc = 0.0f;
    for (int u = w; u < W; ++u)
      if (v[u] == p) acc += g[u];
    out[(long long)r * P + p] = acc;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K5: y [B, T, P] f32, vocab [B, T, W] int32 -> out [B, T, W] f32
int vocab_gather(const float* y, const int* vocab, float* out, int B, int T, int P, int W,
                 cudaStream_t stream) {
  const long long n_rows = (long long)B * T;
  if (n_rows == 0 || W == 0) return 0;
  if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(GATHER_LANES, GATHER_ROWS);
  const unsigned blocks = (unsigned)((n_rows + GATHER_ROWS - 1) / GATHER_ROWS);
  vocab_gather_kernel<<<blocks, block, 0, stream>>>(y, vocab, out, (int)n_rows, P, W);
  return (int)cudaGetLastError();
}

// K6: gsm [T, B, W] f32, vocab [B, T, W] int32 -> gamma [B, T, P] f32
int vocab_scatter(const float* gsm, const int* vocab, float* gamma, int B, int T, int P, int W,
                  cudaStream_t stream) {
  if ((long long)B * T * P == 0) return 0;
  if (W > MAX_W || (long long)SCATTER_ROWS * P > 0x7fffffffLL || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + SCATTER_ROWS - 1) / SCATTER_ROWS, B);
  const size_t shared = 2 * SCATTER_ROWS * (size_t)W * 4;
  vocab_scatter_kernel<<<grid, SCATTER_THREADS, shared, stream>>>(gsm, vocab, gamma, B, T, P, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
