// Fused conformer feed-forward half-step: kernels K10f (forward) and K10b
// (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/fused_ffn.py:
//   K10f  ffn_forward  -> _fwd_kernel (pallas_call :200)
//   K10b  ffn_backward -> _bwd_kernel (pallas_call :239)
//
//   u   = xn W1 + b1                      [N, F], float32 accumulation
//   h   = round(u * sigmoid(u))           rounded to the trunk dtype
//   out = res + alpha * (h W2 + b2)       [N, D], trunk dtype
//
// xn, res, W1, W2, g, out and dx are float32 or bfloat16 (the trunk dtype);
// b1, b2 and the weight gradients are float32.  The backward recomputes u,
// sigmoid and h, and keeps the roundings of the Pallas body: h and
// dhb = round(dh) are rounded before the products that use them, db1 sums
// the unrounded dh, db2 = alpha * sum(g), dW2 = alpha * h^T g.
//
// What bounds them on the H100: operations.  At N=6400, D=256, F=1024 the
// forward is 6.7 GFLOP over 11 MB of bf16 operands and the backward 16.8
// GFLOP.  These kernels multiply on the float32 FMA units (a product of two
// bfloat16 values is exact in float32, so the sums differ from a tensor
// core's only in order); tensor-core products (mma.sync, wgmma) are the
// later step.
//
// Forward design: a block owns 32 rows.  It keeps their xn tile in shared
// memory and walks F in chunks of 128: u-chunk (registers) -> swish -> h
// chunk (shared memory) -> partial product with W2[chunk, :] added into
// the block's [32, D] output accumulator, which lives in shared memory so
// that any D is handled; the [N, F] hidden tensor never leaves the SM.  A
// warp owns 4 rows and a lane every 32nd column, so the W slices staged in
// shared memory are read without bank conflicts and the A operand is a
// broadcast.
//
// Backward design: the TPU kernel carries the four weight-gradient sums
// across its sequential grid; blocks here run in no order.  Pass 1 (one
// block per 32 rows, as the forward) recomputes u, h, dh per chunk, writes
// dx, and leaves h and dhb in a [N, F] scratch (trunk dtype) with per-block
// column sums of dh and g.  Pass 2 gives each block one 64 x 64 tile of
// dW1 = xn^T dhb or dW2 = alpha h^T g and lets it loop over all N rows.
// Pass 3 adds the per-block column sums in block order.  No atomics: the
// results repeat bit for bit.  W1^T and W2^T arrive as separate operands
// so that every product reads its B operand row-major.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 32;    // rows per block: 8 warps x RPW rows
constexpr int RPW = 4;    // rows per warp
constexpr int FC = 128;   // hidden columns per chunk
constexpr int DT = 256;   // output columns per pass of the second product
constexpr int KT = 16;    // depth of one staged slice of a B operand
constexpr int CTF = FC / 32, CTD = DT / 32;
constexpr int TM = 64, TN = 64, KT2 = 32;  // pass 2: output tile and row slice
constexpr int PER = KT2 * TM / THREADS;    // staged elements per thread

static_assert(BM == RPW * THREADS / 32, "a warp owns RPW rows");
static_assert(FC <= THREADS && FC <= DT, "one thread per chunk column");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float u) { return 1.0f / (1.0f + expf(-u)); }

// acc[r][c] += sum over k < K of A[warp*RPW + r][k] * B[k][lane + 32 c].
// A lies in shared memory (row stride lda); B in device memory (row stride
// ldb, `ncols` valid columns) and is staged through Bs in slices of KT
// rows.  Every thread of the block must call this with the same K.
template <int CT, typename TA, typename TB>
__device__ __forceinline__ void tile_gemm(float (&acc)[RPW][CT], const TA* As, int lda, int K,
                                          const TB* __restrict__ Bg, long long ldb, int ncols,
                                          float* Bs) {
  constexpr int W = 32 * CT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TA* a0 = As + warp * RPW * lda;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    __syncthreads();  // the slice before has been read; A is complete
    for (int i = threadIdx.x; i < KT * W; i += THREADS) {
      const int kk = i / W, c = i - kk * W;
      Bs[i] = (kk < kt && c < ncols) ? to_f32(Bg[(long long)(k0 + kk) * ldb + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kt; ++kk) {
      float a[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) a[r] = to_f32(a0[r * lda + k0 + kk]);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float bv = Bs[kk * W + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][c] = fmaf(a[r], bv, acc[r][c]);
      }
    }
  }
}

template <int CT>
__device__ __forceinline__ void zero(float (&acc)[RPW][CT]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.0f;
}

// Rows [row0, row0 + BM) of src [N, D] into shared memory, zeros past N.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int row0, int N,
                                          int D) {
  for (int i = threadIdx.x; i < BM * D; i += THREADS) {
    const int r = i / D;
    dst[i] = row0 + r < N ? src[(long long)row0 * D + i] : from_f32<T>(0.0f);
  }
}

// acc, a [BM, DT] tile at column d0, into the block's [BM, D] accumulator;
// each element belongs to one thread, in every pass.
__device__ __forceinline__ void add_tile(float* dst, const float (&acc)[RPW][CTD], int D, int d0,
                                         int dn, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < CTD; ++c) {
      const int col = lane + 32 * c;
      if (col < dn) {
        float* p = dst + (warp * RPW + r) * D + d0 + col;
        *p = first ? acc[r][c] : *p + acc[r][c];
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_kernel(const T* __restrict__ xn, const T* __restrict__ res, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ out, int N, int D, int F,
               float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* outs = reinterpret_cast<float*>(smem);  // [BM, D]
  float* hs = outs + BM * D;                     // [BM, FC]
  float* Bs = hs + BM * FC;                      // [KT, DT]
  T* xs = reinterpret_cast<T*>(Bs + KT * DT);    // [BM, D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;
  load_rows(xs, xn, row0, N, D);

  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);
    float u[RPW][CTF];
    zero(u);
    tile_gemm<CTF>(u, xs, D, D, w1 + f0, (long long)F, fc, Bs);
#pragma unroll
    for (int c = 0; c < CTF; ++c) {
      const int col = lane + 32 * c;
      const float bb = col < fc ? b1[f0 + col] : 0.0f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float uu = u[r][c] + bb;
        const float h = to_f32(from_f32<T>(uu * sigmoid_f32(uu)));
        hs[(warp * RPW + r) * FC + col] = col < fc ? h : 0.0f;
      }
    }
    // (a warp reads only the rows of hs it wrote; tile_gemm's first
    // barrier orders them anyway)
    for (int d0 = 0; d0 < D; d0 += DT) {
      const int dn = min(DT, D - d0);
      float o[RPW][CTD];
      zero(o);
      tile_gemm<CTD>(o, hs, FC, fc, w2 + (long long)f0 * D + d0, (long long)D, dn, Bs);
      add_tile(outs, o, D, d0, dn, f0 == 0);
    }
  }

  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp * RPW + r;
    if (row >= N) continue;
    for (int d = lane; d < D; d += 32) {
      const float v = outs[(warp * RPW + r) * D + d] + b2[d];
      out[(long long)row * D + d] =
          from_f32<T>(to_f32(res[(long long)row * D + d]) + alpha * v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_kernel(const T* __restrict__ xn, const T* __restrict__ g,
                    const T* __restrict__ w1, const float* __restrict__ b1,
                    const T* __restrict__ w1t, const T* __restrict__ w2t, T* __restrict__ dx,
                    T* __restrict__ hbuf, T* __restrict__ dhbuf, float* __restrict__ db1_part,
                    float* __restrict__ db2_part, int N, int D, int F, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dxs = reinterpret_cast<float*>(smem);  // [BM, D]
  float* dhs = dxs + BM * D;                    // [BM, FC] dh rounded to T
  float* dhf = dhs + BM * FC;                   // [BM, FC] dh as computed
  float* Bs = dhf + BM * FC;                    // [KT, DT]
  T* xs = reinterpret_cast<T*>(Bs + KT * DT);   // [BM, D]
  T* gs = xs + BM * D;                          // [BM, D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;
  load_rows(xs, xn, row0, N, D);
  load_rows(gs, g, row0, N, D);

  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);
    float u[RPW][CTF], t[RPW][CTF];
    zero(u);
    zero(t);
    tile_gemm<CTF>(u, xs, D, D, w1 + f0, (long long)F, fc, Bs);   // xn W1
    tile_gemm<CTF>(t, gs, D, D, w2t + f0, (long long)F, fc, Bs);  // g W2^T
#pragma unroll
    for (int c = 0; c < CTF; ++c) {
      const int col = lane + 32 * c;
      const bool live = col < fc;
      const float bb = live ? b1[f0 + col] : 0.0f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int lr = warp * RPW + r;
        const float uu = u[r][c] + bb;
        const float sig = sigmoid_f32(uu);
        const T h = from_f32<T>(uu * sig);
        // rows past N have g = 0, so their dh is 0
        const float dh = live ? t[r][c] * alpha * (sig * (1.0f + uu * (1.0f - sig))) : 0.0f;
        const T dhb = from_f32<T>(dh);
        dhf[lr * FC + col] = dh;
        dhs[lr * FC + col] = to_f32(dhb);
        if (live && row0 + lr < N) {
          const long long at = (long long)(row0 + lr) * F + f0 + col;
          hbuf[at] = h;
          dhbuf[at] = dhb;
        }
      }
    }
    __syncthreads();
    // this block's share of db1: the unrounded dh summed over its rows
    if ((int)threadIdx.x < fc) {
      float s = 0.0f;
      for (int r = 0; r < BM; ++r) s += dhf[r * FC + threadIdx.x];
      db1_part[(long long)blockIdx.x * F + f0 + threadIdx.x] = s;
    }
    for (int d0 = 0; d0 < D; d0 += DT) {  // dx += dhb W1^T
      const int dn = min(DT, D - d0);
      float o[RPW][CTD];
      zero(o);
      tile_gemm<CTD>(o, dhs, FC, fc, w1t + (long long)f0 * D + d0, (long long)D, dn, Bs);
      add_tile(dxs, o, D, d0, dn, f0 == 0);
    }
  }

  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp * RPW + r;
    if (row >= N) continue;
    for (int d = lane; d < D; d += 32)
      dx[(long long)row * D + d] = from_f32<T>(dxs[(warp * RPW + r) * D + d]);
  }
  // this block's share of db2: g summed over its rows
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.0f;
    for (int r = 0; r < BM; ++r) s += to_f32(gs[r * D + d]);
    db2_part[(long long)blockIdx.x * D + d] = s;
  }
}

// The slice of KT2 rows at r0 of A (columns m0..) and B (columns n0..) into
// registers, zeros outside the operands.
template <typename T>
__device__ __forceinline__ void fetch_slice(float (&ra)[PER], float (&rb)[PER],
                                            const T* __restrict__ A, int M,
                                            const T* __restrict__ B, int Nc, int R, int r0,
                                            int m0, int n0) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int kk = i / TM, c = i - kk * TM;
    const long long row = r0 + kk;
    ra[j] = (row < R && m0 + c < M) ? to_f32(A[row * M + m0 + c]) : 0.0f;
    rb[j] = (row < R && n0 + c < Nc) ? to_f32(B[row * Nc + n0 + c]) : 0.0f;
  }
}

// One TM x TN tile of C [M, Nc] = s * A^T B, A [R, M] and B [R, Nc]
// row-major, looping over all R rows in slices of KT2 (the next slice is
// fetched into registers while this one is multiplied).
template <typename T>
__device__ __forceinline__ void atb_tile(const T* __restrict__ A, int M, const T* __restrict__ B,
                                         int Nc, int R, float s, float* __restrict__ C, int m0,
                                         int n0, float* As, float* Bs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float ra[PER], rb[PER];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  fetch_slice(ra, rb, A, M, B, Nc, R, 0, m0, n0);
  for (int r0 = 0; r0 < R; r0 += KT2) {
    __syncthreads();  // the slice before has been read
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      As[threadIdx.x + j * THREADS] = ra[j];
      Bs[threadIdx.x + j * THREADS] = rb[j];
    }
    __syncthreads();
    if (r0 + KT2 < R) fetch_slice(ra, rb, A, M, B, Nc, R, r0 + KT2, m0, n0);
#pragma unroll 8
    for (int kk = 0; kk < KT2; ++kk) {  // rows past R are zeros on both sides
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * TM + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * TN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Nc) C[(long long)m * Nc + n] = s * acc[i][j];
    }
  }
}

// Pass 2: blocks [0, tiles1) own the tiles of dW1 [D, F] = xn^T dhb, the
// rest those of dW2 [F, D] = alpha * h^T g.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_weights_kernel(const T* __restrict__ xn, const T* __restrict__ g,
                       const T* __restrict__ hbuf, const T* __restrict__ dhbuf,
                       float* __restrict__ dw1, float* __restrict__ dw2, int N, int D, int F,
                       float alpha) {
  __shared__ float As[KT2 * TM];
  __shared__ float Bs[KT2 * TN];
  const int td = (D + TM - 1) / TM, tf = (F + TN - 1) / TN;  // TM == TN
  const int tiles1 = td * tf;
  int b = blockIdx.x;
  if (b < tiles1) {
    atb_tile(xn, D, dhbuf, F, N, 1.0f, dw1, (b / tf) * TM, (b % tf) * TN, As, Bs);
  } else {
    b -= tiles1;
    atb_tile(hbuf, F, g, D, N, alpha, dw2, (b / td) * TM, (b % td) * TN, As, Bs);
  }
}

// Pass 3: out[j] = s * sum over blocks, in block order, of part[blk, j]
__global__ void sum_parts_kernel(const float* __restrict__ part, int nblk, int n, float s,
                                 float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < nblk; ++b) acc += part[(long long)b * n + j];
  out[j] = s * acc;
}

long long shared_bytes(int D, int elem, int backward) {
  const long long acc = (long long)BM * D, chunk = (long long)BM * FC, stage = KT * DT;
  return backward ? 4 * (acc + 2 * chunk + stage) + 2LL * elem * acc
                  : 4 * (acc + chunk + stage) + (long long)elem * acc;
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
int forward(const void* xn, const void* res, const void* w1, const float* b1, const void* w2,
            const float* b2, void* out, int N, int D, int F, float alpha, cudaStream_t stream) {
  const long long bytes = shared_bytes(D, sizeof(T), 0);
  const int err = allow_shared(ffn_fwd_kernel<T>, bytes);
  if (err) return err;
  ffn_fwd_kernel<T><<<(N + BM - 1) / BM, THREADS, bytes, stream>>>(
      (const T*)xn, (const T*)res, (const T*)w1, b1, (const T*)w2, b2, (T*)out, N, D, F, alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* xn, const void* g, const void* w1, const float* b1, const void* w1t,
             const void* w2t, void* dx, void* hbuf, void* dhbuf, float* db1_part,
             float* db2_part, float* dw1, float* db1, float* dw2, float* db2, int N, int D, int F,
             float alpha, cudaStream_t stream) {
  const long long bytes = shared_bytes(D, sizeof(T), 1);
  int err = allow_shared(ffn_bwd_rows_kernel<T>, bytes);
  if (err) return err;
  const int nblk = (N + BM - 1) / BM;
  ffn_bwd_rows_kernel<T><<<nblk, THREADS, bytes, stream>>>(
      (const T*)xn, (const T*)g, (const T*)w1, b1, (const T*)w1t, (const T*)w2t, (T*)dx,
      (T*)hbuf, (T*)dhbuf, db1_part, db2_part, N, D, F, alpha);
  if ((err = (int)cudaGetLastError())) return err;
  const int tiles = ((D + TM - 1) / TM) * ((F + TN - 1) / TN);
  ffn_bwd_weights_kernel<T><<<2 * tiles, THREADS, 0, stream>>>(
      (const T*)xn, (const T*)g, (const T*)hbuf, (const T*)dhbuf, dw1, dw2, N, D, F, alpha);
  if ((err = (int)cudaGetLastError())) return err;
  sum_parts_kernel<<<(F + 255) / 256, 256, 0, stream>>>(db1_part, nblk, F, 1.0f, db1);
  if ((err = (int)cudaGetLastError())) return err;
  sum_parts_kernel<<<(D + 255) / 256, 256, 0, stream>>>(db2_part, nblk, D, alpha, db2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Rows of xn that one block of the forward and of the backward's first pass
// owns: the per-block partial sums are [ceil(N / rows), F] and [.., D].
int ffn_rows_per_block() { return BM; }

// Shared memory per block, in bytes, of the forward (backward = 0) or of the
// backward's first pass (1) at width D, for float32 (is_bf16 = 0) or
// bfloat16 (1) operands.
int ffn_shared_bytes(int D, int is_bf16, int backward) {
  const long long bytes = shared_bytes(D, is_bf16 ? 2 : 4, backward);
  return bytes > 0x7fffffffLL ? 0x7fffffff : (int)bytes;
}

// The most shared memory a block may ask for on the current device.
int ffn_shared_limit() { return shared_limit(); }

// K10f: xn, res [N, D], w1 [D, F], w2 [F, D] in the trunk dtype, b1 [F] and
// b2 [D] f32 -> out [N, D] in the trunk dtype.
int ffn_forward(const void* xn, const void* res, const void* w1, const float* b1, const void* w2,
                const float* b2, void* out, int N, int D, int F, float alpha, int is_bf16,
                cudaStream_t stream) {
  if (N == 0 || D == 0) return 0;
  if (F == 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? forward<__nv_bfloat16>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, stream)
                 : forward<float>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, stream);
}

// K10b: xn, g [N, D], w1 [D, F], w1t [F, D], w2t [D, F] in the trunk dtype,
// b1 [F] f32 -> dx [N, D] (trunk dtype), dw1 [D, F], db1 [F], dw2 [F, D],
// db2 [D] (f32); scratch hbuf, dhbuf [N, F] (trunk dtype), db1_part
// [blocks, F] and db2_part [blocks, D] (f32), blocks = ceil(N / rows).
int ffn_backward(const void* xn, const void* g, const void* w1, const float* b1, const void* w1t,
                 const void* w2t, void* dx, void* hbuf, void* dhbuf, float* db1_part,
                 float* db2_part, float* dw1, float* db1, float* dw2, float* db2, int N, int D,
                 int F, float alpha, int is_bf16, cudaStream_t stream) {
  if (N == 0 || D == 0) return 0;
  if (F == 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? backward<__nv_bfloat16>(xn, g, w1, b1, w1t, w2t, dx, hbuf, dhbuf, db1_part,
                                           db2_part, dw1, db1, dw2, db2, N, D, F, alpha, stream)
                 : backward<float>(xn, g, w1, b1, w1t, w2t, dx, hbuf, dhbuf, db1_part, db2_part,
                                   dw1, db1, dw2, db2, N, D, F, alpha, stream);
}

}  // extern "C"
