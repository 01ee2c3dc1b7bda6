// The dense Moore denominator's tiles (den_dense.cu: K9f/K9b): the float32
// shared-memory product tile and the deterministic block reductions.  The
// source keeps its own tile loaders and epilogues.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace den_tiles {

constexpr int BM = 64;   // rows (sequences) per tile
constexpr int BN = 64;   // columns per tile
constexpr int BK = 16;   // depth per shared-memory stage
constexpr int TM = 4;    // rows per thread   (ty + 16 * i)
constexpr int TN = 4;    // columns per thread (tx + 16 * j)
constexpr int NTHREADS = 256;
constexpr int ROW_THREADS = 256;
// shared tiles are padded by one column: the A stores (and K2's V store) run
// k fastest across a warp, which on an unpadded 64-float row stride would put
// 16 threads on one bank
constexpr int LDA = BM + 1;
constexpr int LDB = BN + 1;

// acc[i][j] += A[ty + 16 i, :] . B[:, tx + 16 j] over one BK stage
__device__ __forceinline__ void tile_fma(float (*As)[LDA], float (*Bs)[LDB],
                                         int ty, int tx, float acc[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// deterministic block sum (fixed tree); every thread gets the result
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ float block_max(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

}  // namespace den_tiles
