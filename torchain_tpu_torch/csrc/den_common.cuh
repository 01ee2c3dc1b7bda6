// What the sparse denominator kernels share (den_resident.cu: K1/K2,
// den_dense.cu: K9f/K9b): the block size, cp.async row copies, the
// fixed-order block reductions and the opt-in shared-memory allowance.  The
// numerator kernels (num_resident.cu: K4, num_e2e.cu: K8) take the
// cp.async, sizing and allowance helpers from here too.
//
// Every block sum has one order: a thread's share in index order (thread i
// takes i, i + THREADS, ...), then a butterfly over the lanes of each warp
// and the same butterfly over the warps' sums, so that every lane ends with
// the same bits and two launches on the same inputs give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// threads of a block: every kernel of both sources launches this many
// (ops/den_resident.py mirrors it in its emulation of the block sums)
constexpr int THREADS = 1024;
constexpr int MAX_WARPS = THREADS / 32;

__host__ __device__ inline long long up16(long long bytes) { return (bytes + 15) & ~15LL; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Queue the copy of n floats into shared memory: 16-byte pieces where
// gran == 16 (n a multiple of 4, both rows 16-byte aligned), else 4-byte.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int gran) {
  if (gran == 16) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + i)),
                   "l"(src + i));
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + i)),
                   "l"(src + i));
  }
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void wait_async_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queue one copy into shared memory: 4 bytes (any 4-byte aligned source),
// or 16 (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// the larger of a and b, NaN if either is (as torch.max)
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

// Butterflies over the 32 lanes: lane i adds lane i^off for off = 16 .. 1,
// so every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block sum with one barrier: each warp's butterfly, its lane 0 writes the
// warp's sum to red[warp], then every warp runs the butterfly over red
// (zeros past the last warp).  Every thread gets the same bits.  `red` must
// not be written again before every thread has returned from this call.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nw ? red[lane] : 0.0f);
}

// The same for a sum and a maximum at once (red holds 2 * MAX_WARPS).
__device__ __forceinline__ void block_sum_max(float& sum, float& mx, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  sum = warp_sum(sum);
  mx = warp_max(mx);
  if (lane == 0) {
    red[warp] = sum;
    red[MAX_WARPS + warp] = mx;
  }
  __syncthreads();
  sum = warp_sum(lane < nw ? red[lane] : 0.0f);
  mx = warp_max(lane < nw ? red[MAX_WARPS + lane] : -INFINITY);
}

template <typename T>
__device__ __forceinline__ void copy_plain(T* dst, const T* src, long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// int32 indices below 2^16 as 16 bits (0xFFFF for -1)
__device__ __forceinline__ void copy_u16(unsigned short* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (unsigned short)src[i];
}

int shared_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return limit;
}

// Raise `kernel`'s dynamic shared-memory allowance to the device's limit
// once; `granted` (one per kernel) remembers it, so that later launches make
// no runtime call.
template <typename Kern>
int allow_shared(Kern kernel, long long bytes, int& granted) {
  if (bytes <= granted) return 0;
  const int limit = shared_limit();
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (!err) granted = limit;
  return err;
}

// 16 where rows of n floats from `ptr` are all 16-byte aligned, else 4
int granule(const void* ptr, long long n) {
  return (n % 4 == 0 && (uintptr_t)ptr % 16 == 0) ? 16 : 4;
}

}  // namespace
