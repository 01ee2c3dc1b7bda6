// Probe of the shared memory one thread block can really use: kernel T1,
// CUDA C++ for sm_90a.
//
// Replaces the Pallas probe of tools/probe_vmem.py (try_size, pallas_call
// :27), which pins an N-MiB scratch buffer in the TPU's on-chip memory,
// writes 2x to its first row and 3x to its last and returns their sum.  On
// Hopper the on-chip memory a kernel can pin is a block's dynamic shared
// memory, which above 48 KB must be opted in to with cudaFuncSetAttribute;
// the probe asks for N KiB, writes 2x to its first 128 words and 3x to its
// last 128, and returns their sum, 5x.  A size the device refuses fails at
// the attribute call or at the launch, and the error code comes back.
//
// What bounds it: nothing to speak of (1 KB in and out, one block); it is a
// probe of a limit, not a computation.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ out, int words) {
  extern __shared__ float scratch[];
  const int tid = threadIdx.x;
  scratch[tid] = x[tid] * 2.0f;
  scratch[words - LANES + tid] = x[tid] * 3.0f;
  __syncthreads();
  out[tid] = scratch[tid] + scratch[words - LANES + tid];
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The device's opt-in limit of dynamic shared memory per block, in bytes.
int probe_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return limit;
}

// T1: one block of 128 threads with `kib` KiB (>= 1) of dynamic shared
// memory; x and out hold 128 floats.  Returns the CUDA error of the opt-in
// or of the launch (cleared, so that the next size starts clean).
int probe_smem(const float* x, float* out, int kib, cudaStream_t stream) {
  const int bytes = kib * 1024;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  probe_kernel<<<1, LANES, bytes, stream>>>(x, out, bytes / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
