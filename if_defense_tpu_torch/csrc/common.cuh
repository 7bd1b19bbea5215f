// Shared helpers for the port's CUDA kernels: element loads in f32 from
// f32 or bf16 storage, stores back, and warp sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ifdef {

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_f(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Launch-time error of the last launch (a refused launch never runs and
// synchronising does not report it).
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace ifdef
