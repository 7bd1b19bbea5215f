// Farthest point sampling (kernel B5).
//
// Replaces the Pallas kernel `fps_pallas` of if_defense_tpu/ops/pallas_fps.py
// (:82; `_fps_kernel`:25, pallas_call at :107; `_fps_kernel_v2`:50 is an
// index-identical variant), and covers the masked form that the JAX package
// runs on its lax path (if_defense_tpu/ops/pointops.py:252-273).
//
// Semantics (as the JAX package): start at `start[b]` if given, else at the
// first valid point (index 0 without a mask); keep a running min of squared
// distances to the selected set, with invalid points held at -inf; each step
// takes the first maximum, the lowest index among equal distances. d2 is the
// difference form ((dx dx + dy dy) + dz dz) with no fused multiply-add, the
// bits of the plain PyTorch version (`ops/pointops.py`), so the two select
// the same indices. Once every remaining distance is 0 (a cloud padded by
// duplication and sampled to its full size), the first maximum is index 0,
// step after step, as in JAX.
//
// Bound: at PU-Net's first level (B=128, N=npoint=1024) the work is
// ~10 flops x B N npoint = 1.3 GFLOP, about 20 us of f32 on the card, and the
// bytes are 0.5 MB in and 0.5 MB out. The real limit is the chain of npoint
// dependent steps, each a block-wide argmax, which no roofline sees.
//
// Design: one block per cloud (128 blocks on 132 SMs at the path's batch).
// The cloud's coordinates sit in shared memory (12 B x N, as x, y, z rows);
// the running min sits in registers, PER points per thread, so a step reads
// only shared memory. A step's argmax is a warp shuffle over (distance,
// index) pairs, then one shared-memory round that every warp reduces for
// itself; the partials are double-buffered, so a step costs one barrier.
// The TPU kernel's one-hot masked reductions (for the centroid fetch and
// the argmax) are TPU workarounds: here the winner's coordinates are one
// shared-memory read.

#include <stdint.h>

#include <climits>
#include <limits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kInf = std::numeric_limits<float>::infinity();

// (d, i) beats (bd, bi): larger distance, or equal distance and lower index
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od = __shfl_xor_sync(0xffffffffu, d, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Block argmax; every thread gets the winner's index. One barrier: the
// partials of consecutive calls go to alternate buffers.
__device__ __forceinline__ int block_argmax(float d, int i, float (*part_d)[kWarps],
                                            int (*part_i)[kWarps], int buf) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(d, i);
  if (lane == 0) {
    part_d[buf][warp] = d;
    part_i[buf][warp] = i;
  }
  __syncthreads();
  d = lane < kWarps ? part_d[buf][lane] : -kInf;
  i = lane < kWarps ? part_i[buf][lane] : INT_MAX;
  warp_argmax(d, i);
  return i;
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
               const int* __restrict__ start, int N, int npoint,
               int* __restrict__ out) {
  extern __shared__ float s[];
  __shared__ float part_d[2][kWarps];
  __shared__ int part_i[2][kWarps];
  float* sx = s;
  float* sy = s + N;
  float* sz = s + 2 * N;
  const long b = blockIdx.x;
  const float* p = xyz + b * N * 3;
  for (int t = threadIdx.x; t < N; t += kThreads) {
    sx[t] = p[3 * t];
    sy[t] = p[3 * t + 1];
    sz[t] = p[3 * t + 2];
  }
  // running min: +inf for valid points, -inf for invalid ones; the start
  // is the first valid point (key 1 over key 0), or 0 when none is valid
  float dist[PER];
  float kd = -kInf;
  int ki = INT_MAX;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    int n = threadIdx.x + k * kThreads;
    if (n < N) {
      bool v = valid == nullptr || valid[b * N + n] != 0;
      dist[k] = v ? kInf : -kInf;
      float key = v ? 1.f : 0.f;
      if (better(key, n, kd, ki)) {
        kd = key;
        ki = n;
      }
    }
  }
  // this barrier also publishes the coordinates in shared memory
  int far = block_argmax(kd, ki, part_d, part_i, 0);
  if (start != nullptr) far = start[b];
  int buf = 1;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) out[b * npoint + it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float bd = -kInf;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      int n = threadIdx.x + k * kThreads;
      if (n < N) {
        float dx = __fsub_rn(sx[n], cx);
        float dy = __fsub_rn(sy[n], cy);
        float dz = __fsub_rn(sz[n], cz);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        dist[k] = fminf(dist[k], d);
        if (better(dist[k], n, bd, bi)) {
          bd = dist[k];
          bi = n;
        }
      }
    }
    far = block_argmax(bd, bi, part_d, part_i, buf);
    buf ^= 1;
  }
}

template <int PER>
int launch(const float* xyz, const uint8_t* valid, const int* start, int B,
           int N, int npoint, int* out, cudaStream_t s) {
  size_t smem = sizeof(float) * 3 * (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<PER><<<B, kThreads, smem, s>>>(xyz, valid, start, N, npoint, out);
  return ifdef::last_error();
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xyz [B,N,3] f32; valid [B,N] u8 or null; start [B] i32 or null
// -> out [B,npoint] i32. N <= 32 * 512 (registers and shared memory).
int ifdef_fps(const float* xyz, const uint8_t* valid, const int* start, int B,
              int N, int npoint, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per = (N + kThreads - 1) / kThreads;
  if (per <= 1) return launch<1>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 2) return launch<2>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 4) return launch<4>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 8) return launch<8>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 16) return launch<16>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 32) return launch<32>(xyz, valid, start, B, N, npoint, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
