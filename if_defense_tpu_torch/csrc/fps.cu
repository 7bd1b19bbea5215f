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
// dependent steps, each a block-wide argmax, which no roofline sees: the
// design shortens a step's critical path.
//
// Design: one block per cloud (128 blocks on 132 SMs at the path's batch),
// kPer = 8 points a thread, so 32 threads at N <= 256, 64 at 512, 128 at
// 1024 (the next power of two of N / 8, up to 1024 threads at 8192 points).
// A thread keeps its points' coordinates and running minima in registers,
// and a step's distances are an unrolled run of independent work, reduced
// to the thread's best by a tree whose left side always holds the lower
// indices. The cloud also sits in shared memory as float4 (x, y, z, 0), so
// the winner's coordinates are one broadcast 16-byte load. The argmax works
// on an order-preserving integer key, the running minimum's bits as a
// signed int: a distance >= 0 orders as its bits do and an invalid point's
// -inf is negative. A warp's winner is then two REDUX instructions: the
// max of the keys, then the min of the indices among the lanes that hold it
// (first maximum, lowest index). The warps' winners meet in shared memory,
// double-buffered, for one barrier a step, each packed into 64 bits as
// (key with its sign bit flipped, ~index), whose unsigned order is the
// selection's, and every thread takes their max in registers. A one-warp
// block needs no barrier at all. Thread t keeps the index of the steps s
// with s mod threads = t in a register and writes them, coalesced, once
// every `threads` steps.
//
// Any N. Above 8192 points (registers and shared memory), the running
// minima live in a [B, N] f32 scratch buffer in device memory that the
// wrapper allocates, and the coordinates are read from the input as they
// are; at such N both sit in the 50 MB L2. Same selection, same bits.
//
// Measured on the H100 at 700 W (`tools/time_kernels.py`, device time over
// PU-Net's 1920 steps at B = 128): this design about 0.22 us a step. Slower:
// the port's first design (512 threads whatever N, 32 running minima a
// thread with the coordinates in shared memory as three arrays, an argmax
// of ten shuffles and five selects a stage, thread 0 storing each index to
// global memory), 0.50 us; this design with the warps' winners reduced by a
// second REDUX pair instead of the packed max, 0.31 us (a one-warp block,
// 128 steps at N = 256, 0.14 us: the cross-warp stage was most of a step);
// 16 or 32 points a thread (fewer warps), 0.31 and 0.38 us.

#include <stdint.h>

#include <climits>
#include <limits>

#include "common.cuh"

namespace {

constexpr int kPer = 8;                  // points a thread keeps in registers
constexpr int kMaxThreads = 1024;
constexpr int kRegN = kPer * kMaxThreads;  // the register tier's largest N
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = std::numeric_limits<float>::infinity();

// order-preserving key of a running minimum (>= 0, or -inf when invalid)
__device__ __forceinline__ int key_of(float d) { return __float_as_int(d); }

// The warp's winner: the largest key, then the lowest index among the
// lanes that hold it. Every lane gets both.
__device__ __forceinline__ int warp_argmax(int& key, int idx) {
  const int top = __reduce_max_sync(kFull, key);
  idx = (int)__reduce_min_sync(kFull, key == top ? (unsigned)idx : UINT_MAX);
  key = top;
  return idx;
}

// The block's winner; every thread gets its index. The warps' winners go
// to shared memory packed as (key with its sign bit flipped, ~index), whose
// unsigned order is the selection's, and every thread takes their max.
template <int WARPS>
__device__ __forceinline__ int block_argmax(int key, int idx,
                                            unsigned long long (*part)[WARPS],
                                            int buf) {
  idx = warp_argmax(key, idx);
  if (WARPS == 1) return idx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    part[buf][warp] = ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
                      (unsigned)~idx;
  __syncthreads();
  unsigned long long best = part[buf][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) best = max(best, part[buf][w]);
  return (int)~(unsigned)best;
}

// Step `it` selected `far`: thread (it mod THREADS) keeps it, and the
// block writes the kept indices once every THREADS steps and at the end.
template <int THREADS>
__device__ __forceinline__ void record(int it, int far, int npoint,
                                       int& mine, int* out) {
  const int slot = it & (THREADS - 1);
  if (slot == (int)threadIdx.x) mine = far;
  if (slot == THREADS - 1 || it == npoint - 1) {
    const int at = it - slot + threadIdx.x;
    if (at <= it) out[at] = mine;
  }
}

// Register tier: N <= THREADS * kPer. Thread t holds points t + k THREADS.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
               const int* __restrict__ start, int N, int npoint,
               int* __restrict__ out) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float4 cloud[];
  __shared__ unsigned long long part[2][WARPS];
  const long b = blockIdx.x;
  const float* p = xyz + b * N * 3;
  out += b * npoint;
  // a slot past N holds (0, 0, 0) at -inf: it ties with invalid points and
  // loses to them on its index
  float x[kPer], y[kPer], z[kPer], dist[kPer];
  int key = INT_MIN, idx = INT_MAX;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = threadIdx.x + k * THREADS;
    x[k] = y[k] = z[k] = 0.f;
    dist[k] = -kInf;
    if (n < N) {
      x[k] = p[3 * n];
      y[k] = p[3 * n + 1];
      z[k] = p[3 * n + 2];
      cloud[n] = make_float4(x[k], y[k], z[k], 0.f);
      const bool v = valid == nullptr || valid[b * N + n] != 0;
      dist[k] = v ? kInf : -kInf;
      // the start: the first valid point (key 1 over key 0), else 0
      if ((int)v > key) {
        key = v;
        idx = n;
      }
    }
  }
  __syncthreads();  // the cloud is in shared memory
  int far = block_argmax<WARPS>(key, idx, part, 0);
  if (start != nullptr) far = start[b];
  int mine = 0, buf = 1;
  for (int it = 0; it < npoint; ++it) {
    record<THREADS>(it, far, npoint, mine, out);
    const float4 c = cloud[far];
    int kk[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float dx = __fsub_rn(x[k], c.x);
      const float dy = __fsub_rn(y[k], c.y);
      const float dz = __fsub_rn(z[k], c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[k] = fminf(dist[k], d);
      kk[k] = key_of(dist[k]);
    }
    // the thread's best by a tree; slot k holds the lower index of a pair
    int ii[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) ii[k] = threadIdx.x + k * THREADS;
#pragma unroll
    for (int w = 1; w < kPer; w <<= 1)
#pragma unroll
      for (int k = 0; k + w < kPer; k += 2 * w)
        if (kk[k + w] > kk[k]) {
          kk[k] = kk[k + w];
          ii[k] = ii[k + w];
        }
    far = block_argmax<WARPS>(kk[0], ii[0], part, buf);
    buf ^= 1;
  }
}

// Device-memory tier: any N. The running minima sit in dist [B, N], the
// coordinates are read from the input; thread t takes n = t, t + THREADS,
// ... in increasing order.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    fps_kernel_global(const float* __restrict__ xyz,
                      const uint8_t* __restrict__ valid,
                      const int* __restrict__ start, int N, int npoint,
                      int* __restrict__ out, float* __restrict__ dist) {
  constexpr int WARPS = THREADS / 32;
  __shared__ unsigned long long part[2][WARPS];
  const long b = blockIdx.x;
  const float* p = xyz + b * N * 3;
  out += b * npoint;
  dist += b * N;
  int key = INT_MIN, idx = INT_MAX;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const bool v = valid == nullptr || valid[b * N + n] != 0;
    dist[n] = v ? kInf : -kInf;
    if ((int)v > key) {
      key = v;
      idx = n;
    }
  }
  int far = block_argmax<WARPS>(key, idx, part, 0);
  if (start != nullptr) far = start[b];
  int mine = 0, buf = 1;
  for (int it = 0; it < npoint; ++it) {
    record<THREADS>(it, far, npoint, mine, out);
    const float cx = p[3 * far], cy = p[3 * far + 1], cz = p[3 * far + 2];
    key = INT_MIN;
    idx = INT_MAX;
#pragma unroll 4
    for (int n = threadIdx.x; n < N; n += THREADS) {
      const float dx = __fsub_rn(p[3 * n], cx);
      const float dy = __fsub_rn(p[3 * n + 1], cy);
      const float dz = __fsub_rn(p[3 * n + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[n], d);
      dist[n] = m;
      if (key_of(m) > key) {
        key = key_of(m);
        idx = n;
      }
    }
    far = block_argmax<WARPS>(key, idx, part, buf);
    buf ^= 1;
  }
}

template <int THREADS>
int launch(const float* xyz, const uint8_t* valid, const int* start, int B,
           int N, int npoint, int* out, cudaStream_t s) {
  size_t smem = sizeof(float4) * (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<THREADS><<<B, THREADS, smem, s>>>(xyz, valid, start, N, npoint,
                                               out);
  return ifdef::last_error();
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest N of the register tier; above it `ifdef_fps` needs `dist`.
int ifdef_fps_register_n() { return kRegN; }

// xyz [B,N,3] f32; valid [B,N] u8 or null; start [B] i32 or null;
// dist [B,N] f32 scratch, read only when N > kRegN -> out [B,npoint] i32.
int ifdef_fps(const float* xyz, const uint8_t* valid, const int* start, int B,
              int N, int npoint, int* out, float* dist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > kRegN) {
    if (dist == nullptr) return (int)cudaErrorInvalidValue;
    fps_kernel_global<kMaxThreads><<<B, kMaxThreads, 0, s>>>(
        xyz, valid, start, N, npoint, out, dist);
    return ifdef::last_error();
  }
  const int per = (N + kPer - 1) / kPer;  // threads needed
  if (per <= 32) return launch<32>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 64) return launch<64>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 128) return launch<128>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 256) return launch<256>(xyz, valid, start, B, N, npoint, out, s);
  if (per <= 512) return launch<512>(xyz, valid, start, B, N, npoint, out, s);
  return launch<1024>(xyz, valid, start, B, N, npoint, out, s);
}

}  // extern "C"
