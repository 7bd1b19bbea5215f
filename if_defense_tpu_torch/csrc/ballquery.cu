// Ball query (kernel B6).
//
// Replaces the Pallas kernel `ballquery_pallas` of
// if_defense_tpu/ops/pallas_ballquery.py (:71; `_ballquery_kernel`:28,
// pallas_call at :95), and covers the masked form that the JAX package runs
// on its XLA path (if_defense_tpu/ops/pointops.py:323-343).
//
// Semantics (as the JAX package): slot j of a centre holds the (j+1)-th
// point in index order with d2 <= r2; slots past the hit count repeat the
// first hit; a centre with no hit gets 0. Invalid points (mask) are out of
// radius: their |x|^2 is stored as +inf, so their d2 is +inf. d2 is the
// full-f32 expansion (|q|^2 - 2 q.x) + |x|^2 with q.x = (qx xx + qy xy) +
// qz xz and |v|^2 = (vx vx + vy vy) + vz vz, with no fused multiply-add:
// the bits of the plain PyTorch version (`ops/pointops.py`), so a point on
// the radius falls on the same side in both.
//
// Bound: at PU-Net's first level (B=128, S=N=1024, nsample=32) a full scan
// is ~9 flops x B S N = 1.2 GFLOP (about 18 us of f32 on the card) and the
// indices written are 17 MB (about 5 us at 3.35 TB/s): operations, on paper.
// A centre's scan ends at its nsample-th hit, so the data decide how much
// of that work is done.
//
// Design: one warp per centre, a block holds a tile of 32 centres (8 warps,
// 4 centres each) and stages the cloud in shared memory (x, y, z rows and
// |x|^2: 16 B x N). Lanes walk N in chunks of 32 points; `__ballot_sync`
// gives the chunk's hits, and a hit's slot is the count so far plus the
// `__popc` of the hits on lower lanes, so slots fill in index order with no
// sort. The warp stops once nsample slots are full, then fills the rest.
// The TPU kernel's [TS, N] rank from a triangular matmul and its nsample
// compare-and-sum passes are matrix-unit workarounds with no use here.
//
// Any N. Above kStagedN points (16 B a point would pass the 227 KB a block
// can hold), ballquery_kernel_global reads the points straight from device
// memory, where the block's 32 centres share them through L1 and L2, and
// computes |x|^2 and the mask test as it goes: the same scan in the same
// order, the same bits. It is a kernel of its own: one templated kernel for
// both tiers ran the staged scan 3-4 % slower on the H100 at 700 W
// (`tools/time_kernels.py`).

#include <stdint.h>

#include <limits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kCentres = 32;  // centres per block
constexpr int kStagedN = 12288;  // largest cloud staged in shared memory
constexpr float kInf = std::numeric_limits<float>::infinity();

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kWarps * 32)
    ballquery_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ new_xyz,
                     const uint8_t* __restrict__ valid, int N, int S,
                     int nsample, float r2, int* __restrict__ out) {
  extern __shared__ float s[];
  float* sx = s;
  float* sy = s + N;
  float* sz = s + 2 * N;
  float* sw = s + 3 * N;  // |x|^2, +inf for invalid points
  const long b = blockIdx.y;
  const float* p = xyz + b * N * 3;
  for (int t = threadIdx.x; t < N; t += kWarps * 32) {
    float x = p[3 * t], y = p[3 * t + 1], z = p[3 * t + 2];
    sx[t] = x;
    sy[t] = y;
    sz[t] = z;
    bool v = valid == nullptr || valid[b * N + t] != 0;
    sw[t] = v ? sq3(x, y, z) : kInf;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int c = warp; c < kCentres; c += kWarps) {
    const int si = blockIdx.x * kCentres + c;
    if (si >= S) break;
    const float* q = new_xyz + (b * S + si) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    const float q2 = sq3(qx, qy, qz);
    int* o = out + (b * S + si) * nsample;
    int count = 0, first = 0;
    for (int base = 0; base < N && count < nsample; base += 32) {
      const int n = base + lane;
      bool hit = false;
      if (n < N) {
        float cross = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, sx[n]), __fmul_rn(qy, sy[n])),
            __fmul_rn(qz, sz[n]));
        float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), sw[n]);
        hit = d2 <= r2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) {
        if (count == 0) first = base + __ffs(m) - 1;
        const int slot = count + __popc(m & below);
        if (hit && slot < nsample) o[slot] = n;
        count += __popc(m);
      }
    }
    const int fill = count > 0 ? first : 0;
    for (int j = min(count, nsample) + lane; j < nsample; j += 32) o[j] = fill;
  }
}

// ballquery_kernel above kStagedN points: point n read from device memory
__global__ void __launch_bounds__(kWarps * 32)
    ballquery_kernel_global(const float* __restrict__ xyz,
                            const float* __restrict__ new_xyz,
                            const uint8_t* __restrict__ valid, int N, int S,
                            int nsample, float r2, int* __restrict__ out) {
  const long b = blockIdx.y;
  const float* p = xyz + b * N * 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int c = warp; c < kCentres; c += kWarps) {
    const int si = blockIdx.x * kCentres + c;
    if (si >= S) break;
    const float* q = new_xyz + (b * S + si) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    const float q2 = sq3(qx, qy, qz);
    int* o = out + (b * S + si) * nsample;
    int count = 0, first = 0;
    for (int base = 0; base < N && count < nsample; base += 32) {
      const int n = base + lane;
      bool hit = false;
      if (n < N) {
        const float x = p[3 * n], y = p[3 * n + 1], z = p[3 * n + 2];
        const bool v = valid == nullptr || valid[b * N + n] != 0;
        float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)),
                                __fmul_rn(qz, z));
        float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)),
                             v ? sq3(x, y, z) : kInf);
        hit = d2 <= r2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) {
        if (count == 0) first = base + __ffs(m) - 1;
        const int slot = count + __popc(m & below);
        if (hit && slot < nsample) o[slot] = n;
        count += __popc(m);
      }
    }
    const int fill = count > 0 ? first : 0;
    for (int j = min(count, nsample) + lane; j < nsample; j += 32) o[j] = fill;
  }
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xyz [B,N,3] f32, new_xyz [B,S,3] f32, valid [B,N] u8 or null
// -> out [B,S,nsample] i32. 16 N bytes of shared memory per block up to
// kStagedN points, none above.
int ifdef_ballquery(const float* xyz, const float* new_xyz,
                    const uint8_t* valid, int B, int N, int S, int nsample,
                    float r2, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > kStagedN) {
    dim3 grid((unsigned)((S + kCentres - 1) / kCentres), (unsigned)B);
    ballquery_kernel_global<<<grid, kWarps * 32, 0, s>>>(
        xyz, new_xyz, valid, N, S, nsample, r2, out);
    return ifdef::last_error();
  }
  size_t smem = sizeof(float) * 4 * (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ballquery_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((S + kCentres - 1) / kCentres), (unsigned)B);
  ballquery_kernel<<<grid, kWarps * 32, smem, s>>>(xyz, new_xyz, valid, N, S,
                                                   nsample, r2, out);
  return ifdef::last_error();
}

}  // extern "C"
