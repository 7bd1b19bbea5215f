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
// qz xz and |v|^2 = (vx vx + vy vy) + vz vz, each product and sum rounded
// on its own: the bits of the plain PyTorch version (`ops/pointops.py`), so
// a point on the radius falls on the same side in both. The one fused
// multiply-add, |q|^2 - 2 q.x as fma(-2, q.x, |q|^2), rounds once where the
// plain version rounds 2 q.x and then the difference; 2 q.x is exact in
// f32, so the two agree bit for bit unless 2 q.x overflows, which needs
// |q|^2 + |x|^2 past FLT_MAX (coordinates of ~1e19).
//
// Bound: at PU-Net's levels (B=128) a centre rarely reaches its 32nd hit
// before the end of the cloud, so the work is the whole product: 9 flops x
// B S N = 2.0 GFLOP over the four levels, 0.030 ms at the card's FMA rate.
// The distance chain above is 8 separately rounded f32 instructions a pair
// (3 FMUL, 3 FADD, one FFMA, the compare), and a bit of the hit mask costs
// one or two more, so a bit-exact scan issues about twice the flops the
// bound counts: a share near 0.5 is its ceiling.
//
// Design: one centre per thread. A block of 8 warps stages the cloud in
// shared memory as float4 (x, y, z, |x|^2 or +inf), 4096 points at a time,
// padded to a multiple of 32 with points that never hit. A thread walks the
// staged points 32 at a time (a step), with one broadcast 16-byte load a
// point that serves the whole warp, and runs the distance chain for its own
// centre into a 32-bit hit mask, branch-free. After the step the thread
// puts the mask's points in its next slots, so slots fill in index order
// with no vote in the inner loop. Before each step the warp votes
// (`__all_sync`) whether all its centres have their nsample hits and stops
// if so: the early exit of clouds dense enough to fill the slots. A centre
// keeps its first slots in shared memory (up to 36 KB a block; slots past
// them go straight to the output), so that its row is written once,
// coalesced, when its group is done: 32 consecutive slots a store, the
// empty ones with the first hit.
//
// Where the centres are too few to keep the card busy (B S / 32 under 2048
// warps), P = 2, 4 or 8 warps take the same 32 centres (up to 4096 warps)
// and the steps in turn: in a round, warp p of the group scans step t0 + p.
// The warps post their steps' hit counts in shared memory and meet at a
// barrier of the group; each then puts its hits behind those of the steps
// before its own (a prefix over the posted counts), and all of them add
// the round's total, so they agree on every centre's count and leave
// together once the slots are full. Same slots, same early exit, P times
// the warps; the result does not depend on P.
//
// The TPU kernel's [TS, N] rank from a triangular matmul and its nsample
// compare-and-sum passes are matrix-unit workarounds with no use here. Any
// N and any B: clouds above 4096 points are staged chunk after chunk, and
// each block takes one (cloud, tile) of a 1-D grid.
//
// Measured on the H100 at 700 W (`tools/time_kernels.py`, device time):
// 0.133 ms summed over PU-Net's four levels at B = 128 against 0.347 for
// the warp-per-centre design it replaced (a warp per centre, a ballot and
// a popc a 32-point step), and 1.5-1.7x faster at the victims' shapes
// (B = 32), where centres fill their slots. Slower: two or four centres a thread (one load serving two or
// four chains, but half or a quarter of the warps), and every hit stored
// straight to the output (scattered 4-byte stores; 1.2-1.7x slower at the
// victims' shapes).

#include <stdint.h>

#include <climits>
#include <limits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 4096;        // points staged in shared memory at a time
constexpr int kStep = 32;           // points between a warp's exit votes
constexpr int kMaxSplits = 8;
constexpr int kOutBytes = 36 * 1024;  // shared memory for the block's slots
constexpr long kFewWarps = 2048;    // below, more warps a group of centres
constexpr long kTargetWarps = 4096;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = std::numeric_limits<float>::infinity();

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d2 of the centre q = (x, y, z, |q|^2) and a staged point v
__device__ __forceinline__ float dist2(float4 q, float4 v) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(q.x, v.x), __fmul_rn(q.y, v.y)), __fmul_rn(q.z, v.z));
  return __fadd_rn(__fmaf_rn(-2.f, cross, q.w), v.w);
}

// Slots a centre keeps in shared memory, for a block of 256 / P centres.
__host__ __device__ __forceinline__ int slots_kept(int P, int nsample) {
  return min(nsample, kOutBytes / (4 * (kThreads / P)) - 1);
}

// P warps take each group of 32 centres (lane l of each: the same centre)
// and the 32-point steps of a staged chunk in turn; a block holds kWarps / P
// groups.
template <int P>
__global__ void __launch_bounds__(kThreads, 4)
    ballquery_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ new_xyz,
                     const uint8_t* __restrict__ valid, int N, int S,
                     int nsample, float r2, int tiles,
                     int* __restrict__ out) {
  extern __shared__ float4 pts[];  // the staged chunk, then the slots
  __shared__ int posted[2][kWarps][32];  // a round's hit counts, 2 buffers
  const int staged = min((N + kStep - 1) / kStep * kStep, kChunk);
  const int kept = slots_kept(P, nsample);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = warp % P, group = warp / P, cl = group * 32 + lane;
  // slot j < kept of centre c of the block: slots[c * (kept + 1) + j]
  int* slots = reinterpret_cast<int*>(pts + staged);
  int parity = 0;
  const long blk = blockIdx.x;  // one (cloud, tile) a block
  const long b = blk / tiles;
  const int s0 = (int)(blk % tiles) * (kThreads / P), si = s0 + cl;
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (si < S) {
    const float* c = new_xyz + (b * S + si) * 3;
    q = make_float4(c[0], c[1], c[2], 0.f);
  }
  q.w = sq3(q.x, q.y, q.z);
  int cnt = si < S ? 0 : nsample;  // not a centre: nothing to find
  int* mine = slots + cl * (kept + 1);
  int* row = out + (b * S + si) * nsample;  // written only for si < S
  const float* p = xyz + b * N * 3;
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int len = min(kChunk, N - c0);
    const int steps = (len + kStep - 1) / kStep;
    for (int t = threadIdx.x; t < steps * kStep; t += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, kInf);
      if (t < len) {
        const long n = c0 + t;
        v.x = p[3 * n];
        v.y = p[3 * n + 1];
        v.z = p[3 * n + 2];
        if (valid == nullptr || valid[b * N + n] != 0) v.w = sq3(v.x, v.y, v.z);
      }
      pts[t] = v;
    }
    __syncthreads();
    // a round: step t0 + part for each warp of the group; cnt is the
    // same in all of them, so they leave together
    for (int t0 = 0; t0 < steps; t0 += P) {
      if (__all_sync(kFull, cnt >= nsample)) break;
      const int t = t0 + part;
      unsigned mask = 0u;  // bit j: point j of the step is in radius
      if (t < steps) {
        const float4* v = pts + t * kStep;
#pragma unroll
        for (int j = 0; j < kStep; ++j)
          mask |= (dist2(q, v[j]) <= r2 ? 1u : 0u) << j;
      }
      int at = cnt;  // this step's first slot
      if constexpr (P == 1) {
        cnt += __popc(mask);
      } else {
        posted[parity][warp][lane] = __popc(mask);
        asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * P));
#pragma unroll
        for (int w = 0; w < P; ++w) {
          const int k = posted[parity][group * P + w][lane];
          if (w < part) at += k;
          cnt += k;
        }
        parity ^= 1;
      }
      const int base = c0 + t * kStep;
      for (unsigned m = mask; m && at < nsample; m &= m - 1, ++at) {
        const int n = base + __ffs(m) - 1;
        if (at < kept) mine[at] = n; else row[at] = n;
      }
    }
    if (c0 + kChunk >= N) break;
    // every warp is done with this chunk before the next is staged
    if (__syncthreads_and(cnt >= nsample)) break;
  }
  // the group writes its 32 centres' rows, a row a warp at a time: kept
  // slots from shared memory, the empty ones with the first hit (slot 0)
  // or 0
  if constexpr (P == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * P));
  }
  for (int c = part; c < 32; c += P) {
    const int n = __shfl_sync(kFull, cnt, c);
    const int sc = s0 + group * 32 + c;
    if (sc >= S) break;
    const int* kc = slots + (group * 32 + c) * (kept + 1);
    const int fill = n > 0 ? kc[0] : 0;
    int* oc = out + (b * S + sc) * nsample;
    for (int j = lane; j < nsample; j += 32) {
      if (j < n && j < kept) oc[j] = kc[j];
      else if (j >= n) oc[j] = fill;
    }
  }
}

int auto_splits(long B, int N, int S) {
  const long warps = B * ((S + 31) / 32);
  const int steps = (min(N, kChunk) + kStep - 1) / kStep;
  int P = 1;
  while (warps < kFewWarps && P < kMaxSplits && warps * P < kTargetWarps &&
         2 * P <= steps)
    P *= 2;
  return P;
}

template <int P>
int launch(const float* xyz, const float* new_xyz, const uint8_t* valid, int B,
           int N, int S, int nsample, float r2, int* out, cudaStream_t s) {
  const size_t smem =
      sizeof(float4) * (size_t)min((N + kStep - 1) / kStep * kStep, kChunk) +
      sizeof(int) * (size_t)(kThreads / P) * (slots_kept(P, nsample) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ballquery_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (S + kThreads / P - 1) / (kThreads / P);
  // one block a (cloud, tile): B S centres past 2^31 - 1 tiles would need
  // over 800 GB of centres, more than a card holds
  const long blocks = (long)B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ballquery_kernel<P><<<(unsigned)blocks, kThreads, smem, s>>>(
      xyz, new_xyz, valid, N, S, nsample, r2, tiles, out);
  return ifdef::last_error();
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xyz [B,N,3] f32, new_xyz [B,S,3] f32, valid [B,N] u8 or null
// -> out [B,S,nsample] i32
int ifdef_ballquery(const float* xyz, const float* new_xyz,
                    const uint8_t* valid, int B, int N, int S, int nsample,
                    float r2, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (auto_splits(B, N, S)) {
    case 1:
      return launch<1>(xyz, new_xyz, valid, B, N, S, nsample, r2, out, s);
    case 2:
      return launch<2>(xyz, new_xyz, valid, B, N, S, nsample, r2, out, s);
    case 4:
      return launch<4>(xyz, new_xyz, valid, B, N, S, nsample, r2, out, s);
    case 8:
      return launch<8>(xyz, new_xyz, valid, B, N, S, nsample, r2, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
