// Each cloud's rows grouped by target: a CSR built on the card by a
// counting sort.
//
// Given idx [B, M] (int32 or int64, each in [0, K)), for every cloud b
//   offsets[b, k] .. offsets[b, k + 1]   the positions of target k's rows,
//   rows[b, offsets[b, k] + r]            its r-th row m, in increasing m.
// offsets [B, K + 1] starts at 0 and ends at M; a target no row names has
// an empty range. This is the order a stable sort of each cloud's indices
// gives (`torch.sort(stable=True)`, or numpy's stable argsort).
//
// Replaces no TPU kernel. The port's kernels that add or compare each
// target's rows in row order read it: the gather's backward
// (`csrc/gather.cu`) and the encoder's scatter-mean and pooled max
// (`csrc/scatter.cu`). It takes the place of torch's radix sort, the casts
// and the fills that their wrappers launched before each kernel.
//
// Design: one block of 1024 threads a cloud, three passes over its rows.
// Up to kWarpTargets (1,024: the victims' gathers, whose clouds have up
// to 20,480 rows) each warp takes a contiguous segment of the rows and
// keeps counts of its own, [32 warps, K] in shared memory (128 KB):
//  1. Each warp counts its segment's targets, 32 rows a step: the rows of
//     a step grouped by target (`__match_any_sync`), one lane a group
//     adds the group's size.
//  2. One thread a target turns the warps' counts into an exclusive
//     prefix over the warps in order, and a block-wide exclusive scan of
//     the targets' totals gives each target's first position: each
//     warp's cursor for each target.
//  3. Each warp walks its segment again in order; a row lands at its
//     group's cursor plus its rank among the group's lanes below it, and
//     the group's first lane moves the cursor on. Rows of one target keep
//     their order within a step, across a warp's steps and, through the
//     prefix, across the warps: all warps place at once, with no barrier
//     between their steps.
// Above it the warps cannot keep counts of their own, and the block
// takes its rows 1024 at a time:
//  1. A histogram of the targets. Each warp groups its 32 rows by target
//     (`__match_any_sync`) and one lane a group adds the group's size; the
//     counts are integers, so the order of the adds does not matter.
//  2. An exclusive scan of the counts in place: each warp sums a
//     contiguous segment of the table, one warp scans the 32 sums, and
//     each warp scans its segment 32 entries at a time with shuffles. The
//     table then holds each target's first position, its cursor.
//  3. A stable placement, 1024 rows a chunk, chunks in order. Each row
//     takes its rank among the rows of its warp with the same target (the
//     lanes below it in its `__match_any_sync` group), and the group's
//     first lane its group's size. Warp 0 then walks the block's 32 warps
//     in order and, for each group, takes the cursor and moves it on by
//     the group's size (a warp's groups have targets of their own, so its
//     32 lanes do so at once). Each row lands at its group's cursor plus
//     its rank: rows of one target keep their order within a warp, across
//     the warps of a chunk and across chunks.
// The cursors end at each target's last position plus one, which are the
// offsets past 0.
//
// Tiers: up to kWarpTargets the warps' own counts; up to kSharedTargets
// (32,768: the 64^2 planes, the grid's 32^3 cells) the block's table in
// shared memory (128 KB of the 227 KB a block may have); above that the
// table in device memory, a [B, K] scratch the caller provides, with the
// same passes, so any K runs.
//
// An index outside [0, K) is a fault of the caller, as in `gather`'s
// device assert: it stops the kernel (`__trap()`) with no host sync, and
// the CUDA error it leaves raises at the next sync.
//
// Bound: bytes. The indices are read twice (the histogram, the placement)
// and the rows and offsets written once: about 4 B M (int32) + 4 B (K + 1)
// bytes of traffic, and the table's passes in shared memory.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpTargets = 1024;
constexpr int kAhead = 8;       // steps of keys a warp loads at once
constexpr int kSharedTargets = 32768;
constexpr unsigned kFull = 0xffffffffu;

// The target of row m of a cloud, checked against [0, K).
template <typename I>
__device__ __forceinline__ int target_of(const I* row, long m, int K) {
  const I v = row[m];
  if (v < 0 || v >= K) __trap();
  return static_cast<int>(v);
}

template <typename I, bool kShared>
__global__ void __launch_bounds__(kThreads)
    csr_build_kernel(const I* __restrict__ idx, int M, int K,
                     int* __restrict__ offsets, int* __restrict__ rows,
                     int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* table = kShared ? smem : scratch + static_cast<long>(b) * K;
  int* aux = smem + (kShared ? K : 0);
  int* lead_key = aux;                   // [kThreads]
  int* lead_cnt = aux + kThreads;        // [kThreads]
  int* lead_base = aux + 2 * kThreads;   // [kThreads]
  int* wsum = aux + 3 * kThreads;        // [kWarps]
  const I* row = idx + static_cast<long>(b) * M;
  int* out_rows = rows + static_cast<long>(b) * M;
  int* out_offs = offsets + static_cast<long>(b) * (K + 1);
  const unsigned below = (1u << lane) - 1u;

  for (int k = tid; k < K; k += kThreads) table[k] = 0;
  __syncthreads();

  // 1. histogram, one add a group of equal targets in a warp
  for (int base = 0; base < M; base += kThreads) {
    const int m = base + tid;
    const bool valid = m < M;
    const int key = valid ? target_of(row, m, K) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    if (valid && (peers & below) == 0) atomicAdd(&table[key], __popc(peers));
  }
  __syncthreads();

  // 2. exclusive scan in place: warp segments, then warps in order
  const int seg = (K + kWarps - 1) / kWarps;
  const int lo = min(warp * seg, K), hi = min(lo + seg, K);
  int s = 0;
  for (int k = lo + lane; k < hi; k += 32) s += table[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int v = wsum[lane];
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    wsum[lane] = incl - v;
  }
  __syncthreads();
  int carry = wsum[warp];
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int k = k0 + lane;
    const int v = k < hi ? table[k] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    if (k < hi) table[k] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();

  // 3. stable placement, warps taken in order within each chunk
  for (int base = 0; base < M; base += kThreads) {
    const int m = base + tid;
    const bool valid = m < M;
    const int key = valid ? static_cast<int>(row[m]) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int rank = __popc(peers & below);
    lead_key[tid] = valid && rank == 0 ? key : -1;
    lead_cnt[tid] = __popc(peers);
    __syncthreads();
    if (warp == 0) {
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) {
        const int at_lane = w * 32 + lane;
        const int key_w = lead_key[at_lane];
        if (key_w >= 0) {
          const int at = table[key_w];
          table[key_w] = at + lead_cnt[at_lane];
          lead_base[at_lane] = at;
        }
        if (!kShared) __threadfence_block();
        __syncwarp();
      }
    }
    __syncthreads();
    if (valid)
      out_rows[lead_base[warp * 32 + __ffs(peers) - 1] + rank] = m;
  }
  __syncthreads();

  // each cursor now sits at its target's end: the offsets past 0
  for (int k = tid; k < K; k += kThreads) out_offs[k + 1] = table[k];
  if (tid == 0) out_offs[0] = 0;
}

// The first tier: each warp a contiguous segment and counts of its own
// (K <= kWarpTargets <= kThreads, so one thread a target in step 2).
template <typename I>
__global__ void __launch_bounds__(kThreads)
    csr_warp_kernel(const I* __restrict__ idx, int M, int K,
                    int* __restrict__ offsets, int* __restrict__ rows) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* wtab = smem;                      // [kWarps, K]: counts, cursors
  int* wsum = smem + kWarps * K;         // [kWarps]
  const I* row = idx + static_cast<long>(b) * M;
  int* out_rows = rows + static_cast<long>(b) * M;
  int* out_offs = offsets + static_cast<long>(b) * (K + 1);
  const unsigned below = (1u << lane) - 1u;
  const int seg = (M + kWarps - 1) / kWarps;
  const int lo = min(warp * seg, M), hi = min(lo + seg, M);
  int* mine = wtab + warp * K;

  for (int i = tid; i < kWarps * K; i += kThreads) wtab[i] = 0;
  __syncthreads();

  // 1. each warp counts its segment, a step of 32 rows at a time, the
  // keys of kAhead steps loaded before their counts
  for (int base = lo; base < hi; base += 32 * kAhead) {
    int keys[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int m = base + 32 * u + lane;
      keys[u] = m < hi ? target_of(row, m, K) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const unsigned peers = __match_any_sync(kFull, keys[u]);
      if (keys[u] >= 0 && (peers & below) == 0)
        mine[keys[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // 2. per target, the warps' counts as an exclusive prefix in warp
  // order; the targets' totals scanned into their first positions
  int total = 0;
  if (tid < K) {
    for (int w = 0; w < kWarps; ++w) {
      const int c = wtab[w * K + tid];
      wtab[w * K + tid] = total;
      total += c;
    }
  }
  int incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = wsum[lane];
    int run = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, run, off);
      if (lane >= off) run += u;
    }
    wsum[lane] = run - v;
  }
  __syncthreads();
  if (tid < K) {
    const int start = wsum[warp] + incl - total;
    for (int w = 0; w < kWarps; ++w) wtab[w * K + tid] += start;
    out_offs[tid + 1] = start + total;
  }
  if (tid == 0) out_offs[0] = 0;
  __syncthreads();

  // 3. each warp places its segment in order at its own cursors
  for (int base = lo; base < hi; base += 32 * kAhead) {
    int keys[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int m = base + 32 * u + lane;
      keys[u] = m < hi ? static_cast<int>(row[m]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int key = keys[u];
      const unsigned peers = __match_any_sync(kFull, key);
      const int rank = __popc(peers & below);
      int at = 0;
      if (key >= 0 && rank == 0) {
        at = mine[key];
        mine[key] = at + __popc(peers);
      }
      at = __shfl_sync(kFull, at, __ffs(peers) - 1);
      if (key >= 0) out_rows[at + rank] = base + 32 * u + lane;
      __syncwarp();
    }
  }
}

// Above 48 KB a kernel's dynamic shared memory must be allowed explicitly.
template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename I>
int launch_build(const I* idx, int B, int M, int K, int* offsets, int* rows,
                 int* scratch, cudaStream_t s) {
  const size_t aux = (3 * kThreads + kWarps) * sizeof(int);
  if (K <= kWarpTargets) {
    const size_t smem = (static_cast<size_t>(kWarps) * K + kWarps) *
                        sizeof(int);
    auto kern = csr_warp_kernel<I>;
    const int e = allow_smem(kern, smem);
    if (e) return e;
    kern<<<B, kThreads, smem, s>>>(idx, M, K, offsets, rows);
  } else if (K <= kSharedTargets) {
    const size_t smem = aux + static_cast<size_t>(K) * sizeof(int);
    auto kern = csr_build_kernel<I, true>;
    const int e = allow_smem(kern, smem);
    if (e) return e;
    kern<<<B, kThreads, smem, s>>>(idx, M, K, offsets, rows, scratch);
  } else {
    csr_build_kernel<I, false><<<B, kThreads, aux, s>>>(idx, M, K, offsets,
                                                        rows, scratch);
  }
  return ifdef::last_error();
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// idx [B,M], int64 where idx64 is 1 and int32 where 0, each in [0, K) or
// the kernel traps; offsets [B, K+1] and rows [B, M] int32, every entry
// written; scratch [B, K] int32 where K > kSharedTargets (32,768, the
// wrapper's SHARED_TARGETS: the table then lives in device memory), else
// it may be null.
int ifdef_csr_build(const void* idx, int idx64, int B, int M, int K,
                    int* offsets, int* rows, int* scratch, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || M < 0 || K < 1 || B > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > kSharedTargets && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_build(static_cast<const int64_t*>(idx), B, M, K, offsets,
                        rows, scratch, s);
  return launch_build(static_cast<const int*>(idx), B, M, K, offsets, rows,
                      scratch, s);
}

}  // extern "C"
