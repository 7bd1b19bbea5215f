// Repulsion loss with exact k-NN selection (kernels B1, B2, B3).
//
// Replaces the Pallas kernels of if_defense_tpu/ops/pallas_repulsion.py:
//   B1 fused_repulsion_loss:196   (_fwd_call:148 / _bwd_call:172)
//   B2 fused_repulsion_mask:267   (_mask_kernel:260)
//   B3 fused_repulsion_loss_masked:390 (_masked_fwd_call:340 / _masked_bwd_call:364)
//
// Semantics (as the Pallas kernels): d2 is the exact f32 squared distance
// from coordinate differences, summed x, y, z in that order with no fused
// multiply-add, so every kernel and the plain PyTorch version see the same
// bits. Self is excluded by index. A row's threshold t is its k-th smallest
// d2 counted with multiplicity; weights are 1 below t and (k - n_lt) / n_eq
// at t. loss[b] = sum_i sum_j w_ij (r - d)exp(-(d/h)^2) / (N k) with
// d = sqrt(max(d2, eps)); the gradient is zero inside eps.
//
// The TPU kernels build dense [NT, N] tiles for the matrix unit and carry
// the column half of the gradient across a grid that runs in order. Here
// blocks run in any order, so the forward of B1 keeps each row's threshold
// and tie weight, and every backward is a gather over one point's partners:
// no selection in the backward, no atomics, every result deterministic from
// run to run (sums in a fixed order: a lane's pairs in the order the warp
// found them, then a fixed butterfly across the warp; per-cloud sums by
// `rows_to_loss` over per-row partials). The matrix unit does not apply: the distances must
// keep their exact bits.
//
// A warp's list. Every pair loop below is branch-free: a warp tests 32
// pairs at a time and gathers the few that carry weight (about 2k of N)
// into its list in shared memory by ballot; the list is then taken a pair a
// lane, so the sqrt, exp and divisions of a pair's term or coefficient run
// on full warps, once per weighted pair. (A first design that tested and
// computed in one divergent loop ran at the latency of its shared-memory
// loads, its unrolled iterations each a branch of their own.)
//
// B1 forward (rep_fwd). Bound: issue. At the ConvONet-Opt shapes (B=48,
// N=1024) a call is ~50M pair distances of 8 operations each and no memory
// traffic to speak of. A warp per row, lane l taking partners j = l mod 32
// from the cloud in shared memory as three coordinate arrays (neighbouring
// lanes read neighbouring words: no bank conflict). Up to N = 1024 a lane
// keeps its 32 distances in registers and selection is a filter: u, the
// k-th smallest of the 32 lanes' minima, bounds the threshold from above
// (k lanes hold a distance <= u), so the distances <= u, a few per row, go
// to the list, and the threshold, counts and sums come from the list
// alone. The threshold is the k-th order statistic with multiplicity, bit-
// equal to a full sort: k rounds of a warp min over the lanes' heads, the
// lowest lane holding the min popping it. Where ties at u overflow the list,
// every distance enters the lanes' sorted top-k (a branch-free min/max
// network in registers) instead. Above N = 1024 (rep_fwd_chunked) every
// distance enters the top-k, and the counting pass computes them again.
//
// Any N. No kernel's shared memory grows past a fixed chunk: where a cloud
// is larger than a kernel's staged chunk (1024 points in B1's forward and
// B2, 4096 in B1's backward, 1024 partners in B3's backward), the block
// walks the partners j chunk by chunk in increasing order, and every lane
// still takes its partners in the order it did with the whole cloud
// staged. Up to 4096 points the sums therefore keep their order and the
// results their bits; above, B1's backward also empties its list at the end
// of each chunk, so its sums group differently (still one fixed order:
// deterministic). The only limit left is the [B, N, N] mask of B2/B3, which
// the wrapper allocates.
//
// Any k. Up to k = 8 the selection above keeps a sorted top-k in registers
// (k a template parameter). Above, B1's forward and B2 take K = 0 and find
// each row's threshold by the Pallas kernels' scan (row_threshold_scan,
// walk_threshold_scan): rounds of a warp min over the distances above the
// last threshold, each adding the count of that min, until the count reaches
// k; the same k-th order statistic with multiplicity, so the rows, weights
// and losses follow as for k <= 8. A round is one pass over the row (32
// registers a lane up to 1024 points, a walk over the staged chunks above),
// so the threshold costs up to k passes where the top-k costs one. B1's
// backward and B3 take any k as they are (k only scales the loss).
//
// B1 backward (rep_bwd). Bound: issue, one distance per pair. A warp per
// point m, lanes over j; a pair carries weight only where d2 <= max(t_m,
// t_j) (the thresholds sit in shared memory beside the cloud), and those
// pairs go to the list for their row and column weights and coefficient.
//
// B2 (rep_mask). Bound: bytes, the [B, N, N] int8 mask written once (48 MB
// at B=48, N=1024: 0.015 ms at 3.35 TB/s); its ~50M pair distances, 9
// operations each, would take 0.007 ms at the f32 peak. What holds it at
// about 5x that is not measured (`ncu` does not run on the card's machine);
// the lead is a row's instruction count (distances, the list, the REDUX
// rounds, the ballots). B1's forward up to its threshold: a warp per row, the
// row's distances in registers, the bound filter and the list, the k-th
// order statistic by REDUX rounds (`row_threshold`, shared with rep_fwd).
// Then, from the same registers, the row: a ballot of d2 <= t for each
// 32-column group gives 32 mask bits (self and columns past N hold +inf),
// and lane l expands half a ballot into the 16-byte word at columns 16 l
// and at 512 + 16 l, so a 1 KB row is two coalesced warp stores of 512
// bytes and no distance is computed twice. Rows of N % 16 != 0 columns are
// not 16-byte aligned: there each lane stores its own columns' bytes.
// Above 1024 points (rep_mask_chunked) the thresholds come from the lanes'
// top-k over staged chunks, as in rep_fwd_chunked, and the row is written
// chunk by chunk with the distances computed again. Measured on the H100
// at 700 W (`tools/time_kernels.py`, B=48, N=1024): this design 0.082 ms in
// f32 and in bf16. Slower: the port's first B2, a thread per row for the
// thresholds (a serial top-k insertion over N - 1 partners) and a second
// pass that computed every distance again to store a byte a lane, 0.134
// ms; this design at three blocks an SM (80 registers), 0.090 ms; and with
// the cloud staged as float4 and the ballots handed on by shuffles, 0.092.
//
// B3 forward (rep_masked_fwd). Bound: bytes, the [B, N, N] int8 mask read
// once (48 MB; ~0.5 % of it ones). A warp per row reads the row as 16-byte
// words (a 1 KB row in two warp instructions), finds the nonzero bytes by a
// per-byte compare, and lists them with their weights; terms only for those.
// (Four rows a warp with their words loaded at once ran slower: it spilled.)
//
// B3 backward (rep_masked_bwd). Bound: bytes, the mask read twice (row and
// column side). A block per (cloud, tile of 32 points m) stages, chunk by
// chunk of 1024 partners j, the tile's rows mask[b, tile, j0:j0+1024] into
// shared memory with 16-byte loads, and its column slab mask[b,
// j0:j0+1024, tile] (32 bytes a row, one sector) with 16-byte loads whose
// few nonzero bytes it scatters transposed into a zero-filled slab. A warp
// per point then scans both as 16-byte words with its lanes over j and
// lists the nonzero bytes. The slabs take 67 KB with the lists whatever N
// (whole slabs would not fit in a block's 227 KB at N = 4096). Measured
// slower on the H100: the row side read straight from global
// memory warp by warp with only the column slab staged (with or without
// the words loaded ahead), and the row slab staged by cp.async with the
// column words loaded 8 a thread at once.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;        // warps per block of the warp-per-row kernels
constexpr int kRowsPerWarp = 4;  // B1: rows (points) a warp takes in turn
constexpr int kRegN = 1024;      // B1 forward and B2 keep distances in registers up to
                                 // this N (and stage chunks of this many points above it)
constexpr int kStep = 4;         // B1 backward: 32-partner steps a warp takes at once
constexpr int kStage = 4096;     // B1 backward: points staged at once
constexpr int kList = 64;        // entries of a warp's list of weighted pairs
constexpr int kLoads = 2;        // B3: 16-byte words of a mask row a lane loads at once
constexpr int kTile = 32;        // B3 backward: points m per block
constexpr int kChunk = 1024;     // B3 backward: partners j staged per pass
constexpr int kBatch = 4;        // B3 backward: 16-byte column words a thread loads at once
constexpr int kReduce = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int B, N, k;
  float radius, h, eps;
};

__device__ __forceinline__ float d2_of(float xi, float yi, float zi, float xj,
                                       float yj, float zj) {
  float dx = xi - xj, dy = yi - yj, dz = zi - zj;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float term_of(float d2, const Params& P) {
  float d = sqrtf(fmaxf(d2, P.eps));
  float q = d / P.h;
  return (P.radius - d) * expf(-(q * q));
}

// d(term)/d(d2): the pair coefficient before the 2 (p_i - p_j) factor;
// zero inside the eps floor
__device__ __forceinline__ float coef_of(float d2, const Params& P) {
  if (!(d2 > P.eps)) return 0.f;
  float d = sqrtf(d2);
  float q = d / P.h;
  float e = expf(-(q * q));
  float dterm_dd = -e + (P.radius - d) * e * (-2.f * d / (P.h * P.h));
  return dterm_dd * (0.5f / d);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// points j0 .. j0 + n of a cloud as three coordinate arrays of np >= n
// entries, zero past n: x in s[0, np), y in s[np, 2 np), z in s[2 np, 3 np).
// No barrier: the caller orders it with the readers.
template <typename T>
__device__ void stage_soa(const T* pb, int j0, int n, int np, float* s) {
#pragma unroll 4
  for (int t = threadIdx.x; t < 3 * n; t += blockDim.x)
    s[(t % 3) * np + t / 3] = ifdef::load_f(pb, 3L * j0 + t);
  for (int t = n + threadIdx.x; t < np; t += blockDim.x)
    s[t] = s[np + t] = s[2 * np + t] = 0.f;
}

// point j of a cloud in global memory, in f32
template <typename T>
__device__ __forceinline__ void point_of(const T* p, int j, float& x, float& y,
                                         float& z) {
  x = ifdef::load_f(p, 3L * j);
  y = ifdef::load_f(p, 3L * j + 1);
  z = ifdef::load_f(p, 3L * j + 2);
}

// The block walks a cloud of N points in chunks of `np`, staged one after
// the other into s (three coordinate arrays of np entries), and calls
// body(j0, n) on each with the chunk in place. Every thread of the block
// must call it the same number of times (it synchronises the block).
template <typename T, typename F>
__device__ __forceinline__ void walk_chunks(const T* pb, int N, int np,
                                            float* s, F&& body) {
  for (int j0 = 0; j0 < N; j0 += np) {
    const int n = min(np, N - j0);
    __syncthreads();  // the previous chunk has been read
    stage_soa(pb, j0, n, np, s);
    __syncthreads();
    body(j0, n);
  }
}

// v into a lane's ascending top-K, branch-free
template <int K>
__device__ __forceinline__ void top_insert(float (&top)[K], float v) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float lo = fminf(top[t], v);
    v = fmaxf(top[t], v);
    top[t] = lo;
  }
}

// The R-th smallest, with multiplicity, of the values in the lanes' lists
// (each ascending, of length L; values >= 0 or +inf, whose bit patterns
// order as unsigned integers do, so a warp min is one REDUX): R rounds of a
// warp min over the lanes' heads, the lowest lane holding the min popping
// it. Every lane returns it.
template <int R, int L>
__device__ __forceinline__ float warp_kth(float (&top)[L], int lane) {
  float m = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m = __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(top[0])));
    unsigned hit = __ballot_sync(kFull, top[0] == m);
    if (lane == __ffs(hit) - 1) {
#pragma unroll
      for (int t = 0; t + 1 < L; ++t) top[t] = top[t + 1];
      top[L - 1] = inf_f();
    }
  }
  return m;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The warp's list entries before this lane's `cnt` (an exclusive prefix sum
// over the lanes); `total` gets the warp's sum.
__device__ __forceinline__ int warp_slots(int cnt, int lane, int& total) {
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  total = __shfl_sync(kFull, incl, 31);
  return incl - cnt;
}

// A row's threshold t, the K-th smallest of its distances with
// multiplicity, from the lane's PER distances in registers (lane l holds
// j = 32 c + l; +inf where j is self or past N). u, the K-th smallest of the
// lanes' minima, bounds t from above (K lanes hold a distance <= u), so the
// distances <= u, a few per row, go to the warp's list and t comes from the
// list alone; where ties at u overflow the list, every distance enters the
// lanes' sorted top-K instead. `n` gets the count of distances <= u: the
// list holds them where n <= kList. The caller syncs the warp before the
// list is written again.
template <int K, int PER>
__device__ __forceinline__ float row_threshold(const float (&d)[PER], int lane,
                                               float* list, int& n) {
  float lo[4] = {inf_f(), inf_f(), inf_f(), inf_f()};
#pragma unroll
  for (int c = 0; c < PER; ++c) lo[c & 3] = fminf(lo[c & 3], d[c]);
  float lane_min[1] = {fminf(fminf(lo[0], lo[1]), fminf(lo[2], lo[3]))};
  const float u = warp_kth<K>(lane_min, lane);
  n = 0;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const bool q = d[c] <= u;
    const unsigned bal = __ballot_sync(kFull, q);
    if (bal) {
      const int at = n + __popc(bal & lanes_below(lane));
      if (q && at < kList) list[at] = d[c];
      n += __popc(bal);
    }
  }
  __syncwarp();
  if (n <= kList) {
    float a = lane < n ? list[lane] : inf_f();
    float c2 = lane + 32 < n ? list[lane + 32] : inf_f();
    float top[2] = {fminf(a, c2), fmaxf(a, c2)};
    return warp_kth<K>(top, lane);
  }
  float top[K];
#pragma unroll
  for (int c = 0; c < K; ++c) top[c] = inf_f();
#pragma unroll
  for (int c = 0; c < PER; ++c) top_insert(top, d[c]);
  return warp_kth<K>(top, lane);
}

// The threshold of row i above kRegN points: every distance enters the
// lanes' top-K, the partners staged chunk by chunk (walk_chunks: every warp
// of the block calls it; a warp whose row is past N, valid false, does no
// work and gets +inf).
template <int K, typename T>
__device__ __forceinline__ float walk_threshold(const T* pb, int N, float* s,
                                                int i, bool valid, int lane,
                                                float xi, float yi, float zi) {
  const float *sx = s, *sy = s + kRegN, *sz = s + 2 * kRegN;
  float top[K];
#pragma unroll
  for (int c = 0; c < K; ++c) top[c] = inf_f();
  walk_chunks(pb, N, kRegN, s, [&](int j0, int n) {
    if (valid)
      for (int jj = lane; jj < n; jj += 32)
        if (j0 + jj != i)
          top_insert(top, d2_of(xi, yi, zi, sx[jj], sy[jj], sz[jj]));
  });
  return warp_kth<K>(top, lane);
}

// k above the register top-K's reach (K == 0 in the kernels' templates, k
// given at run time): the row's k-th smallest distance with multiplicity by
// the Pallas kernels' scan (pallas_repulsion.py:71-88), a warp per row:
// rounds of a warp min over the distances above the last threshold, each
// adding the count of that min, until the count reaches k. A round is one
// pass over the row; at most k rounds, fewer where distances tie. A lane
// folds each distance v > t into its (min, count of the min).
struct ScanRound {
  float t, lm;
  int c;
  __device__ __forceinline__ void add(float v) {
    const bool above = v > t;
    const bool lt = above && v < lm;
    c = lt ? 1 : c + (above && v == lm);
    lm = lt ? v : lm;
  }
  // the round's warp min and its count over the warp; false where no finite
  // distance is left (the row's points not finite)
  __device__ __forceinline__ bool close(int& cnt) {
    const float m =
        __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(lm)));
    if (m == inf_f()) return false;
    cnt += __reduce_add_sync(kFull, lm == m ? c : 0);
    t = m;
    return true;
  }
};

// The scan over a lane's PER distances in registers (rep_fwd, rep_mask).
template <int PER>
__device__ __forceinline__ float row_threshold_scan(const float (&d)[PER],
                                                    int k) {
  ScanRound r{-1.f};  // t below every distance (d2 >= 0)
  int cnt = 0;
  while (cnt < k) {
    r.lm = inf_f();
    r.c = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) r.add(d[q]);
    if (!r.close(cnt)) return inf_f();
  }
  return r.t;
}

// The scan above kRegN points, a round a walk over the staged chunks. Every
// warp of the block takes the rounds together (the walks synchronise the
// block) until each has its threshold; a warp whose row is past N gets +inf.
template <typename T>
__device__ __forceinline__ float walk_threshold_scan(const T* pb, int N,
                                                     float* s, int i,
                                                     bool valid, int lane,
                                                     float xi, float yi,
                                                     float zi, int k) {
  const float *sx = s, *sy = s + kRegN, *sz = s + 2 * kRegN;
  ScanRound r{-1.f};
  int cnt = valid ? 0 : k;
  bool finite = valid;
  while (__syncthreads_or(cnt < k)) {
    r.lm = inf_f();
    r.c = 0;
    const bool open = cnt < k;  // the same for the whole warp
    walk_chunks(pb, N, kRegN, s, [&](int j0, int n) {
      if (open)
        for (int jj = lane; jj < n; jj += 32)
          if (j0 + jj != i) r.add(d2_of(xi, yi, zi, sx[jj], sy[jj], sz[jj]));
    });
    if (open && !r.close(cnt)) {
      finite = false;
      cnt = k;
    }
  }
  return finite ? r.t : inf_f();
}

// The threshold of a row whose distances sit in registers (rep_fwd,
// rep_mask): the lanes' top-K through the warp's list for K > 0, `n` as
// row_threshold sets it; else the scan for k, with n = kList + 1 (the list
// holds nothing: the caller reads the registers).
template <int K, int PER>
__device__ __forceinline__ float register_threshold(const float (&d)[PER],
                                                    int lane, float* list,
                                                    int& n, int k) {
  if constexpr (K > 0) {
    return row_threshold<K>(d, lane, list, n);
  } else {
    n = kList + 1;
    return row_threshold_scan(d, k);
  }
}

// The threshold of row i above kRegN points: the lanes' top-K for K > 0,
// else the scan for k
template <int K, typename T>
__device__ __forceinline__ float chunked_threshold(const T* pb, int N,
                                                   float* s, int i,
                                                   bool valid, int lane,
                                                   float xi, float yi,
                                                   float zi, int k) {
  if constexpr (K > 0)
    return walk_threshold<K>(pb, N, s, i, valid, lane, xi, yi, zi);
  else
    return walk_threshold_scan(pb, N, s, i, valid, lane, xi, yi, zi, k);
}

// A row's tally of the distances v <= t: count and term sum below t and
// at it
struct Tally {
  int n_lt = 0, n_eq = 0;
  float s_lt = 0.f, s_eq = 0.f;
  __device__ __forceinline__ void add(float v, float t, const Params& P) {
    if (v <= t) {
      const float tv = term_of(v, P);
      if (v < t) {
        ++n_lt;
        s_lt += tv;
      } else {
        ++n_eq;
        s_eq += tv;
      }
    }
  }
  // the warp's sums; lane 0 writes the row's loss, threshold and tie weight
  __device__ __forceinline__ void write(int K, float t, long r, int lane,
                                        float* row_loss, float* thr,
                                        float* frac) {
    n_lt = __reduce_add_sync(kFull, n_lt);
    n_eq = __reduce_add_sync(kFull, n_eq);
    s_lt = ifdef::warp_sum(s_lt);
    s_eq = ifdef::warp_sum(s_eq);
    if (lane == 0) {
      const float f = (float)(K - n_lt) / (float)max(n_eq, 1);
      row_loss[r] = s_lt + f * s_eq;
      thr[r] = t;
      frac[r] = f;
    }
  }
};

// B1 forward: warp per row; per-row threshold, tie weight and weighted
// loss. A lane keeps its PER distances in registers (N <= 32 PER, the cloud
// padded to 32 PER points) and selects through the warp's list.
template <int K, int PER, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_fwd(const T* __restrict__ pts, Params P, float* __restrict__ row_loss,
            float* __restrict__ thr, float* __restrict__ frac) {
  extern __shared__ float s[];
  const int N = P.N, b = blockIdx.y;
  constexpr int np = 32 * PER;
  stage_soa(pts + (long)b * N * 3, 0, N, np, s);
  __syncthreads();
  const float *sx = s, *sy = s + np, *sz = s + 2 * np;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* list = s + 3 * np + warp * kList;
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int i = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    if (i >= N) break;
    const float xi = sx[i], yi = sy[i], zi = sz[i];
    // the lane's distances, branch-free
    float d[PER];
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int j = 32 * c + lane;
      const float v = d2_of(xi, yi, zi, sx[j], sy[j], sz[j]);
      d[c] = (j < N && j != i) ? v : inf_f();
    }
    int n;
    const float t = register_threshold<K>(d, lane, list, n, P.k);
    Tally tl;
    if (n <= kList) {  // the list holds every distance <= t
      for (int q = lane; q < n; q += 32) tl.add(list[q], t, P);
    } else {  // more ties at u than the list holds
#pragma unroll
      for (int c = 0; c < PER; ++c) tl.add(d[c], t, P);
    }
    __syncwarp();  // the list is read before the next row writes it
    tl.write(K > 0 ? K : P.k, t, (long)b * N + i, lane, row_loss, thr, frac);
  }
}

// B1 forward above kRegN points: warp per row as rep_fwd; every distance
// enters the lanes' top-K, then a counting pass computes them again. The
// partners come in chunks of kRegN points staged in shared memory; a lane
// takes j = lane mod 32 in increasing order, chunk after chunk.
template <int K, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_fwd_chunked(const T* __restrict__ pts, Params P,
                    float* __restrict__ row_loss, float* __restrict__ thr,
                    float* __restrict__ frac) {
  __shared__ float s[3 * kRegN];
  const int N = P.N, b = blockIdx.y;
  const T* pb = pts + (long)b * N * 3;
  const float *sx = s, *sy = s + kRegN, *sz = s + 2 * kRegN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every warp takes kRowsPerWarp turns (the walks synchronise the block);
  // a row past N, the same for the whole warp, does no work
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int i = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    const bool valid = i < N;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (valid) point_of(pb, i, xi, yi, zi);
    const float t =
        chunked_threshold<K>(pb, N, s, i, valid, lane, xi, yi, zi, P.k);
    Tally tl;
    walk_chunks(pb, N, kRegN, s, [&](int j0, int n) {
      if (valid)
        for (int jj = lane; jj < n; jj += 32)
          if (j0 + jj != i)
            tl.add(d2_of(xi, yi, zi, sx[jj], sy[jj], sz[jj]), t, P);
    });
    if (valid)
      tl.write(K > 0 ? K : P.k, t, (long)b * N + i, lane, row_loss, thr, frac);
  }
}

// per-cloud sum of row partials, fixed order: loss[b] = sum / (N k)
__global__ void rows_to_loss(const float* __restrict__ row_loss, int N, int k,
                             float* __restrict__ loss) {
  __shared__ float part[kReduce];
  int b = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < N; i += kReduce) acc += row_loss[(long)b * N + i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kReduce / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[b] = part[0] / (float)(N * k);
}

// cloud points in B1's backward: N rounded up to whole steps
__host__ __device__ inline int bwd_points(int N) {
  return (N + 32 * kStep - 1) / (32 * kStep) * (32 * kStep);
}

// B1 backward: warp per point m, lanes over j; row and column weights from
// the saved thresholds; grad in the points' type. A pair carries weight
// only where d2 <= max(t_m, t_j): the lanes test kStep partners each,
// branch-free, then gather the pairs that pass (~2k a row) into the warp's
// list by ballot, and take them a pair a lane for the weights and the
// coefficient's sqrt, exp and divisions. The partners and their thresholds
// sit in shared memory: the whole cloud, staged once (kChunked false, N <=
// kStage), or kStage points at a time, staged again for each of a warp's
// rows, with the list drained at the end of each chunk (kChunked true).
template <bool kChunked, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_bwd(const T* __restrict__ pts, Params P,
            const float* __restrict__ thr, const float* __restrict__ frac,
            const float* __restrict__ g, T* __restrict__ grad) {
  extern __shared__ float s[];
  const int N = P.N, b = blockIdx.y, np = kChunked ? kStage : bwd_points(N);
  const T* pb = pts + (long)b * N * 3;
  const float *sx = s, *sy = s + np, *sz = s + 2 * np;
  float* st = s + 3 * np;
  float* sf = st + np;
  // points j0 .. j0 + np (zero past N) and their thresholds and weights
  auto stage = [&](int j0) {
    const int n = min(np, N - j0);
    __syncthreads();  // the previous chunk has been read
    for (int t = threadIdx.x; t < np; t += blockDim.x) {
      st[t] = t < n ? thr[(long)b * N + j0 + t] : 0.f;
      sf[t] = t < n ? frac[(long)b * N + j0 + t] : 0.f;
    }
    stage_soa(pb, j0, n, np, s);
    __syncthreads();
  };
  if (!kChunked) stage(0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* list = reinterpret_cast<int*>(sf + np) + warp * kList;
  const float gs = 2.f * g[b] / (float)(N * P.k);
  // chunked, every warp takes kRowsPerWarp turns (the stages synchronise the
  // block); a point past N, the same for the whole warp, does no work
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int m = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    const bool valid = m < N;
    if (!kChunked && !valid) break;
    float xm = 0.f, ym = 0.f, zm = 0.f, tm = 0.f, fm = 0.f;
    if (!kChunked) {
      xm = sx[m], ym = sy[m], zm = sz[m], tm = st[m], fm = sf[m];
    } else if (valid) {
      point_of(pb, m, xm, ym, zm);
      tm = thr[(long)b * N + m];
      fm = frac[(long)b * N + m];
    }
    float ax = 0.f, ay = 0.f, az = 0.f;
    int n = 0;  // pairs in the list (indices into the chunk)
    auto drain = [&]() {
      for (int q = lane; q < n; q += 32) {
        const int j = list[q];
        const float xj = sx[j], yj = sy[j], zj = sz[j];
        const float v = d2_of(xm, ym, zm, xj, yj, zj);
        float w = (v < tm) ? 1.f : (v == tm ? fm : 0.f);
        const float tj = st[j];
        w += (v < tj) ? 1.f : (v == tj ? sf[j] : 0.f);
        const float c = w * coef_of(v, P);
        ax += c * (xm - xj);
        ay += c * (ym - yj);
        az += c * (zm - zj);
      }
      __syncwarp();
      n = 0;
    };
    // the staged partners j0 .. j0 + jn into the list, then drained
    auto scan = [&](int j0, int jn) {
      for (int c0 = 0; c0 < jn; c0 += 32 * kStep) {
        bool cand[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int j = c0 + 32 * u + lane;
          const float v = d2_of(xm, ym, zm, sx[j], sy[j], sz[j]);
          cand[u] = (v <= fmaxf(tm, st[j])) & (j0 + j != m) & (j < jn);
        }
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const unsigned bal = __ballot_sync(kFull, cand[u]);
          if (bal) {
            if (n + __popc(bal) > kList) drain();
            if (cand[u]) list[n + __popc(bal & lanes_below(lane))] = c0 + 32 * u + lane;
            n += __popc(bal);
            __syncwarp();
          }
        }
      }
      drain();
    };
    if (!kChunked) {
      scan(0, N);
    } else {
      for (int j0 = 0; j0 < N; j0 += np) {
        stage(j0);
        if (valid) scan(j0, min(np, N - j0));
      }
    }
    if (!valid) continue;
    ax = ifdef::warp_sum(ax);
    ay = ifdef::warp_sum(ay);
    az = ifdef::warp_sum(az);
    if (lane == 0) {
      const long o = ((long)b * N + m) * 3;
      ifdef::store_f(grad, o, ax * gs);
      ifdef::store_f(grad, o + 1, ay * gs);
      ifdef::store_f(grad, o + 2, az * gs);
    }
  }
}

// Four mask bits as four bytes of 0/1, bit e into byte e: the bits land at
// 0, 8, 16 and 24 with no carries between them
__device__ __forceinline__ unsigned bytes_of(unsigned bits4) {
  return (bits4 * 0x00204081u) & 0x01010101u;
}

// 16 mask bits as a 16-byte word of 0/1 bytes, bit e into byte e
__device__ __forceinline__ uint4 word_of(unsigned bits16) {
  return make_uint4(bytes_of(bits16 & 0xf), bytes_of((bits16 >> 4) & 0xf),
                    bytes_of((bits16 >> 8) & 0xf), bytes_of((bits16 >> 12) & 0xf));
}

// B2's row writer for up to 1024 columns j0 + 32 c + l (c < 32). Per group
// c the warp calls `group(c, hit)` with the lane's bit; on a 16-byte-aligned
// row (`vec`) lane l keeps the ballots of groups l / 2 and 16 + l / 2 and
// stores the 16-byte words at columns j0 + 16 l and j0 + 512 + 16 l that
// lie below `ncols`; else each lane stores its own bytes.
struct MaskRow {
  int8_t* row;
  int ncols, lane;
  bool vec;
  unsigned h0 = 0, h1 = 0;
  __device__ __forceinline__ void group(int c, bool hit) {
    const unsigned bal = __ballot_sync(kFull, hit);
    if (vec) {
      if (c == lane >> 1) h0 = bal;
      if (c == 16 + (lane >> 1)) h1 = bal;
    } else if (32 * c + lane < ncols) {
      row[32 * c + lane] = hit ? 1 : 0;
    }
  }
  __device__ __forceinline__ void store() {
    if (!vec) return;
    const int sh = 16 * (lane & 1);
    if (16 * lane < ncols)
      reinterpret_cast<uint4*>(row)[lane] = word_of((h0 >> sh) & 0xffffu);
    if (512 + 16 * lane < ncols)
      reinterpret_cast<uint4*>(row)[32 + lane] = word_of((h1 >> sh) & 0xffffu);
  }
};

// B2 up to kRegN points: warp per row as rep_fwd, the cloud padded to 32 PER
// points; each row's mask from the distances in registers. Four blocks an
// SM (64 registers a thread): 9 % faster on the H100 at 700 W than the
// three that 80 registers allow.
template <int K, int PER, typename T>
__global__ void __launch_bounds__(kWarps * 32, 4)
    rep_mask(const T* __restrict__ pts, Params P, int8_t* __restrict__ mask) {
  extern __shared__ float s[];
  const int N = P.N, b = blockIdx.y;
  constexpr int np = 32 * PER;
  stage_soa(pts + (long)b * N * 3, 0, N, np, s);
  __syncthreads();
  const float *sx = s, *sy = s + np, *sz = s + 2 * np;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* list = s + 3 * np + warp * kList;
  const bool vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int i = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    if (i >= N) break;
    const float xi = sx[i], yi = sy[i], zi = sz[i];
    float d[PER];
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int j = 32 * c + lane;
      const float v = d2_of(xi, yi, zi, sx[j], sy[j], sz[j]);
      d[c] = (j < N && j != i) ? v : inf_f();
    }
    int n;
    const float t = register_threshold<K>(d, lane, list, n, P.k);
    __syncwarp();  // the list is read before the next row writes it
    MaskRow out{mask + ((long)b * N + i) * N, N, lane, vec};
#pragma unroll
    for (int c = 0; c < PER; ++c) out.group(c, d[c] <= t);
    out.store();
  }
}

// B2 above kRegN points: warp per row as rep_fwd_chunked; the threshold from
// the lanes' top-K over the staged chunks, then the row written chunk by
// chunk with the chunk's distances computed again.
template <int K, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_mask_chunked(const T* __restrict__ pts, Params P,
                     int8_t* __restrict__ mask) {
  __shared__ float s[3 * kRegN];
  const int N = P.N, b = blockIdx.y;
  const T* pb = pts + (long)b * N * 3;
  const float *sx = s, *sy = s + kRegN, *sz = s + 2 * kRegN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  // every warp takes kRowsPerWarp turns (the walks synchronise the block);
  // a row past N, the same for the whole warp, does no work
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int i = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    const bool valid = i < N;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (valid) point_of(pb, i, xi, yi, zi);
    const float t =
        chunked_threshold<K>(pb, N, s, i, valid, lane, xi, yi, zi, P.k);
    walk_chunks(pb, N, kRegN, s, [&](int j0, int n) {
      if (!valid) return;
      MaskRow out{mask + ((long)b * N + i) * N + j0, n, lane, vec};
#pragma unroll
      for (int c = 0; c < kRegN / 32; ++c) {
        const int jj = 32 * c + lane;
        out.group(c, jj < n && j0 + jj != i &&
                         d2_of(xi, yi, zi, sx[jj], sy[jj], sz[jj]) <= t);
      }
      out.store();
    });
  }
}

// The nonzero bytes of a mask word (0x80 in each), lowest first by __ffs
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return __vcmpne4(w, 0u) & 0x80808080u;
}

__device__ __forceinline__ int byte_of(unsigned w, int byte) {
  return (int8_t)(w >> (8 * byte));
}

// A B3 list entry: index j (>= -16) and an int weight
__device__ __forceinline__ int pack(int j, int w) {
  return ((j + 16) << 16) | (w & 0xffff);
}
__device__ __forceinline__ int entry_j(int e) { return (e >> 16) - 16; }
__device__ __forceinline__ float entry_w(int e) {
  return (float)(int16_t)(e & 0xffff);
}

// B3's gather. Every lane holds four 16-byte-word halves of a mask row (wr)
// and of the matching column slab (wc, zero on the forward), byte e of the
// 16 at index j16 + e. Appends to the warp's list (lane order, then index
// order) an entry (j, wr byte + wc byte) for each index where either byte
// is nonzero, and returns its new length. It calls `drain` (which processes
// the list and returns 0) where the entries would not fit; where even an
// empty list would not hold them (a mask far denser than a k-NN graph) the
// lanes hand their entries to `each` at once.
template <typename D, typename E>
__device__ __forceinline__ int gather(const unsigned (&wr)[4],
                                      const unsigned (&wc)[4], int j16,
                                      int lane, int* list, int len, D&& drain,
                                      E&& each) {
  unsigned bits[4];
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bits[e] = nonzero_bytes(wr[e]) | nonzero_bytes(wc[e]);
    cnt += __popc(bits[e]);
  }
  if (!__any_sync(kFull, cnt > 0)) return len;
  int total;
  int at = warp_slots(cnt, lane, total);
  if (len + total > kList) len = drain(len);
  const bool direct = total > kList;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    for (unsigned x = bits[e]; x; x &= x - 1) {
      const int byte = (__ffs(x) - 1) >> 3;
      const int j = j16 + 4 * e + byte;
      const int w = byte_of(wr[e], byte) + byte_of(wc[e], byte);
      if (direct)
        each(j, (float)w);
      else
        list[len + at++] = pack(j, w);
    }
  __syncwarp();
  return direct ? len : len + total;
}

// B3's drain: the list's entries a pair a lane (each lane's in list order),
// `each(j, w)` for those with j in [0, n), j != skip; returns 0
template <typename E>
__device__ __forceinline__ int drain_list(const int* list, int len, int n,
                                          int skip, int lane, E&& each) {
  for (int q = lane; q < len; q += 32) {
    const int e = list[q];
    const int j = entry_j(e);
    if (j >= 0 && j < n && j != skip) each(j, entry_w(e));
  }
  __syncwarp();
  return 0;
}

// a weighted pair's share of point m's gradient (before 2 g / (N k))
template <typename T>
__device__ __forceinline__ void add_pair(const T* pb, int j, float w,
                                         float xm, float ym, float zm,
                                         const Params& P, float& ax,
                                         float& ay, float& az) {
  float xj, yj, zj;
  point_of(pb, j, xj, yj, zj);
  const float cf = w * coef_of(d2_of(xm, ym, zm, xj, yj, zj), P);
  ax += cf * (xm - xj);
  ay += cf * (ym - yj);
  az += cf * (zm - zj);
}

// B3 forward: warp per row of [B*N]. The row's 16-byte words (the aligned
// words that cover it: an aligned word never crosses the allocation's
// 256-byte granularity) go through the warp's list; terms only at its
// nonzero bytes.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_masked_fwd(const T* __restrict__ pts, const int8_t* __restrict__ mask,
                   Params P, float* __restrict__ row_loss) {
  __shared__ int lists[kWarps][kList];
  const int N = P.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long r = (long)blockIdx.x * kWarps + warp;
  if (r >= (long)P.B * N) return;
  const int b = (int)(r / N), i = (int)(r % N);
  const T* pb = pts + (long)b * N * 3;
  float xi, yi, zi;
  point_of(pb, i, xi, yi, zi);
  float acc = 0.f;
  auto each = [&](int j, float w) {
    if (j < 0 || j >= N || j == i) return;
    float xj, yj, zj;
    point_of(pb, j, xj, yj, zj);
    acc += w * term_of(d2_of(xi, yi, zi, xj, yj, zj), P);
  };
  int* list = lists[warp];
  auto drain = [&](int len) { return drain_list(list, len, N, i, lane, each); };
  const int8_t* row = mask + r * N;
  const int off = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const uint4* words = reinterpret_cast<const uint4*>(row - off);
  const int nw = (off + N + 15) >> 4;
  const unsigned none[4] = {0u, 0u, 0u, 0u};
  int len = 0;
  for (int c0 = 0; c0 < nw; c0 += 32 * kLoads) {
    uint4 q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = c0 + 32 * u + lane;
      q[u] = c < nw ? words[c] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned w4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      len = gather(w4, none, 16 * (c0 + 32 * u + lane) - off, lane, list, len,
                   drain, each);
    }
  }
  drain(len);
  acc = ifdef::warp_sum(acc);
  if (lane == 0) row_loss[r] = acc;
}

// B3 backward: block per (cloud, tile of kTile points m), a warp per point.
// Per chunk of kChunk partners j, shared memory holds rows_s[r][jj] =
// mask[b, m0+r, j0+jj] and cols_s[r][jj] = mask[b, j0+jj, m0+r] in rows of
// `stride` bytes (a multiple of 16), zero past the chunk, then each warp's
// list.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_masked_bwd(const T* __restrict__ pts, const int8_t* __restrict__ mask,
                   Params P, int stride, const float* __restrict__ g,
                   T* __restrict__ grad) {
  extern __shared__ uint4 slab[];
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(slab);
  uint8_t* cols_s = rows_s + kTile * stride;
  const int N = P.N, b = blockIdx.y, m0 = blockIdx.x * kTile;
  const int nt = min(kTile, N - m0);
  const int8_t* mb = mask + (long)b * N * N;
  // 16-byte loads where every row and tile starts on a 16-byte boundary
  const bool vec = N % 16 == 0 && nt == kTile &&
                   (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* list = reinterpret_cast<int*>(cols_s + kTile * stride) + warp * kList;
  const T* pb = pts + (long)b * N * 3;
  constexpr int kPer = kTile / kWarps;  // points per warp
  float px[kPer], py[kPer], pz[kPer], ax[kPer], ay[kPer], az[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int m = m0 + warp + kWarps * u;
    px[u] = py[u] = pz[u] = ax[u] = ay[u] = az[u] = 0.f;
    if (m < N) point_of(pb, m, px[u], py[u], pz[u]);
  }
  // the slabs' 16-byte words: both when the rows are copied byte by byte
  // (their tails must be zero), else the columns'
  const int zero_from = vec ? kTile * stride / 16 : 0;
  const int zero_to = 2 * kTile * stride / 16;
  for (int j0 = 0; j0 < N; j0 += kChunk) {
    const int jn = min(kChunk, N - j0);
    const int nw = (jn + 15) >> 4;  // 16-byte words of a staged row
    __syncthreads();                // the previous chunk has been read
    for (int t = zero_from + threadIdx.x; t < zero_to; t += blockDim.x)
      slab[t] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    if (vec) {
#pragma unroll 4
      for (int t = threadIdx.x; t < kTile * nw; t += blockDim.x) {
        const int r = t / nw, c = t % nw;
        reinterpret_cast<uint4*>(rows_s + r * stride)[c] =
            reinterpret_cast<const uint4*>(mb + (long)(m0 + r) * N + j0)[c];
      }
      // two 16-byte words per partner j: mask[b, j, m0 .. m0 + 32), loaded
      // kBatch at a time; their few nonzero bytes land transposed
      for (int t0 = threadIdx.x; t0 < 2 * jn; t0 += kBatch * blockDim.x) {
        uint4 q[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + u * blockDim.x;
          q[u] = t < 2 * jn ? *reinterpret_cast<const uint4*>(
                                  mb + (long)(j0 + (t >> 1)) * N + m0 +
                                  16 * (t & 1))
                            : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + u * blockDim.x, jj = t >> 1, r0 = 16 * (t & 1);
          const unsigned w4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            for (unsigned x = nonzero_bytes(w4[e]); x; x &= x - 1) {
              const int byte = (__ffs(x) - 1) >> 3;
              cols_s[(r0 + 4 * e + byte) * stride + jj] =
                  (uint8_t)(w4[e] >> (8 * byte));
            }
        }
      }
    } else {
      for (int t = threadIdx.x; t < nt * jn; t += blockDim.x) {
        const int r = t / jn, jj = t % jn;
        rows_s[r * stride + jj] = mb[(long)(m0 + r) * N + j0 + jj];
      }
      for (int t = threadIdx.x; t < jn * nt; t += blockDim.x) {
        const int jj = t / nt, r = t % nt;
        const int8_t v = mb[(long)(j0 + jj) * N + m0 + r];
        if (v) cols_s[r * stride + jj] = (uint8_t)v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int r = warp + kWarps * u, m = m0 + r;
      if (m >= N) break;
      auto each = [&, u](int j, float w) {
        add_pair(pb, j, w, px[u], py[u], pz[u], P, ax[u], ay[u], az[u]);
      };
      auto drain = [&](int len) {
        return drain_list(list, len, N, m, lane, each);
      };
      const uint4* rw = reinterpret_cast<const uint4*>(rows_s + r * stride);
      const uint4* cw = reinterpret_cast<const uint4*>(cols_s + r * stride);
      int len = 0;
      for (int c = lane; c - lane < nw; c += 32) {
        const uint4 qr = c < nw ? rw[c] : make_uint4(0u, 0u, 0u, 0u);
        const uint4 qc = c < nw ? cw[c] : make_uint4(0u, 0u, 0u, 0u);
        const unsigned wr[4] = {qr.x, qr.y, qr.z, qr.w};
        const unsigned wc[4] = {qc.x, qc.y, qc.z, qc.w};
        len = gather(wr, wc, j0 + 16 * c, lane, list, len, drain, each);
      }
      drain(len);
    }
  }
  const float gs = 2.f * g[b] / (float)(N * P.k);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int m = m0 + warp + kWarps * u;
    const float sx = ifdef::warp_sum(ax[u]), sy = ifdef::warp_sum(ay[u]),
                sz = ifdef::warp_sum(az[u]);
    if (lane == 0 && m < N) {
      const long o = ((long)b * N + m) * 3;
      ifdef::store_f(grad, o, sx * gs);
      ifdef::store_f(grad, o + 1, sy * gs);
      ifdef::store_f(grad, o + 2, sz * gs);
    }
  }
}

// Above 48 KB a kernel's dynamic shared memory must be allowed explicitly.
template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

inline dim3 row_grid(const Params& P, int rows) {
  return dim3((unsigned)((P.N + rows - 1) / rows), (unsigned)P.B);
}

// bytes of a staged row in B3's backward: the chunk rounded up to 16-byte
// words, plus 16 so that rows start in other banks
inline int slab_stride(int N) { return 16 * ((min(N, kChunk) + 15) / 16) + 16; }

// Allows the dynamic shared memory, launches, returns the launch error.
#define IFDEF_LAUNCH(kern, grid, threads, smem, stream, ...)                 \
  do {                                                                       \
    int _e = allow_smem(kern, smem);                                         \
    if (_e) return _e;                                                       \
    kern<<<grid, threads, smem, stream>>>(__VA_ARGS__);                      \
    _e = ifdef::last_error();                                                \
    if (_e) return _e;                                                       \
  } while (0)

template <int K, typename T>
int fwd_impl(const void* pts, Params P, float* loss, float* thr, float* frac,
             float* row_loss, cudaStream_t s) {
  const dim3 grid = row_grid(P, kWarps * kRowsPerWarp);
  if (P.N <= kRegN) {  // the cloud padded to kRegN points, then the lists
    auto rows = rep_fwd<K, kRegN / 32, T>;
    IFDEF_LAUNCH(rows, grid, kWarps * 32,
                 sizeof(float) * (3 * kRegN + kWarps * kList), s,
                 static_cast<const T*>(pts), P, row_loss, thr, frac);
  } else {  // chunks of kRegN points in static shared memory
    auto rows = rep_fwd_chunked<K, T>;
    IFDEF_LAUNCH(rows, grid, kWarps * 32, 0, s, static_cast<const T*>(pts), P,
                 row_loss, thr, frac);
  }
  IFDEF_LAUNCH(rows_to_loss, dim3(P.B), kReduce, 0, s, row_loss, P.N, P.k,
               loss);
  return 0;
}

template <typename T>
int bwd_impl(const void* pts, Params P, const float* thr, const float* frac,
             const float* g, void* grad, cudaStream_t s) {
  const size_t list = sizeof(int) * kWarps * kList;
  const int np = bwd_points(P.N);
  if (np <= kStage) {  // the whole cloud staged once
    auto kern = rep_bwd<false, T>;
    IFDEF_LAUNCH(kern, row_grid(P, kWarps * kRowsPerWarp), kWarps * 32,
                 sizeof(float) * 5 * np + list, s,
                 static_cast<const T*>(pts), P, thr, frac, g,
                 static_cast<T*>(grad));
  } else {
    auto kern = rep_bwd<true, T>;
    IFDEF_LAUNCH(kern, row_grid(P, kWarps * kRowsPerWarp), kWarps * 32,
                 sizeof(float) * 5 * kStage + list, s,
                 static_cast<const T*>(pts), P, thr, frac, g,
                 static_cast<T*>(grad));
  }
  return 0;
}

template <int K, typename T>
int mask_impl(const void* pts, Params P, int8_t* mask, cudaStream_t s) {
  const dim3 grid = row_grid(P, kWarps * kRowsPerWarp);
  if (P.N <= kRegN) {  // the cloud padded to kRegN points, then the lists
    auto rows = rep_mask<K, kRegN / 32, T>;
    IFDEF_LAUNCH(rows, grid, kWarps * 32,
                 sizeof(float) * (3 * kRegN + kWarps * kList), s,
                 static_cast<const T*>(pts), P, mask);
  } else {  // chunks of kRegN points in static shared memory
    auto rows = rep_mask_chunked<K, T>;
    IFDEF_LAUNCH(rows, grid, kWarps * 32, 0, s, static_cast<const T*>(pts), P,
                 mask);
  }
  return 0;
}

template <typename T>
int masked_fwd_impl(const void* pts, const int8_t* mask, Params P,
                    float* loss, float* row_loss, cudaStream_t s) {
  const long rows = (long)P.B * P.N;
  IFDEF_LAUNCH(rep_masked_fwd<T>, dim3((unsigned)((rows + kWarps - 1) / kWarps)),
               kWarps * 32, 0, s, static_cast<const T*>(pts), mask, P,
               row_loss);
  IFDEF_LAUNCH(rows_to_loss, dim3(P.B), kReduce, 0, s, row_loss, P.N, P.k,
               loss);
  return 0;
}

template <typename T>
int masked_bwd_impl(const void* pts, const int8_t* mask, Params P,
                    const float* g, void* grad, cudaStream_t s) {
  const int stride = slab_stride(P.N);
  IFDEF_LAUNCH(rep_masked_bwd<T>, row_grid(P, kTile), kWarps * 32,
               (size_t)2 * kTile * stride + sizeof(int) * kWarps * kList, s,
               static_cast<const T*>(pts), mask, P, stride, g,
               static_cast<T*>(grad));
  return 0;
}

// k <= 8 is a template parameter (the top-K lives in registers); above, the
// kernels take K = 0 and scan for the threshold with k given at run time
#define IFDEF_DISPATCH_K(k, call)                                            \
  switch (k) {                                                               \
    case 1: return call(1);                                                  \
    case 2: return call(2);                                                  \
    case 3: return call(3);                                                  \
    case 4: return call(4);                                                  \
    case 5: return call(5);                                                  \
    case 6: return call(6);                                                  \
    case 7: return call(7);                                                  \
    case 8: return call(8);                                                  \
    default: return k > 8 ? call(0) : (int)cudaErrorInvalidValue;            \
  }

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B1 forward. pts [B,N,3] f32/bf16 -> loss [B]; thr, frac, row_loss [B,N]
int ifdef_repulsion_fwd(const void* pts, int is_bf16, int B, int N, int k,
                        float radius, float h, float eps, float* loss,
                        float* thr, float* frac, float* row_loss,
                        void* stream) {
  Params P{B, N, k, radius, h, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IFDEF_FWD(K)                                                          \
  (is_bf16 ? fwd_impl<K, __nv_bfloat16>(pts, P, loss, thr, frac, row_loss, s) \
           : fwd_impl<K, float>(pts, P, loss, thr, frac, row_loss, s))
  IFDEF_DISPATCH_K(k, IFDEF_FWD)
#undef IFDEF_FWD
}

// B1 backward. g [B] f32 -> grad [B,N,3] in the points' type
int ifdef_repulsion_bwd(const void* pts, int is_bf16, int B, int N, int k,
                        float radius, float h, float eps, const float* thr,
                        const float* frac, const float* g, void* grad,
                        void* stream) {
  Params P{B, N, k, radius, h, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_impl<__nv_bfloat16>(pts, P, thr, frac, g, grad, s)
                 : bwd_impl<float>(pts, P, thr, frac, g, grad, s);
}

// B2. pts [B,N,3] -> mask int8 [B,N,N]
int ifdef_repulsion_mask(const void* pts, int is_bf16, int B, int N, int k,
                         int8_t* mask, void* stream) {
  Params P{B, N, k, 0.f, 1.f, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IFDEF_MASK(K)                                                        \
  (is_bf16 ? mask_impl<K, __nv_bfloat16>(pts, P, mask, s)                    \
           : mask_impl<K, float>(pts, P, mask, s))
  IFDEF_DISPATCH_K(k, IFDEF_MASK)
#undef IFDEF_MASK
}

// B3 forward. pts [B,N,3], mask int8 [B,N,N] -> loss [B]; row_loss [B,N]
int ifdef_repulsion_masked_fwd(const void* pts, int is_bf16,
                               const int8_t* mask, int B, int N, int k,
                               float radius, float h, float eps, float* loss,
                               float* row_loss, void* stream) {
  Params P{B, N, k, radius, h, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? masked_fwd_impl<__nv_bfloat16>(pts, mask, P, loss, row_loss, s)
             : masked_fwd_impl<float>(pts, mask, P, loss, row_loss, s);
}

// B3 backward. g [B] f32 -> grad [B,N,3] in the points' type
int ifdef_repulsion_masked_bwd(const void* pts, int is_bf16,
                               const int8_t* mask, int B, int N, int k,
                               float radius, float h, float eps,
                               const float* g, void* grad, void* stream) {
  Params P{B, N, k, radius, h, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? masked_bwd_impl<__nv_bfloat16>(pts, mask, P, g, grad, s)
                 : masked_bwd_impl<float>(pts, mask, P, g, grad, s);
}

}  // extern "C"
