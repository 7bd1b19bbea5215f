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
// and above N = 1024, every distance enters the lanes' sorted top-k (a
// branch-free min/max network in registers) instead.
//
// B1 backward (rep_bwd). Bound: issue, one distance per pair. A warp per
// point m, lanes over j; a pair carries weight only where d2 <= max(t_m,
// t_j) (the thresholds sit in shared memory beside the cloud), and those
// pairs go to the list for their row and column weights and coefficient.
//
// B2 (rep_mask): thread per row for the thresholds, then each warp writes
// whole rows of the int8 mask, lanes on consecutive columns; the design of
// its port, bound by the 48 MB it writes at these shapes. Its thresholds sit
// in dynamic shared memory after the cloud, so that the launch asks for
// more than 48 KB at MAX_N (a static array on top of a 48 KB cloud was
// refused).
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
// (up to MAX_N = 4096, where whole slabs would not fit in a block's 227
// KB). Measured slower on the H100: the row side read straight from global
// memory warp by warp with only the column slab staged (with or without
// the words loaded ahead), and the row slab staged by cp.async with the
// column words loaded 8 a thread at once.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;       // B2: thread-per-row blocks
constexpr int kWarps = 8;        // warps per block of the warp-per-row kernels
constexpr int kRowsPerWarp = 4;  // B1: rows (points) a warp takes in turn
constexpr int kRegN = 1024;      // B1 forward keeps distances in registers up to this N
constexpr int kStep = 4;         // B1 backward: 32-partner steps a warp takes at once
constexpr int kList = 64;        // entries of a warp's list of weighted pairs
constexpr int kLoads = 2;        // B3: 16-byte words of a mask row a lane loads at once
constexpr int kTile = 32;        // B3 backward: points m per block
constexpr int kChunk = 1024;     // B3 backward: partners j staged per pass
constexpr int kBatch = 4;        // B3 backward: 16-byte column words a thread loads at once
constexpr int kReduce = 256;
constexpr float kInf = 1e30f;    // B2: an empty top-k entry (the Pallas kernels' _INF)
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

// from a cloud stored point by point (x, y, z)
__device__ __forceinline__ float dist2(const float* s, int i, int j) {
  return d2_of(s[3 * i], s[3 * i + 1], s[3 * i + 2], s[3 * j], s[3 * j + 1],
               s[3 * j + 2]);
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

// the cloud point by point into s[0, 3N)
template <typename T>
__device__ void load_cloud(const T* pts, long b, int N, float* s) {
  const T* p = pts + b * (long)N * 3;
  for (int t = threadIdx.x; t < 3 * N; t += blockDim.x) s[t] = ifdef::load_f(p, t);
  __syncthreads();
}

// the cloud as three coordinate arrays of np >= N entries, zero past N: x in
// s[0, np), y in s[np, 2 np), z in s[2 np, 3 np)
template <typename T>
__device__ void load_cloud_soa(const T* pts, long b, int N, int np, float* s) {
  const T* p = pts + b * (long)N * 3;
#pragma unroll 4
  for (int t = threadIdx.x; t < 3 * N; t += blockDim.x)
    s[(t % 3) * np + t / 3] = ifdef::load_f(p, t);
  for (int t = N + threadIdx.x; t < np; t += blockDim.x)
    s[t] = s[np + t] = s[2 * np + t] = 0.f;
  __syncthreads();
}

// B2: k-th smallest d2 of row i (self excluded), with multiplicity, by one
// thread
template <int K>
__device__ float row_threshold(const float* s, int N, int i) {
  float top[K];
#pragma unroll
  for (int t = 0; t < K; ++t) top[t] = kInf;
  for (int j = 0; j < N; ++j) {
    if (j == i) continue;
    float v = dist2(s, i, j);
    if (v < top[K - 1]) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        float lo = fminf(top[t], v);
        v = fmaxf(top[t], v);
        top[t] = lo;
      }
    }
  }
  return top[K - 1];
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

// B1 forward: warp per row; per-row threshold, tie weight and weighted
// loss. PER > 0: a lane keeps its PER distances in registers (N <= 32 PER,
// the cloud padded to 32 PER points) and selects through the warp's list;
// PER == 0: every distance enters the lanes' top-K and the counting pass
// computes them again.
template <int K, int PER, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_fwd(const T* __restrict__ pts, Params P, float* __restrict__ row_loss,
            float* __restrict__ thr, float* __restrict__ frac) {
  extern __shared__ float s[];
  const int N = P.N, b = blockIdx.y;
  const int np = PER > 0 ? 32 * PER : N;
  load_cloud_soa(pts, b, N, np, s);
  const float *sx = s, *sy = s + np, *sz = s + 2 * np;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* list = s + 3 * np + warp * kList;
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int i = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    if (i >= N) break;
    const float xi = sx[i], yi = sy[i], zi = sz[i];
    float t = 0.f;
    int n_lt = 0, n_eq = 0;
    float s_lt = 0.f, s_eq = 0.f;
    auto tally = [&](float v) {
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
    };
    if constexpr (PER > 0) {
      // the lane's distances, branch-free, and their minimum
      float d[PER];
      float lo[4] = {inf_f(), inf_f(), inf_f(), inf_f()};
#pragma unroll
      for (int c = 0; c < PER; ++c) {
        const int j = 32 * c + lane;
        const float v = d2_of(xi, yi, zi, sx[j], sy[j], sz[j]);
        d[c] = (j < N && j != i) ? v : inf_f();
        lo[c & 3] = fminf(lo[c & 3], d[c]);
      }
      // u, the K-th smallest of the lanes' minima, bounds t from above (K
      // lanes hold a distance <= u): the distances <= u, a few per row, go
      // to the warp's list
      float lane_min[1] = {fminf(fminf(lo[0], lo[1]), fminf(lo[2], lo[3]))};
      const float u = warp_kth<K>(lane_min, lane);
      int n = 0;
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
        // t and the sums from the list alone: it holds every distance <= t
        float a = lane < n ? list[lane] : inf_f();
        float c2 = lane + 32 < n ? list[lane + 32] : inf_f();
        float top[2] = {fminf(a, c2), fmaxf(a, c2)};
        t = warp_kth<K>(top, lane);
        for (int q = lane; q < n; q += 32) tally(list[q]);
      } else {  // more ties at u than the list holds
        float top[K];
#pragma unroll
        for (int c = 0; c < K; ++c) top[c] = inf_f();
#pragma unroll
        for (int c = 0; c < PER; ++c) top_insert(top, d[c]);
        t = warp_kth<K>(top, lane);
#pragma unroll
        for (int c = 0; c < PER; ++c) tally(d[c]);
      }
      __syncwarp();  // the list is read before the next row writes it
    } else {
      float top[K];
#pragma unroll
      for (int c = 0; c < K; ++c) top[c] = inf_f();
      for (int j = lane; j < N; j += 32)
        if (j != i) top_insert(top, d2_of(xi, yi, zi, sx[j], sy[j], sz[j]));
      t = warp_kth<K>(top, lane);
      for (int j = lane; j < N; j += 32)
        if (j != i) tally(d2_of(xi, yi, zi, sx[j], sy[j], sz[j]));
    }
    n_lt = __reduce_add_sync(kFull, n_lt);
    n_eq = __reduce_add_sync(kFull, n_eq);
    s_lt = ifdef::warp_sum(s_lt);
    s_eq = ifdef::warp_sum(s_eq);
    if (lane == 0) {
      const float f = (float)(K - n_lt) / (float)max(n_eq, 1);
      const long r = (long)b * N + i;
      row_loss[r] = s_lt + f * s_eq;
      thr[r] = t;
      frac[r] = f;
    }
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
// coefficient's sqrt, exp and divisions.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    rep_bwd(const T* __restrict__ pts, Params P,
            const float* __restrict__ thr, const float* __restrict__ frac,
            const float* __restrict__ g, T* __restrict__ grad) {
  extern __shared__ float s[];
  const int N = P.N, b = blockIdx.y, np = bwd_points(N);
  float* st = s + 3 * np;
  float* sf = st + np;
  for (int t = threadIdx.x; t < np; t += blockDim.x) {
    st[t] = t < N ? thr[(long)b * N + t] : 0.f;
    sf[t] = t < N ? frac[(long)b * N + t] : 0.f;
  }
  load_cloud_soa(pts, b, N, np, s);
  const float *sx = s, *sy = s + np, *sz = s + 2 * np;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* list = reinterpret_cast<int*>(sf + np) + warp * kList;
  const float gs = 2.f * g[b] / (float)(N * P.k);
  for (int rr = warp; rr < kWarps * kRowsPerWarp; rr += kWarps) {
    const int m = blockIdx.x * (kWarps * kRowsPerWarp) + rr;
    if (m >= N) break;
    const float xm = sx[m], ym = sy[m], zm = sz[m], tm = st[m], fm = sf[m];
    float ax = 0.f, ay = 0.f, az = 0.f;
    int n = 0;  // pairs in the list
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
    for (int j0 = 0; j0 < N; j0 += 32 * kStep) {
      bool cand[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int j = j0 + 32 * u + lane;
        const float v = d2_of(xm, ym, zm, sx[j], sy[j], sz[j]);
        cand[u] = (v <= fmaxf(tm, st[j])) & (j != m) & (j < N);
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const unsigned bal = __ballot_sync(kFull, cand[u]);
        if (bal) {
          if (n + __popc(bal) > kList) drain();
          if (cand[u]) list[n + __popc(bal & lanes_below(lane))] = j0 + 32 * u + lane;
          n += __popc(bal);
          __syncwarp();
        }
      }
    }
    drain();
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

// B2: thresholds thread-per-row, then each warp writes whole rows of the
// int8 mask with consecutive lanes on consecutive columns
template <int K, typename T>
__global__ void rep_mask(const T* __restrict__ pts, Params P,
                         int8_t* __restrict__ mask) {
  extern __shared__ float s[];
  float* ts = s + 3 * P.N;  // dynamic too: with the cloud over 48 KB at MAX_N
  int b = blockIdx.y;
  load_cloud(pts, b, P.N, s);
  int r0 = blockIdx.x * kRows;
  int i = r0 + threadIdx.x;
  if (i < P.N) ts[threadIdx.x] = row_threshold<K>(s, P.N, i);
  __syncthreads();
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < kRows && r0 + rr < P.N; rr += kRows / 32) {
    int row = r0 + rr;
    float t = ts[rr];
    int8_t* out = mask + ((long)b * P.N + row) * P.N;
    for (int j = lane; j < P.N; j += 32)
      out[j] = (j != row && dist2(s, row, j) <= t) ? 1 : 0;
  }
}

// point j of a cloud in global memory, in f32
template <typename T>
__device__ __forceinline__ void point_of(const T* p, int j, float& x, float& y,
                                         float& z) {
  x = ifdef::load_f(p, 3L * j);
  y = ifdef::load_f(p, 3L * j + 1);
  z = ifdef::load_f(p, 3L * j + 2);
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

inline size_t cloud_bytes(const Params& P) { return sizeof(float) * 3 * P.N; }

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
  } else {
    auto rows = rep_fwd<K, 0, T>;
    IFDEF_LAUNCH(rows, grid, kWarps * 32, cloud_bytes(P), s,
                 static_cast<const T*>(pts), P, row_loss, thr, frac);
  }
  IFDEF_LAUNCH(rows_to_loss, dim3(P.B), kReduce, 0, s, row_loss, P.N, P.k,
               loss);
  return 0;
}

template <typename T>
int bwd_impl(const void* pts, Params P, const float* thr, const float* frac,
             const float* g, void* grad, cudaStream_t s) {
  IFDEF_LAUNCH(rep_bwd<T>, row_grid(P, kWarps * kRowsPerWarp), kWarps * 32,
               sizeof(float) * 5 * bwd_points(P.N) + sizeof(int) * kWarps * kList, s,
               static_cast<const T*>(pts), P, thr, frac, g,
               static_cast<T*>(grad));
  return 0;
}

template <int K, typename T>
int mask_impl(const void* pts, Params P, int8_t* mask, cudaStream_t s) {
  auto kern = rep_mask<K, T>;
  IFDEF_LAUNCH(kern, row_grid(P, kRows), kRows,
               cloud_bytes(P) + sizeof(float) * kRows, s,
               static_cast<const T*>(pts), P, mask);
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

// k is a template parameter (the top-K lives in registers); 1 <= k <= 8
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
    default: return (int)cudaErrorInvalidValue;                              \
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
