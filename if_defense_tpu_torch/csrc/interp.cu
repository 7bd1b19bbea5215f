// The ConvONet decoder's plane features in one launch (kernel B4):
//   out[b, q] = sum over the planes k, in order, of bilinear(plane_k[b], uv_k)
//   uv_k = clamp(p[b, q, axes_k] * inv_scale + 0.5, 0, hi)
// with inv_scale = 1 / (1 + padding + 1e-5) and hi = 1 - 1e-5, and the
// bilinear sample of the planes' port: x = u (W - 1), y = v (H - 1),
// align_corners, border clamp, x -> W, y -> H.
//
// Replaces the Pallas kernel `fused_bilinear_plane_sample` of
// if_defense_tpu/ops/pallas_interp.py:233 (_fwd_kernel:62, _bwd_kernel:74),
// which the JAX decoder calls once per plane after `normalize_coordinate`.
// The TPU kernel expands two-hot selectors into matmuls for its matrix unit;
// here each query is a direct 4-corner gather and lerp per plane, and the
// projection, normalisation and sum over the planes are inside the launch.
//
// The uv form (plane_sample): one plane and coordinates already normalised,
//   out[b, q] = bilinear(plane[b], clamp(uv[b, q], 0, 1)),  uv [B, Q, 2],
// the form the Pallas kernel itself has. It runs the same three kernels
// with a point row of 2 in place of 3, the projection taken as the identity
// (axes 0 and 1, scale 1, shift 0) and the clamp's top at 1: the same
// roundings as the plain `bilinear_plane_sample`.
//
// Channels: a lane moves 16 bytes of a corner row where C is a multiple of
// 16 bytes' worth (4 f32, 8 bf16) and every row pointer is 16-byte aligned;
// otherwise it moves one channel at a time (the scalar path, any C), with
// the same arithmetic per channel.
//
// Layout: p [B, Q, 3], planes [B, H, W, C] (one pointer each, never
// stacked), out [B, Q, C], all f32 or all bf16; math in f32. The
// normalisation multiplies by inv_scale, as torch's CUDA division by a
// Python scalar does (its reciprocal taken in double and rounded to f32
// once; the wrapper passes that constant), and the lerps round after every
// product and sum in the order of the plain composition (no contraction
// into fused multiply-adds): in f32 the forward gives the plain composition's
// bits on the card. A coordinate one bit off would move a sample by (R - 1)
// ulps of the cell times the difference of its corners.
//
// Bound: bytes. At the defense's shapes (B=48, Q=1024, three 64x64x32 f32
// planes) a forward reads the corner rows it touches (128 bytes each; up to
// 75 MB of planes, more than the 50 MB L2) and writes 6 MB; a query's cell
// is a few dozen operations against 1.5 KB of corner rows. What the design
// does about it:
// - A group of 8 lanes takes a query (4 queries a warp) and each lane moves
//   16 bytes of a corner row at once (a float4 of f32, 8 bf16): a 128-byte
//   row is one group instruction, and a lane has the 12 corner loads of three
//   planes in flight together.
// - A block takes 32 queries of one cloud, the cloud from blockIdx.y: no
//   64-bit division. p is read once (12 bytes) for every plane, and each
//   plane's cell (clamps, floors, corner offsets in 32 bits) once a query.
// - One launch forward and one per gradient asked for, in place of three
//   per-plane launches each way and the torch ops of the normalisation and
//   the sum around them: in the defense's host-paced loop launches cost more
//   than bytes.
//
// Gradient to p (the defense, planes frozen; features_dp): per plane
//   du = (W-1) sum_c g (col1 - col0),  dv = (H-1) sum_c g [(1-wx)(f10-f00) +
//   wx(f11-f01)], col0 = (1-wy) f00 + wy f10, col1 = (1-wy) f01 + wy f11,
// reduced over the 8-lane group in 3 shuffle steps, zero where the
// normalisation's clamp holds the coordinate (torch's clamp passes the
// gradient for 0 <= u <= hi inclusive), times inv_scale, and added into
// dp's two axes in plane order; written once. Deterministic.
//
// Gradient to the planes (training; features_dplane): a block per (band of
// rows, cloud, plane asked for) accumulates its band, [rows, W, C] f32, in
// shared memory (64 KB: 8 rows of 64 x 32). It scans the cloud's queries
// 2048 at a time, 4 a thread with their loads in flight together; ballots
// rank, in query
// order, those whose corners touch the band; they are listed with their
// corners' accumulator offsets and weights, their g rows staged 64 at a
// time, and each warp adds into the columns it owns (x mod 16 == warp), a
// query at a time in list order with its lanes over the channels, finding
// its own entries 32 at a time by ballot. So every cell's sum has one
// order and no atomics are needed; each cell is written once, zeros
// included (no fill), in the planes' type (bf16 accumulates in f32 and is
// cast once). Where a corner clips onto its neighbour at the border the two
// weights land on one cell and add; a query clamped from outside still
// feeds its border cells. Deterministic. Bound: bytes, the planes'
// gradients written once (50 MB at the training shapes); what holds it back
// is each block's chain of scans, barriers and list walks. Measured slower
// at the training shapes: 256 queries scanned a pass; every warp walking
// every entry; bands of 1, 2 or 4 rows; 8 warps a block in place of 16;
// adds by shared atomics in a fixed order; the plane's axes indexed at run
// time in the kernel's parameters (which copies them to each thread's
// stack).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kGroup = 8;                     // lanes a query
constexpr int kQueries = kThreads / kGroup;   // queries a block (forward, dp)
constexpr int kDWarps = 16;                   // dplane: warps a block
constexpr int kDThreads = 32 * kDWarps;
constexpr int kPerThread = 64 / kDWarps;      // dplane: queries a thread scans
constexpr int kSpan = kDThreads * kPerThread; // dplane: queries a block scans at once
constexpr int kStageQ = 64;                   // dplane: g rows staged at once
constexpr int kList = 256;                    // dplane: entries listed at once
constexpr int kBandBytes = 64 * 1024;         // dplane: the band's f32 accumulator
constexpr unsigned kFull = 0xffffffffu;

struct Planes {
  const void* f[kMaxPlanes];   // [B, H, W, C]
  void* df[kMaxPlanes];        // their gradients (dplane), null if not asked
  int ax[kMaxPlanes], ay[kMaxPlanes];  // p's axes on x (-> W) and y (-> H)
  int gk[kMaxPlanes];          // dplane: blockIdx.z -> plane
  int n, B, Q, H, W, C;
  int dim;                     // a point row: 3 (p form) or 2 (uv form)
  float inv_scale, shift, hi;  // u = clamp(c inv_scale + shift, 0, hi)
};

// N elements of T as floats: 16 bytes at once (4 f32, 8 bf16), or one
template <typename T, int N>
struct Vec;

template <>
struct Vec<float, 4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  float v[8];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[2 * e] = f.x, v[2 * e + 1] = f.y;
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
struct Vec<T, 1> {
  float v[1];
  __device__ __forceinline__ void load(const T* p) { v[0] = ifdef::load_f(p, 0); }
  __device__ __forceinline__ void store(T* p) const { ifdef::store_f(p, 0, v[0]); }
};

struct Cell {
  int o00, o01, o10, o11;  // element offsets of the corner rows in a cloud's plane
  float wx, wy;
  bool in_u, in_v;         // inside the normalisation's clamp (gradient passes)
};

__device__ __forceinline__ float axis(const float (&pt)[3], int a) {
  return a == 0 ? pt[0] : (a == 1 ? pt[1] : pt[2]);
}

// One axis of a plane's cell, with the rounding of the plain composition:
// u = clamp(c * inv_scale + shift, 0, hi), x = u (R - 1); the corners i0 <=
// i1 (border clamp), the weight w = x - floor(x), and whether the clamp
// passes the gradient.
__device__ __forceinline__ void axis_cell(float coord, int R, const Planes& P,
                                          int& i0, int& i1, float& w,
                                          bool& in) {
  float u = __fadd_rn(__fmul_rn(coord, P.inv_scale), P.shift);
  in = (u >= 0.f) && (u <= P.hi);
  u = fminf(fmaxf(u, 0.f), P.hi);
  const float x = __fmul_rn(u, (float)(R - 1));
  const float x0 = floorf(x);
  w = __fsub_rn(x, x0);
  i0 = min(max((int)x0, 0), R - 1);
  i1 = min(max((int)x0 + 1, 0), R - 1);
}

// plane k's cell of a query at pt
__device__ __forceinline__ Cell cell_of(const float (&pt)[3], int k,
                                        const Planes& P) {
  Cell c;
  int x0, x1, y0, y1;
  axis_cell(axis(pt, P.ax[k]), P.W, P, x0, x1, c.wx, c.in_u);
  axis_cell(axis(pt, P.ay[k]), P.H, P, y0, y1, c.wy, c.in_v);
  c.o00 = (y0 * P.W + x0) * P.C;
  c.o01 = (y0 * P.W + x1) * P.C;
  c.o10 = (y1 * P.W + x0) * P.C;
  c.o11 = (y1 * P.W + x1) * P.C;
  return c;
}

template <typename T>
__device__ __forceinline__ void point_at(const T* p, long row, int dim,
                                         float (&pt)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    pt[a] = a < dim ? ifdef::load_f(p, dim * row + a) : 0.f;
}

__device__ __forceinline__ float lerp2(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// Forward: a group of 8 lanes a query, a lane 16 bytes of each corner row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    features_fwd(const T* __restrict__ p, Planes P, T* __restrict__ out) {
  const int b = blockIdx.y, l = threadIdx.x % kGroup;
  const int q = blockIdx.x * kQueries + threadIdx.x / kGroup;
  if (q >= P.Q) return;
  const long row = (long)b * P.Q + q;
  const long base = (long)b * P.H * P.W * P.C;
  float pt[3];
  point_at(p, row, P.dim, pt);
  Cell cell[kMaxPlanes];
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k)
    if (k < P.n) cell[k] = cell_of(pt, k, P);
  for (int c0 = l * V; c0 < P.C; c0 += kGroup * V) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (k >= P.n) break;
      const T* f = static_cast<const T*>(P.f[k]) + base + c0;
      const Cell& c = cell[k];
      Vec<T, V> f00, f01, f10, f11;
      f00.load(f + c.o00);
      f01.load(f + c.o01);
      f10.load(f + c.o10);
      f11.load(f + c.o11);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float col0 = lerp2(f00.v[e], f10.v[e], c.wy);
        const float col1 = lerp2(f01.v[e], f11.v[e], c.wy);
        acc[e] = __fadd_rn(acc[e], lerp2(col0, col1, c.wx));
      }
    }
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = acc[e];
    o.store(out + row * P.C + c0);
  }
}

// Gradient to p: the forward's layout; the group's partial sums reduce in
// 3 shuffle steps, and the group's first lane writes dp's row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    features_dp(const T* __restrict__ p, Planes P, const T* __restrict__ g,
                T* __restrict__ dp) {
  const int b = blockIdx.y, l = threadIdx.x % kGroup;
  const int q = blockIdx.x * kQueries + threadIdx.x / kGroup;
  const bool valid = q < P.Q;  // every lane takes part in the shuffles
  const long row = (long)b * P.Q + q;
  const long base = (long)b * P.H * P.W * P.C;
  float pt[3] = {0.f, 0.f, 0.f};
  if (valid) point_at(p, row, P.dim, pt);
  Cell cell[kMaxPlanes];
  float su[kMaxPlanes], sv[kMaxPlanes];
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    su[k] = sv[k] = 0.f;
    if (k < P.n) cell[k] = cell_of(pt, k, P);
  }
  for (int c0 = l * V; valid && c0 < P.C; c0 += kGroup * V) {
    Vec<T, V> gv;
    gv.load(g + row * P.C + c0);
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (k >= P.n) break;
      const T* f = static_cast<const T*>(P.f[k]) + base + c0;
      const Cell& c = cell[k];
      Vec<T, V> f00, f01, f10, f11;
      f00.load(f + c.o00);
      f01.load(f + c.o01);
      f10.load(f + c.o10);
      f11.load(f + c.o11);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float col0 = lerp2(f00.v[e], f10.v[e], c.wy);
        const float col1 = lerp2(f01.v[e], f11.v[e], c.wy);
        su[k] += gv.v[e] * (col1 - col0);
        sv[k] += gv.v[e] * lerp2(f10.v[e] - f00.v[e], f11.v[e] - f01.v[e], c.wx);
      }
    }
  }
  float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      su[k] += __shfl_xor_sync(kFull, su[k], off);
      sv[k] += __shfl_xor_sync(kFull, sv[k], off);
    }
    if (k >= P.n) continue;
    const Cell& c = cell[k];
    const float du = c.in_u ? su[k] * (float)(P.W - 1) * P.inv_scale : 0.f;
    const float dv = c.in_v ? sv[k] * (float)(P.H - 1) * P.inv_scale : 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (P.ax[k] == a) d[a] += du;
      if (P.ay[k] == a) d[a] += dv;
    }
  }
  if (valid && l == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if (a < P.dim) ifdef::store_f(dp, P.dim * row + a, d[a]);
  }
}

// a listed query of a dplane band: its index, its corner columns, the
// accumulator offsets of its corners (x0, y0), (x0, y1), (x1, y0), (x1, y1)
// (-1 outside the band), and its weights
struct Entry {
  int q, x0, x1;
  int o[4];
  float rx, wx, ry, wy;
};

// a[k] with k known only at run time, without indexing the parameter space
// (which would copy the parameters to each thread's stack)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[kMaxPlanes], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

// rows of a dplane band
inline int band_rows(int H, int W, int C) {
  const int r = kBandBytes / (int)(sizeof(float) * W * C);
  return r < 1 ? 1 : (r > H ? H : r);
}

inline size_t dplane_smem(int rows, int W, int C) {
  return sizeof(float) * ((size_t)rows * W * C + (size_t)kStageQ * C) +
         sizeof(Entry) * kList;
}

// Gradient to the planes: a block per (band of `rows` rows, cloud, plane
// asked for); see the head of the file. The block takes the cloud's queries
// kSpan at a time, query s0 + u kDThreads + t to thread t (coalesced loads,
// all in flight together); ballots rank the queries that touch the band in
// query order, and the ranked entries are listed kList at a time.
template <typename T, int V>
__global__ void __launch_bounds__(kDThreads)
    features_dplane(const T* __restrict__ p, Planes P,
                    const T* __restrict__ g, int rows) {
  constexpr int kRanks = kPerThread * kDWarps;
  static_assert(kRanks == 64, "the rank scan takes two counts a lane");
  extern __shared__ float smem[];
  __shared__ int counts[kRanks], base[kRanks + 1];  // (u, warp) order
  const int k = pick(P.gk, blockIdx.z), b = blockIdx.y;
  const int ax = pick(P.ax, k), ay = pick(P.ay, k);
  const int r0 = blockIdx.x * rows, rn = min(rows, P.H - r0);
  const int W = P.W, C = P.C, band = rn * W * C;
  float* acc = smem;                               // [rn, W, C]
  float* gs = acc + (size_t)rows * W * C;          // [kStageQ, C]
  Entry* list = reinterpret_cast<Entry*>(gs + (size_t)kStageQ * C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const T* pb = p + (long)b * P.Q * P.dim;
  for (int t = threadIdx.x; t < band; t += kDThreads) acc[t] = 0.f;
  for (int s0 = 0; s0 < P.Q; s0 += kSpan) {
    // the thread's queries: the plane's two coordinates, and which touch
    // the band
    float cx[kPerThread], cy[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int q = s0 + u * kDThreads + threadIdx.x;
      cx[u] = q < P.Q ? ifdef::load_f(pb, (long)P.dim * q + ax) : 0.f;
      cy[u] = q < P.Q ? ifdef::load_f(pb, (long)P.dim * q + ay) : 0.f;
    }
    unsigned hits[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      int y0, y1;
      float wy;
      bool in;
      axis_cell(cy[u], P.H, P, y0, y1, wy, in);
      y0 -= r0, y1 -= r0;
      hits[u] = __ballot_sync(
          kFull, s0 + u * kDThreads + (int)threadIdx.x < P.Q &&
                     ((y0 >= 0 && y0 < rn) || (y1 >= 0 && y1 < rn)));
      if (lane == 0) counts[u * kDWarps + warp] = __popc(hits[u]);
    }
    __syncthreads();  // also: the previous span's ranks have been read
    if (warp == 0) {  // exclusive scan of the 64 counts
      const int c0 = counts[2 * lane], c1 = counts[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      base[2 * lane] = incl - c0 - c1;
      base[2 * lane + 1] = incl - c1;
      if (lane == 31) base[kRanks] = incl;
    }
    __syncthreads();
    const int total = base[kRanks];
    for (int w0 = 0; w0 < total; w0 += kList) {
      __syncthreads();  // the previous window has been read
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        if (!((hits[u] >> lane) & 1u)) continue;
        const int r = base[u * kDWarps + warp] + __popc(hits[u] & below) - w0;
        if (r >= 0 && r < kList) {
          Entry e;
          int y0, y1;
          bool in;
          e.q = s0 + u * kDThreads + threadIdx.x;
          axis_cell(cx[u], W, P, e.x0, e.x1, e.wx, in);
          axis_cell(cy[u], P.H, P, y0, y1, e.wy, in);
          y0 -= r0, y1 -= r0;
          const bool in0 = y0 >= 0 && y0 < rn, in1 = y1 >= 0 && y1 < rn;
          e.o[0] = in0 ? (y0 * W + e.x0) * C : -1;
          e.o[1] = in1 ? (y1 * W + e.x0) * C : -1;
          e.o[2] = in0 ? (y0 * W + e.x1) * C : -1;
          e.o[3] = in1 ? (y1 * W + e.x1) * C : -1;
          e.rx = __fsub_rn(1.f, e.wx);
          e.ry = __fsub_rn(1.f, e.wy);
          list[r] = e;
        }
      }
      const int wn = min(kList, total - w0);
      for (int e0 = 0; e0 < wn; e0 += kStageQ) {
        const int en = min(kStageQ, wn - e0);
        __syncthreads();  // the list is written, the previous g rows read
        for (int t = threadIdx.x; t < en * (C / V); t += kDThreads) {
          const int i = t / (C / V), c0 = (t % (C / V)) * V;
          Vec<T, V> gv;
          gv.load(g + ((long)b * P.Q + list[e0 + i].q) * C + c0);
#pragma unroll
          for (int x = 0; x < V; ++x) gs[i * C + c0 + x] = gv.v[x];
        }
        __syncthreads();
        // warp `warp` owns the columns x with x mod kDWarps == warp; it
        // finds its entries 32 at a time by ballot and takes them in order
        for (int i0 = 0; i0 < en; i0 += 32) {
          bool own0 = false, own1 = false;
          if (i0 + lane < en) {
            const Entry& e = list[e0 + i0 + lane];
            own0 = e.x0 % kDWarps == warp;
            own1 = e.x1 % kDWarps == warp;
          }
          const unsigned m0 = __ballot_sync(kFull, own0);
          const unsigned m1 = __ballot_sync(kFull, own1);
          for (unsigned m = m0 | m1; m; m &= m - 1) {
            const int bit = __ffs(m) - 1, i = i0 + bit;
            const Entry& e = list[e0 + i];
            for (int c = lane; c < C; c += 32) {
              const float gv = gs[i * C + c];
              if ((m0 >> bit) & 1u) {
                const float g0 = __fmul_rn(gv, e.rx);
                if (e.o[0] >= 0) acc[e.o[0] + c] += __fmul_rn(g0, e.ry);
                if (e.o[1] >= 0) acc[e.o[1] + c] += __fmul_rn(g0, e.wy);
              }
              if ((m1 >> bit) & 1u) {
                const float g1 = __fmul_rn(gv, e.wx);
                if (e.o[2] >= 0) acc[e.o[2] + c] += __fmul_rn(g1, e.ry);
                if (e.o[3] >= 0) acc[e.o[3] + c] += __fmul_rn(g1, e.wy);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the span's list has been read
  }
  T* out = static_cast<T*>(pick(P.df, k)) + ((long)b * P.H + r0) * W * C;
  for (int t = threadIdx.x * V; t < band; t += kDThreads * V) {
    Vec<T, V> o;
#pragma unroll
    for (int x = 0; x < V; ++x) o.v[x] = acc[t + x];
    o.store(out + t);
  }
}

Planes planes_of(const void* const* planes, const int* axes, int n, int B,
                 int Q, int H, int W, int C, float inv_scale, float hi) {
  Planes P{};
  for (int k = 0; k < n; ++k) {
    P.f[k] = planes[k];
    P.ax[k] = axes[2 * k];
    P.ay[k] = axes[2 * k + 1];
  }
  P.n = n, P.B = B, P.Q = Q, P.H = H, P.W = W, P.C = C;
  P.dim = 3;
  P.inv_scale = inv_scale, P.shift = 0.5f, P.hi = hi;
  return P;
}

// the uv form: one plane, coordinates (x, y) = uv's two columns, identity
// projection, clamp to [0, 1]
Planes plane_of(const void* plane, int B, int Q, int H, int W, int C) {
  const int axes[2] = {0, 1};
  Planes P = planes_of(&plane, axes, 1, B, Q, H, W, C, 1.f, 1.f);
  P.dim = 2;
  P.shift = 0.f;
  return P;
}

// what the kernels take: 1-3 planes, axes in [0, 3), a plane row that fits
// the plane gradient's shared memory (227 KB)
bool takes(const Planes& P) {
  if (P.n < 1 || P.n > kMaxPlanes || P.H < 1 || P.W < 1 || P.C < 1) return false;
  for (int k = 0; k < P.n; ++k)
    if (P.ax[k] < 0 || P.ax[k] > 2 || P.ay[k] < 0 || P.ay[k] > 2) return false;
  return dplane_smem(1, P.W, P.C) <= 232448;
}

// 16-byte moves: whole 16-byte words of channels, every row pointer aligned
bool wide(const Planes& P, int bf16, const void* a, const void* b) {
  bool ok = P.C % (bf16 ? 8 : 4) == 0;
  auto al = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  for (int k = 0; k < P.n; ++k)
    ok = ok && al(P.f[k]) && (!P.df[k] || al(P.df[k]));
  return ok && (!a || al(a)) && (!b || al(b));
}

dim3 query_grid(const Planes& P) {
  return dim3((unsigned)((P.Q + kQueries - 1) / kQueries), (unsigned)P.B);
}

template <typename T, int V>
int fwd_impl(const void* p, const Planes& P, void* out, cudaStream_t s) {
  features_fwd<T, V><<<query_grid(P), kThreads, 0, s>>>(
      static_cast<const T*>(p), P, static_cast<T*>(out));
  return ifdef::last_error();
}

template <typename T, int V>
int dp_impl(const void* p, const Planes& P, const void* g, void* dp,
            cudaStream_t s) {
  features_dp<T, V><<<query_grid(P), kThreads, 0, s>>>(
      static_cast<const T*>(p), P, static_cast<const T*>(g),
      static_cast<T*>(dp));
  return ifdef::last_error();
}

template <typename T, int V>
int dplane_impl(const void* p, const Planes& P, const void* g, int nz,
                cudaStream_t s) {
  const int rows = band_rows(P.H, P.W, P.C);
  const size_t smem = dplane_smem(rows, P.W, P.C);
  auto kern = features_dplane<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((P.H + rows - 1) / rows), (unsigned)P.B,
                  (unsigned)nz);
  kern<<<grid, kDThreads, smem, s>>>(static_cast<const T*>(p), P,
                                    static_cast<const T*>(g), rows);
  return ifdef::last_error();
}

// the launch for the type of p and the planes and the width of the moves
#define IFDEF_TYPE(bf16, vec, impl, ...)                                      \
  (bf16 ? (vec ? impl<__nv_bfloat16, 8>(__VA_ARGS__)                          \
               : impl<__nv_bfloat16, 1>(__VA_ARGS__))                         \
        : (vec ? impl<float, 4>(__VA_ARGS__) : impl<float, 1>(__VA_ARGS__)))

int run_fwd(const void* p, int bf16, const Planes& P, void* out,
            void* stream) {
  if (!takes(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return IFDEF_TYPE(bf16, wide(P, bf16, out, nullptr), fwd_impl, p, P, out, s);
}

int run_dp(const void* p, int bf16, const Planes& P, const void* g, void* dp,
           void* stream) {
  if (!takes(P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return IFDEF_TYPE(bf16, wide(P, bf16, g, nullptr), dp_impl, p, P, g, dp, s);
}

int run_dplane(const void* p, int bf16, Planes P, const void* g,
               void* const* dplanes, void* stream) {
  if (!takes(P)) return (int)cudaErrorInvalidValue;
  int nz = 0;
  for (int k = 0; k < P.n; ++k) {
    P.df[k] = dplanes[k];
    if (dplanes[k]) P.gk[nz++] = k;
  }
  if (nz == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return IFDEF_TYPE(bf16, wide(P, bf16, g, nullptr), dplane_impl, p, P, g,
                    nz, s);
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p [B,Q,3] and planes: n pointers to [B,H,W,C], all bf16 if bf16 else
// f32; axes: n pairs (x axis, y axis) of p -> out [B,Q,C] in that type
int ifdef_plane_features_fwd(const void* p, int bf16,
                             const void* const* planes, const int* axes,
                             int n, int B, int Q, int H, int W,
                             int C, float inv_scale, float hi, void* out,
                             void* stream) {
  return run_fwd(p, bf16, planes_of(planes, axes, n, B, Q, H, W, C, inv_scale, hi),
             out, stream);
}

// g [B,Q,C] -> dp [B,Q,3]
int ifdef_plane_features_dp(const void* p, int bf16,
                            const void* const* planes, const int* axes, int n,
                            int B, int Q, int H, int W, int C,
                            float inv_scale, float hi, const void* g, void* dp,
                            void* stream) {
  return run_dp(p, bf16, planes_of(planes, axes, n, B, Q, H, W, C, inv_scale, hi),
              g, dp, stream);
}

// g [B,Q,C] -> dplanes[k] [B,H,W,C] for each k whose pointer is not null;
// every cell of those is written
int ifdef_plane_features_dplane(const void* p, int bf16,
                                const void* const* planes, const int* axes,
                                int n, int B, int Q, int H, int W,
                                int C, float inv_scale, float hi,
                                const void* g, void* const* dplanes,
                                void* stream) {
  return run_dplane(p, bf16,
                planes_of(planes, axes, n, B, Q, H, W, C, inv_scale, hi), g,
                dplanes, stream);
}

// the uv form: uv [B,Q,2] and plane [B,H,W,C], both bf16 if bf16 else f32
// -> out [B,Q,C] in that type
int ifdef_plane_sample_fwd(const void* uv, int bf16, const void* plane, int B,
                           int Q, int H, int W, int C, void* out,
                           void* stream) {
  return run_fwd(uv, bf16, plane_of(plane, B, Q, H, W, C), out, stream);
}

// g [B,Q,C] -> duv [B,Q,2]
int ifdef_plane_sample_duv(const void* uv, int bf16, const void* plane, int B,
                           int Q, int H, int W, int C, const void* g,
                           void* duv, void* stream) {
  return run_dp(uv, bf16, plane_of(plane, B, Q, H, W, C), g, duv, stream);
}

// g [B,Q,C] -> dplane [B,H,W,C], every cell written
int ifdef_plane_sample_dplane(const void* uv, int bf16, const void* plane,
                              int B, int Q, int H, int W, int C,
                              const void* g, void* dplane_out, void* stream) {
  void* d[kMaxPlanes] = {dplane_out, nullptr, nullptr};
  return run_dplane(uv, bf16, plane_of(plane, B, Q, H, W, C), g, d, stream);
}

}  // extern "C"
