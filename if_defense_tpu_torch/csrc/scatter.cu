// The ConvONet encoder's two per-cell reductions in a fixed order.
//
// Scatter-mean:
//   out[b, k, c] = (sum over the points n of cloud b with idx[b, n] == k,
//                   in increasing n, of feat[b, n, c]) / count,
// and 0 where no point falls in cell k.
//
// Pooled max (the encoder's pool_local), each point given its cell's max:
//   out[b, n, c] = max over the points m of n's cell of feat[b, m, c],
// and its backward, the gradient of each cell shared evenly among the
// points that equal its max:
//   s = (sum over the cell's points m, in increasing m, of g[b, m, c]),
//   t = (the cell's points m with feat[b, m, c] == max),
//   grad[b, n, c] = (feat[b, n, c] == max ? 1 : 0) * (s / t).
//
// Neither replaces a TPU kernel. The JAX package computes the scatter-mean
// as a one-hot matmul and the pooled max as a masked max over a pairwise
// same-cell mask (if_defense_tpu/ops/scatter.py:20-56), with no scatter,
// so a seeded JAX run repeats. The port's plain versions take torch's
// scatters (`scatter_add_`; `scatter_reduce` amax then `gather`, whose
// backward is a `scatter_add_`), which on the card add with atomics in an
// order that changes from run to run, so two seeded runs of ConvONet-Opt,
// and of ConvONet training, differed. The one-hot and pairwise forms
// would need a [B, N, 32^3] or [B, N, N, C] operand. These kernels take
// each cell's points one after another in point order, which is also the
// order in which the plain versions take them on the CPU (`scatter_add_`
// into zeros; `scatter_reduce` amax keeps the first of equal values): the
// same bits as the plain versions run on a CPU copy, launch after launch.
// The pooled max's backward is the CPU's autograd of its plain version
// written out: `scatter_reduce`'s amax formula (the tie count is the
// points equal to the max, plus 1 where the max is -inf, the fill value
// the plain version starts from) after `gather`'s backward.
//
// Input order: each cloud's CSR (`csrc/csr.cu`, built on the card once for
// a plane index and shared by the calls that read it): cell k's points are
// rows[b, offsets[b, k] .. offsets[b, k + 1]], in increasing point order,
// and the CSR build checks the cells against [0, K). The encoder builds
// one CSR a plane and its four pooled maxes (forward and backward) and its
// scatter-mean read it.
//
// Design: one thread per (cloud, sorted position, channel), channels
// fastest, so a warp shares a position and reads a point's channels
// contiguously. The position's cell is the index of the point it holds,
// and a thread whose position does not start its cell's range returns, so
// the thread at a cell's first position walks the cell in order; only the
// occupied cells are walked. Scatter-mean: that thread adds the cell's
// points' values from 0.0f (as the plain version adds into zeros) and
// divides by their count (IEEE division, as torch's on the CPU); its
// channel-0 thread writes the count to each of the cell's points
// (`counts`, f32), which the backward divides by. Empty cells keep the
// zeros of a memset that the C entry issues before the kernel. Pooled max:
// the forward takes the cell's max (NaN sticks, as in torch's CPU max),
// writes it to each of the cell's points and keeps the tie count at the
// cell's first position (`ties`); the backward adds the cell's output
// gradients from 0.0f, divides by the tie count and writes the quotient,
// times 1 or 0, to each of the cell's points.
//
// Bound: bytes. At the defense's shapes (B = 48, N = 600, C = 32, a 64x64
// plane) the scatter-mean reads 3.7 MB of features and writes 25 MB of
// cells (the zero fill included); for the grid's 32^3 cells, 201 MB. The
// sums themselves are N C adds a cloud. The pooled max writes no cells:
// its forward reads the features and writes as many values, its backward
// reads the output gradient and the features and writes the gradient,
// 3.7 MB each at those shapes, whatever the cells.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The cell range of sorted position j of cloud b when j starts it, else
// false: the cell is the index of the point that j holds.
template <typename I>
__device__ __forceinline__ bool run_at(const I* idx, const int* offs,
                                       const int* rows, int j, int* end) {
  const int cell = static_cast<int>(idx[rows[j]]);
  if (offs[cell] != j) return false;
  *end = offs[cell + 1];
  return true;
}

template <typename I>
__global__ void scatter_mean_kernel(const float* __restrict__ feat,
                                    const I* __restrict__ idx,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ rows, int B,
                                    int N, int C, int K,
                                    float* __restrict__ out,
                                    float* __restrict__ counts) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * N * C) return;
  const int c = static_cast<int>(t % C);
  const long bj = t / C;
  const int j = static_cast<int>(bj % N);
  const int b = static_cast<int>(bj / N);
  const int* rr = rows + static_cast<long>(b) * N;
  const I* ib = idx + static_cast<long>(b) * N;
  int end;
  if (!run_at(ib, offsets + static_cast<long>(b) * (K + 1), rr, j, &end))
    return;
  const float* fb = feat + static_cast<long>(b) * N * C + c;
  float s = 0.0f;
  for (int k = j; k < end; ++k)
    s = __fadd_rn(s, fb[static_cast<long>(rr[k]) * C]);
  const int n = end - j;
  const long cell = static_cast<long>(ib[rr[j]]);
  out[(static_cast<long>(b) * K + cell) * C + c] =
      __fdiv_rn(s, static_cast<float>(n));
  if (c == 0) {
    float* cb = counts + static_cast<long>(b) * N;
    for (int k = j; k < end; ++k) cb[rr[k]] = static_cast<float>(n);
  }
}

template <typename I>
__global__ void pooled_max_kernel(const float* __restrict__ feat,
                                  const I* __restrict__ idx,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ rows, int B, int N,
                                  int C, int K, float* __restrict__ out,
                                  float* __restrict__ ties) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * N * C) return;
  const int c = static_cast<int>(t % C);
  const long bj = t / C;
  const int j = static_cast<int>(bj % N);
  const int b = static_cast<int>(bj / N);
  const int* rr = rows + static_cast<long>(b) * N;
  int end;
  if (!run_at(idx + static_cast<long>(b) * N,
              offsets + static_cast<long>(b) * (K + 1), rr, j, &end))
    return;
  const long base = static_cast<long>(b) * N * C + c;
  float m = __int_as_float(0xff800000);      // -inf
  for (int k = j; k < end; ++k) {
    const float v = feat[base + static_cast<long>(rr[k]) * C];
    m = isnan(v) ? v : (m < v ? v : m);     // torch's CPU max, in order
  }
  // the plain version's fill, -inf, counts where it is the max
  float n = m == __int_as_float(0xff800000) ? 1.0f : 0.0f;
  for (int k = j; k < end; ++k) {
    const long at = base + static_cast<long>(rr[k]) * C;
    n += feat[at] == m ? 1.0f : 0.0f;
    out[at] = m;
  }
  ties[t] = n;
}

template <typename I>
__global__ void pooled_max_backward_kernel(
    const float* __restrict__ grad_out, const float* __restrict__ feat,
    const float* __restrict__ out, const float* __restrict__ ties,
    const I* __restrict__ idx, const int* __restrict__ offsets,
    const int* __restrict__ rows, int B, int N, int C, int K,
    float* __restrict__ grad) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * N * C) return;
  const int c = static_cast<int>(t % C);
  const long bj = t / C;
  const int j = static_cast<int>(bj % N);
  const int b = static_cast<int>(bj / N);
  const int* rr = rows + static_cast<long>(b) * N;
  int end;
  if (!run_at(idx + static_cast<long>(b) * N,
              offsets + static_cast<long>(b) * (K + 1), rr, j, &end))
    return;
  const long base = static_cast<long>(b) * N * C + c;
  float s = 0.0f;
  for (int k = j; k < end; ++k)
    s = __fadd_rn(s, grad_out[base + static_cast<long>(rr[k]) * C]);
  const float q = __fdiv_rn(s, ties[t]);
  const float m = out[base + static_cast<long>(rr[j]) * C];
  for (int k = j; k < end; ++k) {
    const long at = base + static_cast<long>(rr[k]) * C;
    grad[at] = __fmul_rn(feat[at] == m ? 1.0f : 0.0f, q);
  }
}

inline long blocks_for(long total) {
  return (total + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat [B,N,C] f32; idx [B,N] the cells the CSR was built from (int64
// where idx64 is 1, int32 where 0); offsets [B,K+1], rows [B,N] i32 its
// CSR (`ifdef_csr_build`); out [B,K,C] f32, every cell written (0 where
// empty, by a memset); counts [B,N] f32: the points of each point's cell.
int ifdef_scatter_mean(const float* feat, const void* idx, int idx64,
                       const int* offsets, const int* rows, int B, int N,
                       int C, int K, float* out, float* counts,
                       void* stream) {
  const long total = static_cast<long>(B) * N * C;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(B) * K * C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total == 0) return 0;
  const long blocks = blocks_for(total);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  if (idx64)
    scatter_mean_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, static_cast<const int64_t*>(idx), offsets, rows, B, N, C, K,
        out, counts);
  else
    scatter_mean_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, static_cast<const int*>(idx), offsets, rows, B, N, C, K, out,
        counts);
  return ifdef::last_error();
}

// feat [B,N,C] f32; idx [B,N] the cells the CSR was built from (int64
// where idx64 is 1, int32 where 0); offsets [B,K+1], rows [B,N] i32 its
// CSR; out [B,N,C] f32, each point's cell max; ties [B,N,C] f32, at each
// cell's first sorted position the tie count the backward divides by
// (other entries unset).
int ifdef_pooled_max(const float* feat, const void* idx, int idx64,
                     const int* offsets, const int* rows, int B, int N, int C,
                     int K, float* out, float* ties, void* stream) {
  const long total = static_cast<long>(B) * N * C;
  if (total == 0) return 0;
  const long blocks = blocks_for(total);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    pooled_max_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, static_cast<const int64_t*>(idx), offsets, rows, B, N, C, K,
        out, ties);
  else
    pooled_max_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        feat, static_cast<const int*>(idx), offsets, rows, B, N, C, K, out,
        ties);
  return ifdef::last_error();
}

// grad_out, feat, out [B,N,C] f32; ties as the forward left it; idx,
// offsets, rows as the forward took them; grad [B,N,C] f32, every entry
// written.
int ifdef_pooled_max_backward(const float* grad_out, const float* feat,
                              const float* out, const float* ties,
                              const void* idx, int idx64, const int* offsets,
                              const int* rows, int B, int N, int C, int K,
                              float* grad, void* stream) {
  const long total = static_cast<long>(B) * N * C;
  if (total == 0) return 0;
  const long blocks = blocks_for(total);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    pooled_max_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(grad_out, feat, out, ties,
                                      static_cast<const int64_t*>(idx),
                                      offsets, rows, B, N, C, K, grad);
  else
    pooled_max_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(grad_out, feat, out, ties,
                                      static_cast<const int*>(idx), offsets,
                                      rows, B, N, C, K, grad);
  return ifdef::last_error();
}

}  // extern "C"
