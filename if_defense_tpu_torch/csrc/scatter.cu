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
// Input order: the wrapper sorts each cloud's cell indices with a stable
// sort (`torch.sort(stable=True)`, deterministic), so `sorted_idx[b]` is
// ascending and, within a run of equal cells, `perm[b]` holds the points'
// positions in increasing order. The pooled max's forward and backward
// share one sort.
//
// Design: one thread per (cloud, sorted position, channel), channels
// fastest, so a warp shares a position and reads a point's channels
// contiguously. A thread whose position does not start a run of equal
// cells returns; the thread at a run's start walks the run in order.
// Scatter-mean: it adds its points' values from 0.0f (as the plain version
// adds into zeros) and divides by the run's length (IEEE division, as
// torch's on the CPU); its channel-0 thread writes the run's length to
// each of the run's points (`counts`, f32), which the backward divides by.
// Empty cells keep the zeros the wrapper's output was filled with. Pooled
// max: the forward takes the run's max (NaN sticks, as in torch's CPU
// max), writes it to each of the run's points and keeps the tie count at
// the run's start (`ties`, by sorted position); the backward adds the
// run's output gradients from 0.0f, divides by the tie count and writes
// the quotient, times 1 or 0, to each of the run's points.
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

// Whether sorted position j starts a run of equal cells. A cell outside
// [0, K) is a fault of the caller, as in scatter_add_'s device assert: it
// stops the kernel without a host sync in the wrapper.
__device__ __forceinline__ bool run_start(const int* row, int j, int K) {
  const int cell = row[j];
  if (cell < 0 || cell >= K) __trap();
  return j == 0 || row[j - 1] != cell;
}

__global__ void scatter_mean_kernel(const float* __restrict__ feat,
                                    const int* __restrict__ sorted_idx,
                                    const int* __restrict__ perm, int B,
                                    int N, int C, int K,
                                    float* __restrict__ out,
                                    float* __restrict__ counts) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * N * C) return;
  const int c = static_cast<int>(t % C);
  const long bj = t / C;
  const int j = static_cast<int>(bj % N);
  const int b = static_cast<int>(bj / N);
  const int* row = sorted_idx + static_cast<long>(b) * N;
  const int* prow = perm + static_cast<long>(b) * N;
  if (!run_start(row, j, K)) return;
  const int cell = row[j];
  const float* fb = feat + static_cast<long>(b) * N * C + c;
  float s = 0.0f;
  int k = j;
  for (; k < N && row[k] == cell; ++k)
    s = __fadd_rn(s, fb[static_cast<long>(prow[k]) * C]);
  const int n = k - j;
  out[(static_cast<long>(b) * K + cell) * C + c] =
      __fdiv_rn(s, static_cast<float>(n));
  if (c == 0) {
    float* cb = counts + static_cast<long>(b) * N;
    for (int m = j; m < k; ++m) cb[prow[m]] = static_cast<float>(n);
  }
}

__global__ void pooled_max_kernel(const float* __restrict__ feat,
                                  const int* __restrict__ sorted_idx,
                                  const int* __restrict__ perm, int B, int N,
                                  int C, int K, float* __restrict__ out,
                                  float* __restrict__ ties) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * N * C) return;
  const int c = static_cast<int>(t % C);
  const long bj = t / C;
  const int j = static_cast<int>(bj % N);
  const int b = static_cast<int>(bj / N);
  const int* row = sorted_idx + static_cast<long>(b) * N;
  const int* prow = perm + static_cast<long>(b) * N;
  if (!run_start(row, j, K)) return;
  const int cell = row[j];
  const long base = static_cast<long>(b) * N * C + c;
  int end = j;
  float m = __int_as_float(0xff800000);      // -inf
  for (; end < N && row[end] == cell; ++end) {
    const float v = feat[base + static_cast<long>(prow[end]) * C];
    m = isnan(v) ? v : (m < v ? v : m);     // torch's CPU max, in order
  }
  // the plain version's fill, -inf, counts where it is the max
  float n = m == __int_as_float(0xff800000) ? 1.0f : 0.0f;
  for (int k = j; k < end; ++k) {
    const long at = base + static_cast<long>(prow[k]) * C;
    n += feat[at] == m ? 1.0f : 0.0f;
    out[at] = m;
  }
  ties[bj * C + c] = n;
}

__global__ void pooled_max_backward_kernel(
    const float* __restrict__ grad_out, const float* __restrict__ feat,
    const float* __restrict__ out, const float* __restrict__ ties,
    const int* __restrict__ sorted_idx, const int* __restrict__ perm, int B,
    int N, int C, int K, float* __restrict__ grad) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * N * C) return;
  const int c = static_cast<int>(t % C);
  const long bj = t / C;
  const int j = static_cast<int>(bj % N);
  const int b = static_cast<int>(bj / N);
  const int* row = sorted_idx + static_cast<long>(b) * N;
  const int* prow = perm + static_cast<long>(b) * N;
  if (!run_start(row, j, K)) return;
  const int cell = row[j];
  const long base = static_cast<long>(b) * N * C + c;
  int end = j;
  float s = 0.0f;
  for (; end < N && row[end] == cell; ++end)
    s = __fadd_rn(s, grad_out[base + static_cast<long>(prow[end]) * C]);
  const float q = __fdiv_rn(s, ties[bj * C + c]);
  const float m = out[base + static_cast<long>(prow[j]) * C];
  for (int k = j; k < end; ++k) {
    const long at = base + static_cast<long>(prow[k]) * C;
    grad[at] = __fmul_rn(feat[at] == m ? 1.0f : 0.0f, q);
  }
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat [B,N,C] f32; sorted_idx, perm [B,N] i32 (a stable sort of each
// cloud's cells, each in [0, K), or the kernel traps); out [B,K,C] f32,
// zero-filled by the caller; counts [B,N] f32: the points of each point's
// cell.
int ifdef_scatter_mean(const float* feat, const int* sorted_idx,
                       const int* perm, int B, int N, int C, int K,
                       float* out, float* counts, void* stream) {
  const long total = static_cast<long>(B) * N * C;
  if (total == 0) return 0;
  const long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  scatter_mean_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      feat, sorted_idx, perm, B, N, C, K, out, counts);
  return ifdef::last_error();
}

// feat [B,N,C] f32; sorted_idx, perm [B,N] i32 (a stable sort of each
// cloud's cells, each in [0, K), or the kernel traps); out [B,N,C] f32,
// each point's cell max; ties [B,N,C] f32, at each run's first sorted
// position the tie count the backward divides by (other entries unset).
int ifdef_pooled_max(const float* feat, const int* sorted_idx,
                     const int* perm, int B, int N, int C, int K, float* out,
                     float* ties, void* stream) {
  const long total = static_cast<long>(B) * N * C;
  if (total == 0) return 0;
  const long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  pooled_max_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      feat, sorted_idx, perm, B, N, C, K, out, ties);
  return ifdef::last_error();
}

// grad_out, feat, out [B,N,C] f32; ties, sorted_idx, perm as the forward
// left them; grad [B,N,C] f32, every entry written.
int ifdef_pooled_max_backward(const float* grad_out, const float* feat,
                              const float* out, const float* ties,
                              const int* sorted_idx, const int* perm, int B,
                              int N, int C, int K, float* grad,
                              void* stream) {
  const long total = static_cast<long>(B) * N * C;
  if (total == 0) return 0;
  const long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  pooled_max_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      grad_out, feat, out, ties, sorted_idx, perm, B, N, C, K, grad);
  return ifdef::last_error();
}

}  // extern "C"
