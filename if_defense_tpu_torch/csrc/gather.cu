// The backward of a batched row gather in a fixed order.
//
// The forward, `ops.pointops.index_points`, is
//   out[b, m, c] = points[b, idx[b, m], c]      (idx flattened to [B, M]),
// and its backward, given the output's gradient g [B, M, C], is
//   grad[b, n, c] = (sum over the m with idx[b, m] == n, in increasing m,
//                    from 0.0f, of g[b, m, c]),
// and 0 where no m reads point n.
//
// Replaces no TPU kernel. The JAX package's `index_points` is `p[i]`, whose
// VJP is an XLA scatter-add, and its `gather_neighbors` a one-hot
// contraction with a custom VJP (if_defense_tpu/ops/pointops.py:49-58,
// 149-174); both repeat their bits on the TPU. torch's `gather` backward on
// the card is a `scatter_add_` with float atomics, whose order changes from
// run to run, so a seeded victim training run did not repeat; under
// deterministic algorithms it is a sort-based index backward
// (`indexing_backward_kernel`), the largest single cost of an attack
// iteration. This kernel adds each point's rows in row order, the order of
// the plain version's autograd on the CPU (`scatter_add_` into zeros, row
// after row), so it gives those bits on a CPU copy, launch after launch.
//
// Input order: the wrapper sorts the keys b N + idx[b, m] of all clouds at
// once with a stable sort (`torch.sort(stable=True)` of a flat int32
// tensor, deterministic; sorting along the rows of [B, M] instead cost
// about 1.5 ms of host time a call at B = 32, M = 20,480 on the H100), so
// `sorted_key` is ascending and, within a run of equal keys, `perm` holds
// the flat rows b M + m in increasing order.
//
// Design: two kernels in one launch. `gather_bounds_kernel`, one thread a
// sorted position, checks the caller's index at that position (int32 or
// int64) against [0, N) and the sorted key against [0, B N) (`__trap()`
// outside them: no host sync in the wrapper) and writes where each key's
// run starts and ends in `bounds` [B N, 2], zero-filled by the wrapper,
// so a point no row reads has an empty run. `gather_backward_kernel`, one
// thread a (cloud, point, channel), channels fastest, walks its point's
// run in order and writes the sum: every entry of the gradient is written
// once, with no fill and no atomics, and a warp reads a row's channels
// contiguously.
//
// Bound: bytes. The output's gradient is read once ([B, M, C] f32, 168 MB
// for DGCNN's second EdgeConv block at B = 32, M = 1024 x 20, C = 64), the
// indices once and the gradient written once ([B, N, C]); B M C adds.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename I>
__global__ void gather_bounds_kernel(const I* __restrict__ idx,
                                     const int* __restrict__ sorted_key,
                                     long rows, int N, long keys,
                                     int* __restrict__ bounds) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows) return;
  const I given = idx[t];
  const int key = sorted_key[t];
  // an index outside [0, N) is a fault of the caller, as in gather's
  // device assert (the key is checked too: an int64 index cut to 32 bits
  // may land anywhere)
  if (given < 0 || given >= N || key < 0 || key >= keys) __trap();
  if (t == 0 || sorted_key[t - 1] != key)
    bounds[2L * key] = static_cast<int>(t);
  if (t == rows - 1 || sorted_key[t + 1] != key)
    bounds[2L * key + 1] = static_cast<int>(t + 1);
}

__global__ void gather_backward_kernel(const float* __restrict__ grad_out,
                                       const int* __restrict__ perm,
                                       const int* __restrict__ bounds,
                                       long total, int C,
                                       float* __restrict__ grad) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long bn = t / C;
  const int c = static_cast<int>(t - bn * C);
  const int start = bounds[2 * bn], end = bounds[2 * bn + 1];
  float s = 0.0f;
  for (int j = start; j < end; ++j)
    s = __fadd_rn(s, grad_out[static_cast<long>(perm[j]) * C + c]);
  grad[t] = s;
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// grad_out [B,M,C] f32; idx [B,M] the caller's indices, int64 where idx64
// is 1 and int32 where 0 (each in [0, N), or the kernel traps); sorted_key,
// perm [B M] i32 (a stable sort of the keys b N + idx[b, m], and the flat
// rows in that order); bounds [B N, 2] i32, zero-filled by the caller;
// grad [B,N,C] f32, every entry written.
int ifdef_gather_backward(const float* grad_out, const void* idx, int idx64,
                          const int* sorted_key, const int* perm, int B,
                          int M, int N, int C, int* bounds, float* grad,
                          void* stream) {
  const long rows = static_cast<long>(B) * M;
  const long keys = static_cast<long>(B) * N;
  const long total = keys * C;
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long row_blocks = (rows + kThreads - 1) / kThreads;
  const long blocks = (total + kThreads - 1) / kThreads;
  if (row_blocks > 0x7fffffffL || blocks > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    if (idx64)
      gather_bounds_kernel<<<static_cast<unsigned>(row_blocks), kThreads, 0,
                             s>>>(static_cast<const int64_t*>(idx),
                                  sorted_key, rows, N, keys, bounds);
    else
      gather_bounds_kernel<<<static_cast<unsigned>(row_blocks), kThreads, 0,
                             s>>>(static_cast<const int*>(idx), sorted_key,
                                  rows, N, keys, bounds);
    const int err = ifdef::last_error();
    if (err) return err;
  }
  gather_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      grad_out, perm, bounds, total, C, grad);
  return ifdef::last_error();
}

}  // extern "C"
