// The ConvONet encoder's scatter-mean in a fixed order:
//   out[b, k, c] = (sum over the points n of cloud b with idx[b, n] == k,
//                   in increasing n, of feat[b, n, c]) / count,
// and 0 where no point falls in cell k.
//
// Replaces no TPU kernel. The JAX package computes this scatter-mean as a
// one-hot matmul (if_defense_tpu/ops/scatter.py:20-38), which has no
// scatter, so a seeded JAX run repeats. The port's plain version sums with
// `scatter_add_`, which on the card adds with atomics in an order that
// changes from run to run, so two seeded runs of ConvONet-Opt differed. The
// one-hot form would need a [B, N, 32^3] operand for the grid's volume.
// This kernel sums each cell's points one after another in point order,
// which is also the order in which the plain version adds them on the CPU:
// the same bits as the plain version run on a CPU copy, launch after launch.
//
// Input order: the wrapper sorts each cloud's cell indices with a stable
// sort (`torch.sort(stable=True)`, deterministic), so `sorted_idx[b]` is
// ascending and, within a run of equal cells, `perm[b]` holds the points'
// positions in increasing order.
//
// Design: one thread per (cloud, sorted position, channel), channels
// fastest, so a warp shares a position and reads a point's channels
// contiguously. A thread whose position does not start a run of equal
// cells returns; the thread at a run's start walks the run, adds its
// points' values in order from 0.0f (as the plain version adds into zeros)
// and divides by the run's length (IEEE division, as torch's on the CPU).
// Its channel-0 thread writes the run's length to each of the run's points
// (`counts`, f32), which the backward divides by. Empty cells keep the
// zeros the wrapper's output was filled with.
//
// Bound: bytes. At the defense's shapes (B = 48, N = 600, C = 32, a 64x64
// plane) the kernel reads 3.7 MB of features and writes 25 MB of cells
// (the zero fill included); for the grid's 32^3 cells, 201 MB. The sums
// themselves are N C adds a cloud.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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
  const int cell = row[j];
  // a cell outside [0, K) is a fault of the caller, as in scatter_add_'s
  // device assert: it stops the kernel without a host sync in the wrapper
  if (cell < 0 || cell >= K) __trap();
  if (j > 0 && row[j - 1] == cell) return;      // not the start of a run
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

}  // extern "C"
