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
// run to run, so a seeded victim training run did not repeat. This kernel
// adds each point's rows in row order, the order of the plain version's
// autograd on the CPU (`scatter_add_` into zeros, row after row), so it
// gives those bits on a CPU copy, launch after launch.
//
// Input order: each cloud's CSR (`csrc/csr.cu`, built on the card just
// before): point n's rows are rows[b, offsets[b, n] .. offsets[b, n + 1]],
// in increasing m. The CSR build checks the indices against [0, N).
//
// Design: a group of G lanes a point (G a power of two up to 32, the
// fewest that cover its row's channels: C / 4 float4 words where
// C % 4 == 0, else C floats), so a warp holds 32 / G points. Each lane
// walks its point's rows in order, eight rows' loads issued before
// their adds, and adds each word's channels from 0.0f with `__fadd_rn`; each
// entry of the gradient is written once, with no fill and no atomics, and
// a point no row reads gets its zeros from the empty walk.
//
// Bound: bytes. The output's gradient is read once ([B, M, C] f32, 168 MB
// for DGCNN's second EdgeConv block at B = 32, M = 1024 x 20, C = 64), the
// CSR's rows and offsets once and the gradient written once ([B, N, C]);
// B M C adds.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }

// V is float4 (C % 4 == 0) or float; W = C / (sizeof(V) / 4) words a row
template <typename V>
__global__ void gather_sum_kernel(const V* __restrict__ g,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ rows, int M, int N,
                                  int W, int G, long points,
                                  V* __restrict__ grad) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long point = t / G;
  if (point >= points) return;
  const int sub = static_cast<int>(t - point * G);
  const long b = point / N;
  const int n = static_cast<int>(point - b * N);
  const int* offs = offsets + b * (N + 1);
  const int start = offs[n], end = offs[n + 1];
  const int* rr = rows + b * M;
  const V* gb = g + b * M * W;
  V* out = grad + point * W;
  for (int w = sub; w < W; w += G) {
    V s = zero<V>();
    int j = start;
    for (; j + 8 <= end; j += 8) {
      V v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = gb[static_cast<long>(rr[j + u]) * W + w];
#pragma unroll
      for (int u = 0; u < 8; ++u) s = add(s, v[u]);
    }
    for (; j < end; ++j) s = add(s, gb[static_cast<long>(rr[j]) * W + w]);
    out[w] = s;
  }
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// grad_out [B,M,C] f32; offsets [B,N+1] and rows [B,M] i32, each cloud's
// CSR (`ifdef_csr_build`); grad [B,N,C] f32, every entry written.
int ifdef_gather_backward(const float* grad_out, const int* offsets,
                          const int* rows, int B, int M, int N, int C,
                          float* grad, void* stream) {
  const long points = static_cast<long>(B) * N;
  if (points == 0 || C == 0) return 0;
  // float4 words where the rows fill them and both tensors are aligned
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(grad_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  const int W = vec ? C / 4 : C;
  int G = 1;
  while (G < 32 && G < W) G <<= 1;
  const long threads = points * G;
  const long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_sum_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
        reinterpret_cast<const float4*>(grad_out), offsets, rows, M, N, W, G,
        points, reinterpret_cast<float4*>(grad));
  else
    gather_sum_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(grad_out, offsets, rows, M, N, W, G,
                                    points, grad);
  return ifdef::last_error();
}

}  // extern "C"
