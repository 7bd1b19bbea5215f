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
// Design. The TPU kernels build dense [NT, N] tiles for the matrix unit and
// carry the column half of the gradient across a grid that runs in order.
// Here blocks run in any order, so:
//   - one thread owns one row i and scans the cloud, held in shared memory
//     (all lanes of a warp read the same point: a broadcast). A sorted
//     top-K kept in registers gives t in one pass, a second pass counts
//     n_lt / n_eq and sums the weighted terms;
//   - the forward keeps t and the tie weight per row, so the backward needs
//     no selection: one thread owns one point m and sums, over every j, the
//     pair's row weight (j among m's neighbours, against t_m) and column
//     weight (m among j's neighbours, against t_j). Only about 2k pairs per
//     point carry weight, so the exp/sqrt work is tiny;
//   - per-cloud sums are a second small kernel over per-row partials.
// No atomics: every result is deterministic from run to run.
//
// Bound: at the ConvONet-Opt shapes (B=48, N=1024) a selection pass is
// ~50M pair distances of a few flops each from shared memory, latency and
// issue bound, not memory; the int8 mask (B2/B3) is 48 MB and is read or
// written once per call, coalesced along a row (and, for B3's column side,
// along the 32 consecutive points of a warp).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;      // thread-per-row blocks
constexpr int kWarpRows = 32;   // rows per block in warp-per-row kernels
constexpr int kReduce = 256;
constexpr float kInf = 1e30f;

struct Params {
  int B, N, k;
  float radius, h, eps;
};

__device__ __forceinline__ float dist2(const float* s, int i, int j) {
  float dx = s[3 * i] - s[3 * j];
  float dy = s[3 * i + 1] - s[3 * j + 1];
  float dz = s[3 * i + 2] - s[3 * j + 2];
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

template <typename T>
__device__ void load_cloud(const T* pts, long b, int N, float* s) {
  const T* p = pts + b * (long)N * 3;
  for (int t = threadIdx.x; t < 3 * N; t += blockDim.x) s[t] = ifdef::load_f(p, t);
  __syncthreads();
}

// k-th smallest d2 of row i (self excluded), with multiplicity
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

// B1 forward: per-row threshold, tie weight and weighted loss
template <int K, typename T>
__global__ void rep_fwd(const T* __restrict__ pts, Params P,
                        float* __restrict__ row_loss, float* __restrict__ thr,
                        float* __restrict__ frac) {
  extern __shared__ float s[];
  int b = blockIdx.y;
  load_cloud(pts, b, P.N, s);
  int i = blockIdx.x * kRows + threadIdx.x;
  if (i >= P.N) return;
  float t = row_threshold<K>(s, P.N, i);
  int n_lt = 0, n_eq = 0;
  float s_lt = 0.f, s_eq = 0.f;
  for (int j = 0; j < P.N; ++j) {
    if (j == i) continue;
    float v = dist2(s, i, j);
    if (v < t) {
      ++n_lt;
      s_lt += term_of(v, P);
    } else if (v == t) {
      ++n_eq;
      s_eq += term_of(v, P);
    }
  }
  float f = (float)(K - n_lt) / (float)max(n_eq, 1);
  long r = (long)b * P.N + i;
  row_loss[r] = s_lt + f * s_eq;
  thr[r] = t;
  frac[r] = f;
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

// B1 backward: thread per point m, row and column weights from the saved
// thresholds; grad in the points' type
template <typename T>
__global__ void rep_bwd(const T* __restrict__ pts, Params P,
                        const float* __restrict__ thr,
                        const float* __restrict__ frac,
                        const float* __restrict__ g, T* __restrict__ grad) {
  extern __shared__ float s[];
  int b = blockIdx.y;
  float* st = s + 3 * P.N;
  float* sf = st + P.N;
  for (int t = threadIdx.x; t < P.N; t += blockDim.x) {
    st[t] = thr[(long)b * P.N + t];
    sf[t] = frac[(long)b * P.N + t];
  }
  load_cloud(pts, b, P.N, s);
  int m = blockIdx.x * kRows + threadIdx.x;
  if (m >= P.N) return;
  float tm = st[m], fm = sf[m];
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j = 0; j < P.N; ++j) {
    if (j == m) continue;
    float v = dist2(s, m, j);
    float w = (v < tm) ? 1.f : (v == tm ? fm : 0.f);
    float tj = st[j];
    w += (v < tj) ? 1.f : (v == tj ? sf[j] : 0.f);
    if (w > 0.f) {
      float c = w * coef_of(v, P);
      ax += c * (s[3 * m] - s[3 * j]);
      ay += c * (s[3 * m + 1] - s[3 * j + 1]);
      az += c * (s[3 * m + 2] - s[3 * j + 2]);
    }
  }
  float gs = 2.f * g[b] / (float)(P.N * P.k);
  long o = ((long)b * P.N + m) * 3;
  ifdef::store_f(grad, o, ax * gs);
  ifdef::store_f(grad, o + 1, ay * gs);
  ifdef::store_f(grad, o + 2, az * gs);
}

// B2: thresholds thread-per-row, then each warp writes whole rows of the
// int8 mask with consecutive lanes on consecutive columns
template <int K, typename T>
__global__ void rep_mask(const T* __restrict__ pts, Params P,
                         int8_t* __restrict__ mask) {
  extern __shared__ float s[];
  __shared__ float ts[kRows];
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

// B3 forward: warp per row, mask row read coalesced
template <typename T>
__global__ void rep_masked_fwd(const T* __restrict__ pts,
                               const int8_t* __restrict__ mask, Params P,
                               float* __restrict__ row_loss) {
  extern __shared__ float s[];
  int b = blockIdx.y;
  load_cloud(pts, b, P.N, s);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < kWarpRows; rr += blockDim.x / 32) {
    int i = blockIdx.x * kWarpRows + rr;
    if (i >= P.N) break;
    const int8_t* mrow = mask + ((long)b * P.N + i) * P.N;
    float acc = 0.f;
    for (int j = lane; j < P.N; j += 32) {
      int8_t w = mrow[j];
      if (w != 0 && j != i) acc += (float)w * term_of(dist2(s, i, j), P);
    }
    acc = ifdef::warp_sum(acc);
    if (lane == 0) row_loss[(long)b * P.N + i] = acc;
  }
}

// B3 backward: thread per point m; row weight mask[m, j], column weight
// mask[j, m] (32 consecutive bytes across a warp)
template <typename T>
__global__ void rep_masked_bwd(const T* __restrict__ pts,
                               const int8_t* __restrict__ mask, Params P,
                               const float* __restrict__ g,
                               T* __restrict__ grad) {
  extern __shared__ float s[];
  int b = blockIdx.y;
  load_cloud(pts, b, P.N, s);
  int m = blockIdx.x * kRows + threadIdx.x;
  if (m >= P.N) return;
  const int8_t* mb = mask + (long)b * P.N * P.N;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j = 0; j < P.N; ++j) {
    if (j == m) continue;
    int8_t wr = mb[(long)m * P.N + j];
    int8_t wc = mb[(long)j * P.N + m];
    if (wr != 0 || wc != 0) {
      float c = ((float)wr + (float)wc) * coef_of(dist2(s, m, j), P);
      ax += c * (s[3 * m] - s[3 * j]);
      ay += c * (s[3 * m + 1] - s[3 * j + 1]);
      az += c * (s[3 * m + 2] - s[3 * j + 2]);
    }
  }
  float gs = 2.f * g[b] / (float)(P.N * P.k);
  long o = ((long)b * P.N + m) * 3;
  ifdef::store_f(grad, o, ax * gs);
  ifdef::store_f(grad, o + 1, ay * gs);
  ifdef::store_f(grad, o + 2, az * gs);
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
  auto rows = rep_fwd<K, T>;
  IFDEF_LAUNCH(rows, row_grid(P, kRows), kRows, cloud_bytes(P), s,
               static_cast<const T*>(pts), P, row_loss, thr, frac);
  IFDEF_LAUNCH(rows_to_loss, dim3(P.B), kReduce, 0, s, row_loss, P.N, P.k,
               loss);
  return 0;
}

template <int K, typename T>
int mask_impl(const void* pts, Params P, int8_t* mask, cudaStream_t s) {
  auto kern = rep_mask<K, T>;
  IFDEF_LAUNCH(kern, row_grid(P, kRows), kRows, cloud_bytes(P), s,
               static_cast<const T*>(pts), P, mask);
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
  size_t smem = sizeof(float) * 5 * N;
  if (is_bf16)
    IFDEF_LAUNCH(rep_bwd<__nv_bfloat16>, row_grid(P, kRows), kRows, smem, s,
                 static_cast<const __nv_bfloat16*>(pts), P, thr, frac, g,
                 static_cast<__nv_bfloat16*>(grad));
  else
    IFDEF_LAUNCH(rep_bwd<float>, row_grid(P, kRows), kRows, smem, s,
                 static_cast<const float*>(pts), P, thr, frac, g,
                 static_cast<float*>(grad));
  return 0;
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
  if (is_bf16)
    IFDEF_LAUNCH(rep_masked_fwd<__nv_bfloat16>, row_grid(P, kWarpRows), 256,
                 cloud_bytes(P), s, static_cast<const __nv_bfloat16*>(pts),
                 mask, P, row_loss);
  else
    IFDEF_LAUNCH(rep_masked_fwd<float>, row_grid(P, kWarpRows), 256,
                 cloud_bytes(P), s, static_cast<const float*>(pts), mask, P,
                 row_loss);
  IFDEF_LAUNCH(rows_to_loss, dim3(P.B), kReduce, 0, s, row_loss, P.N, P.k,
               loss);
  return 0;
}

// B3 backward. g [B] f32 -> grad [B,N,3] in the points' type
int ifdef_repulsion_masked_bwd(const void* pts, int is_bf16,
                               const int8_t* mask, int B, int N, int k,
                               float radius, float h, float eps,
                               const float* g, void* grad, void* stream) {
  Params P{B, N, k, radius, h, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    IFDEF_LAUNCH(rep_masked_bwd<__nv_bfloat16>, row_grid(P, kRows), kRows,
                 cloud_bytes(P), s, static_cast<const __nv_bfloat16*>(pts),
                 mask, P, g, static_cast<__nv_bfloat16*>(grad));
  else
    IFDEF_LAUNCH(rep_masked_bwd<float>, row_grid(P, kRows), kRows,
                 cloud_bytes(P), s, static_cast<const float*>(pts), mask, P,
                 g, static_cast<float*>(grad));
  return 0;
}

}  // extern "C"
