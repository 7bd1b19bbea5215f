// Bilinear sampling of channel-last feature planes (kernel B4).
//
// Replaces the Pallas kernel `fused_bilinear_plane_sample` of
// if_defense_tpu/ops/pallas_interp.py (_fwd_kernel:62, _bwd_kernel:74,
// pallas_call at :132 and :160). The TPU kernel expands two-hot selectors
// into matmuls for its matrix unit; here each query is a direct 4-corner
// gather and lerp: x -> W, y -> H, align_corners=True, border clamp.
//
// Layout: plane [B, H, W, C] (f32 or bf16), uv [B, Q, 2] f32, out [B, Q, C]
// in the plane's type, math in f32. One warp per query, lanes over the
// channels, so each corner read is C contiguous values (128 bytes for C=32
// in f32).
//
// Bound: memory. At the ConvONet-Opt shapes (B=48, Q=1024, 64x64x32
// planes) a call reads 4 corner rows per query (~25 MB of f32, mostly from
// L2 since a plane is 512 KB) and writes 6 MB; there is no arithmetic to
// speak of. The design keeps the TPU path's [B, Q, W, C] intermediate out
// of existence altogether.
//
// The backward is two kernels, launched only for what autograd asks for
// (the defense needs duv, implicit-network training dplane):
//
// duv, one warp per query:
//   du = (W-1) sum_c g [(1-wy)(f01-f00) + wy(f11-f10)],
//   dv = (H-1) sum_c g [(1-wx)(f10-f00) + wx(f11-f01)],
// zero outside [0, 1] (the clamp). When x0 clips onto x1 at the border,
// f01 == f00 and the x term is 0, as in JAX. Deterministic: each output
// is written by one warp, with a fixed shuffle-reduction order.
//
// dplane[b, y, x, c] = sum_q w_q(y, x) g[b, q, c] over each query's four
// corners, weights (1-wy)(1-wx), (1-wy)wx, wy(1-wx), wy wx from the same
// cell_of as the forward. Same layout as the forward (warp per query,
// lanes over channels); each lane atomically adds its four weighted values
// into a zero-filled f32 [B, H, W, C] buffer, so a warp's corner update is
// one coalesced 128-byte reduction (C=32) resolved in L2 (a 64x64x32 f32
// plane is 512 KB). Where a corner clips onto its neighbour at the border
// the two weights land on one cell and add, as the one-hot sums of JAX's
// selectors do; a query clamped from outside [0, 1] still adds to its
// border cells. bf16 planes accumulate in f32; the wrapper casts once.
// NOT deterministic: f32 atomics add in no fixed order, so the last bits
// vary from run to run (as the plain version's on the card: gather's CUDA
// backward is an atomic scatter_add). Bound: memory, g read once and the
// plane gradient written once; the atomics' L2 traffic is 4x the g reads.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // queries per block

struct Cell {
  long i00, i01, i10, i11;  // element offsets of the 4 corner rows
  float wx, wy;
  bool in_u, in_v;          // inside the clamp (gradient passes)
};

__device__ __forceinline__ Cell cell_of(float u, float v, int H, int W,
                                        long plane_base, int C) {
  Cell c;
  c.in_u = (u >= 0.f) && (u <= 1.f);
  c.in_v = (v >= 0.f) && (v <= 1.f);
  float x = fminf(fmaxf(u, 0.f), 1.f) * (float)(W - 1);
  float y = fminf(fmaxf(v, 0.f), 1.f) * (float)(H - 1);
  float x0 = floorf(x), y0 = floorf(y);
  c.wx = x - x0;
  c.wy = y - y0;
  int x0i = min(max((int)x0, 0), W - 1), x1i = min(max((int)x0 + 1, 0), W - 1);
  int y0i = min(max((int)y0, 0), H - 1), y1i = min(max((int)y0 + 1, 0), H - 1);
  c.i00 = plane_base + ((long)y0i * W + x0i) * C;
  c.i01 = plane_base + ((long)y0i * W + x1i) * C;
  c.i10 = plane_base + ((long)y1i * W + x0i) * C;
  c.i11 = plane_base + ((long)y1i * W + x1i) * C;
  return c;
}

template <typename T>
__global__ void sample_fwd(const T* __restrict__ plane,
                           const float* __restrict__ uv, int B, int H, int W,
                           int C, int Q, T* __restrict__ out) {
  int lane = threadIdx.x & 31;
  long q = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= (long)B * Q) return;
  long b = q / Q;
  Cell k = cell_of(uv[2 * q], uv[2 * q + 1], H, W, b * H * W * C, C);
  for (int ch = lane; ch < C; ch += 32) {
    float f00 = ifdef::load_f(plane, k.i00 + ch), f01 = ifdef::load_f(plane, k.i01 + ch);
    float f10 = ifdef::load_f(plane, k.i10 + ch), f11 = ifdef::load_f(plane, k.i11 + ch);
    float col0 = (1.f - k.wy) * f00 + k.wy * f10;
    float col1 = (1.f - k.wy) * f01 + k.wy * f11;
    ifdef::store_f(out, q * C + ch, (1.f - k.wx) * col0 + k.wx * col1);
  }
}

template <typename T>
__global__ void sample_bwd(const T* __restrict__ plane,
                           const float* __restrict__ uv,
                           const T* __restrict__ g, int B, int H, int W, int C,
                           int Q, float* __restrict__ duv) {
  int lane = threadIdx.x & 31;
  long q = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= (long)B * Q) return;
  long b = q / Q;
  Cell k = cell_of(uv[2 * q], uv[2 * q + 1], H, W, b * H * W * C, C);
  float su = 0.f, sv = 0.f;
  for (int ch = lane; ch < C; ch += 32) {
    float gc = ifdef::load_f(g, q * C + ch);
    float f00 = ifdef::load_f(plane, k.i00 + ch), f01 = ifdef::load_f(plane, k.i01 + ch);
    float f10 = ifdef::load_f(plane, k.i10 + ch), f11 = ifdef::load_f(plane, k.i11 + ch);
    su += gc * ((1.f - k.wy) * (f01 - f00) + k.wy * (f11 - f10));
    sv += gc * ((1.f - k.wx) * (f10 - f00) + k.wx * (f11 - f01));
  }
  su = ifdef::warp_sum(su);
  sv = ifdef::warp_sum(sv);
  if (lane == 0) {
    duv[2 * q] = k.in_u ? su * (float)(W - 1) : 0.f;
    duv[2 * q + 1] = k.in_v ? sv * (float)(H - 1) : 0.f;
  }
}

template <typename T>
__global__ void sample_bwd_plane(const float* __restrict__ uv,
                                 const T* __restrict__ g, int B, int H, int W,
                                 int C, int Q, float* __restrict__ dplane) {
  int lane = threadIdx.x & 31;
  long q = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= (long)B * Q) return;
  long b = q / Q;
  Cell k = cell_of(uv[2 * q], uv[2 * q + 1], H, W, b * H * W * C, C);
  float w00 = (1.f - k.wy) * (1.f - k.wx), w01 = (1.f - k.wy) * k.wx;
  float w10 = k.wy * (1.f - k.wx), w11 = k.wy * k.wx;
  for (int ch = lane; ch < C; ch += 32) {
    float gc = ifdef::load_f(g, q * C + ch);
    atomicAdd(dplane + k.i00 + ch, w00 * gc);
    atomicAdd(dplane + k.i01 + ch, w01 * gc);
    atomicAdd(dplane + k.i10 + ch, w10 * gc);
    atomicAdd(dplane + k.i11 + ch, w11 * gc);
  }
}

inline dim3 grid_for(long queries) {
  return dim3((unsigned)((queries + kWarps - 1) / kWarps));
}

}  // namespace

extern "C" {

const char* ifdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// plane [B,H,W,C] (is_bf16 ? bf16 : f32), uv [B,Q,2] f32 -> out [B,Q,C]
int ifdef_plane_sample_fwd(const void* plane, int is_bf16, const float* uv,
                           int B, int H, int W, int C, int Q, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid = grid_for((long)B * Q);
  if (is_bf16)
    sample_fwd<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(plane), uv, B, H, W, C, Q,
        static_cast<__nv_bfloat16*>(out));
  else
    sample_fwd<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(plane), uv, B, H, W, C, Q,
        static_cast<float*>(out));
  return ifdef::last_error();
}

// g [B,Q,C] in the plane's type -> duv [B,Q,2] f32
int ifdef_plane_sample_bwd(const void* plane, int is_bf16, const float* uv,
                           const void* g, int B, int H, int W, int C, int Q,
                           float* duv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid = grid_for((long)B * Q);
  if (is_bf16)
    sample_bwd<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(plane), uv,
        static_cast<const __nv_bfloat16*>(g), B, H, W, C, Q, duv);
  else
    sample_bwd<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(plane), uv, static_cast<const float*>(g), B,
        H, W, C, Q, duv);
  return ifdef::last_error();
}

// g [B,Q,C] in the plane's type -> dplane [B,H,W,C] f32, which the caller
// zero-fills (the kernel adds into it)
int ifdef_plane_sample_bwd_plane(const float* uv, const void* g, int is_bf16,
                                 int B, int H, int W, int C, int Q,
                                 float* dplane, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid = grid_for((long)B * Q);
  if (is_bf16)
    sample_bwd_plane<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        uv, static_cast<const __nv_bfloat16*>(g), B, H, W, C, Q, dplane);
  else
    sample_bwd_plane<float><<<grid, kWarps * 32, 0, s>>>(
        uv, static_cast<const float*>(g), B, H, W, C, Q, dplane);
  return ifdef::last_error();
}

}  // extern "C"
