"""Attribute the time of ball query's warp-per-centre design (kernel B6
before its redesign) by ablation, on one CUDA card.

    python tools/ballquery_ablation.py

The design: a warp per centre, 8 warps and 32 centres a block, the cloud
staged as four f32 arrays, 32 points a step, a ballot and a popc a step,
a loop that stops at the nsample-th hit. Built here from the source below
in three forms: `stage` (the cloud staged and every slot written, no
scan), `no_exit` (the scan with the `count < nsample` test taken out of
the loop condition, the 32-point steps unrolled by 4) and `as_was` (the
scan as it was). Each is timed at PU-Net's four set-abstraction levels (B
= 128, 32 slots) of one batch of `chip_smoke.py` phase 7's clouds, in
device ms per call by `chip_smoke.py`'s `device_ms` (torch.profiler over
20 calls, the self device time of the kernel), after the card's name and
power limit. `no_exit` and `as_was` must give the plain version's
indices, or the script exits non-zero; `stage` is timed only.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ABLATION_CU = r"""
#include <stdint.h>

constexpr int kWarps = 8;
constexpr int kCentres = 32;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// kMode 0: staging and the slots' writes only; 1: no exit test, steps
// unrolled by 4; 2: the scan as it was
template <int kMode>
__global__ void __launch_bounds__(kWarps * 32)
    bq_ablation(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                int N, int S, int nsample, float r2, int* __restrict__ out) {
  extern __shared__ float s[];
  float* sx = s;
  float* sy = s + N;
  float* sz = s + 2 * N;
  float* sw = s + 3 * N;
  const long b = blockIdx.y;
  const float* p = xyz + b * N * 3;
  for (int t = threadIdx.x; t < N; t += kWarps * 32) {
    float x = p[3 * t], y = p[3 * t + 1], z = p[3 * t + 2];
    sx[t] = x;
    sy[t] = y;
    sz[t] = z;
    sw[t] = sq3(x, y, z);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int c = warp; c < kCentres; c += kWarps) {
    const int si = blockIdx.x * kCentres + c;
    if (si >= S) break;
    int* o = out + (b * S + si) * nsample;
    if (kMode == 0) {
      const int v = sw[c] < 0.f ? 1 : 0;
      for (int j = lane; j < nsample; j += 32) o[j] = v;
      continue;
    }
    const float* q = new_xyz + (b * S + si) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    const float q2 = sq3(qx, qy, qz);
    int count = 0, first = 0;
    auto step = [&](int base) {
      const int n = base + lane;
      bool hit = false;
      if (n < N) {
        float cross = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, sx[n]), __fmul_rn(qy, sy[n])),
            __fmul_rn(qz, sz[n]));
        float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), sw[n]);
        hit = d2 <= r2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) {
        if (count == 0) first = base + __ffs(m) - 1;
        const int slot = count + __popc(m & below);
        if (hit && slot < nsample) o[slot] = n;
        count += __popc(m);
      }
    };
    if (kMode == 1) {
#pragma unroll 4
      for (int base = 0; base < N; base += 32) step(base);
    } else {
      for (int base = 0; base < N && count < nsample; base += 32) step(base);
    }
    const int fill = count > 0 ? first : 0;
    for (int j = min(count, nsample) + lane; j < nsample; j += 32) o[j] = fill;
  }
}

extern "C" int bq_ablation_launch(int mode, const float* xyz,
                                  const float* new_xyz, int B, int N, int S,
                                  int nsample, float r2, int* out,
                                  void* stream) {
  size_t smem = sizeof(float) * 4 * (size_t)N;
  dim3 grid((unsigned)((S + kCentres - 1) / kCentres), (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    cudaFuncSetAttribute(bq_ablation<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    bq_ablation<0><<<grid, kWarps * 32, smem, st>>>(xyz, new_xyz, N, S, nsample, r2, out);
  } else if (mode == 1) {
    cudaFuncSetAttribute(bq_ablation<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    bq_ablation<1><<<grid, kWarps * 32, smem, st>>>(xyz, new_xyz, N, S, nsample, r2, out);
  } else {
    cudaFuncSetAttribute(bq_ablation<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    bq_ablation<2><<<grid, kWarps * 32, smem, st>>>(xyz, new_xyz, N, S, nsample, r2, out);
  }
  return (int)cudaGetLastError();
}
"""

MODES = ("stage", "no_exit", "as_was")


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_ablation(tmp: str) -> ctypes.CDLL:
    from if_defense_tpu_torch.ops import _build

    src = os.path.join(tmp, "bq_ablation.cu")
    lib = os.path.join(tmp, "libbq_ablation.so")
    with open(src, "w") as f:
        f.write(ABLATION_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    dll.bq_ablation_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p]
    dll.bq_ablation_launch.restype = ctypes.c_int
    return dll


def main() -> int:
    import numpy as np
    import torch

    from if_defense_tpu_torch.ops import query_ball_point_plain

    if not torch.cuda.is_available():
        print("ballquery_ablation: no CUDA device", file=sys.stderr)
        return 1
    cs = smoke()
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}")
    clouds = cs.ellipsoids(np.random.default_rng(7), cs.DUP_CLOUDS)
    levels = cs.sa_level_inputs(dev, clouds[:cs.DUP_B])
    failed = []
    with tempfile.TemporaryDirectory() as tmp, cs.SmClock() as clock:
        dll = build_ablation(tmp)
        for level, (xyz, new, radius) in enumerate(levels):
            b, n, _ = xyz.shape
            s = new.shape[1]
            want = query_ball_point_plain(radius, 32, xyz, new)
            for mode, tag in enumerate(MODES):
                out = torch.empty((b, s, 32), dtype=torch.int32, device=dev)

                def call(mode=mode, out=out, xyz=xyz, new=new, radius=radius):
                    err = dll.bq_ablation_launch(
                        mode, xyz.data_ptr(), new.data_ptr(), b, n, s, 32,
                        float(radius) ** 2, out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"bq_ablation {tag}: CUDA error "
                                           f"{err}")
                    return out

                call()
                ok = "timed only" if mode == 0 else (
                    "bit-equal" if torch.equal(call(), want) else "DIFFERS")
                if ok == "DIFFERS":
                    failed.append(f"ablation {tag} level {level}")
                got = cs.device_ms(call, ("bq_ablation",))
                print(f"ablation {tag} at level {level} [{b}, {n}] -> {s}: "
                      f"{got[0]:.4f} ms (device, per call; {ok})")
    print(clock.text())
    if failed:
        print(f"ballquery_ablation FAILED: {failed} differ from the plain "
              "version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
