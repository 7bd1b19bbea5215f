#!/usr/bin/env python3
"""Profile an iteration of the CW attack loop on a CUDA card.

    python3 tools/profile_cw_iteration.py [--victim pointnet2] [--iters 10]
        [--batch 32]

`attack.cw.cw_perturb` of the PyTorch port (`if_defense_tpu_torch`) at
the CLI's defaults (lr 1e-2, weight 10, the margin loss and L2 distance)
on a victim at its published widths, weights from the port's seeded init
with batch-norm statistics calibrated on the clouds
(`models.common.calibrate_batch_norm`), `--batch` clouds of 1024 points
(ellipsoid surfaces, 8 outliers each, in the unit sphere), f32 with TF32
off. After a warm-up, a binary step of `iters` iterations and one of 2
`iters` are timed and profiled; each figure an iteration is their
difference over `iters`, so what a call does once cancels:
- wall ms: host clock around the call, ending in a synchronise (median of
  3 calls, without the profiler);
- device ms: the self device time of every kernel and copy
  (`torch.profiler`, one call each);
- busy share: device ms / wall ms;
- device operations an iteration, and the kernels that take the most
  device time an iteration.
Both under `torch.use_deterministic_algorithms(True)`, the attack CLI's
setting, and without it, in turns (on, off, off, on): the difference is
what determinism costs an iteration. Prints a line per kernel and one JSON
line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

# cuBLAS's deterministic workspace, before the process's first handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def clouds(n: int, seed: int = 0) -> np.ndarray:
    """n clouds of 1024 points on ellipsoid surfaces, 8 outliers each."""
    gen = np.random.default_rng(seed)
    d = gen.normal(size=(n, 1024, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = d * gen.uniform(0.3, 1.0, (n, 1, 3))
    pc[:, :8] *= 3.0
    return pc.astype(np.float32)


def _device_events(prof):
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in stats
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in host}


def profile(dev, victim: str = "pointnet2", iters: int = 10,
            batch: int = 32, top: int = 8) -> dict:
    """The per-iteration figures (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from if_defense_tpu_torch.attack.cw import cw_perturb
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.models.common import calibrate_batch_norm
    from if_defense_tpu_torch.ops import normalize_unit_sphere

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = normalize_unit_sphere(torch.from_numpy(clouds(batch))).to(dev)
    torch.manual_seed(0)
    model = calibrate_batch_norm(build_model(victim).to(dev), pc)
    for p in model.parameters():
        p.requires_grad_(False)
    target = torch.arange(batch, device=dev) % 40

    def call(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cw_perturb(lambda x: model(x)[0], pc, target,
                   torch.Generator(device=dev).manual_seed(0),
                   binary_step=1, num_iter=n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    counts = (iters, 2 * iters)
    before = torch.are_deterministic_algorithms_enabled()
    walls = {True: [], False: []}
    try:
        for mode in (True, False, False, True):
            torch.use_deterministic_algorithms(mode)
            for n in counts:
                call(n)
            wall = {n: statistics.median(call(n) for _ in range(3))
                    for n in counts}
            walls[mode].append((wall[counts[1]] - wall[counts[0]]) / iters)
        torch.use_deterministic_algorithms(True)
        events = {}
        for n in counts:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                call(n)
            events[n] = _device_events(prof)
    finally:
        torch.use_deterministic_algorithms(before)
    lo, hi = events[counts[0]], events[counts[1]]
    per = {k: ((hi.get(k, (0.0, 0))[0] - lo.get(k, (0.0, 0))[0]) / iters,
               (hi.get(k, (0.0, 0))[1] - lo.get(k, (0.0, 0))[1]) / iters)
           for k in set(lo) | set(hi)}
    out = dict(
        victim=victim, batch=batch, iters=iters,
        wall_ms=statistics.mean(walls[True]),
        wall_ms_nondeterministic=statistics.mean(walls[False]),
        wall_ms_turns=[walls[True][0], walls[False][0], walls[False][1],
                       walls[True][1]],
        device_ms=sum(v[0] for v in per.values()),
        ops=sum(v[1] for v in per.values()),
        device=torch.cuda.get_device_name(dev))
    out["busy_share"] = out["device_ms"] / out["wall_ms"]
    out["determinism_ms"] = out["wall_ms"] - out["wall_ms_nondeterministic"]
    b5_b6 = sum(v[0] for k, v in per.items()
                if "fps_kernel" in k or "ballquery_kernel" in k)
    out["b5_b6_ms"] = b5_b6
    print(f"  {victim}, a CW iteration (batch {batch}; {iters} and "
          f"{2 * iters} iterations differenced): wall {out['wall_ms']:.4f} "
          f"ms deterministic, {out['wall_ms_nondeterministic']:.4f} ms not "
          f"(turns on, off, off, on: "
          f"{', '.join(f'{w:.4f}' for w in out['wall_ms_turns'])}), device "
          f"{out['device_ms']:.4f} ms, busy share {out['busy_share']:.3f}, "
          f"{out['ops']:.1f} device operations, B5 + B6 {b5_b6:.4f} ms")
    for k, (ms, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:8.4f} ms x{cnt:5.1f}  {k[:90]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--victim", default="pointnet2")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cw_iteration: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(profile(torch.device("cuda", 0), args.victim,
                             args.iters, args.batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
