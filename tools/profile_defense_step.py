#!/usr/bin/env python3
"""Profile a step of the IF-Defense restoration loop on a CUDA card.

    python3 tools/profile_defense_step.py [--variant convonet|onet|both]
        [--steps 5] [--batch 48]

ConvONet-Opt and ONet-Opt of the PyTorch port (`if_defense_tpu_torch`) at
full width in the reference mode (f32, TF32 off), with random weights from
a seed (`init_params(0)`, `flax_init_params(0, "onet")`), on `--batch`
synthetic clouds of 1024 points (ellipsoid surfaces, 8 outliers each),
1024 optimised points. After a warm-up, a restoration of `steps` steps and
one of 2 `steps` steps are timed and profiled; each figure a step is their
difference over `steps`, so what a call does once (SOR, sampling, the
encoder, the copy of the model) cancels:
- wall ms: host clock around the call, ending in a synchronise (median of
  3 calls, without the profiler);
- device ms: the self device time of every kernel and copy
  (`torch.profiler`, one call each);
- busy share: device ms / wall ms;
- device operations (kernels, copies, fills) a step, and the kernels that
  take the most device time a step.
Prints a line per kernel and one JSON line per variant. Needs a card; it
uses only the port's public modules, so it runs on earlier trees of the
repository too.
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


def model_of(variant: str, dev):
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        init_params,
        params_from_jax,
    )

    if variant == "convonet":
        model, tree = ConvOccupancyNetwork(), init_params(0)
    else:
        model, tree = OccupancyNetwork(), flax_init_params(0, "onet")
    model.load_state_dict(params_from_jax(tree, model))
    return model.to(dev)


def _device_events(prof):
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in stats
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in host}


def profile(dev, variant: str, steps: int = 5, batch: int = 48,
            top: int = 8) -> dict:
    """The per-step figures of one variant (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from if_defense_tpu_torch.defense.ifdefense import (
        convonet_opt_defense,
        onet_opt_defense,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make = convonet_opt_defense if variant == "convonet" else onet_opt_defense
    model = model_of(variant, dev)
    pc = torch.from_numpy(clouds(batch)).to(dev)

    def call(n):
        # `iterations` steps and one more, as the reference runs
        defend = make(model, iterations=n - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        defend(pc, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    counts = (steps, 2 * steps)
    for n in counts:
        call(n)
    wall = {n: statistics.median(call(n) for _ in range(3)) for n in counts}
    events = {}
    for n in counts:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            call(n)
        events[n] = _device_events(prof)
    lo, hi = events[counts[0]], events[counts[1]]
    per = {k: ((hi.get(k, (0.0, 0))[0] - lo.get(k, (0.0, 0))[0]) / steps,
               (hi.get(k, (0.0, 0))[1] - lo.get(k, (0.0, 0))[1]) / steps)
           for k in set(lo) | set(hi)}
    out = dict(
        variant=variant, batch=batch, steps=steps,
        wall_ms=(wall[counts[1]] - wall[counts[0]]) / steps,
        device_ms=sum(v[0] for v in per.values()),
        ops=sum(v[1] for v in per.values()),
        device=torch.cuda.get_device_name(dev))
    out["busy_share"] = out["device_ms"] / out["wall_ms"]
    print(f"  {variant} reference mode, a step (batch {batch}; {steps} and "
          f"{2 * steps} steps differenced): wall {out['wall_ms']:.4f} ms, "
          f"device {out['device_ms']:.4f} ms, busy share "
          f"{out['busy_share']:.3f}, {out['ops']:.1f} device operations")
    for k, (ms, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:8.4f} ms x{cnt:5.1f}  {k[:90]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="both",
                    choices=("convonet", "onet", "both"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=48)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_defense_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    variants = (("convonet", "onet") if args.variant == "both"
                else (args.variant,))
    for v in variants:
        print(json.dumps(profile(dev, v, args.steps, args.batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
