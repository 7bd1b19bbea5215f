#!/usr/bin/env python3
"""Profile a train step of a victim classifier on a CUDA card.

    python3 tools/profile_train_step.py [--victim pointnet2] [--batch 32]
        [--steps 5] [--devices cuda:0,cuda:0 | cuda]
        [--setting deterministic | "no fill" | free]

`training.make_train_step` of the PyTorch port (`if_defense_tpu_torch`) at
`cli/train.py`'s defaults (Adam lr 1e-3, weight decay 1e-4, the cosine
schedule, dropout from a seeded `torch.Generator`) on a victim at its
published widths from `utils.params_io.flax_init_params(0)`, `--batch`
clouds of 1024 points (ellipsoid surfaces, 8 outliers each, in the unit
sphere) with labels i mod 40, f32 with TF32 off, under deterministic
algorithms as the train CLI runs (`utils.determinism.deterministic`,
entered before any CUDA work); `--setting` takes another of
`utils.determinism.setting`'s: `"no fill"` keeps them but not their NaN
fill of each new tensor, `free` leaves them off. `--devices` splits each
step over a list of devices (repeats allowed; `cuda` is every visible
card), as `cli/train.py` splits it over `best_data_mesh`; by default one
shard on card 0. After 3 warm steps, each figure is per step:
- wall ms: host clock around one step, ending in a synchronise (median of
  `steps` steps, without the profiler);
- event ms: CUDA events on the first device's stream around each of those
  steps (median);
- device ms: the self device time of every kernel and copy over `steps`
  steps (`torch.profiler`), over `steps`, summed over the cards;
- busy share: device ms / (wall ms x cards);
- device operations a step, and the kernels that take the most device
  time a step; B5 + B6 (FPS and ball query) on their own line.
Prints a line per kernel and one JSON line. Needs a card.
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


def profile(dev, victim: str = "pointnet2", batch: int = 32, steps: int = 5,
            top: int = 8, devices=None,
            setting: str = "deterministic") -> dict:
    """The per-step figures (see the module docstring); `devices` (the
    first `dev`) splits the step, run in `utils.determinism.setting`'s
    `setting` (the train CLI's by default)."""
    from if_defense_tpu_torch.utils import determinism

    with determinism.setting(setting):
        out = _profile(dev, victim, batch, steps, top, devices)
    out["setting"] = setting
    return out


def _profile(dev, victim: str, batch: int, steps: int, top: int,
             devices) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.models.common import generator_draw
    from if_defense_tpu_torch.ops import normalize_unit_sphere
    from if_defense_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = normalize_unit_sphere(torch.from_numpy(clouds(batch))).to(dev)
    label = torch.arange(batch, device=dev) % 40
    model = build_model(victim)
    model.load_state_dict(params_from_jax(flax_init_params(0, victim), model))
    model.to(dev)
    state = create_train_state(model)
    train_step = make_train_step(model, devices=devices)
    cards = len({str(d) for d in devices or [dev]})
    draw = generator_draw(torch.Generator(device=dev).manual_seed(2))

    def step():
        train_step(state, pc, label, draw)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls, events = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    per = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
           for e in stats
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in host}
    out = dict(victim=victim, batch=batch, steps=steps,
               shards=len(devices or [dev]), cards=cards,
               wall_ms=statistics.median(walls),
               event_ms=statistics.median(events),
               device_ms=sum(v[0] for v in per.values()),
               ops=sum(v[1] for v in per.values()),
               device=torch.cuda.get_device_name(dev))
    out["busy_share"] = out["device_ms"] / (out["wall_ms"] * cards)
    out["b5_b6_ms"] = sum(v[0] for k, v in per.items()
                          if "fps_kernel" in k or "ballquery_kernel" in k)
    out["gather_backward_ms"] = sum(v[0] for k, v in per.items()
                                    if "gather_b" in k)
    out["indexing_backward_ms"] = sum(v[0] for k, v in per.items()
                                      if "indexing_backward" in k)
    print(f"  {victim}, a train step (batch {batch} in {out['shards']} "
          f"shard(s) on {cards} card(s), median of {steps}): wall "
          f"{out['wall_ms']:.4f} ms, events {out['event_ms']:.4f} ms, "
          f"device {out['device_ms']:.4f} ms, "
          f"busy share {out['busy_share']:.3f}, {out['ops']:.1f} device "
          f"operations, B5 + B6 {out['b5_b6_ms']:.4f} ms, the gather "
          f"backward's kernels {out['gather_backward_ms']:.4f} ms, torch's "
          f"indexing_backward_kernel {out['indexing_backward_ms']:.4f} ms")
    if not per:
        print("    device time not measured (the profiler saw no kernel)")
    for k, (ms, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:8.4f} ms x{cnt:5.1f}  {k[:90]}")
    return out


def main(argv=None) -> int:
    from if_defense_tpu_torch.utils.determinism import SETTINGS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--victim", default="pointnet2")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--devices", default=None,
                    help="split each step: 'cuda' (every visible card) or "
                         "a comma list, repeats allowed")
    ap.add_argument("--setting", default="deterministic", choices=SETTINGS,
                    help="deterministic algorithms as the train CLI runs, "
                         "without their NaN fill, or off")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    from if_defense_tpu_torch.parallel import visible_devices

    devices = (None if args.devices is None else visible_devices(
        args.devices.split(",") if "," in args.devices else args.devices))
    print(json.dumps(profile(torch.device("cuda", 0), args.victim,
                             args.batch, args.steps, devices=devices,
                             setting=args.setting)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
