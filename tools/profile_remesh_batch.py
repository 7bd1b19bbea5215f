#!/usr/bin/env python3
"""Profile one batch of the mesh restoration (ONet-Mesh or ConvONet-Mesh)
on a CUDA card.

    python3 tools/profile_remesh_batch.py [--variant onet|convonet]
        [--weights W.npz] [--batch 32] [--wire bf16|int8|sparse]

`cli/remesh_defense.py`'s `remesh_batch` of the PyTorch port
(`if_defense_tpu_torch`) at the CLI's defaults (resolution0 32 x upsample
4, 1024 output points, SOR, f32 with TF32 off, host workers one per core)
on `--batch` clouds of 1024 points (ellipsoid surfaces, 8 outliers each),
with the weights npz given (default: `flax_init_params(0)`, whose untrained
field has surface nearly everywhere, the most work ONet's refinement can
get). After one warm batch:
- wall ms: host clock around one batch, ending in host numpy (median of
  `--reps` batches, without the profiler);
- host-clock ms of the phases of one batch, each ended by a device
  synchronise: encode (SOR, normalisation, the encoder), occupancy (the
  lattice or coarse + refine evaluation and the copy to the host), host
  (marching and sampling on `workers` threads), and the wire's bytes;
- device ms of the encode and occupancy phases (`torch.profiler`: the
  kernels and copies that start inside each phase's host range, which a
  synchronise ends), of the device-to-host copies, and of the whole batch; busy share = device ms of
  the batch / its wall ms; the kernels that take the most device time.
Prints a line per figure and one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
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


def profile(dev, variant: str = "onet", weights: str | None = None,
            pc: np.ndarray | None = None, batch: int = 32, wire: str = "bf16",
            reps: int = 3, top: int = 6) -> dict:
    """The figures of one batch (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from if_defense_tpu_torch.cli import remesh_defense as rd
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        save_params_npz,
    )

    with tempfile.TemporaryDirectory() as tmp:
        if weights is None:
            weights = save_params_npz(os.path.join(tmp, "w.npz"),
                                      flax_init_params(0, variant))
        args = rd.parse_args(["--variant", variant, "--data_root", "x.npz",
                              "--weights", weights, "--wire", wire,
                              "--batch_size", str(batch)])
        model, input_n = rd.build_model(args, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dense_fn, sparse_fn, decode_fn, encode_fn = rd.build_eval_fns(args, model)
    pc = clouds(batch) if pc is None else pc[:batch]
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def run(timings=None):
        return rd.remesh_batch(model, input_n, pc, args,
                               np.random.default_rng(args.seed), gen,
                               dense_fn=dense_fn, decode_fn=decode_fn,
                               encode_fn=encode_fn, sparse_fn=sparse_fn,
                               timings=timings)

    run()
    torch.cuda.synchronize(dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    phases: dict = {}
    run(phases)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        _, failed = run({})
        torch.cuda.synchronize(dev)
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    stats = prof.key_averages()
    host = {e.key for e in stats if e.device_type == cpu}
    kernels = [e for e in stats if e.device_type == gpu
               and e.self_device_time_total > 0 and e.key not in host]
    # each phase ends in a synchronise, so its kernels start inside its
    # host range: device ms of a phase = the kernels starting there
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cpu and e.name.startswith("remesh.")}
    device = [e for e in events if e.device_type == gpu
              and e.name not in host and not e.name.startswith("remesh.")]
    ranges = {name: sum(e.time_range.elapsed_us() for e in device
                        if lo <= e.time_range.start < hi) / 1e3
              for name, (lo, hi) in spans.items()}
    out = dict(
        variant=variant, batch=batch, wire=wire, reps=reps,
        device=torch.cuda.get_device_name(dev),
        wall_ms=statistics.median(walls),
        encode_ms=phases["encode_s"] * 1e3,
        occupancy_ms=phases["occupancy_s"] * 1e3,
        host_ms=phases["host_s"] * 1e3, workers=phases["workers"],
        wire_bytes=int(phases["wire_bytes"]),
        refine_k=phases.get("refine_k"),
        encode_device_ms=ranges.get("remesh.encode", 0.0),
        occupancy_device_ms=ranges.get("remesh.occupancy", 0.0),
        copy_device_ms=sum(e.self_device_time_total for e in kernels
                           if "DtoH" in e.key) / 1e3,
        device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
        fallbacks=int(failed.sum()))
    out["busy_share"] = out["device_ms"] / out["wall_ms"]
    print(f"  {variant}-mesh, one batch of {batch} ({wire} wire; median of "
          f"{reps}): wall {out['wall_ms']:.4f} ms, device "
          f"{out['device_ms']:.4f} ms, busy share {out['busy_share']:.3f}")
    print(f"    phases (host clock, synchronised): encode "
          f"{out['encode_ms']:.4f} ms, occupancy + copy "
          f"{out['occupancy_ms']:.4f} ms, host marching + sampling "
          f"{out['host_ms']:.4f} ms on {out['workers']} threads; wire "
          f"{out['wire_bytes']} bytes"
          + (f", refined voxels a cloud K = {out['refine_k']}"
             if out["refine_k"] else ""))
    if not kernels:
        print("    device time not measured (the profiler saw no kernel)")
    print(f"    device: encode {out['encode_device_ms']:.4f} ms, occupancy "
          f"{out['occupancy_device_ms']:.4f} ms (of which device-to-host "
          f"copies {out['copy_device_ms']:.4f} ms)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="onet", choices=["onet", "convonet"])
    ap.add_argument("--weights", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--wire", default="bf16",
                    choices=["bf16", "int8", "sparse"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_remesh_batch: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(profile(torch.device("cuda", 0), args.variant,
                             args.weights, batch=args.batch,
                             wire=args.wire)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
