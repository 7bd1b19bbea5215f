"""Baseline-defense CLI: SRS / SOR / DUP-Net over npz files (port of
`if_defense_tpu/cli/defend_npz.py`).

Reads `test_pc`, applies each defense in fixed-size batches (the tail batch
padded with copies of its last cloud, then cut back) and writes
`<defense>_<file>.npz` into a `<defense>/` subfolder beside the input. All
three defenses when `--defense` is empty. SOR's output is fixed-shape
(inliers first, cyclically duplicated padding). Eager, on the card
unless `--device cpu`, with TF32 off for matmuls (f32 reference numerics).
Random draws (SRS, DUP-Net's resampling) come from one `torch.Generator`
per file and defense, seeded by `--seed`. Each batch is split over the
most visible cards that divide it (`--device cuda`: every card, `cuda:i`:
that one; `parallel.best_data_mesh`), as the JAX CLI shards it over its
mesh: a split batch's draws are made for the whole batch on the first
card, then split with it, so it gives what the unsplit batch gives.

Usage:
    python -m if_defense_tpu_torch.cli.defend_npz --data_root adv.npz \
        [--defense srs|sor|dup] [--punet_weights weights/punet_1024_up4.npz]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.data import load_npz, save_npz
from if_defense_tpu_torch.defense import DUPNet, sor_defense_fixed, srs_defense
from if_defense_tpu_torch.parallel import (
    best_data_mesh,
    mesh_devices,
    replicate,
    run_shards,
    shard_batch,
)
from if_defense_tpu_torch.utils.params_io import (
    load_params_npz,
    params_from_jax,
)

DEFAULT_PUNET_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights",
    "punet_1024_up4.npz",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Apply baseline defenses to npz")
    p.add_argument("--data_root", required=True,
                   help="npz file or directory of npz files")
    p.add_argument("--defense", default="", choices=["", "srs", "sor", "dup"],
                   help="apply all three if unspecified")
    p.add_argument("--srs_drop_num", type=int, default=500)
    p.add_argument("--sor_k", type=int, default=2)
    p.add_argument("--sor_alpha", type=float, default=1.1)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--npoint", type=int, default=1024,
                   help="DUP-Net PU-Net input size")
    p.add_argument("--punet_weights", default=DEFAULT_PUNET_WEIGHTS)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card pass --device cpu")
    return p.parse_args(argv)


def _uniforms(pc: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The [B, K] uniforms that SRS and DUP-Net's resampling draw."""
    return torch.rand(pc.shape[:2], generator=gen, device=pc.device)


def build_defense_fn(name: str, args, mesh):
    """fn(batch [B, K, 3] on the mesh's first device, generator) ->
    defended batch there. The batch's uniforms are drawn whole, then the
    batch and its draws are split over the devices and the shares
    concatenated."""
    devices = mesh_devices(mesh)
    if name == "srs":
        def one(pc, u):
            return srs_defense(pc, args.srs_drop_num,
                               perm=torch.argsort(u, dim=-1))
        runs = [one] * len(devices)
    elif name == "sor":
        def one(pc, u):
            return sor_defense_fixed(pc, args.sor_k, args.sor_alpha)[0]
        runs = [one] * len(devices)
    elif name == "dup":
        dup = DUPNet(sor_k=args.sor_k, sor_alpha=args.sor_alpha,
                     npoint=args.npoint, up_ratio=4)
        dup.pu_net.load_state_dict(
            params_from_jax(load_params_npz(args.punet_weights), dup.pu_net))
        dup.to(devices[0]).eval()
        runs = [lambda pc, u, m=m: m(pc, u=u) for m in replicate(dup, mesh)]
    else:
        raise ValueError(name)

    def run(pc, gen):
        u = None if name == "sor" else _uniforms(pc, gen)
        return run_shards(lambda i, part: runs[i](*part).to(devices[0]),
                          shard_batch((pc, u), mesh), devices)
    return run


def defend_file(path: str, name: str, args, run, device: torch.device) -> str:
    """Defend one npz with `run` (`build_defense_fn`), its batches on
    `device`; the saved path."""
    d = load_npz(path)
    test_pc = d.test_pc[..., :3].astype(np.float32)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    B = args.batch_size
    outs = []
    with torch.inference_mode():
        for i in range(0, len(test_pc), B):
            batch = test_pc[i : i + B]
            pad = B - len(batch)
            if pad:
                batch = np.concatenate([batch, batch[-1:].repeat(pad, 0)], 0)
            out = run(torch.from_numpy(batch).to(device), generator)
            outs.append((out[: B - pad] if pad else out).cpu().numpy())
    def_pc = np.concatenate(outs, 0)

    folder = os.path.join(os.path.dirname(os.path.abspath(path)), name)
    save_path = os.path.join(folder, f"{name}_{os.path.basename(path)}")
    save_npz(save_path, {"test_pc": def_pc, "test_label": d.test_label,
                         "target_label": d.target_label})
    print(f"{name} defense saved to {save_path}")
    return save_path


def main(argv=None, devices=None):
    """Apply the defenses to every npz of `--data_root`; the saved paths.
    `devices` (for tests) replaces the devices `--device` names, repeats
    allowed."""
    args = parse_args(argv)
    if device_of(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = best_data_mesh(args.batch_size,
                          args.device if devices is None else devices)
    device = mesh_devices(mesh)[0]
    defenses = [args.defense] if args.defense else ["srs", "sor", "dup"]
    if os.path.isdir(args.data_root):
        files = [
            os.path.join(args.data_root, f)
            for f in sorted(os.listdir(args.data_root))
            if os.path.isfile(os.path.join(args.data_root, f))
        ]
    else:
        files = [args.data_root]
    paths = []
    for name in defenses:
        run = build_defense_fn(name, args, mesh)
        for f in files:
            paths.append(defend_file(f, name, args, run, device))
    return paths


if __name__ == "__main__":
    main()
