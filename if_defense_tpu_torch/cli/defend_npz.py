"""Baseline-defense CLI: SRS / SOR / DUP-Net over npz files (port of
`if_defense_tpu/cli/defend_npz.py`).

Reads `test_pc`, applies each defense in fixed-size batches (the tail batch
padded with copies of its last cloud, then cut back) and writes
`<defense>_<file>.npz` into a `<defense>/` subfolder beside the input. All
three defenses when `--defense` is empty. SOR's output is fixed-shape
(inliers first, cyclically duplicated padding). One device, eager: CUDA
unless `--device cpu`, with TF32 off for matmuls (f32 reference numerics).
Random draws (SRS, DUP-Net's resampling) come from one `torch.Generator`
per file and defense, seeded by `--seed`.

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


def build_defense_fn(name: str, args, device: torch.device):
    """fn(batch [B, K, 3] on `device`, generator) -> defended batch."""
    if name == "srs":
        return lambda pc, gen: srs_defense(pc, args.srs_drop_num, gen)
    if name == "sor":
        return lambda pc, gen: sor_defense_fixed(pc, args.sor_k,
                                                 args.sor_alpha)[0]
    if name == "dup":
        dup = DUPNet(sor_k=args.sor_k, sor_alpha=args.sor_alpha,
                     npoint=args.npoint, up_ratio=4)
        dup.pu_net.load_state_dict(
            params_from_jax(load_params_npz(args.punet_weights), dup.pu_net))
        dup.to(device).eval()
        return dup
    raise ValueError(name)


def defend_file(path: str, name: str, args, run, device: torch.device) -> str:
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


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
        run = build_defense_fn(name, args, device)
        for f in files:
            paths.append(defend_file(f, name, args, run, device))
    return paths


if __name__ == "__main__":
    main()
