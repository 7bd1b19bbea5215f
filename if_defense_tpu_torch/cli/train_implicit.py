"""Implicit-network (ONet / ConvONet) occupancy training CLI (port of
`if_defense_tpu/cli/train_implicit.py`).

Writes `<output>.npz` in the JAX package's flat format (`params`, and
`batch_stats` for ONet), which both packages' `opt_defense` load, and
`<output>.metrics.jsonl` (step, loss, acc, steps_per_sec). Input: an
occupancy npz built by `tools/build_occupancy_dataset.py` (or any npz with
pointcloud / points / points_occ arrays). One device, eager (CUDA unless
`--device cpu`), with TF32 off for matmuls and cuDNN convolutions.

Usage:
    python -m if_defense_tpu_torch.cli.train_implicit --variant convonet \
        --data occ_mn40.npz --steps 100000 --output weights/convonet_mn40
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.implicit.training import (
    OccupancyBatchSampler,
    init_occupancy_model,
    make_occupancy_train_step,
)
from if_defense_tpu_torch.utils.metrics import MetricsWriter
from if_defense_tpu_torch.utils.params_io import params_to_jax, save_params_npz


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train an occupancy network")
    p.add_argument("--variant", default="convonet",
                   choices=["convonet", "onet"])
    p.add_argument("--data", required=True, help="occupancy npz")
    p.add_argument("--val_data", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--pointcloud_n", type=int, default=None,
                   help="encoder input points (default 600 conv/300 onet)")
    p.add_argument("--pointcloud_noise", type=float, default=0.005)
    p.add_argument("--points_subsample", type=int, default=2048)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--output", default="weights/implicit")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card pass --device cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    if device.type == "cuda":
        # f32 reference numerics: no TF32 in matmuls or cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".",
                exist_ok=True)
    metrics = MetricsWriter(args.output + ".metrics.jsonl")

    if args.variant == "convonet":
        model = ConvOccupancyNetwork()
        pointcloud_n = args.pointcloud_n or 600
    else:
        model = OccupancyNetwork()
        pointcloud_n = args.pointcloud_n or 300

    with np.load(args.data) as npz:
        sampler = OccupancyBatchSampler(
            pointcloud=npz["pointcloud"],
            points=npz["points"],
            points_occ=npz["points_occ"],
            pointcloud_n=pointcloud_n,
            pointcloud_noise=args.pointcloud_noise,
            points_subsample=args.points_subsample,
            seed=args.seed,
        )

    init_occupancy_model(model, args.seed)
    model.to(device)
    _, train_step = make_occupancy_train_step(model, args.lr)

    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = [torch.from_numpy(a).to(device)
                 for a in sampler.sample(args.batch_size)]
        m = train_step(*batch)
        if step % args.log_every == 0 or step == args.steps:
            metrics.write(step=step, loss=float(m["loss"]),
                          acc=float(m["acc"]),
                          steps_per_sec=step / (time.time() - t0))
        if step % args.save_every == 0 or step == args.steps:
            save_params_npz(args.output + ".npz",
                            params_to_jax(model.state_dict(), model))
    print(f"weights saved to {args.output}.npz")
    return args.output + ".npz"


if __name__ == "__main__":
    main()
