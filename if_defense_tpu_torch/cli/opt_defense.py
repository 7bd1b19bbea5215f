"""IF-Defense optimisation CLI, ConvONet-Opt and ONet-Opt (port of
`if_defense_tpu/cli/opt_defense.py`).

Reads npz, restores every test (and optionally train) cloud by
implicit-surface optimisation, writes `convonet_opt-<file>.npz` into a
`ConvONet-Opt/` subfolder beside the input (`onet_opt-<file>.npz` into
`ONet-Opt/` for `--variant onet`, whose weights npz holds `params` and
`batch_stats`), with a `.metrics.jsonl`
sidecar. One device, eager (CUDA unless `--device cpu`); the tail batch
is padded to the full batch size, because the loss (and so Adam's step
near its eps) depends on B.
f32 modes run with TF32 off for matmuls and cuDNN convolutions.

Usage:
    python -m if_defense_tpu_torch.cli.opt_defense --variant convonet \
        --data_root adv.npz --weights weights/convonet_mn40.npz
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.data import load_npz, save_npz
from if_defense_tpu_torch.defense.ifdefense import (
    convonet_opt_defense,
    onet_opt_defense,
)
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, OccupancyNetwork
from if_defense_tpu_torch.utils.params_io import (
    load_params_npz,
    params_from_jax,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="IF-Defense opt restoration")
    p.add_argument("--variant", default="convonet",
                   choices=["convonet", "onet"])
    p.add_argument("--data_root", required=True,
                   help="npz file or directory")
    p.add_argument("--weights", required=True,
                   help="pretrained implicit-model params npz")
    p.add_argument("--train", action="store_true",
                   help="also defend train_pc (hybrid training data)")
    p.add_argument("--sample_npoint", type=int, default=1024)
    p.add_argument("--padding_scale", type=float, default=0.9)
    p.add_argument("--init_sigma", type=float, default=0.01)
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=192)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--rep_weight", type=float, default=500.0)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--no_sor", action="store_true")
    p.add_argument("--sor_k", type=int, default=2)
    p.add_argument("--sor_alpha", type=float, default=1.1)
    p.add_argument("--knn_refresh", type=int, default=1,
                   help="rebuild the repulsion kNN graph every R "
                        "iterations (1 = reference semantics)")
    p.add_argument("--exact_knn", action="store_true",
                   help="index-carrying exact top-k repulsion path instead "
                        "of the fused kernel")
    p.add_argument("--interp_refresh", type=int, default=1,
                   help="refresh the decoder's cached bilinear corner "
                        "features every R iterations (1 = reference "
                        "semantics)")
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16"],
                   help="run the decoder/repulsion fwd+bwd in bf16 "
                        "(f32 master points + Adam)")
    p.add_argument("--rep_graph_cache", action="store_true",
                   help="freeze the repulsion neighbour graph per "
                        "corner-cache window (requires --interp_refresh > 1)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card pass --device cpu")
    return p.parse_args(argv)


def build_defend_fn(args, device: torch.device):
    """The ConvONet-Opt or ONet-Opt defense over the weights file, on
    `device`. As in the JAX CLI, `--interp_refresh` and
    `--rep_graph_cache` apply to ConvONet only."""
    if args.variant == "convonet":
        model, make = ConvOccupancyNetwork(), convonet_opt_defense
        extra = dict(interp_refresh=args.interp_refresh,
                     rep_graph_cache=args.rep_graph_cache)
    else:
        model, make, extra = OccupancyNetwork(), onet_opt_defense, {}
    model.load_state_dict(
        params_from_jax(load_params_npz(args.weights), model))
    model.to(device).eval()
    return make(
        model,
        sample_npoint=args.sample_npoint,
        padding_scale=args.padding_scale,
        init_sigma=args.init_sigma,
        iterations=args.iterations,
        lr=args.lr,
        rep_weight=args.rep_weight,
        threshold=args.threshold,
        sor=not args.no_sor,
        sor_k=args.sor_k,
        sor_alpha=args.sor_alpha,
        knn_refresh=args.knn_refresh,
        exact_knn=args.exact_knn,
        compute_dtype=args.compute_dtype,
        **extra,
    )


def defend_clouds(defend, pc: np.ndarray, args, device: torch.device,
                  generator: torch.Generator, losses: list) -> np.ndarray:
    """Run the defense over all clouds in batches, padding the tail batch
    with copies of its last cloud. Appends each batch's first- and
    last-step occupancy losses to `losses`."""
    B = args.batch_size
    outs = []
    for i in range(0, len(pc), B):
        batch = pc[i : i + B].astype(np.float32)
        pad = B - len(batch)
        if pad:
            batch = np.concatenate([batch, batch[-1:].repeat(pad, 0)], 0)
        stats = {}
        out = defend(torch.from_numpy(batch).to(device), generator,
                     stats=stats)
        outs.append(out[: B - pad] if pad else out)
        losses.append((stats["occ_loss_first"], stats["occ_loss_last"]))
    return torch.cat(outs, 0).cpu().numpy()


def get_save_name(path: str, variant: str) -> str:
    folder = os.path.join(
        os.path.dirname(os.path.abspath(path)),
        "ConvONet-Opt" if variant == "convonet" else "ONet-Opt",
    )
    return os.path.join(folder, f"{variant}_opt-{os.path.basename(path)}")


def defend_file(path: str, defend, args, device: torch.device) -> str:
    d = load_npz(path)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    losses: list = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = {"test_label": d.test_label}
    if d.target_label is not None:
        out["target_label"] = d.target_label
    out["test_pc"] = defend_clouds(defend, d.test_pc[..., :3], args, device,
                                   generator, losses)
    n = len(out["test_pc"])
    if args.train:
        out["train_pc"] = defend_clouds(defend, d.train_pc[..., :3], args,
                                        device, generator, losses)
        out["train_label"] = d.train_label
        n += len(out["train_pc"])
    dt = time.perf_counter() - t0        # ends in a device-to-host copy
    save_path = get_save_name(path, args.variant)
    save_npz(save_path, out)
    first = [float(a) for a, _ in losses]
    last = [float(b) for _, b in losses]
    record = dict(
        time=time.time(), variant=args.variant, data=path, clouds=n,
        seconds=dt, clouds_per_sec=n / max(dt, 1e-9), output=save_path,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        occ_loss_first=float(np.mean(first)),
        occ_loss_last=float(np.mean(last)))
    line = json.dumps(record)
    with open(save_path + ".metrics.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)
    print(f"defense result saved to {save_path} "
          f"({n} clouds in {dt:.1f}s, {n / max(dt, 1e-9):.2f} clouds/s)")
    return save_path


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    if device.type == "cuda" and args.compute_dtype is None:
        # f32 reference numerics: no TF32 in matmuls or cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    defend = build_defend_fn(args, device)
    if os.path.isdir(args.data_root):
        files = [
            os.path.join(args.data_root, f)
            for f in sorted(os.listdir(args.data_root))
            if os.path.isfile(os.path.join(args.data_root, f))
        ]
    else:
        files = [args.data_root]
    return [defend_file(f, defend, args, device) for f in files]


if __name__ == "__main__":
    main()
