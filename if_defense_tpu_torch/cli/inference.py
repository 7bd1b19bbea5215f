"""Evaluation CLI: accuracy / targeted-attack success of an npz against a
victim (port of `if_defense_tpu/cli/inference.py`).

Normal mode reports accuracy; target mode also reports targeted success
(pred == target). Add-family attack outputs get their point count grown
from the filename (+512 Add, +3*32 Cluster, +3*64 Object), like the
reference. The flags and the JSON metrics line are the JAX CLI's, plus
`--device` (default `cuda`; `cpu` only when asked). Each batch is split
over the most visible cards that divide it (`--device cuda`: every card,
`cuda:i`: that one; `parallel.best_data_mesh`), the victim copied to each
once, as the JAX CLI shards it over its mesh. Checkpoints are the
port's flat npz (`utils/checkpoint.py`; `tools/victim_ckpt_to_npz.py`
converts the JAX package's orbax directories). TF32 is off for matmuls and
convolutions, so `--boundary_tau` changes the scoring alone: the forward
is full f32 either way.

Usage:
    python -m if_defense_tpu_torch.cli.inference --data adv.npz \\
        --checkpoint victim.npz [--model pointnet] [--mode target]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.data import ModelNet40, ModelNet40Attack, batch_iterator
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.parallel import best_data_mesh, mesh_devices
from if_defense_tpu_torch.training import make_eval_step
from if_defense_tpu_torch.utils import MetricsWriter
from if_defense_tpu_torch.utils.cache import BoundedCache
from if_defense_tpu_torch.utils.checkpoint import restore_checkpoint_raw
from if_defense_tpu_torch.utils.params_io import params_from_jax


def class_margins(logits: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """Margin of class `cls` over the best OTHER class, per row.

    Positive = `cls` wins argmax by that much. Used by --boundary_tau
    scoring: robust-correct requires margin(label) > tau; targeted success
    requires margin(target) > -tau."""
    own = np.take_along_axis(logits, cls[:, None], axis=-1)[:, 0]
    masked = logits.copy()
    np.put_along_axis(masked, cls[:, None], -np.inf, axis=-1)
    return own - masked.max(-1)


def adjust_num_points(num_points: int, data_path: str) -> int:
    """Add-family attacks append points; grow the eval cloud accordingly."""
    name = os.path.basename(data_path).lower()
    if "add" in name:
        if "cluster" in name:
            return num_points + 3 * 32
        if "object" in name:
            return num_points + 3 * 64
        return num_points + 512
    return num_points


def resolve_checkpoint(checkpoint: str, model_name: str | None = None,
                       num_points: int = 1024,
                       registry: str | None = None) -> str:
    """Resolve a `registry:<dataset>` name to its checkpoint path, keyed by
    (dataset, model, num_points). Plain paths pass through unchanged."""
    if checkpoint.startswith("registry:"):
        from if_defense_tpu_torch.utils.registry import lookup_checkpoint

        if model_name is None:
            raise ValueError("registry: checkpoints need --model")
        checkpoint = lookup_checkpoint(
            checkpoint[len("registry:"):], model_name, num_points, registry)
    return checkpoint


def load_eval_model(checkpoint: str, model_name: str | None = None,
                    num_points: int = 1024, registry: str | None = None):
    """A checkpoint's victim with its weights loaded (every key, strictly),
    on the CPU; returns (model, meta). `registry:` names resolve via
    `resolve_checkpoint`. A PointNet whose params hold the feature
    transform (`PointNetFeat_0/STN_1`, trained with `--feature_transform`)
    is built with it; the JAX package's loader builds it without and
    leaves those params unused."""
    checkpoint = resolve_checkpoint(
        checkpoint, model_name, num_points, registry)
    raw = restore_checkpoint_raw(checkpoint)
    meta = raw.pop("metadata")
    name = model_name or meta.get("model")
    if name is None:
        raise ValueError(
            "checkpoint has no model metadata; pass --model explicitly")
    kwargs = {}
    if "STN_1" in raw["params"].get("PointNetFeat_0", {}):
        kwargs["feature_transform"] = True
    model = build_model(str(name), **kwargs)
    model.load_state_dict(params_from_jax(raw, model), strict=True)
    return model.eval(), meta


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate accuracy / attack success")
    p.add_argument("--data", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="victim npz (params/..., batch_stats/... keys, "
                        "model name in <path>.meta.json) or "
                        "registry:<dataset>")
    p.add_argument("--model", default=None,
                   help="override model name from checkpoint metadata")
    p.add_argument("--mode", default="normal", choices=["normal", "target"])
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--no_adjust_points", action="store_true")
    p.add_argument("--normalize", action="store_true",
                   help="re-normalize clouds (reference default is off "
                        "for defended data)")
    p.add_argument("--metrics_out", default=None)
    p.add_argument("--registry", default=None,
                   help="registry JSON for registry:<dataset> checkpoints")
    p.add_argument("--boundary_tau", type=float, default=0.0,
                   help="margin-tolerant scoring for adversarial npz: "
                        "count an example CORRECT only if the true logit "
                        "beats every other by > tau, and count targeted "
                        "SUCCESS if the target logit is within tau of the "
                        "top (CW stops exactly at the decision boundary, "
                        "so plain argmax flips with float noise). 0 = "
                        "exact argmax (reference semantics)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p.parse_args(argv)


_EVAL_CACHE = BoundedCache()


def _load_eval_cached(args, mesh):
    """(model, meta, eval_step) over the mesh's devices, cached across
    main() calls; `eval_step` (`training.make_eval_step`) takes a batch
    on the first device, runs a share on each device (a victim copy on
    each) and returns the logits there.

    Scoring many npz files against one victim in one process loads the
    checkpoint once. registry: names are resolved before keying (the
    registry file is re-read each call), and the key holds the resolved
    path's mtime, so a re-registered or re-trained checkpoint is picked
    up. num_points is not in the key: it matters only for registry
    resolution, already done. FIFO-bounded so a long sweep over many
    victims does not pin unbounded device-resident weights."""
    ck = resolve_checkpoint(
        args.checkpoint, args.model, args.num_points, args.registry)
    mtime = os.path.getmtime(ck) if os.path.exists(ck) else None
    devices = mesh_devices(mesh)
    key = (os.path.abspath(ck), mtime, args.model,
           tuple(str(d) for d in devices))

    def build():
        model, meta = load_eval_model(ck, args.model)
        model.to(devices[0])
        return model, meta, make_eval_step(model, devices)

    return _EVAL_CACHE.get_or_build(key, build)


def main(argv=None, devices=None):
    """Score the npz; the metrics record. `devices` (for tests) replaces
    the devices `--device` names, repeats allowed."""
    args = parse_args(argv)
    device_of(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = best_data_mesh(args.batch_size,
                          args.device if devices is None else devices)
    device = mesh_devices(mesh)[0]
    _, meta, eval_step = _load_eval_cached(args, mesh)

    num_points = args.num_points
    if not args.no_adjust_points:
        num_points = adjust_num_points(num_points, args.data)

    if args.mode == "target":
        ds = ModelNet40Attack(args.data, num_points, normalize=args.normalize)
    else:
        ds = ModelNet40(
            args.data, num_points, normalize=args.normalize,
            partition="test", augmentation=False,
        )

    tau = args.boundary_tau
    correct, success, total = 0, 0, 0
    for batch, valid in batch_iterator(ds, args.batch_size, pad_last=True):
        pc = torch.from_numpy(batch[0].astype(np.float32)).to(device)
        logits = eval_step(pc).cpu().numpy()[:valid]
        label = batch[1][:valid]
        if tau > 0.0:
            correct += int((class_margins(logits, label) > tau).sum())
        else:
            pred = logits.argmax(-1)
            correct += int((pred == label).sum())
        total += valid
        if args.mode == "target":
            target = batch[2][:valid]
            if tau > 0.0:
                success += int((class_margins(logits, target) > -tau).sum())
            else:
                success += int((pred == target).sum())

    acc = correct / max(total, 1)
    out = {"data": args.data, "model": meta.get("model", args.model),
           "num_points": num_points, "accuracy": acc, "n": total}
    if tau > 0.0:
        out["boundary_tau"] = tau
    if args.mode == "target":
        out["target_success"] = success / max(total, 1)
    MetricsWriter(args.metrics_out).write(**out)
    return out


if __name__ == "__main__":
    main()
