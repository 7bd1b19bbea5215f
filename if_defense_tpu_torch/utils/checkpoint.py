"""Victim checkpoints as flat npz files (the read side of
`if_defense_tpu/utils/checkpoint.py`, and the writer of the same format).

The JAX package saves orbax directories, and orbax imports JAX, so the
port reads a flat npz instead: the flax variables flattened with
'/'-joined keys, `params/...` and `batch_stats/...` (the `params_io`
layout), beside the JAX package's metadata sidecar `<path>.meta.json`,
which names the model. `tools/victim_ckpt_to_npz.py` turns an orbax
checkpoint of the JAX package into such a file.
"""

from __future__ import annotations

import json
import os

from if_defense_tpu_torch.utils.params_io import (
    load_params_npz,
    save_params_npz,
)

CONVERTER = "tools/victim_ckpt_to_npz.py"


def load_metadata(path: str) -> dict:
    """The sidecar `<path>.meta.json`, or {} where there is none."""
    meta_path = os.path.abspath(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def restore_checkpoint_raw(path: str) -> dict:
    """A victim checkpoint npz -> {"params": ..., "batch_stats": ... (where
    saved), "metadata": {...}}, nested numpy trees. Exits with a message
    naming the converter where `path` is an orbax directory."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise SystemExit(
            f"{path} is a directory (an orbax checkpoint of the JAX package); "
            f"the port reads a flat npz: convert it with `python {CONVERTER} "
            f"{path} OUT.npz`")
    tree = load_params_npz(path)
    unknown = set(tree) - {"params", "batch_stats"}
    if "params" not in tree or unknown:
        raise ValueError(f"{path}: not a victim checkpoint (top-level keys "
                         f"{sorted(tree)}, want params and batch_stats)")
    tree["metadata"] = load_metadata(path)
    return tree


def save_eval_checkpoint(path: str, variables: dict,
                         metadata: dict | None = None) -> str:
    """Flax variables {"params": ..., "batch_stats": ...} as a flat npz at
    `path` (".npz" appended where it lacks it, as numpy does), with the
    metadata sidecar `<path>.meta.json` where given. -> the npz's path."""
    path = os.path.abspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    save_params_npz(path, {k: v for k, v in variables.items()
                           if k in ("params", "batch_stats")})
    if metadata:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, default=float)
    return path
