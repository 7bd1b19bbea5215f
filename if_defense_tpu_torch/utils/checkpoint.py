"""Victim checkpoints as flat npz files (the port of
`if_defense_tpu/utils/checkpoint.py`).

The JAX package saves orbax directories, and orbax imports JAX, so the
port writes and reads a flat npz instead: the flax variables flattened
with '/'-joined keys, `params/...` and `batch_stats/...` (the `params_io`
layout), beside the JAX package's metadata sidecar `<path>.meta.json`,
which names the model. A train checkpoint (`save_checkpoint`) adds the
optimiser's sidecar `<path>.opt.npz`: optax's Adam state in the flax
layout (`opt_state/count`, `opt_state/mu/...`, `opt_state/nu/...`) and
`step`, so the npz itself stays an eval checkpoint that `cli/inference.py`
and `cli/attack.py` load. `tools/victim_ckpt_to_npz.py` turns an orbax
checkpoint of the JAX package into such files.
"""

from __future__ import annotations

import json
import os

import numpy as np

from if_defense_tpu_torch.utils.params_io import (
    adam_state_from_jax,
    adam_state_to_jax,
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
)

CONVERTER = "tools/victim_ckpt_to_npz.py"
OPT_SUFFIX = ".opt.npz"


def npz_path(path: str) -> str:
    """`path` as an absolute npz path, ".npz" appended where it lacks it (as
    numpy does)."""
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else path + ".npz"


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
                         metadata: dict | None = None,
                         compress: bool = True) -> str:
    """Flax variables {"params": ..., "batch_stats": ...} as a flat npz at
    `path` (".npz" appended where it lacks it; `compress` as
    `save_params_npz`), with the metadata sidecar `<path>.meta.json` where
    given. -> the npz's path."""
    path = npz_path(path)
    save_params_npz(path, {k: v for k, v in variables.items()
                           if k in ("params", "batch_stats")}, compress)
    if metadata:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, default=float)
    return path


def save_checkpoint(path: str, state, metadata: dict | None = None) -> str:
    """A `training.TrainState` at `path` (".npz" appended where it lacks
    it): the eval npz of its model's variables, the metadata sidecar, and
    the optimiser's sidecar `<npz>.opt.npz` (Adam's count and moments in
    the flax layout, and the step), both npz uncompressed. -> the npz's
    path."""
    path = save_eval_checkpoint(
        path, params_to_jax(state.model.state_dict(), state.model), metadata,
        compress=False)
    save_params_npz(path + OPT_SUFFIX, {
        "opt_state": adam_state_to_jax(state.optimizer.state_dict(),
                                       state.model),
        "step": np.asarray(state.step, np.int64)}, compress=False)
    return path


def restore_checkpoint(path: str, state) -> tuple:
    """Restore a `save_checkpoint` (or a converted JAX train checkpoint)
    into `state` (a `training.TrainState` of the same model): the model's
    variables, Adam's moments and count, the step, and the schedule moved
    to that step. -> (state, metadata)."""
    path = npz_path(path)
    raw = restore_checkpoint_raw(path)
    meta = raw.pop("metadata")
    state.model.load_state_dict(params_from_jax(raw, state.model), strict=True)
    if not os.path.exists(path + OPT_SUFFIX):
        raise ValueError(f"{path}: no optimiser state ({path}{OPT_SUFFIX}); "
                         "an eval checkpoint cannot be resumed")
    side = load_params_npz(path + OPT_SUFFIX)
    state.optimizer.load_state_dict(adam_state_from_jax(
        side["opt_state"], state.model, state.optimizer.state_dict()))
    state.set_step(int(side["step"]))
    return state, meta
