"""Checkpoint registry: the BEST_WEIGHTS equivalent (a copy of
`if_defense_tpu/utils/registry.py`, over the same JSON layout).

The reference hard-codes a dataset -> num_points -> model table of
pretrained paths (`baselines/config.py:4-41`). This registry is a JSON file
(`weights/registry.json` by default) edited through the API, so evaluation
tooling resolves checkpoints the way `inference.py` resolved BEST_WEIGHTS.
"""

from __future__ import annotations

import json
import os

DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights",
    "registry.json",
)


def _load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def register_checkpoint(
    dataset: str, model: str, checkpoint: str,
    num_points: int = 1024, path: str | None = None,
):
    """Record the best checkpoint for (dataset, num_points, model)."""
    path = path or DEFAULT_PATH
    reg = _load(path)
    reg.setdefault(dataset, {}).setdefault(str(num_points), {})[model] = (
        os.path.abspath(checkpoint)
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(reg, f, indent=2, sort_keys=True)
    return reg


def lookup_checkpoint(
    dataset: str, model: str, num_points: int = 1024,
    path: str | None = None,
) -> str:
    path = path or DEFAULT_PATH
    reg = _load(path)
    try:
        return reg[dataset][str(num_points)][model]
    except KeyError:
        raise KeyError(
            f"no checkpoint registered for {dataset}/{num_points}/{model}; "
            f"train one and call register_checkpoint (registry: {path})"
        ) from None
