"""The single npz interchange schema every pipeline communicates through.

A copy of `if_defense_tpu/data/npz.py` (which needs no JAX itself, but its
package's `__init__` imports JAX):
    train_pc     [num_train, K, 3] or [num_train, K, 6] (xyz + normals)
    train_label  [num_train]
    test_pc      [num_test, K, 3] or [num_test, K, 6]
    test_label   [num_test]
    target_label [num_test]   (attack target, optional)

Attack outputs may carry only test_* (+ target_label); defense outputs
preserve whatever labels were present.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

KEYS = ("train_pc", "train_label", "test_pc", "test_label", "target_label")


@dataclasses.dataclass
class NpzData:
    train_pc: np.ndarray | None = None
    train_label: np.ndarray | None = None
    test_pc: np.ndarray | None = None
    test_label: np.ndarray | None = None
    target_label: np.ndarray | None = None

    def asdict(self) -> dict:
        return {
            k: v for k, v in dataclasses.asdict(self).items() if v is not None
        }


def load_npz(path: str) -> NpzData:
    """Load a dataset/attack/defense npz file."""
    out = NpzData()
    with np.load(path, allow_pickle=False) as npz:
        for key in KEYS:
            if key in npz.files:
                setattr(out, key, npz[key])
    return out


def save_npz(path: str, data: NpzData | dict) -> str:
    """Save with the reference dtype conventions (f32 points, u8 labels)."""
    if isinstance(data, NpzData):
        data = data.asdict()
    cast = {}
    for k, v in data.items():
        if v is None:
            continue
        if k.endswith("_pc"):
            cast[k] = np.asarray(v, dtype=np.float32)
        else:
            cast[k] = np.asarray(v, dtype=np.uint8)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    np.savez(path, **cast)
    return path if path.endswith(".npz") else path + ".npz"
