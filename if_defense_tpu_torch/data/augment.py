"""Point-cloud augmentation (host-side numpy, seeded): a copy of
`if_defense_tpu/data/augment.py` (numpy only; its package imports JAX).

Same transforms as `baselines/util/augmentation.py:9-50`: random y-axis
rotation, clipped Gaussian jitter, anisotropic translate (unused by the
training recipe but kept for parity).
"""

from __future__ import annotations

import numpy as np


def rotate_point_cloud(pc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Rotate [N, 3] points around the up (y) axis by a random angle."""
    angle = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=pc.dtype)
    return pc @ rot


def jitter_point_cloud(
    pc: np.ndarray,
    rng: np.random.Generator,
    sigma: float = 0.01,
    clip: float = 0.05,
) -> np.ndarray:
    """Add clipped per-point Gaussian noise to [N, 3] points."""
    noise = np.clip(sigma * rng.standard_normal(pc.shape), -clip, clip)
    return pc + noise.astype(pc.dtype)


def translate_point_cloud(pc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random anisotropic scale + shift on [N, 3] points."""
    xyz1 = rng.uniform(2.0 / 3.0, 3.0 / 2.0, size=3)
    xyz2 = rng.uniform(-0.2, 0.2, size=3)
    return (pc * xyz1 + xyz2).astype(np.float32)
