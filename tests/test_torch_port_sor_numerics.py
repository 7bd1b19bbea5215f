"""The port's SOR (`if_defense_tpu_torch.defense.sor`) against a float64
oracle, on the CPU.

The reference computes SOR's k=2-NN statistic in float64
(`baselines/defense/drop_points/SOR.py:31-37`); the port computes it in
f32. The mu + 1.1 sigma threshold is the kind of statistic a precision
change can flip, so the four input families of `tests/test_sor_numerics.py`
bound the inlier-set disagreement with the same bounds:

  - ModelNet-like unit-sphere clouds (1024-4096 points): no flip at all;
  - a dense cluster (sigma 1e-3) plus far outliers: the outliers dropped
    exactly as by the oracle;
  - near-duplicate 1e-3-scale offsets away from the origin (f32's worst
    case: squared distances ~1e-6 next to coordinates ~1);
  - the statistic itself within 2e-6 of float64 on [-1, 1] coordinates.

Any flip must be borderline: the point's statistic within 1e-6 absolute
(or 1e-3 relative) of the threshold, and at most 1 % of a cloud's points.
The oracle and the flip check are this file's own copies.
"""

import numpy as np
import pytest
import torch

from if_defense_tpu_torch.defense.sor import sor_defense, sor_statistics


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle_f64(pc: np.ndarray, k: int = 2, alpha: float = 1.1):
    """Reference SOR in float64 (`SOR.py:31-47`), returning (mask, value,
    threshold)."""
    pc = pc.astype(np.float64)
    inner = -2.0 * pc @ pc.transpose(0, 2, 1)
    xx = np.sum(pc**2, axis=-1, keepdims=True)
    dist = xx + inner + xx.transpose(0, 2, 1)            # [B, K, K]
    # reference: topk(k+1) of -dist, drop the first (self)
    part = np.sort(dist, axis=-1)[..., 1 : k + 1]        # [B, K, k]
    value = part.mean(axis=-1)                           # [B, K]
    mean = value.mean(axis=-1, keepdims=True)
    std = value.std(axis=-1, ddof=1, keepdims=True)      # Bessel like torch
    threshold = mean + alpha * std
    return value <= threshold, value, threshold


def _agreement(pc: np.ndarray):
    _, mask = sor_defense(torch.from_numpy(pc.astype(np.float32)))
    got = mask.numpy() > 0.5
    want, value, threshold = _oracle_f64(pc)
    return got, want, got != want, value, threshold


def _assert_flips_borderline(pc, max_flip_frac=0.01):
    got, want, flips, value, threshold = _agreement(pc)
    B, K = flips.shape
    assert flips.mean(axis=-1).max() <= max_flip_frac, (
        f"{flips.sum()} flips / {B * K} points")
    if flips.any():
        # every flip must be a genuinely borderline point
        margin = np.abs(value - threshold)
        tol = np.maximum(1e-6, 1e-3 * np.abs(threshold))
        bad = flips & (margin > tol)
        assert not bad.any(), (
            f"non-borderline flip: margin {margin[bad].max():.3e} vs tol "
            f"{tol[bad].min():.3e}")
    return flips


def test_sor_matches_f64_on_modelnet_like_clouds():
    rng = np.random.default_rng(0)
    for n in (1024, 4096):
        pts = rng.normal(size=(4, n, 3))
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)  # unit sphere
        pts += rng.normal(size=pts.shape) * 0.02            # surface jitter
        flips = _assert_flips_borderline(pts.astype(np.float32))
        # benign family: agreement is exact
        assert not flips.any()


def test_sor_matches_f64_cluster_plus_outliers():
    rng = np.random.default_rng(1)
    n, n_out = 1024, 124
    center = np.array([0.4, -0.3, 0.5])
    dense = center + rng.normal(size=(2, n - n_out, 3)) * 1e-3
    far = rng.uniform(-1.0, 1.0, size=(2, n_out, 3))
    pts = np.concatenate([dense, far], axis=1).astype(np.float32)
    _assert_flips_borderline(pts)
    # the far outliers are dropped exactly as by the oracle
    _, _, flips, _, _ = _agreement(pts)
    assert not flips[:, n - n_out :].any()


def test_sor_near_duplicate_offsets_off_origin():
    rng = np.random.default_rng(2)
    for n in (1024, 2048):
        base = rng.uniform(-1.0, 1.0, size=(2, n // 4, 3))
        jitter = rng.normal(size=(2, n, 3)) * 1e-3
        pts = (np.repeat(base, 4, axis=1) + jitter).astype(np.float32)
        _assert_flips_borderline(pts)


def test_sor_statistic_absolute_accuracy():
    """The f32 statistic stays within 2e-6 of float64 at ModelNet scales
    (coordinates in [-1, 1])."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.0, 1.0, size=(2, 1024, 3)).astype(np.float32)
    got = sor_statistics(torch.from_numpy(pts)).numpy()
    _, value, _ = _oracle_f64(pts)
    assert np.abs(got - value).max() < 2e-6
