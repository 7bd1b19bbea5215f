"""The protocol's kNN attack, PyTorch port vs JAX package, at a tiny size
on the CPU (`tools/knn_attack_vs_jax.py`, which runs it at full width for
2,500 iterations).

Two clouds of the hard family at 1,024 points, with their analytic normals
and pair-partner targets, attacked for 30 iterations with the protocol's
flags (lr 1e-3, kappa 15, budget 0.1, `chamfer_knn_dist`) on a full-width
PointNet at JAX's initial weights (untrained: the attack's arithmetic is
what is held here), JAX's initial noise handed to the port. The bound is
the tool's: at iterations 1, 10 and 30 the port's mean coordinate gap from
JAX at most 1.5 times JAX's own gap on the clouds moved by one unit in the
last place, or under 1e-6. The control: the port at lr x 1.05, run beside
it, misses that bound at the last check.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import knn_attack_vs_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_threads():
    """The tool runs torch in one thread; the worker's count comes back."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def test_knn_attack_within_yardstick_and_sees_a_fault(tmp_path):
    report = knn_attack_vs_jax.main([
        "--out_dir", str(tmp_path), "--clouds", "2", "--iters", "30",
        "--checks", "1", "10", "30", "--train_per_class", "1",
        "--test_per_class", "1", "--epochs", "0", "--faults", "lr x 1.05"])
    assert report["victim_epochs"] == 0
    assert set(report["checks"]) == {1, 10, 30}
    assert report["bound_held"], report["misses"]
    assert report["faults_missed"] == {"lr x 1.05": True}
    last = report["checks"][30]
    assert all(len(last[n]["success"]) == 2 for n in last)
    assert os.path.exists(tmp_path / "knn_attack_vs_jax.json")
