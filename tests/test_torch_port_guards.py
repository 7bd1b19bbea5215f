"""Guards of the PyTorch port (`if_defense_tpu_torch`): it never imports
JAX, flax, optax, orbax or the JAX package, its seeded weights have the
flax model's keys and shapes, the flax tree loads into its modules with no
key left over, and its npz schema round-trips with the JAX package's."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from if_defense_tpu.data import load_npz as jax_load_npz
from if_defense_tpu.data import save_npz as jax_save_npz
from if_defense_tpu.implicit import ConvOccupancyNetwork as JaxConvONet
from if_defense_tpu_torch.data import load_npz, save_npz
from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    init_params,
    load_params_npz,
    params_from_jax,
    save_params_npz,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
sys.modules["orbax"] = None
sys.modules["if_defense_tpu"] = None
import if_defense_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "if_defense_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    """Every module of the port imports with jax/flax/optax/orbax and the
    JAX package blocked."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 46      # every module was walked


def test_port_sources_import_no_jax():
    """No source of the port imports those packages anywhere, not even
    inside a function (which the import walk above does not run)."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|"
                         r"if_defense_tpu)\b(?!_torch)", re.M)
    files = sorted(Path(ROOT, "if_defense_tpu_torch").rglob("*.py"))
    assert len(files) >= 46
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
           for m in pattern.finditer(f.read_text())]
    assert not bad, bad


def _flax_params(**cfg):
    """The tree `ConvOccupancyNetwork(**cfg).init` gives, as zeros of its
    shapes (`eval_shape` traces init without running it)."""
    model = JaxConvONet(**cfg)
    x = jnp.zeros((1, 32, 3))
    shapes = jax.eval_shape(model.init, jax.random.key(0), x, x)
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_init_params_matches_flax_init():
    for cfg in ({}, {"c_dim": 8, "hidden_dim": 8, "plane_resolution": 16}):
        want = {k: v.shape for k, v in flatten_params(_flax_params(**cfg)).items()}
        dims = {k: cfg[k] for k in ("c_dim", "hidden_dim") if k in cfg}
        got = init_params(0, **dims)
        assert {k: v.shape for k, v in flatten_params(got).items()} == want
        assert all(np.all(v != 0) for v in flatten_params(got).values())


def test_params_from_jax_loads_every_key(tmp_path):
    tree = _flax_params()
    path = str(tmp_path / "w.npz")
    save_params_npz(path, tree)
    model = ConvOccupancyNetwork()
    sd = params_from_jax(load_params_npz(path), model)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert len(sd) == len(flatten_params(tree))


def test_npz_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    data = {"test_pc": rng.normal(size=(3, 16, 3)),
            "test_label": np.array([1, 2, 3]),
            "target_label": np.array([4, 5, 6])}
    a = jax_save_npz(str(tmp_path / "a.npz"), data)
    b = save_npz(str(tmp_path / "b.npz"), data)
    for x, y in ((jax_load_npz(a), load_npz(b)), (load_npz(a), jax_load_npz(b))):
        assert x.asdict().keys() == y.asdict().keys()
        for k in x.asdict():
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
            assert getattr(x, k).dtype == getattr(y, k).dtype
    assert load_npz(b).train_pc is None


def test_cli_onet_variant_defends_a_file_on_cpu(tmp_path):
    """`--variant onet` restores a file on the CPU from a weights npz with
    `params` and `batch_stats` (narrow ONet widths would not load: the CLI
    builds the shipped configuration), into `ONet-Opt/` under the
    reference's name."""
    from if_defense_tpu_torch.cli import opt_defense
    from if_defense_tpu_torch.utils.params_io import flax_init_params

    rng = np.random.default_rng(1)
    data = save_npz(str(tmp_path / "adv.npz"),
                    {"test_pc": rng.normal(size=(3, 128, 3)) * 0.3,
                     "test_label": np.array([2, 7, 1])})
    weights = save_params_npz(str(tmp_path / "w.npz"),
                              flax_init_params(0, "onet"))
    (out,) = opt_defense.main([
        "--variant", "onet", "--data_root", data, "--weights", weights,
        "--device", "cpu", "--batch_size", "2", "--iterations", "2",
        "--sample_npoint", "64"])
    assert out == str(tmp_path / "ONet-Opt" / "onet_opt-adv.npz")
    got = load_npz(out)
    assert got.test_pc.shape == (3, 64, 3) and np.isfinite(got.test_pc).all()
    np.testing.assert_array_equal(got.test_label, [2, 7, 1])
    assert np.sqrt((got.test_pc ** 2).sum(-1)).max() <= 1 + 1e-5


def test_cli_defends_a_file_on_cpu(tmp_path):
    """The port's CLI at full width on the CPU, a few steps: the tail batch
    is padded and cut back, the output lands in `ConvONet-Opt/` under the
    reference's name, and the metrics sidecar gets one line."""
    from if_defense_tpu_torch.cli import opt_defense

    rng = np.random.default_rng(0)
    data = save_npz(str(tmp_path / "adv.npz"),
                    {"test_pc": rng.normal(size=(3, 128, 3)) * 0.3,
                     "test_label": np.array([3, 1, 4])})
    weights = save_params_npz(str(tmp_path / "w.npz"), init_params(0))
    (out,) = opt_defense.main([
        "--data_root", data, "--weights", weights, "--device", "cpu",
        "--batch_size", "2", "--iterations", "2", "--sample_npoint", "64"])
    assert out == str(tmp_path / "ConvONet-Opt" / "convonet_opt-adv.npz")
    got = load_npz(out)
    assert got.test_pc.shape == (3, 64, 3) and np.isfinite(got.test_pc).all()
    np.testing.assert_array_equal(got.test_label, [3, 1, 4])
    assert np.sqrt((got.test_pc ** 2).sum(-1)).max() <= 1 + 1e-5
    with open(out + ".metrics.jsonl") as f:
        (line,) = f.read().splitlines()
    assert '"clouds": 3' in line


def test_cuda_wrappers_raise_on_cpu_tensors():
    """The kernel wrappers launch or raise: no silent CPU fallback."""
    import pytest

    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda
    from if_defense_tpu_torch.ops.cuda_interp import plane_features_cuda
    from if_defense_tpu_torch.ops.cuda_repulsion import repulsion_loss_cuda

    with pytest.raises(ValueError, match="CUDA"):
        repulsion_loss_cuda(torch.zeros(1, 16, 3))
    with pytest.raises(ValueError, match="CUDA"):
        plane_features_cuda(torch.zeros(1, 3, 3),
                            {"xz": torch.zeros(1, 4, 4, 4)})
    with pytest.raises(ValueError, match="CUDA"):
        fps_cuda(torch.zeros(1, 16, 3), 4)
    with pytest.raises(ValueError, match="CUDA"):
        ballquery_cuda(0.1, 4, torch.zeros(1, 16, 3), torch.zeros(1, 4, 3))
