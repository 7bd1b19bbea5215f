"""The port's scoring path against the JAX package's on the CPU: the
ModelNet40 dataset variants and `batch_iterator`, `class_margins`,
`adjust_num_points`, the checkpoint registry, `BoundedCache`, the victim
checkpoint converter, and `cli/inference.py` itself.

The CLI test runs JAX's `cli.inference.main` on an orbax checkpoint of a
JAX victim (perturbed flax-init weights, batch-norm statistics calibrated
on the clouds, as `tests/test_torch_port_victims.py` makes them) and the port's on the npz that
`tools/victim_ckpt_to_npz.py` makes of it, on one npz of 64-point clouds
whose labels and targets are set from the victim's own logits (half the
clouds at the top class, half at the runner-up), so accuracy and targeted
success are neither 0 nor 1; with `--boundary_tau` at a value between two
clouds' top-two margins (at least 1e-3 from every margin, where the two
packages' logits agree to ~1e-6), so tau moves the counts. `accuracy`,
`target_success` and `n` must be equal.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu import data as jdata
from if_defense_tpu.cli import inference as jinf
from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu.utils import registry as jreg
from if_defense_tpu.utils.cache import BoundedCache as JaxBoundedCache
from if_defense_tpu.utils.checkpoint import save_eval_checkpoint as jax_save
from if_defense_tpu_torch import data
from if_defense_tpu_torch.cli import inference
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.utils import registry
from if_defense_tpu_torch.utils.cache import BoundedCache
from if_defense_tpu_torch.utils.checkpoint import restore_checkpoint_raw
from if_defense_tpu_torch.utils.params_io import flatten_params, params_from_jax
from test_torch_port_victims import calibrated, perturbed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLOUDS, N_POINTS = 6, 64


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def converter():
    spec = importlib.util.spec_from_file_location(
        "victim_ckpt_to_npz", os.path.join(ROOT, "tools",
                                            "victim_ckpt_to_npz.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_npz(path, seed, n_train=5, n_test=7, channels=3, target=True):
    rng = np.random.default_rng(seed)
    d = {"train_pc": rng.normal(size=(n_train, 80, channels)),
         "train_label": rng.integers(0, 40, n_train),
         "test_pc": rng.normal(size=(n_test, 80, channels)),
         "test_label": rng.integers(0, 40, n_test)}
    if target:
        d["target_label"] = rng.integers(0, 40, n_test)
    return data.save_npz(path, d)


def same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype


def test_datasets_match_jax(tmp_path):
    """Every variant item for item (train with its seeded resampling and
    augmentation), and batch_iterator's batches and valid counts."""
    p3 = write_npz(str(tmp_path / "a.npz"), 0)
    p6 = write_npz(str(tmp_path / "b.npz"), 1, channels=6)
    pairs = [
        (data.ModelNet40(p3, 64), jdata.ModelNet40(p3, 64)),
        (data.ModelNet40(p3, 32, partition="test", normalize=False),
         jdata.ModelNet40(p3, 32, partition="test", normalize=False)),
        (data.ModelNet40Hybrid(p3, p6, 48), jdata.ModelNet40Hybrid(p3, p6, 48)),
        (data.ModelNet40Hybrid(p3, p6, 48, partition="test", subset="def"),
         jdata.ModelNet40Hybrid(p3, p6, 48, partition="test", subset="def")),
        (data.ModelNet40Normal(p6, 40), jdata.ModelNet40Normal(p6, 40)),
        (data.ModelNet40Attack(p3, 40), jdata.ModelNet40Attack(p3, 40)),
        (data.ModelNet40NormalAttack(p6, 40),
         jdata.ModelNet40NormalAttack(p6, 40)),
    ]
    for ours, theirs in pairs:
        same_items(ours, theirs)
    for kw in ({}, {"pad_last": True}, {"drop_last": True},
               {"shuffle": True, "seed": 3, "pad_last": True}):
        ours = list(data.batch_iterator(data.ModelNet40Attack(p3, 16), 3, **kw))
        theirs = list(jdata.batch_iterator(jdata.ModelNet40Attack(p3, 16), 3,
                                           **kw))
        assert [v for _, v in ours] == [v for _, v in theirs]
        for (a, _), (b, _) in zip(ours, theirs):
            same_items([a], [b])
    no_target = write_npz(str(tmp_path / "c.npz"), 2, target=False)
    with pytest.raises(ValueError, match="target_label"):
        data.ModelNet40Attack(no_target, 16)


def test_margins_and_point_counts():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(9, 40)).astype(np.float32)
    cls = rng.integers(0, 40, 9)
    np.testing.assert_array_equal(inference.class_margins(logits, cls),
                                  jinf.class_margins(logits, cls))
    for name in ("clean.npz", "add-adv.npz", "Add_Cluster.npz",
                 "x/add_object_3.npz", "drop.npz"):
        assert (inference.adjust_num_points(1024, name)
                == jinf.adjust_num_points(1024, name))
    assert inference.adjust_num_points(1024, "add.npz") == 1536


def test_registry_and_bounded_cache(tmp_path):
    """Entries written by either package resolve in both, through
    `resolve_checkpoint` too; BoundedCache evicts its oldest entry as
    JAX's does."""
    path = str(tmp_path / "reg.json")
    registry.register_checkpoint("mn40", "pointnet", "a.npz", 1024, path)
    jreg.register_checkpoint("mn40", "dgcnn", "b", 512, path)
    for lookup in (registry.lookup_checkpoint, jreg.lookup_checkpoint):
        assert lookup("mn40", "pointnet", 1024, path).endswith("a.npz")
        assert lookup("mn40", "dgcnn", 512, path).endswith("b")
        with pytest.raises(KeyError, match="no checkpoint registered"):
            lookup("mn40", "rscnn", 1024, path)
    assert inference.resolve_checkpoint(
        "registry:mn40", "dgcnn", 512, path) == jinf.resolve_checkpoint(
        "registry:mn40", "dgcnn", 512, path)
    assert inference.resolve_checkpoint("plain.npz") == "plain.npz"
    with pytest.raises(ValueError, match="--model"):
        inference.resolve_checkpoint("registry:mn40", None, 1024, path)
    ours, theirs = BoundedCache(maxsize=2), JaxBoundedCache(maxsize=2)
    builds = []
    for key in ("a", "b", "a", "c", "a"):
        for cache in (ours, theirs):
            cache.get_or_build(key, lambda k=key: builds.append(k) or k)
    assert builds == ["a", "a", "b", "b", "c", "c", "a", "a"]
    assert len(ours) == 2 and "a" in ours and "c" in ours and "b" not in ours


def victim_checkpoint(tmp_path, name, seed, pc):
    """A JAX victim with perturbed variables (batch-norm statistics
    calibrated on the clouds `pc`, then perturbed), saved as an orbax
    checkpoint with its metadata sidecar and converted to the port's npz.
    -> (orbax dir, npz, variables)."""
    jm = jax_build_model(name)
    variables = calibrated(jm, perturbed(jm.init(
        jax.random.key(seed), jnp.asarray(pc), train=False), seed), pc, seed)
    ckpt = jax_save(str(tmp_path / f"{name}_ckpt"), variables,
                    metadata={"model": name, "epoch": 3})
    npz = converter().convert(ckpt, str(tmp_path / f"{name}.npz"))
    return ckpt, npz, variables


def clouds(seed, n=N_CLOUDS):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, N_POINTS, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)
            * rng.uniform(0.3, 1.0, (n, 1, 3))).astype(np.float32)


def scored_npz(tmp_path, name, variables, pc):
    """The clouds `pc` labelled from the victim's own logits: even clouds
    at their top class with the runner-up as target, odd ones the other
    way round. -> (npz path, a tau between two clouds' top-two gaps)."""
    model = build_model(name)
    model.load_state_dict(params_from_jax(variables, model), strict=True)
    with torch.no_grad():
        logits, _ = model.eval()(torch.from_numpy(pc))
    order = np.argsort(-logits.numpy(), axis=-1)
    top, second = order[:, 0], order[:, 1]
    even = np.arange(N_CLOUDS) % 2 == 0
    label = np.where(even, top, second)
    target = np.where(even, second, top)
    path = data.save_npz(str(tmp_path / f"{name}-adv.npz"), {
        "test_pc": pc, "test_label": label, "target_label": target})
    gap = np.take_along_axis(logits.numpy(), order[:, :2], 1) @ [1.0, -1.0]
    # the midpoint farthest from every gap that splits the even clouds
    cuts = (np.sort(gap)[1:] + np.sort(gap)[:-1]) / 2
    cuts = cuts[[0 < (gap[even] > c).sum() < even.sum() for c in cuts]]
    tau = float(max(cuts, key=lambda c: np.abs(gap - c).min()))
    assert np.abs(gap - tau).min() > 1e-3, (gap, tau)
    return path, tau


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "dgcnn",
                                  "pointconv", "rscnn"])
def test_cli_matches_jax(tmp_path, name):
    """The port's CLI (`--device cpu`, the converted npz) against JAX's
    (the orbax checkpoint): target mode without and with --boundary_tau,
    and normal mode; the same accuracy, target_success and n."""
    pc = clouds(11)
    ckpt, npz, variables = victim_checkpoint(tmp_path, name, 5, pc)
    path, tau = scored_npz(tmp_path, name, variables, pc)
    common = ["--data", path, "--num_points", str(N_POINTS),
              "--batch_size", "4"]
    runs = [["--mode", "target"], ["--mode", "target", "--boundary_tau",
                                   str(tau)], []]
    for extra in runs:
        want = jinf.main(common + ["--checkpoint", ckpt] + extra)
        got = inference.main(common + ["--checkpoint", npz, "--device",
                                       "cpu"] + extra)
        for key in ("accuracy", "target_success", "n", "num_points",
                    "model", "boundary_tau"):
            assert got.get(key) == want.get(key), (key, extra)
        assert got["n"] == N_CLOUDS
        assert 0 < got["accuracy"] < 1
    meta = json.load(open(npz + ".meta.json"))
    assert meta == {"model": name, "epoch": 3}


def test_converter_writes_the_flat_layout(tmp_path):
    """The converted npz holds params/ and batch_stats/ keys and nothing of
    the optimizer; the port reads it back exactly, and refuses the orbax
    directory with a message naming the converter."""
    ckpt, npz, variables = victim_checkpoint(tmp_path, "pointnet", 6,
                                             clouds(12, 2))
    raw = restore_checkpoint_raw(npz)
    assert raw["metadata"]["model"] == "pointnet"
    assert set(raw) == {"params", "batch_stats", "metadata"}
    want = flatten_params(variables)
    got = flatten_params({k: raw[k] for k in ("params", "batch_stats")})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(SystemExit, match="victim_ckpt_to_npz.py"):
        restore_checkpoint_raw(ckpt)
    with pytest.raises(SystemExit, match="victim_ckpt_to_npz.py"):
        inference.main(["--data", npz, "--checkpoint", ckpt,
                        "--device", "cpu"])


def test_cli_needs_device_cpu_without_a_card(tmp_path, monkeypatch):
    """Without --device the CLI asks for the card and, where there is none,
    exits naming --device cpu; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = write_npz(str(tmp_path / "a.npz"), 0)
    with pytest.raises(SystemExit, match="--device cpu"):
        inference.main(["--data", path, "--checkpoint", "x.npz"])
