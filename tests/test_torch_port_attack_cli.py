"""The port's attack and merge CLIs (`cli/attack.py`, `cli/merge_results.py`)
against the JAX package's on the CPU, and the attack CLI's resume shards.

The victim is JAX's PointNet with perturbed flax-init variables, saved as an
orbax checkpoint for the JAX CLI and converted to the port's flat npz by
`tools/victim_ckpt_to_npz.py` (statistics calibrated on a few clouds would
saturate its softmax, and Drop's saliencies would all tie at 0). The data
are 6 clouds of 64 points (160 for the adding attacks, whose init reads 128
critical points), batch 4, the last batch padded.

Tolerances: FGM's clouds within atol 1e-5 of JAX's (one gradient in
another summation order, scaled by the budget), its success rate equal;
Drop's clouds and every label exactly equal; a stopped-and-resumed run
bit-identical to an uninterrupted one; merged npz files and metrics equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.cli import attack as jattack
from if_defense_tpu.cli import merge_results as jmerge
from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu.utils.checkpoint import save_eval_checkpoint as jax_save
from if_defense_tpu_torch.attack.cw import cw_chunk_sizes
from if_defense_tpu_torch.cli import attack, merge_results
from if_defense_tpu_torch.data import ModelNet40Attack, save_npz
from test_torch_port_inference import converter
from test_torch_port_victims import perturbed

N_CLOUDS = 6


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clouds(n_points, seed=0, normals=False):
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(N_CLOUDS, n_points, 3)) * 0.4).astype(np.float32)
    if normals:
        nrm = rng.normal(size=pc.shape)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        pc = np.concatenate([pc, nrm.astype(np.float32)], -1)
    return pc


def write_data(path, pc, seed=0):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 40, N_CLOUDS)
    return save_npz(path, {"test_pc": pc, "test_label": label,
                           "target_label": (label + 5) % 40})


@pytest.fixture(scope="module")
def victim(tmp_path_factory):
    """(orbax checkpoint for JAX, the port's npz, a 64-point data npz)."""
    tmp = tmp_path_factory.mktemp("attack_cli")
    pc = clouds(64)
    jm = jax_build_model("pointnet")
    variables = perturbed(jm.init(jax.random.key(1), jnp.asarray(pc),
                                  train=False), 1)
    ckpt = jax_save(str(tmp / "pointnet_ckpt"), variables,
                    metadata={"model": "pointnet"})
    npz = converter().convert(ckpt, str(tmp / "pointnet.npz"))
    return {"ckpt": ckpt, "npz": npz, "tmp": tmp,
            "data": write_data(str(tmp / "x.npz"), pc)}


def run(victim, tmp_path, name, *extra, data=None, num_points=64):
    out = str(tmp_path / f"{name}.npz")
    argv = ["--attack", name, "--data", data or victim["data"],
            "--checkpoint", victim["npz"], "--num_points", str(num_points),
            "--batch_size", "4", "--output", out, "--device", "cpu",
            *extra]
    return attack.main(argv)


def load(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("name,extra", [("fgm", []),
                                        ("drop", ["--num_drop", "12"])])
def test_cli_matches_jax(victim, tmp_path, name, extra):
    """FGM and Drop (neither draws) through both CLIs on the same data and
    victim: the npz, the success rate and the metrics line."""
    jout = str(tmp_path / f"jax-{name}.npz")
    _, jrate = jattack.main(["--attack", name, "--data", victim["data"],
                             "--checkpoint", victim["ckpt"], "--num_points",
                             "64", "--batch_size", "4", "--output", jout,
                             *extra])
    out, rate = run(victim, tmp_path, name, *extra)
    got, want = load(out), load(jout)
    assert got.keys() == want.keys()
    for k in ("test_label", "target_label"):
        np.testing.assert_array_equal(got[k], want[k])
    if name == "drop":
        assert got["test_pc"].shape == (N_CLOUDS, 52, 3)
        np.testing.assert_array_equal(got["test_pc"], want["test_pc"])
    else:
        np.testing.assert_allclose(got["test_pc"], want["test_pc"],
                                   atol=1e-5)
    assert rate == jrate
    line = json.loads(open(out + ".metrics.jsonl").read().splitlines()[-1])
    assert (line["attack"], line["model"], line["n"], line["success_rate"],
            line["output"]) == (name, "pointnet", N_CLOUDS, rate, out)


# (attack, flags, points in each output cloud) at tiny iteration counts
FAMILIES = [
    ("perturb", ["--binary_step", "1", "--num_iter", "2"], 160),
    ("add", ["--binary_step", "1", "--num_iter", "2", "--num_add", "16"],
     176),
    ("add", ["--binary_step", "1", "--num_iter", "2", "--num_add", "16",
             "--adv_dist", "hausdorff"], 176),
    ("add_cluster", ["--binary_step", "1", "--num_iter", "2"], 160 + 96),
    ("add_object", ["--binary_step", "1", "--num_iter", "2"], 160 + 192),
    ("knn", ["--num_iter", "3", "--approx_knn"], 160),
    ("fgm", [], 160),
    ("ifgm", ["--num_iter", "3"], 160),
    ("mifgm", ["--num_iter", "3"], 160),
    ("pgd", ["--num_iter", "3"], 160),
    ("drop", ["--num_drop", "20"], 140),
    ("ifgm", ["--num_iter", "3", "--victim_dtype", "mixed"], 160),
]


@pytest.mark.parametrize("name,extra,points", FAMILIES)
def test_every_attack_runs(victim, tmp_path, name, extra, points):
    """Each of the ten attacks through the port's CLI on the CPU: the
    output's shape and labels, finite points, and the budgets (kNN's per
    point, the FGM family's global L2)."""
    pc = clouds(160, seed=2, normals=name == "knn")
    data = write_data(str(tmp_path / "d.npz"), pc)
    out, rate = run(victim, tmp_path, name, *extra, data=data,
                    num_points=160)
    got = load(out)
    assert got["test_pc"].shape == (N_CLOUDS, points, 3)
    assert np.isfinite(got["test_pc"]).all() and 0 <= rate <= 1
    clean = np.stack([x[0][:, :3] for x in ModelNet40Attack(data, 160)])
    moved = got["test_pc"][:, :160] - clean if points >= 160 else None
    if name == "knn":
        assert np.sqrt((moved ** 2).sum(-1)).max() <= 0.1 + 1e-5
    if name in ("fgm", "ifgm", "mifgm", "pgd"):
        # PGD's ball is centred on its start, itself within the budget
        budget = 0.08 * np.sqrt(160 * 3) * (2 if name == "pgd" else 1)
        assert np.sqrt((moved ** 2).sum((1, 2))).max() <= budget * (1 + 1e-5)
    if name.startswith("add"):
        np.testing.assert_array_equal(got["test_pc"][:, :160], clean)


def test_resume_is_bit_identical(victim, tmp_path):
    """A perturb run stopped after one batch by --stop_after_batches, then
    resumed, gives the npz of an uninterrupted run bit for bit, as does a
    resume that meets a corrupt shard (recomputed) and a different
    --device_chunk_iters (no part of the fingerprint)."""
    flags = ["--binary_step", "2", "--num_iter", "3"]
    full, rate = run(victim, tmp_path, "perturb", *flags)
    want = load(full)
    out = str(tmp_path / "resumed.npz")
    argv = ["--attack", "perturb", "--data", victim["data"], "--checkpoint",
            victim["npz"], "--num_points", "64", "--batch_size", "4",
            "--output", out, "--device", "cpu", "--resume", *flags]
    assert attack.main(argv + ["--stop_after_batches", "1"])[0] is None
    part = out + ".partial"
    assert sorted(os.listdir(part)) == ["batch_00000.npz", "config.json"]
    with open(os.path.join(part, "batch_00001.npz"), "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    got_out, got_rate = attack.main(argv + ["--device_chunk_iters", "2"])
    assert got_out == out and got_rate == rate
    assert not os.path.exists(part)
    for k, v in load(out).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("change", ["--seed", "--num_iter", "data"])
def test_mismatched_resume_refused(victim, tmp_path, change):
    """Shards of another configuration or of other data are refused."""
    data = write_data(str(tmp_path / "d.npz"), clouds(64))
    out = str(tmp_path / "r.npz")
    argv = ["--attack", "ifgm", "--data", data, "--checkpoint",
            victim["npz"], "--num_points", "64", "--batch_size", "4",
            "--output", out, "--device", "cpu", "--resume", "--num_iter",
            "2"]
    assert attack.main(argv + ["--stop_after_batches", "1"])[0] is None
    if change == "data":
        write_data(data, clouds(64, seed=5))
        again = argv
    else:
        again = argv + [change, "3"]
    with pytest.raises(ValueError, match="different attack configuration"):
        attack.main(again)


def test_merge_results_matches_jax(tmp_path):
    """Two shards and their metrics sidecars: the port's merged npz and
    aggregate equal JAX's; --delete removes the shards and sidecars."""
    rng = np.random.default_rng(3)
    shards = []
    for i, n in enumerate((3, 5)):
        p = save_npz(str(tmp_path / f"s{i}.npz"), {
            "test_pc": rng.normal(size=(n, 16, 3)),
            "test_label": rng.integers(0, 40, n),
            "target_label": rng.integers(0, 40, n)})
        with open(p + ".metrics.jsonl", "w") as f:
            f.write(json.dumps({"n": n, "success_rate": 0.2 * (i + 1)})
                    + "\n")
        shards.append(p)
    jout, out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jmerge.main(shards + ["--out", jout])
    merge_results.main(shards + ["--out", out, "--delete"])
    got, want = load(out), load(jout)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (json.loads(open(out + ".metrics.jsonl").read())
            == json.loads(open(jout + ".metrics.jsonl").read()))
    assert not any(os.path.exists(s) or os.path.exists(s + ".metrics.jsonl")
                   for s in shards)


def test_cli_needs_device_cpu_and_restores_determinism(victim, tmp_path,
                                                       monkeypatch):
    """Without --device the CLI asks for the card and, where there is none,
    exits naming --device cpu; a run restores the caller's setting of
    deterministic algorithms; chunk sizes below 1 are refused."""
    before = torch.are_deterministic_algorithms_enabled()
    run(victim, tmp_path, "fgm")
    assert torch.are_deterministic_algorithms_enabled() == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        attack.main(["--attack", "fgm", "--data", victim["data"],
                     "--checkpoint", victim["npz"]])
    assert cw_chunk_sizes(7, 3) == [3, 3, 1]
    assert cw_chunk_sizes(7, None) == [7]
    with pytest.raises(ValueError, match=">= 1"):
        cw_chunk_sizes(7, 0)
