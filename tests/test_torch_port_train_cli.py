"""The port's victim training CLIs (`cli/train.py`, `cli/hybrid_train.py`)
on the CPU, against the JAX package's.

- `parse_args`: the JAX CLI's flags and defaults, plus `--device`.
- Both CLIs exit without a card unless given `--device cpu` (hybrid
  training first refuses a run without `--def_data`, as JAX's does).
- CPU runs of PointNet and PointNet++ (N = 64, batch 4, 2 epochs): JAX's
  `metrics.jsonl` fields, `best.npz` and `final.npz` with their sidecars,
  the registry entry, and `cli.inference` scoring the best checkpoint
  through `registry:` at the accuracy the run recorded for it.
- Hybrid training picks its best checkpoint by defended accuracy.
- `--resume` continues at the next epoch with the saved step and moments.
- CLI-level parity with JAX's `cli.train` on PointNet for 1 epoch of 2
  steps: JAX's initial variables (its `create_train_state` with
  `key(seed)`) and its per-step dropout masks (recomputed from the
  `key(seed + 1)` splits, as in `tests/test_torch_port_victim_training.py`)
  go in through the CLI's init and draw seams (`initial_variables`,
  `dropout_draws`). The port's `train_loss` within 1e-4 of JAX's and its
  `test_acc` equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from if_defense_tpu.cli import train as jtrain
from if_defense_tpu.models import build_model as jax_build_model
from if_defense_tpu.training import create_train_state as jax_create
from if_defense_tpu_torch.cli import hybrid_train, inference, train
from if_defense_tpu_torch.data import save_npz
from if_defense_tpu_torch.utils.checkpoint import load_metadata
from if_defense_tpu_torch.utils.params_io import load_params_npz
from test_torch_port_victim_training import jax_dropout_masks, replay

N, BATCH = 64, 4
JAX_FIELDS = {"time", "epoch", "train_loss", "train_acc", "test_acc",
              "epoch_time"}


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread (see ROADMAP.md section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_data(path, seed, n_train=8, n_test=6):
    """Clouds of distinct shapes (ellipsoids of random axes, 80 points)."""
    rng = np.random.default_rng(seed)

    def clouds(n):
        d = rng.normal(size=(n, 80, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (d * rng.uniform(0.1, 1, (n, 1, 3))).astype(np.float32)

    return save_npz(str(path), {
        "train_pc": clouds(n_train), "train_label": rng.integers(0, 4, n_train),
        "test_pc": clouds(n_test), "test_label": rng.integers(0, 4, n_test)})


def records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def argv(data, out, tmp, *extra):
    return ["--data", data, "--output", str(out), "--num_points", str(N),
            "--batch_size", str(BATCH), "--registry", str(tmp / "reg.json"),
            "--device", "cpu", *extra]


def test_parse_args_matches_jax():
    want = vars(jtrain.parse_args(["--data", "x.npz"]))
    got = vars(train.parse_args(["--data", "x.npz"]))
    assert got.pop("device") == "cuda"
    assert got == want
    flags = ["--def_data", "d.npz", "--model", "rscnn", "--num_points", "512",
             "--batch_size", "8", "--epochs", "3", "--lr", "0.01",
             "--weight_decay", "0.001", "--smoothing", "--feature_transform",
             "--eval_every", "2", "--output", "o", "--registry", "r.json",
             "--resume", "c", "--seed", "5"]
    got = vars(train.parse_args(["--data", "x.npz", *flags]))
    got.pop("device")
    assert got == vars(jtrain.parse_args(["--data", "x.npz", *flags]))


def test_clis_need_a_card_or_device_cpu(tmp_path):
    data = write_data(tmp_path / "d.npz", 0)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--data", data, "--output", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="requires --def_data"):
        hybrid_train.main(["--data", data, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--device cpu"):
        hybrid_train.main(["--data", data, "--def_data", data,
                           "--output", str(tmp_path / "o")])


@pytest.mark.parametrize("model", ["pointnet", "pointnet2"])
def test_train_cli_on_cpu(model, tmp_path):
    data = write_data(tmp_path / "toy.npz", 1)
    out = tmp_path / model
    best = train.main(argv(data, out, tmp_path, "--model", model,
                           "--epochs", "2", "--eval_every", "1"))
    recs = records(out)
    assert [set(r) for r in recs[:2]] == [JAX_FIELDS] * 2
    assert set(recs[2]) == {"time", "best_acc", "best_epoch"}
    assert all(np.isfinite(r["train_loss"]) for r in recs[:2])
    accs = [r["test_acc"] for r in recs[:2]]
    epoch = 2 if accs[1] > accs[0] else 1
    assert recs[2]["best_epoch"] == epoch and best == max(accs)
    for name in ("best", "final"):
        path = out / f"{name}.npz"
        assert path.exists() and (out / f"{name}.npz.opt.npz").exists()
    assert load_metadata(str(out / "best.npz"))["epoch"] == epoch
    assert load_metadata(str(out / "final.npz")) == {
        "model": model, "epoch": 2, "num_points": N}
    with open(tmp_path / "reg.json") as f:
        reg = json.load(f)
    assert reg == {"toy": {str(N): {model: str(out / "best.npz")}}}
    # the best checkpoint scores the test split as the run recorded
    scored = inference.main(["--data", data, "--checkpoint", "registry:toy",
                             "--model", model, "--num_points", str(N),
                             "--batch_size", str(BATCH), "--registry",
                             str(tmp_path / "reg.json"), "--device", "cpu"])
    assert scored["accuracy"] == accs[epoch - 1] and scored["n"] == 6


def test_hybrid_picks_best_by_defended_accuracy(tmp_path):
    data = write_data(tmp_path / "toy.npz", 2)
    defended = write_data(tmp_path / "def.npz", 3)
    out = tmp_path / "hybrid"
    hybrid_train.main(argv(data, out, tmp_path, "--def_data", defended,
                           "--epochs", "3", "--eval_every", "1"))
    recs = records(out)
    assert all(set(r) == JAX_FIELDS | {"def_test_acc"} for r in recs[:3])
    def_accs = [r["def_test_acc"] for r in recs[:3]]
    epoch = 1 + int(np.argmax(def_accs))           # the first maximum
    assert recs[3]["best_def_epoch"] == epoch
    assert recs[3]["best_def_acc"] == max(def_accs)
    meta = load_metadata(str(out / "best.npz"))
    assert meta["epoch"] == epoch and meta["def_acc"] == max(def_accs)


def test_resume_continues_at_the_next_epoch(tmp_path):
    data = write_data(tmp_path / "toy.npz", 4)
    first = tmp_path / "first"
    train.main(argv(data, first, tmp_path, "--epochs", "1"))
    saved = load_params_npz(str(first / "final.npz.opt.npz"))
    assert int(saved["step"]) == 2 and int(saved["opt_state"]["count"]) == 2
    resumed = tmp_path / "resumed"
    seen = {}
    restore = train.restore_checkpoint

    def spy(path, state):
        state, meta = restore(path, state)
        seen.update(step=state.step, moments=[
            s["exp_avg"].clone() for s in state.optimizer.state.values()])
        return state, meta

    train.restore_checkpoint = spy
    try:
        train.main(argv(data, resumed, tmp_path, "--epochs", "2",
                        "--resume", str(first / "final.npz")))
    finally:
        train.restore_checkpoint = restore
    assert seen["step"] == 2
    want = saved["opt_state"]["mu"]
    assert sum(int(np.prod(np.shape(v))) for v in jax.tree_util.tree_leaves(
        want)) == sum(int(m.numel()) for m in seen["moments"])
    recs = records(resumed)
    assert [r["epoch"] for r in recs if "epoch" in r] == [2]
    after = load_params_npz(str(resumed / "final.npz.opt.npz"))
    assert int(after["step"]) == 4


def test_train_cli_matches_jax(tmp_path, monkeypatch):
    """One epoch of PointNet (2 steps, then the test split) in both CLIs,
    the port fed JAX's initial variables and dropout masks."""
    data = write_data(tmp_path / "toy.npz", 5)
    seed, steps = 3, 2
    flags = ["--data", data, "--num_points", str(N), "--batch_size",
             str(BATCH), "--epochs", "1", "--seed", str(seed),
             "--registry", str(tmp_path / "reg.json")]
    jtrain.main(flags + ["--output", str(tmp_path / "jax")])
    want = records(tmp_path / "jax")[0]

    jm = jax_build_model("pointnet")
    sample = np.zeros((BATCH, N, 3), np.float32)
    js = jax_create(jm, jax.random.key(seed), sample, total_epochs=1,
                    steps_per_epoch=steps)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats})
    key, keys = jax.random.key(seed + 1), []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        keys.append(step_key)
    masks = jax_dropout_masks(jm, variables, [(sample, k) for k in keys])

    def draws(seed_, device):
        assert seed_ == seed + 1
        for m in masks:
            yield replay(m)

    monkeypatch.setattr(train, "initial_variables",
                        lambda name, seed_, **kw: variables)
    monkeypatch.setattr(train, "dropout_draws", draws)
    train.main(flags + ["--output", str(tmp_path / "port"), "--device",
                        "cpu"])
    got = records(tmp_path / "port")[0]
    assert got["epoch"] == want["epoch"] == 1
    assert abs(got["train_loss"] - want["train_loss"]) <= 1e-4
    assert got["train_acc"] == want["train_acc"]
    assert got["test_acc"] == want["test_acc"]
