"""The accuracy protocol's tools on the port, `tools/accuracy_benchmark_torch.py`
and `tools/e2e_demo_torch.py`, against the JAX package's tools, on the CPU.

- The port's copies of the JAX tool's pure helpers (`OPT_MODE_FLAGS`,
  `attack_cli_args`, `aggregate`, `write_report`) and its flags' defaults
  equal the originals on the same inputs (exactly: the same dicts, lists
  and text).
- A run of the port's tool with `--device cpu` below `--fast`'s sizes (8
  classes x 4 train and 1 test clouds of 256 points, one epoch, 2 ConvONet
  steps, 2 defense iterations) writes `results.json` with the JAX tool's
  key tree for `clean` and `knn` x `none`, `sor` and
  `convonet_opt:{f32,bf16_r16}`, which the JAX tool's own `aggregate` and
  `write_report` read into the port's `summary.json` and `RESULTS.md`,
  and `tools/accuracy_vs_jax.py` sets beside the JAX table, cell by cell.
- Without a card and without `--device cpu` both tools exit before any
  work, with no CPU fallback; they, `tools/accuracy_vs_jax.py`,
  `tools/compare_trees.py` and `chip_smoke.py` import nothing of JAX.
- A tiny `e2e_demo_torch.py --device cpu` run writes the JAX demo's
  `results.json` keys.
The accuracies at these sizes are not meaningful; they are checked to be
shares in [0, 1].
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTACKS = ["perturb", "add", "add_hd", "add_cluster", "add_object", "knn",
           "fgm", "ifgm", "mifgm", "pgd", "drop", "drop100"]
RECORD = {"accuracy", "data", "model", "n", "num_points", "target_success"}


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_tool = _tool("accuracy_benchmark")
port_tool = _tool("accuracy_benchmark_torch")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed_results(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def rec():
        return {"accuracy": float(rng.uniform()), "n": 400}

    attacks = {a: {"success_rate": float(rng.uniform()),
                   "attack_seconds": 1.0, "attacked": rec(),
                   "defended": {d: rec() for d in (
                       "none", "sor", "convonet_opt:f32",
                       "convonet_opt:bf16_r16")}}
               for a in ("clean", "knn", "perturb")}
    return {"seed": seed, "victims": {"pointnet": {
        "clean_accuracy": float(rng.uniform()), "train_seconds": 2.0,
        "attacks": attacks}}}


def test_helpers_equal_the_jax_tool(tmp_path):
    assert port_tool.OPT_MODE_FLAGS == jax_tool.OPT_MODE_FLAGS
    for attack in ATTACKS:
        for cw, knn, drop in (((10, 500), 2500, 200), ((3, 7), 11, 13)):
            assert (port_tool.attack_cli_args(attack, cw, knn, drop)
                    == jax_tool.attack_cli_args(attack, cw, knn, drop))
    runs = [_seed_results(s) for s in range(3)]
    for n in (1, 3):
        assert port_tool.aggregate(runs[:n]) == jax_tool.aggregate(runs[:n])
    argv = ["--seeds", "0", "1", "2", "--attacks", "clean", "knn", "perturb",
            "--defenses", "none", "sor", "convonet_opt",
            "--opt_modes", "f32", "bf16_r16"]
    want = vars(jax_tool.parse_args(argv))
    got = vars(port_tool.parse_args(argv))
    assert got.pop("device") == "cuda:0"
    # the port's default output lies inside its checkout, not in /tmp
    assert got.pop("out_dir") == os.path.join(ROOT, "runs", "acc_bench")
    assert want.pop("out_dir") == "/tmp/acc_bench"
    assert got == want
    summary = jax_tool.aggregate(runs)
    port_tool.write_report(summary, port_tool.parse_args(argv),
                           tmp_path / "port.md")
    jax_tool.write_report(summary, jax_tool.parse_args(argv),
                          tmp_path / "jax.md")
    assert (tmp_path / "port.md").read_text() == (
        tmp_path / "jax.md").read_text()


def test_tool_runs_the_protocol_on_cpu(tmp_path, capsys):
    out = tmp_path / "acc"
    argv = ["--out_dir", str(out), "--seeds", "0",
            "--attacks", "clean", "knn",
            "--defenses", "none", "sor", "convonet_opt",
            "--opt_modes", "f32", "bf16_r16",
            "--train_per_class", "4", "--test_per_class", "1",
            "--occ_per_class", "1", "--num_points", "256", "--epochs", "1",
            "--occ_steps", "2", "--defense_iters", "2", "--batch_size", "8",
            "--knn_iter", "2", "--device", "cpu"]
    summary = port_tool.main(argv)
    results = json.loads((out / "seed0" / "results.json").read_text())
    assert set(results) == {"seed", "victims"} and results["seed"] == 0
    vres = results["victims"]["pointnet"]
    assert set(vres) == {"clean_accuracy", "train_seconds", "attacks"}
    assert set(vres["attacks"]) == {"clean", "knn"}
    for attack, ares in vres["attacks"].items():
        assert set(ares) == {"success_rate", "attack_seconds", "attacked",
                             "defended"}
        assert set(ares["attacked"]) == RECORD
        assert set(ares["defended"]) == {"none", "sor", "convonet_opt:f32",
                                         "convonet_opt:bf16_r16"}
        extra = set() if attack == "clean" else {"eval_seconds"}
        for rec in [ares["attacked"], *ares["defended"].values()]:
            assert set(rec) - RECORD <= extra and RECORD <= set(rec)
            assert 0.0 <= rec["accuracy"] <= 1.0 and rec["n"] == 8
    # the JAX tool's own aggregation and report read the port's results
    args = jax_tool.parse_args(argv[:-2])
    assert jax_tool.aggregate([results]) == summary == json.loads(
        (out / "summary.json").read_text())
    jax_tool.write_report(summary, args, tmp_path / "jax.md")
    assert (tmp_path / "jax.md").read_text() == (out / "RESULTS.md").read_text()
    legs = json.loads((out / "seed0" / "legs.json").read_text())
    names = [leg["leg"] for leg in legs]
    assert names[:2] == ["train_implicit convonet", "train pointnet"]
    assert "attack knn" in names and all(
        leg["device"] == "cpu" and leg["seconds"] >= 0 for leg in legs)
    # the comparison with the JAX table reads the same files
    capsys.readouterr()
    assert _tool("accuracy_vs_jax").main([str(out)]) == 0
    report = capsys.readouterr().out
    jax = json.loads(open(os.path.join(ROOT, "RESULTS_DISCRIM.summary.json"))
                     .read())
    cell = summary["pointnet/knn/sor"]["mean"]
    ok = abs(cell - jax["pointnet/knn/sor"]["mean"]) <= (
        2 * jax["pointnet/knn/sor"]["std"] + 0.02)
    assert (f"{100 * cell:.1f} / 90.6 ± 1.8 {'in' if ok else '**OUT**'}"
            in report)
    assert "- knn: bf16_r16 " in report and "- clean: bf16_r16 " in report
    assert f"CLI calls {{'seed0': {len(legs)}}}" in report
    assert "| train_implicit convonet | " in report


def test_tools_import_no_jax():
    """The protocol's tools and `chip_smoke.py` import nothing of JAX or of
    the JAX package, not even inside a function, and import with both
    blocked."""
    import re
    import subprocess

    names = ["accuracy_benchmark_torch", "e2e_demo_torch", "accuracy_vs_jax",
             "compare_trees"]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|"
                         r"if_defense_tpu)\b(?!_torch)", re.M)
    files = [os.path.join(ROOT, "tools", f"{n}.py") for n in names]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = [f"{f}: {m.group(0).strip()}" for f in files
           for m in pattern.finditer(open(f).read())]
    assert not bad, bad
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', 'if_defense_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.path.insert(0, 'tools')\n"
            f"for n in {names!r}:\n"
            "    __import__(n)\n"
            "import chip_smoke\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", ["accuracy_benchmark_torch",
                                  "e2e_demo_torch"])
def test_tools_refuse_without_a_card(tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = port_tool if name == "accuracy_benchmark_torch" else _tool(name)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(["--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_e2e_demo_runs_on_cpu(tmp_path):
    sys.path.insert(0, ROOT)
    e2e = _tool("e2e_demo_torch")
    got = e2e.main(["--out_dir", str(tmp_path), "--device", "cpu", "--fast"],
                   sizes=dict(train_pc=2, test_pc=1, epochs=1,
                              cw_steps=(1, 2), occ_steps=2, defense_iters=2,
                              occ_per_class=1, num_points=256, batch=8,
                              mesh=("--resolution0", "8", "--upsample", "2")))
    assert got == json.loads((tmp_path / "results.json").read_text())
    assert set(got) == {"clean_accuracy", "attack_success_rate",
                        "attacked_accuracy", "attacked_target_success",
                        "sor_accuracy", "convonet_opt_accuracy",
                        "convonet_mesh_accuracy"}
    assert all(0.0 <= v <= 1.0 for v in got.values())
