"""The reproduction runbook on the port, `tools/reproduce_baseline_torch.py`,
its parity tools and `tools/make_watertight_torch.py`, against the JAX
package's tools on the same inputs, on the CPU.

- The BASELINE.md parser and the diff report are the JAX runbook's, and
  give its output exactly; the flags' defaults are its own but for
  `--out_dir` (inside the checkout) and the two flags it adds, `--device`
  (cuda:0) and `--opt_modes` (the accuracy tool's bf16_r16).
- Without inputs the stage statuses and `manifest.json` are the JAX
  runbook's; the data stage's npz holds the JAX stage's arrays bit for
  bit.
- The convert stage: a reference `.pth` of each of the six kinds, made by
  `tools/reference_pth.py` from a perturbed seeded tree (the victims at
  their published widths, PointNet++'s with `module.` prefixes; ONet and
  ConvONet at width 16, as `tests/test_torch_port_convert.py`), gives a
  checkpoint holding exactly the leaves of the JAX package's converter on
  the same file.
- The clean stage on 16 clouds of 256 points with PointNet and DGCNN (their
  batch norms calibrated on the clouds; half the labels the seeded
  PointNet's predictions, so its accuracy is not 0): the JAX runbook's
  accuracies, the
  per-cloud predictions equal wherever JAX's top-2 logit margin is at
  least 1e-3 (a near tie may go either way under another summation
  order), the accuracies apart by at most the near ties' share.
- A `--device cpu --fast` tables stage (PointNet; clean and drop100 x none
  and SOR) writes every cell as a share of the clouds, its clean x none
  cell the clean stage's accuracy.
- Without a card and without `--device cpu` the runbook exits before any
  stage; in a process where importing `jax` or `if_defense_tpu` raises,
  the runbook's inventory stage returns 0 and the other three tools and
  `tools/runbook_vs_tool.py` import.
- Two runs on one `--data` with its targets and different ConvONet
  weights write their own clean-row ConvONet-Opt files, each in its
  `--out_dir`; the parity stage hands `--reference_root` to its checks
  and SKIPs "reference absent" where it is not.
- `tools/runbook_vs_tool.py`'s export of the accuracy tool's trained
  files as `.pth`, converted back by the runbook, gives the same leaves.
- `make_watertight_torch.watertight_remesh` of a broken mesh at resolution
  32 gives the JAX tool's vertices and faces bit for bit.
- With the reference repository present, a `.pth` of its PointNet passes
  the convert and parity stages (skipped where it is absent).
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.convert import implicit_weights as jiw
from if_defense_tpu.convert import victim_weights as jvw
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.models.common import calibrate_batch_norm
from if_defense_tpu_torch.utils.checkpoint import restore_checkpoint_raw
from if_defense_tpu_torch.utils.params_io import (
    flatten_params,
    flax_init_params,
    load_params_npz,
    params_from_jax,
    params_to_jax,
)
from test_torch_port_victims import perturbed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 16                      # ONet's and ConvONet's widths
CLEAN_CLOUDS, CLEAN_POINTS = 16, 256
NEAR_TIE = 1e-3             # a top-2 logit margin under which either may win


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_book = _tool("reproduce_baseline")
port_book = _tool("reproduce_baseline_torch")
reference_state_dict = _tool("reference_pth").reference_state_dict


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_leaves(got: dict, want: dict):
    got = flatten_params(got)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert np.array_equal(got[k], want[k]), k


def _results() -> dict:
    return {"victims": {"pointnet": {
        "clean_accuracy": 0.8850,
        "attacks": {"perturb": {
            "attacked": {"accuracy": 0.0},
            "defended": {"sor": {"accuracy": 0.7281},
                         "convonet_mesh": {"accuracy": 0.5}},
        }, "add_hd": {
            "attacked": {"accuracy": 0.125},
            "defended": {"onet_mesh": {"accuracy": 0.61},
                         "dup": {"accuracy": 0.4}},
        }},
    }, "dgcnn": {"clean_accuracy": 0.9149, "attacks": {}}}}


def test_helpers_equal_the_jax_runbook():
    md = os.path.join(ROOT, "BASELINE.md")
    tables = port_book.parse_baseline_tables(md)
    assert tables == jax_book.parse_baseline_tables(md)
    assert set(tables) == set(port_book.TABLE_VICTIMS.values())
    for tol in (2.0, 0.5):
        assert (port_book.diff_report(_results(), tables, tol)
                == jax_book.diff_report(_results(), tables, tol))
    md_text, n_bad = port_book.diff_report(_results(), tables, 2.0)
    assert "| dup | add_hd | 40.00 |" in md_text and n_bad >= 1
    assert "convonet_mesh" not in md_text       # BASELINE.md has no row
    argv = ["--weights_dir", "W"]
    got = vars(port_book.parse_args(argv))
    want = vars(jax_book.parse_args(argv))
    assert got.pop("device") == "cuda:0"
    assert got.pop("opt_modes") == ["bf16_r16"]     # the accuracy tool's
    assert got.pop("reference_root") == os.path.join(ROOT, "reference")
    assert got.pop("out_dir") == os.path.join(ROOT, "runs",
                                              "reproduce_baseline")
    assert want.pop("out_dir") == "/tmp/reproduce_baseline"
    assert got == want


def _statuses(out) -> dict:
    with open(os.path.join(out, "report.json")) as f:
        return {k: v["status"] for k, v in json.load(f)["stages"].items()}


def _manifest(out) -> dict:
    with open(os.path.join(out, "manifest.json")) as f:
        return json.load(f)


def test_stages_without_inputs_equal_the_jax_runbook(tmp_path):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    outs = {}
    for tag, book, extra in (("jax", jax_book, []),
                             ("port", port_book, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / tag)
        assert book.main(["--weights_dir", str(wdir), "--out_dir",
                          outs[tag], *extra]) == 0
    assert _statuses(outs["port"]) == _statuses(outs["jax"])
    assert _manifest(outs["port"]) == _manifest(outs["jax"])
    assert set(_statuses(outs["port"])) == set(port_book.STAGES)


def test_data_stage_is_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    src = str(tmp_path / "mn40.npz")
    np.savez(src, test_pc=rng.normal(size=(40, 64, 3)).astype(np.float32),
             test_label=(np.arange(40) % 7).astype(np.uint8))
    paths = {}
    for tag, book, extra in (("jax", jax_book, []),
                             ("port", port_book, ["--device", "cpu"])):
        args = book.parse_args(["--weights_dir", str(tmp_path), "--data",
                                src, "--out_dir", str(tmp_path / tag),
                                *extra])
        os.makedirs(args.out_dir)
        report = {"stages": {}}
        paths[tag] = book.stage_data(args, report, {"data": src})
        assert report["stages"]["data"]["status"] == "PASS"
    with np.load(paths["jax"]) as a, np.load(paths["port"]) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "target_label", "test_label", "test_pc"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
        assert (b["target_label"] != b["test_label"]).all()


def _seeded_trees() -> dict:
    """Perturbed seeded trees of the six kinds (the port's numpy draws of
    flax's init); PointNet's and DGCNN's batch norms then calibrated on
    the clean stage's clouds (`models.common.calibrate_batch_norm`)."""
    trees = {
        "convonet": perturbed(flax_init_params(0, "convonet", c_dim=W,
                                               hidden_dim=W), 1),
        "onet": perturbed(flax_init_params(1, "onet", c_dim=W, hidden_dim=W,
                                           decoder_hidden=W), 2),
    }
    for i, name in enumerate(("pointnet", "dgcnn", "pointnet2",
                              "pointconv")):
        tree = perturbed(flax_init_params(i, name), i)
        if name in ("pointnet", "dgcnn"):
            model = build_model(name)
            model.load_state_dict(params_from_jax(tree, model), strict=True)
            calibrate_batch_norm(model, torch.from_numpy(_clean_clouds()), i)
            tree = params_to_jax(model.state_dict(), model)
        trees[name] = tree
    return trees


def _clean_clouds() -> np.ndarray:
    rng = np.random.default_rng(5)
    d = rng.normal(size=(CLEAN_CLOUDS, CLEAN_POINTS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * rng.uniform(0.3, 1.0, (CLEAN_CLOUDS, 1, 3))).astype(
        np.float32)


def _labels(trees: dict) -> np.ndarray:
    """The clean clouds' labels: the seeded PointNet's predictions on the
    even clouds (so its accuracy is no trivial 0), i mod 40 on the odd."""
    model = build_model("pointnet")
    model.load_state_dict(params_from_jax(trees["pointnet"], model),
                          strict=True)
    with torch.no_grad():
        pred = model.eval()(torch.from_numpy(_clean_clouds()))[0].argmax(-1)
    i = np.arange(CLEAN_CLOUDS)
    return np.where(i % 2 == 0, pred.numpy(), i % 40).astype(np.uint8)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The six `.pth` files, the port's convert stage on them, and the
    data: -> (args, manifest, converted, seeded trees, state dicts)."""
    tmp = tmp_path_factory.mktemp("runbook")
    wdir = tmp / "weights"
    wdir.mkdir()
    trees = _seeded_trees()
    sds = {}
    for kind, tree in trees.items():
        sds[kind] = reference_state_dict(
            kind, tree, module_prefix=kind == "pointnet2")
        torch.save(sds[kind], str(wdir / f"{kind}.pth"))
    data = str(tmp / "mn40.npz")
    np.savez(data, test_pc=_clean_clouds(), test_label=_labels(trees),
             target_label=((np.arange(CLEAN_CLOUDS) + 1) % 40).astype(
                 np.uint8))
    args = port_book.parse_args([
        "--weights_dir", str(wdir), "--data", data, "--out_dir",
        str(tmp / "port"), "--num_points", str(CLEAN_POINTS),
        "--batch_size", "8", "--device", "cpu"])
    os.makedirs(args.out_dir)
    report = {"stages": {}}
    manifest = port_book.stage_inventory(args, report)
    conv = port_book.stage_convert(args, report, manifest)
    assert report["stages"]["convert"]["status"] == "PASS"
    return args, manifest, conv, trees, sds


def test_convert_stage_gives_the_jax_converters_leaves(converted):
    args, manifest, conv, trees, sds = converted
    assert sorted(manifest["weights"]) == sorted(conv) == sorted(trees)
    with open(os.path.join(args.out_dir, "converted.json")) as f:
        assert json.load(f) == conv
    assert any(k.startswith("module.") for k in sds["pointnet2"])
    for kind, sd in sds.items():
        if kind in port_book.IMPLICITS:
            assert conv[kind].endswith(f"ckpts/{kind}_w.npz")
            got = load_params_npz(conv[kind])
            want = getattr(jiw, f"convert_{kind}_pth")(sd)
        else:
            assert conv[kind].endswith(f"ckpts/{kind}.npz")
            got = restore_checkpoint_raw(conv[kind])
            meta = got.pop("metadata")
            assert meta == {"model": kind, "source": os.path.abspath(
                manifest["weights"][kind])}
            want = getattr(jvw, f"convert_{kind}_pth")(sd)
        _same_leaves(got, want)
        _same_leaves(got, trees[kind])


def _parse_clean(detail: str) -> dict:
    return {v: float(a) / 100
            for v, a in re.findall(r"(\w+) ([\d.]+)%", detail)}


def test_clean_stage_matches_the_jax_runbook(converted, tmp_path):
    from if_defense_tpu.cli.inference import load_eval_model as jax_load

    from if_defense_tpu_torch.cli.inference import load_eval_model

    args, manifest, conv, trees, sds = converted
    args.victims = ["pointnet", "dgcnn"]
    report = {"stages": {}}
    port = port_book.stage_clean(args, report, manifest, conv, args.data, {})
    assert report["stages"]["clean"]["status"] == "PASS"
    # the JAX runbook on the same files
    jargs = jax_book.parse_args([
        "--weights_dir", args.weights_dir, "--data", args.data,
        "--out_dir", str(tmp_path / "jax"), "--victims", "pointnet", "dgcnn",
        "--num_points", str(CLEAN_POINTS), "--batch_size", "8"])
    os.makedirs(jargs.out_dir)
    jmanifest = {**manifest, "weights": {
        v: manifest["weights"][v] for v in jargs.victims}}
    jconv = jax_book.stage_convert(jargs, report, jmanifest)
    jax_book.stage_clean(jargs, report, jmanifest, jconv, args.data, {})
    jax_acc = _parse_clean(report["stages"]["clean"]["detail"])
    pc = _clean_clouds()
    label = _labels(trees)
    for v in jargs.victims:
        jm, variables, _ = jax_load(jconv[v])
        want = np.asarray(jm.apply(variables, jnp.asarray(pc),
                                   train=False)[0])
        model, _ = load_eval_model(conv[v])
        with torch.no_grad():
            got = model(torch.from_numpy(pc))[0].numpy()
        top2 = np.sort(want, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] >= NEAR_TIE
        assert (got.argmax(-1) == want.argmax(-1))[sure].all(), v
        # the stages score what the models predict
        assert port[v]["accuracy"] == float(
            (got.argmax(-1) == label).mean()), v
        assert abs(port[v]["accuracy"] - jax_acc[v]) <= (
            (~sure).sum() / CLEAN_CLOUDS + 1e-4), v    # JAX prints 2 decimals
        if sure.all():
            assert round(100 * port[v]["accuracy"], 2) == round(
                100 * jax_acc[v], 2)
    assert port["pointnet"]["accuracy"] >= 0.5


def test_tables_stage_runs_on_cpu(converted):
    args, manifest, conv, trees, sds = converted
    out = os.path.join(os.path.dirname(args.out_dir), "tables")
    args = port_book.parse_args([
        "--weights_dir", args.weights_dir, "--data", args.data,
        "--out_dir", out, "--num_points", str(CLEAN_POINTS),
        "--batch_size", "8", "--victims", "pointnet",
        "--attacks", "clean", "drop100", "--defenses", "none", "sor",
        "--fast", "--device", "cpu"])
    os.makedirs(out)
    report = {"stages": {}}
    clean = port_book.stage_clean(args, report, manifest, conv, args.data,
                                  {})
    path = port_book.stage_tables(args, report, manifest, conv, args.data)
    assert report["stages"]["tables"]["status"] == "PASS"
    with open(path) as f:
        vres = json.load(f)["victims"]["pointnet"]
    assert set(vres["attacks"]) == {"clean", "drop100"}
    for ares in vres["attacks"].values():
        assert set(ares["defended"]) == {"none", "sor"}
        for r in (ares["attacked"], *ares["defended"].values()):
            assert r["n"] == CLEAN_CLOUDS and 0 <= r["accuracy"] <= 1
    acc = clean["pointnet"]["accuracy"]
    assert vres["clean_accuracy"] == acc
    assert vres["attacks"]["clean"]["defended"]["none"]["accuracy"] == acc
    with open(os.path.join(out, "seed0", "legs.json")) as f:
        assert all(leg["device"] == "cpu" for leg in json.load(f))


def test_defended_files_stay_in_each_runs_out_dir(converted, tmp_path):
    """Two runs on one `--data` that carries its targets, each with its
    own full-width ConvONet: the data stage copies the npz into each
    `--out_dir`, so each run's clean-row ConvONet-Opt file is its own
    (under `--reuse_artifacts` a file beside a shared npz would be taken
    for the second run's) and nothing is written beside `--data`."""
    import shutil

    args = converted[0]
    rng = np.random.default_rng(6)
    pc = rng.normal(size=(1, CLEAN_POINTS, 3))
    pc = (0.4 * pc / np.linalg.norm(pc, axis=-1, keepdims=True)).astype(
        np.float32)
    (tmp_path / "data").mkdir()
    data = str(tmp_path / "data" / "mn40.npz")
    np.savez(data, test_pc=pc, test_label=np.array([3], np.uint8),
             target_label=np.array([4], np.uint8))
    defended = []
    for seed in (0, 1):
        wdir = tmp_path / f"w{seed}"
        wdir.mkdir()
        shutil.copy(os.path.join(args.weights_dir, "pointnet.pth"),
                    str(wdir / "pointnet.pth"))
        torch.save(reference_state_dict(
            "convonet", flax_init_params(seed, "convonet")),
            str(wdir / "convonet.pth"))
        out = tmp_path / f"out{seed}"
        assert port_book.main([
            "--weights_dir", str(wdir), "--data", data, "--out_dir",
            str(out), "--stages", "inventory", "convert", "data", "tables",
            "--victims", "pointnet", "--attacks", "clean", "--defenses",
            "convonet_opt", "--num_points", str(CLEAN_POINTS),
            "--batch_size", "1", "--fast", "--device", "cpu"]) == 0
        copy = np.load(str(out / "data_with_targets.npz"))
        with np.load(data) as src:
            assert sorted(copy.files) == sorted(src.files)
            for k in src.files:
                assert np.array_equal(copy[k], src[k]), k
        path = out / "ConvONet-Opt" / "convonet_opt-data_with_targets.npz"
        defended.append(np.load(str(path))["test_pc"])
    assert os.listdir(tmp_path / "data") == ["mn40.npz"]
    assert defended[0].shape == defended[1].shape
    assert not np.array_equal(defended[0], defended[1])


def test_parity_stage_takes_the_given_reference_root(converted, tmp_path,
                                                     monkeypatch):
    """`--reference_root` reaches every check; an absent one SKIPs with
    "reference absent", a gap of 1e-3 or an exception FAILs."""
    import tools.parity_victims_torch as pv

    args, manifest = converted[0], {"weights": {
        "pointnet": os.path.join(converted[0].weights_dir, "pointnet.pth")}}
    seen, gap = [], [0.0]

    def check(sd, device, reference_root):
        seen.append((sorted(sd) == sorted(converted[4]["pointnet"]),
                     device, reference_root))
        if gap[0] is None:
            raise RuntimeError("arch")
        return gap[0]

    monkeypatch.setattr(pv, "check_pointnet", check)
    ref = tmp_path / "ref"
    for root, g, status in ((tmp_path / "nowhere", 0.0, "SKIP"),
                            (ref, 0.0, "PASS"), (ref, 1e-3, "FAIL"),
                            (ref, None, "FAIL")):
        ref.mkdir(exist_ok=True)
        args = port_book.parse_args([
            "--weights_dir", args.weights_dir, "--device", "cpu",
            "--reference_root", str(root)])
        gap[0] = g
        report = {"stages": {}}
        port_book.stage_parity(args, report, manifest)
        stage = report["stages"]["parity"]
        assert stage["status"] == status, stage
        if status == "SKIP":
            assert stage["detail"] == f"reference absent ({root})"
    assert seen == [(True, "cpu", str(ref))] * 3


def test_trained_weights_round_trip_through_pth(tmp_path):
    """`tools/runbook_vs_tool.py`'s export: the accuracy tool's trained
    files (a victim's eval checkpoint, the implicit nets' params npz) as
    `.pth`, converted back by the runbook, leaf for leaf the same files."""
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from if_defense_tpu_torch.utils.params_io import save_params_npz

    rvt = _tool("runbook_vs_tool")
    seed = tmp_path / "seed0"
    (seed / "pointnet").mkdir(parents=True)
    save_eval_checkpoint(str(seed / "pointnet" / "best.npz"),
                         perturbed(flax_init_params(3, "pointnet"), 3),
                         {"model": "pointnet", "acc": 0.5})
    save_params_npz(str(seed / "convonet_w.npz"), perturbed(flax_init_params(
        4, "convonet", c_dim=W, hidden_dim=W), 4))
    save_params_npz(str(seed / "onet_w.npz"), perturbed(flax_init_params(
        5, "onet", c_dim=W, hidden_dim=W, decoder_hidden=W), 5))
    sources = rvt.export_pth(str(seed), str(tmp_path / "pth"))
    args = port_book.parse_args(["--weights_dir", str(tmp_path / "pth"),
                                 "--out_dir", str(tmp_path / "out"),
                                 "--device", "cpu"])
    os.makedirs(args.out_dir)
    report = {"stages": {}}
    conv = port_book.stage_convert(
        args, report, port_book.stage_inventory(args, report))
    assert sorted(conv) == sorted(sources) == ["convonet", "onet", "pointnet"]
    for kind in sources:
        assert rvt.same_leaves(sources[kind], conv[kind]), kind
    results = {"victims": {"pointnet": {"clean_accuracy": 0.5, "attacks": {
        "knn": {"success_rate": 0.25, "attacked": {"accuracy": 0.5},
                "defended": {"sor": {"accuracy": 0.75}}}}}}}
    assert rvt.cells(results) == {
        "pointnet/clean": 0.5, "pointnet/knn/success_rate": 0.25,
        "pointnet/knn/attacked": 0.5, "pointnet/knn/sor": 0.75}


def test_runbook_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_book.main(["--weights_dir", str(tmp_path),
                        "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# a process in which importing the JAX package or JAX raises
BLOCKER = """
import importlib.abc, sys
BLOCKED = ("jax", "if_defense_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None
for m in [m for m in sys.modules if any(
        m == b or m.startswith(b + ".") for b in BLOCKED)]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
try:
    import if_defense_tpu.native
except ImportError:
    pass
else:
    raise SystemExit("the blocker let the JAX package in")
import if_defense_tpu_torch.native
sys.path.insert(0, "tools")
"""


def test_tools_run_where_jax_cannot_be_imported(tmp_path):
    code = BLOCKER + f"""
import reproduce_baseline_torch as book
for name in ("parity_victims_torch", "parity_implicit_torch",
             "make_watertight_torch", "runbook_vs_tool"):
    __import__(name)
rc = book.main(["--weights_dir", {str(tmp_path)!r}, "--out_dir",
                {str(tmp_path / "out")!r}, "--stages", "inventory",
                "--device", "cpu"])
assert not [m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "if_defense_tpu."))] and "if_defense_tpu" not in sys.modules
raise SystemExit(rc)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RUNBOOK OK (inventory:PASS)" in out.stdout
    assert _manifest(tmp_path / "out")["missing_weights"] == sorted(
        port_book.VICTIMS + port_book.IMPLICITS)


def _broken_mesh():
    """A box with one face missing and a stray triangle far from it."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 2) for z in (0, 1)],
                 np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [1, 5, 7], [1, 7, 3]],
                 np.int64)                           # no face at z = 0
    stray = np.array([[3, 3, 3], [3.1, 3, 3], [3, 3.1, 3]], np.float32)
    return np.concatenate([v, stray]), np.concatenate(
        [f, np.array([[8, 9, 10]])])


def test_watertight_remesh_is_the_jax_tools(tmp_path):
    sys.path.insert(0, ROOT)
    jax_tool = _tool("make_watertight")
    port_tool = _tool("make_watertight_torch")
    verts, faces = _broken_mesh()
    want = jax_tool.watertight_remesh(verts, faces, resolution=32)
    got = port_tool.watertight_remesh(verts, faces, resolution=32)
    assert len(got[1]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # and the command line writes the same OFF files
    root = tmp_path / "in" / "box"
    root.mkdir(parents=True)
    jax_tool.save_off(str(root / "m.off"), verts, faces)
    for tag, tool in (("jax", jax_tool), ("port", port_tool)):
        assert tool.main(["--mesh_root", str(tmp_path / "in"), "--out_root",
                          str(tmp_path / tag), "--resolution", "16"]) == 0
    assert ((tmp_path / "jax" / "box" / "m.off").read_text()
            == (tmp_path / "port" / "box" / "m.off").read_text())


REFERENCE = _tool("parity_victims_torch").REFERENCE_ROOT


@pytest.mark.skipif(not os.path.isdir(os.path.join(REFERENCE, "baselines")),
                    reason="reference repo absent")
def test_convert_and_parity_stages_roundtrip_real_pth(tmp_path):
    """A torch PointNet of the reference saved as `.pth` (with
    DataParallel prefixes), through the convert and parity stages on the
    CPU, and the converted checkpoint scoring as the reference does."""
    from if_defense_tpu_torch.cli.inference import load_eval_model

    sys.path.insert(0, os.path.join(REFERENCE, "baselines"))
    from model.pointnet import PointNetCls

    torch.manual_seed(0)
    net = PointNetCls(k=40, feature_transform=False, use_bn=True)
    net.eval()
    with torch.no_grad():  # non-trivial BN running stats
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save({"module." + k: v for k, v in net.state_dict().items()},
               str(wdir / "pointnet.pth"))
    args = port_book.parse_args(["--weights_dir", str(wdir), "--out_dir",
                                 str(tmp_path / "out"), "--device", "cpu"])
    os.makedirs(args.out_dir)
    report = {"stages": {}}
    manifest = port_book.stage_inventory(args, report)
    assert manifest["weights"] == {"pointnet": str(wdir / "pointnet.pth")}
    conv = port_book.stage_convert(args, report, manifest)
    assert report["stages"]["convert"]["status"] == "PASS"
    port_book.stage_parity(args, report, manifest)
    assert report["stages"]["parity"]["status"] == "PASS", \
        report["stages"]["parity"]["detail"]
    model, meta = load_eval_model(conv["pointnet"])
    assert meta["model"] == "pointnet"
    pc = np.random.default_rng(0).normal(size=(2, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(pc))[0].numpy()
        want = net(torch.from_numpy(pc.transpose(0, 2, 1)))[0].numpy()
    assert np.abs(got - want).max() < 1e-3
