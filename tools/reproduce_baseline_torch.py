"""One-command reproduction runbook against BASELINE.md Tables 2-5, on the
PyTorch/CUDA port.

The port of `tools/reproduce_baseline.py`, with its stages, flags,
defaults, SKIP rules, artifacts (`manifest.json`, `converted.json`,
`data_with_targets.npz`, `seed0/results.json`, `REPRODUCE.md`,
`report.json`), final `RUNBOOK` line and exit code, and three flags more:
`--device` (default `cuda:0`, one card), passed to every CLI,
`--reference_root`, passed to the parity tools, and `--opt_modes`, passed
to the accuracy tool with its default (`bf16_r16`: ConvONet-Opt with the
corner cache, whose decoder and repulsion reach neither B4 nor B2 and B3;
`f32` and `bf16_r16_repc` do). It takes the
reference's published pretrained weights (`.pth`) and a ModelNet40 attack
npz and runs: convert the weights -> check them against the reference's
own torch modules -> validate the dataset -> clean accuracies -> the
Tables 2-5 attack x defense protocol (`tools/accuracy_benchmark_torch.py`)
-> a cell-by-cell diff against BASELINE.md.

Every stage runs as far as its inputs allow and reports PASS, SKIP(reason)
or FAIL; absent weight files give SKIPs. The parity stage needs the
reference repository (`--reference_root`, by default `reference/` inside
this checkout). The data stage always writes the npz that later stages
read into `--out_dir` (`data_with_targets.npz`, a copy where the targets
are present), so the clean row's defended clouds, written beside it, stay
in that run's directory. The diff means something only with the
published weights: seeded stand-ins (`tools/reference_pth.py`) run every
stage but score as random nets do.

Runs on the card unless given `--device cpu`; without a card it exits with
an error before any stage. The stages' CLIs run in this one process, so
the cuBLAS workspace that the attack CLI's deterministic algorithms need
is set at start-up, as the accuracy tool does.

Expected inputs
---------------
--weights_dir with any subset of:
    pointnet.pth pointnet2.pth dgcnn.pth pointconv.pth
        victim classifiers (nn.DataParallel 'module.' prefixes handled)
    onet.pth convonet.pth
        implicit nets (im2mesh CheckpointIO layout, 'model' key or a bare
        state dict, encoder./decoder. prefixes)
--data: ModelNet40 attack npz, test_pc/test_label (+ target_label;
    synthesised with a fixed seed where absent).

Usage:
    python tools/reproduce_baseline_torch.py --weights_dir PTH_DIR \
        --data mn40_1024.npz --out_dir runs/repro [--victims pointnet dgcnn] \
        [--fast] [--device cuda:0]

Stages: inventory convert parity data clean tables diff (--stages runs a
subset; later stages read earlier artifacts from --out_dir).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# numpy-only helpers of the JAX runbook (its JAX imports sit inside its
# stage functions, which this tool does not call)
from tools.reproduce_baseline import (  # noqa: E402
    COL_MAP,
    DEF_MAP,
    IMPLICITS,
    STAGES,
    TABLE_VICTIMS,
    VICTIMS,
    _stamp,
    diff_report,
    parse_baseline_tables,
    stage_diff,
    stage_inventory,
)
from tools.parity_victims_torch import REFERENCE_ROOT  # noqa: E402

__all__ = ["COL_MAP", "DEF_MAP", "TABLE_VICTIMS", "VICTIMS", "IMPLICITS",
           "STAGES", "parse_baseline_tables", "diff_report", "main"]


def load_pth(path: str) -> dict:
    """A `.pth` state dict on the CPU (tensors only); the im2mesh
    CheckpointIO layout's `"model"` entry where the file holds one."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and not any(
            hasattr(v, "shape") for v in sd.values()):
        sd = sd["model"]
    return sd


def stage_convert(args, report, manifest) -> dict:
    """.pth -> the port's checkpoints: victims to flat-npz eval checkpoints
    `ckpts/<name>.npz` (cli/inference, cli/attack), implicit nets to params
    npz `ckpts/<name>_w.npz` (cli/opt_defense, cli/remesh_defense)."""
    if not manifest["weights"]:
        _stamp(report, "convert", "SKIP", "no .pth files present")
        return {}
    from if_defense_tpu_torch.convert import implicit_weights as iw
    from if_defense_tpu_torch.convert import victim_weights as vw
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from if_defense_tpu_torch.utils.params_io import save_params_npz

    victim_fns = {"pointnet": vw.convert_pointnet_pth,
                  "pointnet2": vw.convert_pointnet2_pth,
                  "dgcnn": vw.convert_dgcnn_pth,
                  "pointconv": vw.convert_pointconv_pth}
    implicit_fns = {"onet": iw.convert_onet_pth,
                    "convonet": iw.convert_convonet_pth}
    converted = {}
    os.makedirs(os.path.join(args.out_dir, "ckpts"), exist_ok=True)
    for name, pth in manifest["weights"].items():
        sd = load_pth(pth)
        if name in victim_fns:
            converted[name] = save_eval_checkpoint(
                os.path.join(args.out_dir, "ckpts", f"{name}.npz"),
                victim_fns[name](sd),
                {"model": name, "source": os.path.abspath(pth)})
        else:
            converted[name] = save_params_npz(
                os.path.join(args.out_dir, "ckpts", f"{name}_w.npz"),
                implicit_fns[name](sd))
    with open(os.path.join(args.out_dir, "converted.json"), "w") as f:
        json.dump(converted, f, indent=2)
    _stamp(report, "convert", "PASS",
           f"converted {', '.join(sorted(converted))}")
    return converted


def stage_parity(args, report, manifest):
    """Forward parity of each converted net against the reference's torch
    module on the same weights (tools/parity_{victims,implicit}_torch.py),
    the port's side on --device."""
    if not manifest["weights"]:
        _stamp(report, "parity", "SKIP", "no .pth files present")
        return
    from tools import parity_implicit_torch as pi
    from tools import parity_victims_torch as pv

    if not os.path.isdir(args.reference_root):
        _stamp(report, "parity", "SKIP",
               f"reference absent ({args.reference_root})")
        return
    checks = {"pointnet": pv.check_pointnet, "pointnet2": pv.check_pointnet2,
              "dgcnn": pv.check_dgcnn, "pointconv": pv.check_pointconv,
              "onet": pi.check_onet, "convonet": pi.check_convonet}
    worst, failed = 0.0, []
    for name, pth in sorted(manifest["weights"].items()):
        sd = load_pth(pth)
        try:
            d = checks[name](sd=sd, device=args.device,
                             reference_root=args.reference_root)
        except Exception as e:  # e.g. checkpoint arch != harness arch
            failed.append(f"{name} ({type(e).__name__}: {e})")
            continue
        worst = max(worst, float(d))
        if d >= 1e-3:
            failed.append(f"{name} ({d:.2e})")
    if failed:
        _stamp(report, "parity", "FAIL", "diverged: " + ", ".join(failed))
    else:
        _stamp(report, "parity", "PASS",
               f"{len(manifest['weights'])} nets, worst |Δ| {worst:.2e}")


def stage_data(args, report, manifest) -> str | None:
    """Validate the ModelNet40 npz; synthesise seeded targets if absent."""
    if not manifest["data"]:
        _stamp(report, "data", "SKIP", "no --data npz present")
        return None
    from if_defense_tpu_torch.data.npz import load_npz, save_npz

    d = load_npz(args.data)
    if d.test_pc is None or d.test_label is None:
        _stamp(report, "data", "FAIL",
               f"{args.data} lacks test_pc/test_label")
        return None
    n, p = d.test_pc.shape[0], d.test_pc.shape[1]
    k = int(d.test_label.max()) + 1
    out = os.path.join(args.out_dir, "data_with_targets.npz")
    if d.target_label is not None:
        # copied all the same: the tables stage writes the clean row's
        # defended clouds beside the npz it reads and, under
        # --reuse_artifacts, takes those it finds there, so they must stay
        # in this run's --out_dir
        save_npz(out, {"test_pc": d.test_pc, "test_label": d.test_label,
                       "target_label": d.target_label})
        _stamp(report, "data", "PASS",
               f"{n} test clouds x {p} pts, {k} classes, targets present "
               f"-> {out}")
        return out
    # the reference's protocol: one fixed random wrong target per cloud
    rng = np.random.default_rng(0)
    tgt = rng.integers(0, k, size=n)
    clash = tgt == d.test_label
    tgt[clash] = (tgt[clash] + 1) % k
    save_npz(out, {"test_pc": d.test_pc, "test_label": d.test_label,
                   "target_label": tgt.astype(np.int64)})
    _stamp(report, "data", "PASS",
           f"{n} test clouds x {p} pts, {k} classes; synthesized seeded "
           f"targets -> {out}")
    return out


def stage_clean(args, report, manifest, converted, data_npz, baseline):
    """Each converted victim's clean accuracy (cli/inference.py on
    --device); -> {victim: the CLI's record}."""
    victims = [v for v in args.victims if v in converted]
    if not victims or data_npz is None:
        _stamp(report, "clean", "SKIP",
               "needs converted victim checkpoints + data")
        return {}
    from if_defense_tpu_torch.cli.inference import main as inf_main

    lines, records = [], {}
    for v in victims:
        r = inf_main(["--data", data_npz, "--checkpoint", converted[v],
                      "--num_points", str(args.num_points),
                      "--batch_size", str(args.batch_size),
                      "--device", args.device])
        records[v] = r
        ref = baseline.get(v, {}).get("none", {}).get("clean")
        delta = (f" (ref {ref:.2f}, Δ{100 * r['accuracy'] - ref:+.2f})"
                 if ref is not None else "")
        lines.append(f"{v} {100 * r['accuracy']:.2f}%{delta}")
    _stamp(report, "clean", "PASS", "; ".join(lines))
    return records


def stage_tables(args, report, manifest, converted, data_npz):
    victims = [v for v in args.victims if v in converted]
    have_impl = [i for i in IMPLICITS if i in converted]
    if not victims or data_npz is None:
        _stamp(report, "tables", "SKIP",
               "needs converted victim checkpoints + data")
        return None
    defenses = [d for d in args.defenses
                if d.split("_")[0] not in IMPLICITS
                or d.split("_")[0] in have_impl]
    from tools.accuracy_benchmark_torch import main as bench_main

    bench_main([
        "--out_dir", args.out_dir, "--seeds", "0",
        "--victims", *victims,
        "--attacks", *args.attacks,
        "--defenses", *defenses,
        "--num_points", str(args.num_points),
        "--batch_size", str(args.batch_size),
        "--data_npz", data_npz,
        "--victim_ckpts", *[f"{v}={converted[v]}" for v in victims],
        *((["--implicit_weights"]
           + [f"{i}={converted[i]}" for i in have_impl])
          if have_impl else []),
        "--reuse_artifacts",
        *(["--fast"] if args.fast else []),
        "--opt_modes", *args.opt_modes,
        "--device", args.device,
    ])
    res_path = os.path.join(args.out_dir, "seed0", "results.json")
    dropped = sorted(set(args.defenses) - set(defenses))
    _stamp(report, "tables", "PASS",
           f"{len(victims)} victims x {len(args.attacks)} attacks x "
           f"{len(defenses)} defenses -> {res_path}"
           + (f" (dropped for missing implicit weights: "
              f"{', '.join(dropped)})" if dropped else ""))
    return res_path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights_dir", required=True)
    p.add_argument("--data", default=None,
                   help="ModelNet40 npz (test_pc/test_label[/target_label])")
    p.add_argument("--out_dir",
                   default=os.path.join(ROOT, "runs", "reproduce_baseline"),
                   help="default runs/reproduce_baseline in this checkout")
    p.add_argument("--victims", nargs="+", default=VICTIMS)
    p.add_argument("--attacks", nargs="+",
                   default=["clean", "perturb", "add", "add_hd", "knn",
                            "drop100", "drop"],
                   help="BASELINE.md columns (LG-GAN/AdvPC come from "
                        "external attack codebases the reference repo "
                        "does not ship)")
    p.add_argument("--defenses", nargs="+",
                   default=["none", "srs", "sor", "dup", "onet_opt",
                            "convonet_opt", "onet_mesh", "convonet_mesh"])
    p.add_argument("--stages", nargs="+", default=STAGES, choices=STAGES)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--tolerance", type=float, default=2.0,
                   help="per-cell accuracy-point tolerance for the diff "
                        "stage (1 seed, 1024-pt resample: ~±1.5 noise)")
    p.add_argument("--baseline_md", default=os.path.join(ROOT, "BASELINE.md"))
    p.add_argument("--fast", action="store_true",
                   help="smoke sizes (tiny attack budgets) — pipeline "
                        "check only, numbers will not match")
    p.add_argument("--device", default="cuda:0",
                   help="torch device of every stage (default one card, "
                        "cuda:0; cpu only when asked)")
    p.add_argument("--reference_root", default=REFERENCE_ROOT,
                   help="the reference repository, for the parity stage "
                        "(default reference/ inside this checkout; the "
                        "stage SKIPs where it is absent)")
    p.add_argument("--opt_modes", nargs="+", default=["bf16_r16"],
                   help="ConvONet-Opt modes of the tables stage (the "
                        "accuracy tool's flag and default; f32 runs the "
                        "decoder through kernel B4, bf16_r16_repc the "
                        "repulsion through B2 and B3)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from if_defense_tpu_torch.cli import device_of
    from if_defense_tpu_torch.utils.determinism import CUBLAS_WORKSPACE

    # before any CUDA work: cuBLAS reads it when the process's first handle
    # is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    device_of(args.device)          # exits where no card is and none asked
    os.makedirs(args.out_dir, exist_ok=True)
    baseline = parse_baseline_tables(args.baseline_md)
    report: dict = {"stages": {}, "started": time.time(), "stage_seconds": {}}
    clock = time.perf_counter()

    def timed(stage):
        nonlocal clock
        now = time.perf_counter()
        report["stage_seconds"][stage] = now - clock
        clock = now

    manifest = stage_inventory(args, report)
    timed("inventory")
    converted: dict = {}
    if "convert" in args.stages:
        converted = stage_convert(args, report, manifest)
        timed("convert")
    elif os.path.exists(os.path.join(args.out_dir, "converted.json")):
        with open(os.path.join(args.out_dir, "converted.json")) as f:
            converted = json.load(f)
    if "parity" in args.stages:
        stage_parity(args, report, manifest)
        timed("parity")
    data_npz = None
    if "data" in args.stages:
        data_npz = stage_data(args, report, manifest)
        timed("data")
    else:
        # staged resume: the data stage's artifact from an earlier
        # invocation (synthesised targets), else the raw --data
        prior = os.path.join(args.out_dir, "data_with_targets.npz")
        if os.path.exists(prior):
            data_npz = prior
        elif manifest["data"]:
            data_npz = args.data
    if "clean" in args.stages:
        report["clean"] = {
            v: r["accuracy"] for v, r in stage_clean(
                args, report, manifest, converted, data_npz,
                baseline).items()}
        timed("clean")
    results_path = None
    if "tables" in args.stages:
        results_path = stage_tables(args, report, manifest, converted,
                                    data_npz)
        timed("tables")
    elif os.path.exists(os.path.join(args.out_dir, "seed0",
                                     "results.json")):
        results_path = os.path.join(args.out_dir, "seed0", "results.json")
    if "diff" in args.stages:
        stage_diff(args, report, results_path, baseline)
        timed("diff")

    report["seconds"] = time.time() - report["started"]
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    statuses = [s["status"] for s in report["stages"].values()]
    print("RUNBOOK", "FAIL" if "FAIL" in statuses else "OK",
          "(" + ", ".join(f"{k}:{v['status']}"
                          for k, v in report["stages"].items()) + ")")
    return 1 if "FAIL" in statuses else 0


if __name__ == "__main__":
    sys.exit(main())
