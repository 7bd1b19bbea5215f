"""The reproduction runbook against the accuracy tool, on the port: the same
protocol once from weights the tool trains and once from those weights
written as the reference's `.pth` files.

1. `tools/accuracy_benchmark_torch.py` for seed 0 with the arguments the
   runbook passes it (`--batch_size 40 --num_points 1024`, the default
   `--opt_modes bf16_r16` and `--onet_modes f32`): PointNet, the attacks
   clean, knn, drop and perturb, the defenses none, srs, sor, dup,
   convonet_opt and onet_opt, the victim, ConvONet and ONet trained by the
   tool.
2. Its trained PointNet, ConvONet and ONet written as the reference's
   `.pth` files (`tools/reference_pth.py`).
3. `tools/reproduce_baseline_torch.py` on those files, with the tool's
   seed-0 test npz as `--data` (it carries `target_label`, so the data
   stage keeps the targets), stages inventory to tables.

Then the runbook's checkpoints against the tool's, leaf for leaf, and the
runbook's `results.json` against the tool's, cell by cell (every
accuracy, success rate and clean accuracy). Prints each stage's and each
CLI call's seconds, writes everything to `--summary` (JSON), with both
`results.json` files and the runbook's `report.json` beside it, and exits
0 only when every cell is equal.

Usage (the protocol's size takes about 45 minutes on one H100):
    python tools/runbook_vs_tool.py --out_dir runs/rvt \
        [--summary SUMMARY.json] [--device cuda:0] [--fast]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ATTACKS = ["clean", "knn", "drop", "perturb"]
DEFENSES = ["none", "srs", "sor", "dup", "convonet_opt", "onet_opt"]


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them (None
    where it is absent: a CPU run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except FileNotFoundError:
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def cells(results: dict) -> dict:
    """Every number of a results.json that the protocol computes (not its
    seconds), by `victim/attack/what`."""
    out = {}
    for victim, vres in results["victims"].items():
        out[f"{victim}/clean"] = vres["clean_accuracy"]
        for attack, ares in vres["attacks"].items():
            base = f"{victim}/{attack}"
            out[f"{base}/success_rate"] = ares["success_rate"]
            out[f"{base}/attacked"] = ares["attacked"]["accuracy"]
            for d, r in ares["defended"].items():
                out[f"{base}/{d}"] = r["accuracy"]
    return out


def export_pth(seed_dir: str, pth_dir: str) -> dict:
    """The tool's trained PointNet, ConvONet and ONet as the reference's
    `.pth` files. -> {kind: the tool's file}."""
    import torch

    from if_defense_tpu_torch.utils.checkpoint import restore_checkpoint_raw
    from if_defense_tpu_torch.utils.params_io import load_params_npz

    ref = _tool("reference_pth")
    os.makedirs(pth_dir, exist_ok=True)
    sources = {"pointnet": os.path.join(seed_dir, "pointnet", "best.npz"),
               "convonet": os.path.join(seed_dir, "convonet_w.npz"),
               "onet": os.path.join(seed_dir, "onet_w.npz")}
    for kind, path in sources.items():
        tree = (restore_checkpoint_raw(path) if kind == "pointnet"
                else load_params_npz(path))
        torch.save(ref.reference_state_dict(kind, tree),
                   os.path.join(pth_dir, f"{kind}.pth"))
    return sources


def same_leaves(a: str, b: str) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x.files)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default=os.path.join(ROOT, "runs", "rvt"))
    p.add_argument("--summary", default=None,
                   help="JSON of the comparison (default <out_dir>/"
                        "runbook_vs_tool.json)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--fast", action="store_true",
                   help="both runs at the tools' --fast sizes")
    args = p.parse_args(argv)
    summary_path = args.summary or os.path.join(args.out_dir,
                                                "runbook_vs_tool.json")
    os.makedirs(os.path.dirname(os.path.abspath(summary_path)),
                exist_ok=True)
    tool_dir = os.path.join(args.out_dir, "tool")
    book_dir = os.path.join(args.out_dir, "runbook")
    summary: dict = {"device": args.device, "card": card_line(),
                     "fast": args.fast, "seconds": {}}
    print(f"card: {summary['card']}", flush=True)

    def save(*copies):
        """Write the summary; copy (file, name) pairs beside it."""
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=2)
        for src, name in copies:
            shutil.copy(src, os.path.join(os.path.dirname(
                os.path.abspath(summary_path)), name))

    t0 = time.perf_counter()
    _tool("accuracy_benchmark_torch").main([
        "--out_dir", tool_dir, "--seeds", "0", "--victims", "pointnet",
        "--attacks", *ATTACKS, "--defenses", *DEFENSES,
        "--num_points", "1024", "--batch_size", "40",
        "--device", args.device, *(["--fast"] if args.fast else [])])
    summary["seconds"]["tool"] = time.perf_counter() - t0
    seed_dir = os.path.join(tool_dir, "seed0")
    with open(os.path.join(seed_dir, "legs.json")) as f:
        summary["tool_legs"] = json.load(f)
    save((os.path.join(seed_dir, "results.json"), "tool_results.json"))

    t0 = time.perf_counter()
    sources = export_pth(seed_dir, os.path.join(args.out_dir, "pth"))
    summary["seconds"]["export"] = time.perf_counter() - t0
    data = os.path.join(seed_dir, "hard8.npz")
    t0 = time.perf_counter()
    rc = _tool("reproduce_baseline_torch").main([
        "--weights_dir", os.path.join(args.out_dir, "pth"),
        "--data", data, "--out_dir", book_dir,
        "--victims", "pointnet", "--attacks", *ATTACKS,
        "--defenses", *DEFENSES,
        "--stages", "inventory", "convert", "parity", "data", "clean",
        "tables", "--device", args.device,
        *(["--fast"] if args.fast else [])])
    summary["seconds"]["runbook"] = time.perf_counter() - t0
    save((os.path.join(book_dir, "seed0", "results.json"),
          "runbook_results.json"),
         (os.path.join(book_dir, "report.json"), "runbook_report.json"))
    with open(os.path.join(book_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(book_dir, "seed0", "legs.json")) as f:
        summary["runbook_legs"] = json.load(f)
    with open(os.path.join(book_dir, "converted.json")) as f:
        converted = json.load(f)
    summary["runbook"] = {"rc": rc, "data": data,
                          "stages": report["stages"],
                          "stage_seconds": report["stage_seconds"],
                          "clean": report.get("clean")}
    summary["same_weights"] = {k: same_leaves(sources[k], converted[k])
                               for k in sources}

    with open(os.path.join(seed_dir, "results.json")) as f:
        want = cells(json.load(f))
    with open(os.path.join(book_dir, "seed0", "results.json")) as f:
        got = cells(json.load(f))
    summary["cells"] = {k: {"tool": want.get(k), "runbook": got.get(k)}
                        for k in sorted(set(want) | set(got))}
    differ = sorted(k for k, v in summary["cells"].items()
                    if v["tool"] != v["runbook"])
    summary["differ"] = differ
    save()

    print(f"weights round-trip leaf for leaf: {summary['same_weights']}")
    print(f"runbook rc {rc}; stages "
          + ", ".join(f"{k}:{v['status']}"
                      for k, v in report["stages"].items()))
    print("seconds: tool {tool:.1f}, export {export:.1f}, runbook "
          "{runbook:.1f}".format(**summary["seconds"]))
    print("runbook stage seconds: " + json.dumps(
        {k: round(v, 1) for k, v in report["stage_seconds"].items()}))
    for tag in ("tool_legs", "runbook_legs"):
        print(f"{tag}: " + ", ".join(
            f"{leg['leg']} {leg['seconds']:.1f}" for leg in summary[tag]))
    for k, v in summary["cells"].items():
        mark = "" if v["tool"] == v["runbook"] else "  DIFFERS"
        print(f"  {k:40s} tool {v['tool']}  runbook {v['runbook']}{mark}")
    print(f"{len(summary['cells']) - len(differ)} of {len(summary['cells'])} "
          f"cells equal; differ: {differ}")
    ok = rc == 0 and not differ and all(summary["same_weights"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
