#!/usr/bin/env python3
"""One CLI of the port in several checkouts on one card, one after another:
ConvONet-Opt (`cli/opt_defense.py`) in its reference and fast modes,
ConvONet-Mesh (`cli/remesh_defense.py --variant convonet`), ConvONet
training (`cli/train_implicit.py --variant convonet`) or victim training
(`cli/train.py`, PointNet++ and DGCNN).

    python3 tools/compare_trees.py --cli opt_defense|remesh_defense|
        train_implicit|train TREE [TREE ...] [--runs 2]

The inputs are `chip_smoke.py`'s (this checkout's), made once in a process
of their own:
- opt_defense: phase 4's 4 x 48 synthetic ellipsoid clouds of 1024 points
  and seeded weights (`init_params(0)`), at its flags (batch 48, 200
  iterations = 201 steps, 1024 sample points, --seed 1); reference mode
  f32, fast mode bf16 with the corner cache refreshed every 16 steps and
  the cached repulsion graph.
- remesh_defense: phase 15's: phase 12's 320 victim clouds and a
  full-width ConvONet trained on phase 10's occupancy npz for 100 steps;
  the CLI's defaults (batch 32, a 129^3 lattice, 1024 output points).
- train_implicit: phase 10's occupancy npz and flags (100 steps at its
  learning rate, --seed 0, batch 32).
- train: `tools/synthetic_dataset.py`'s hard family as phase 14 makes it,
  but 100 train clouds a class (800, 25 steps an epoch) and 10 test
  clouds; the CLI's defaults (batch 32, 1024 points, --seed 1) for 3
  epochs, each with its test pass (the last 20 epochs always evaluate).
Then, for each TREE in the order given (the root of a checkout of the
repo, e.g. a parent commit unpacked with `git archive`), one process that
imports that tree's `if_defense_tpu_torch` runs the CLI `--runs` times in
each mode and reads the rate from each run's metrics: clouds/s, steps/s
for `train_implicit`, and for `train` an epoch's steps over its
`epoch_time` (its test pass included), over epochs 2-3; a digest of each
run's output (the clouds, or every trained weight, with the victims' Adam
moments) says whether the runs of a tree repeat their bits. The
first run in each process builds that tree's kernels. Trees given as A B B
A put a drift of the machine on both sides. Prints the card's name and
power limit, then one JSON line: {"card": ..., "cli": ..., "runs":
[{"tree": ..., "mode": ..., "rate": [...], "sha256": [...]}, ...]}.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "opt_defense": {
        "reference": [],
        "fast": ["--compute_dtype", "bfloat16", "--interp_refresh", "16",
                 "--rep_graph_cache"]},
    "remesh_defense": {"default": ["--variant", "convonet"]},
    "train_implicit": {"convonet": ["--variant", "convonet"]},
    "train": {"pointnet2": ["--model", "pointnet2"],
              "dgcnn": ["--model", "dgcnn"]},
}

# the CLI `runs` times a mode in one process of the tree given (its cwd and
# the head of sys.path) -> one JSON line {mode: [(rate, sha256), ...]}
CHILD = r"""
import hashlib, importlib, json, os, sys
import numpy as np
tree, cli, inputs, runs, modes = sys.argv[1:6]
sys.path.insert(0, tree)
main = importlib.import_module(f"if_defense_tpu_torch.cli.{cli}").main
inputs = json.loads(inputs)
out = {}
for mode, extra in json.loads(modes).items():
    out[mode] = []
    for r in range(int(runs)):
        if cli == "train":
            out_dir = os.path.join(inputs["tmp"], f"{mode}{r}")
            main(["--data", inputs["data"], "--output", out_dir,
                  "--registry", os.path.join(out_dir, "registry.json"),
                  "--device", "cuda", *inputs["flags"], *extra])
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                times = [x["epoch_time"] for x in map(json.loads, f)
                         if "epoch" in x][1:]
            digest = hashlib.sha256()
            for name in ("final.npz", "final.npz.opt.npz"):
                with np.load(os.path.join(out_dir, name)) as z:
                    for key in sorted(z.files):
                        digest.update(z[key].tobytes())
            out[mode].append((inputs["steps"] * len(times) / sum(times),
                              digest.hexdigest()))
            continue
        if cli == "train_implicit":
            path = main(["--data", inputs["data"], "--steps",
                         str(inputs["steps"]), "--lr", str(inputs["lr"]),
                         "--log_every", "10", "--device", "cuda",
                         "--output", os.path.join(inputs["tmp"],
                                                  f"{mode}{r}"), *extra])
        else:
            path, = main(["--data_root", inputs["data"], "--weights",
                          inputs["weights"], "--device", "cuda",
                          *inputs["flags"], *extra])
        with open(path.removesuffix(".npz") + ".metrics.jsonl"
                  if cli == "train_implicit" else
                  path + ".metrics.jsonl") as f:
            last = json.loads(f.read().splitlines()[-1])
        rate = last["steps_per_sec" if cli == "train_implicit"
                    else "clouds_per_sec"]
        digest = hashlib.sha256()
        with np.load(path) as z:
            for key in sorted(z.files) if cli == "train_implicit" \
                    else ["test_pc"]:
                digest.update(z[key].tobytes())
        out[mode].append((rate, digest.hexdigest()))
print(json.dumps(out))
"""


def inputs(cli: str, tmp: str) -> dict:
    """The CLI's inputs as this checkout's `chip_smoke.py` makes them."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from if_defense_tpu_torch.data import save_npz

    if cli == "train_implicit":
        return {"data": cs.build_occupancy_npz(tmp), "steps": cs.TRAIN_STEPS,
                "lr": cs.TRAIN_LR, "tmp": tmp}
    if cli == "train":
        data = os.path.join(tmp, "synth.npz")
        cs.tool("synthetic_dataset").make_classification_npz(
            data, 100, 10, 1024, seed=0, family="hard")
        return {"data": data, "steps": 800 // cs.TRAIN_B, "tmp": tmp,
                "flags": ["--batch_size", str(cs.TRAIN_B), "--epochs", "3"]}
    os.makedirs(os.path.join(tmp, "clouds"))
    if cli == "opt_defense":
        from if_defense_tpu_torch.utils.params_io import (
            init_params,
            save_params_npz,
        )

        n = 4 * cs.B
        data = save_npz(os.path.join(tmp, "clouds", "x.npz"), {
            "test_pc": cs.ellipsoids(np.random.default_rng(0), n),
            "test_label": np.arange(n) % 40})
        weights = save_params_npz(os.path.join(tmp, "weights.npz"),
                                  init_params(0))
        return {"data": data, "weights": weights,
                "flags": ["--batch_size", "48", "--iterations", "200",
                          "--sample_npoint", "1024", "--seed", "1"]}
    occ = cs.build_occupancy_npz(tmp)
    weights = cs.run_train_cli(tmp, occ, "convonet", "warm")["path"]
    clouds = cs.victim_clouds(np.random.default_rng(14), cs.VICTIM_CLOUDS)
    label = np.arange(cs.VICTIM_CLOUDS) % 40
    data = save_npz(os.path.join(tmp, "clouds", "victims.npz"), {
        "test_pc": clouds.numpy(), "test_label": label,
        "target_label": (label + 7) % 40})
    return {"data": data, "weights": weights, "flags": []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cli", required=True, choices=sorted(MODES))
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        # the inputs in a process of their own, so that this one holds no
        # card memory while the trees run
        made = subprocess.run(
            [sys.executable, "-c", "import json, sys; sys.path.insert(0, "
             f"{os.path.join(ROOT, 'tools')!r}); import compare_trees as t; "
             f"print(json.dumps(t.inputs({args.cli!r}, {tmp!r})))"],
            check=True, capture_output=True, text=True, timeout=900)
        made = made.stdout.splitlines()[-1]
        for tree in args.trees:
            tree = os.path.abspath(tree)
            run = subprocess.run(
                [sys.executable, "-c", CHILD, tree, args.cli, made,
                 str(args.runs), json.dumps(MODES[args.cli])], cwd=tree,
                check=True, capture_output=True, text=True, timeout=900)
            for mode, got in json.loads(run.stdout.splitlines()[-1]).items():
                rates = [r for r, _ in got]
                digests = [d for _, d in got]
                print(f"{tree} {mode}: {rates} per s, runs bit-equal "
                      f"{len(set(digests)) == 1}", flush=True)
                out.append({"tree": tree, "mode": mode, "rate": rates,
                            "sha256": digests})
    print(json.dumps({"card": card, "cli": args.cli, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
