#!/usr/bin/env python3
"""ConvONet-Mesh (`cli/remesh_defense.py --variant convonet` at its
defaults) in several checkouts of the port on one card, one after another.

    python3 tools/compare_remesh_trees.py TREE [TREE ...] [--runs 2]

First it makes phase 15's inputs as `chip_smoke.py` (this checkout's)
makes them: phase 10's synthetic occupancy npz and a full-width ConvONet
trained on it for 100 steps (`train_implicit`), and phase 12's 320 victim
clouds. Then, for each TREE in the order given (the root of a checkout of
the repo, e.g. a parent commit unpacked with `git archive`), one process
that imports that tree's `if_defense_tpu_torch` runs the CLI `--runs`
times on those clouds and weights (batch 32, a 129^3 lattice, 1024
output points, f32, TF32 off) and reads clouds/s from each run's metrics
sidecar. Trees given as A B B A put a drift of the machine on both sides.
Prints the card's name and power limit, then one JSON line:
{"card": ..., "runs": [{"tree": ..., "clouds_per_sec": [...]}, ...]}.
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

# the CLI `runs` times in one process of the tree given (its cwd and the
# head of sys.path), clouds/s from the metrics sidecar -> one JSON line
CHILD = r"""
import json, sys
tree, data, weights, runs = sys.argv[1:5]
sys.path.insert(0, tree)
from if_defense_tpu_torch.cli import remesh_defense
rates = []
for _ in range(int(runs)):
    path, = remesh_defense.main(["--variant", "convonet", "--data_root",
                                 data, "--weights", weights,
                                 "--device", "cuda"])
    with open(path + ".metrics.jsonl") as f:
        rates.append(json.loads(f.read().splitlines()[-1])["clouds_per_sec"])
print(json.dumps(rates))
"""


def inputs(tmp: str) -> tuple[str, str]:
    """(victim clouds npz, trained ConvONet npz) as phases 10 and 12 of
    this checkout's `chip_smoke.py` make them."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from if_defense_tpu_torch.data import save_npz

    occ = cs.build_occupancy_npz(tmp)
    weights = cs.run_train_cli(tmp, occ, "convonet", "warm")["path"]
    clouds = cs.victim_clouds(np.random.default_rng(14), cs.VICTIM_CLOUDS)
    label = np.arange(cs.VICTIM_CLOUDS) % 40
    os.makedirs(os.path.join(tmp, "clouds"))
    data = save_npz(os.path.join(tmp, "clouds", "victims.npz"), {
        "test_pc": clouds.numpy(), "test_label": label,
        "target_label": (label + 7) % 40})
    return data, weights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
             f"{os.path.join(ROOT, 'tools')!r}); import compare_remesh_trees"
             f" as t; print(json.dumps(t.inputs({tmp!r})))"],
            check=True, capture_output=True, text=True, timeout=900)
        data, weights = json.loads(made.stdout.splitlines()[-1])
        for tree in args.trees:
            tree = os.path.abspath(tree)
            run = subprocess.run(
                [sys.executable, "-c", CHILD, tree, data, weights,
                 str(args.runs)], cwd=tree, check=True, capture_output=True,
                text=True, timeout=900)
            rates = json.loads(run.stdout.splitlines()[-1])
            print(f"{tree}: {rates} clouds/s", flush=True)
            out.append({"tree": tree, "clouds_per_sec": rates})
    print(json.dumps({"card": card, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
