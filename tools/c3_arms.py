#!/usr/bin/env python3
"""Arms of the C3 and C6 experiments on one card, one seed at a time.

    python3 tools/c3_arms.py --seed 0 --out_dir runs/c3 \\
        --copy_to results/c3 [--arms A C]

Arm A is the accuracy protocol as it runs (`tools/accuracy_benchmark_torch.py`,
every leg in f32 with TF32 off) on the rows that decide C3:

    --attacks clean knn --defenses none srs sor dup convonet_opt
    --opt_modes f32 --occ_steps 10000 --test_per_class 50 --device cuda:0

Arm C takes arm A's data, victim and kNN attack files unchanged (copied
into its own directory, each file's sha256 printed beside the original's),
retrains only the ConvONet under the TPU's default precision
(`tools/tpu_precision.py --mode_legs train_implicit`), then runs the
defenses and the scoring in f32 as arm A does. Arm B takes arm A's data
and trained ConvONet unchanged (copied the same way), trains the victim
and runs the attacks under the TPU's default precision (`--mode_legs
"train pointnet" attack`), then the defenses (ConvONet-Opt with arm A's
f32 ConvONet) and the scoring in f32. `--arms` picks the arms, arm A
always first (`A`, `A C` by default, `A B`). Printed after the arms: each
ConvONet's final training loss and accuracy (its `.metrics.jsonl`), each
arm's legs and the paired view of `tools/accuracy_vs_jax.py` (each other
arm minus arm A a seed and cell, with each arm's band verdict).

`--copy_to` copies what the arms wrote that is small (results, legs,
metrics, reports) into a directory of its own; the npz files stay in
`--out_dir`. `--occ_steps`, `--test_per_class` and `--knn_iter` shrink the
protocol for a trial at a tiny size (`--device cpu`).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VICTIM = "pointnet"
DATA = ("hard8.npz", "hard8_occ.npz")
# what an arm takes from arm A besides DATA (paths under the seed's
# directory), and the legs it runs under the TPU's precision
REUSED = {"C": tuple(os.path.join(VICTIM, f) for f in (
              "best.npz", "best.npz.meta.json", f"knn-{VICTIM}.npz",
              f"knn-{VICTIM}.npz.metrics.jsonl")),
          "B": ("convonet_w.npz", "convonet_w.metrics.jsonl")}
MODE_LEGS = {"C": ["train_implicit"], "B": [f"train {VICTIM}", "attack"]}
SMALL = ("results.json", "legs.json", "*.metrics.jsonl", "summary.json",
         "RESULTS.md", "*.config.json")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def protocol_args(args, out_dir: str) -> list[str]:
    return ["--out_dir", out_dir, "--seeds", str(args.seed),
            "--attacks", "clean", "knn",
            "--defenses", "none", "srs", "sor", "dup", "convonet_opt",
            "--opt_modes", "f32", "--occ_steps", str(args.occ_steps),
            "--test_per_class", str(args.test_per_class),
            "--knn_iter", str(args.knn_iter), "--device", args.device,
            *args.extra]


def last_metrics(path: str) -> dict:
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return rows[-1]


def copy_small(src: str, dst: str) -> None:
    """Every small file of `src` (SMALL's patterns, any depth) to `dst`."""
    for pattern in SMALL:
        for path in glob.glob(os.path.join(src, "**", pattern),
                              recursive=True):
            to = os.path.join(dst, os.path.relpath(path, src))
            os.makedirs(os.path.dirname(to), exist_ok=True)
            shutil.copy(path, to)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out_dir", default=os.path.join(ROOT, "runs", "c3"))
    p.add_argument("--copy_to", default=None)
    p.add_argument("--occ_steps", type=int, default=10000)
    p.add_argument("--test_per_class", type=int, default=50)
    p.add_argument("--knn_iter", type=int, default=2500)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--arms", nargs="+", default=["A", "C"],
                   choices=["A", "B", "C"])
    p.add_argument("extra", nargs="*",
                   help="more flags for accuracy_benchmark_torch.py, after --")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from tools import accuracy_benchmark_torch as acc
    from tools import accuracy_vs_jax, tpu_precision

    args = parse_args(argv)
    if args.arms[0] != "A":
        raise SystemExit("--arms: arm A runs first")
    card = card_line()
    print(f"card: {card}", flush=True)
    outs = {arm: os.path.join(args.out_dir, f"arm{arm}") for arm in args.arms}
    seeds = {arm: os.path.join(out, f"seed{args.seed}")
             for arm, out in outs.items()}
    seconds = {}
    t0 = time.time()
    acc.main(protocol_args(args, outs["A"]))
    seconds["A"] = time.time() - t0
    for arm in args.arms[1:]:
        t0 = time.time()
        for f in DATA + REUSED[arm]:
            src = os.path.join(seeds["A"], f)
            dst = os.path.join(seeds[arm], f)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(src, dst)
            a, c = sha256(src), sha256(dst)
            print(f"reused {os.path.relpath(dst, args.out_dir)}: sha256 "
                  f"arm A {a}, arm {arm} {c}{'' if a == c else ' DIFFER'}",
                  flush=True)
            if a != c:
                raise SystemExit(f"{dst} is not arm A's file")
        tpu_precision.main([
            *protocol_args(args, outs[arm]), "--reuse_artifacts",
            "--data_npz", os.path.join(seeds[arm], DATA[0]),
            "--occ_npz", os.path.join(seeds[arm], DATA[1]),
            "--mode_legs", *MODE_LEGS[arm]])
        seconds[arm] = time.time() - t0
    for arm, sd in seeds.items():
        m = last_metrics(os.path.join(sd, "convonet_w.metrics.jsonl"))
        print(f"arm {arm} seed {args.seed} ConvONet, step {m['step']}: "
              f"loss {m['loss']:.6f}, acc {m['acc']:.6f}", flush=True)
    for arm, out in outs.items():
        print(f"\n## arm {arm}\n", flush=True)
        accuracy_vs_jax.main([out])
    for arm in args.arms[1:]:
        print(f"\n## arm {arm} against arm A\n", flush=True)
        accuracy_vs_jax.main([outs[arm], "--paired", outs["A"]])
    print(f"arms' seconds: {json.dumps(seconds)} on {card}", flush=True)
    if args.copy_to:
        for arm, out in outs.items():
            copy_small(out, os.path.join(args.copy_to, f"arm{arm}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
