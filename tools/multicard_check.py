#!/usr/bin/env python3
"""The five eval CLIs and victim training with their batches split over
every visible card (`--device cuda`) against the same CLI on card 0 alone
(`--device cuda:0`), and against the same split over card 0 alone, on the
same files and weights.

    python3 tools/multicard_check.py [--out runs/multicard.json]
        [--only train,inference,...]

Inputs are made from seeds, at the CLIs' widths: 48 ellipsoid clouds of
1024 points (8 outliers each); a ConvONet from the port's seeded init
(`init_params(0)`); the repository's PU-Net; a PointNet++ victim from
`torch.manual_seed(0)` with calibrated batch-norm statistics. The CLIs:

- `opt_defense`, reference mode (200 steps, batch 48), deterministic;
- `inference` of the PointNet++ victim (batch 16), and its eval step's
  logits on one 16-cloud batch;
- `defend_npz`, SRS, SOR and DUP-Net (batch 48);
- `attack`, PGD (10 steps, batch 16) on the victim;
- `remesh_defense`, ConvONet-Mesh (batch 8, a 33^3 lattice);
- `train`, PointNet++ from `flax_init_params(0)`, one epoch at batch 32
  (10 steps, then the test split) on 320 train and 64 test clouds of 8
  classes, deterministic; compared: the final weights (flat), each
  epoch's train loss and test accuracy.

Each runs five times, in this order: on card 0 (`one`), split over every
card (`split`; `best_data_mesh` takes the most cards that divide the
batch), split into as many shares on card 0 alone (`same_card`, through
the CLIs' `devices=` seam), then `split` and `one` again (warm). Records
whether outputs are bit-equal and their largest difference for `one`
against `split` (the shares' batch size changes: cuBLAS and cuDNN may
pick other kernels), `split` against `same_card` (the same shares on
other cards: bit-equal unless a card computes otherwise), and each
against its warm rerun; and the wall time of every run (host clock
around `main`). Prints the card's name and power limit, then one JSON
line, also written to `--out`. `--only` runs the entries named
(`opt_defense`, `inference`, `defend_npz`, `attack_pgd`,
`remesh_defense`, `train`). Exits non-zero when fewer than two cards are
visible, or when an output is not finite. Differences are reported, not
failed on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

N_CLOUDS = 48


def clouds(seed: int, n: int) -> np.ndarray:
    """n clouds of 1024 points on ellipsoid surfaces, 8 outliers each."""
    gen = np.random.default_rng(seed)
    d = gen.normal(size=(n, 1024, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pc = d * gen.uniform(0.3, 1.0, (n, 1, 3))
    pc[:, :8] *= 2.5
    return pc.astype(np.float32)


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise SystemExit("non-finite output")
    if a.shape != b.shape:
        raise SystemExit(f"shapes {a.shape} and {b.shape}")
    gap = np.abs(a - b)
    return {"bit_equal": bool(np.array_equal(a, b)),
            "max_abs_diff": float(gap.max()),
            "within_1e-4": float((gap <= 1e-4).mean())}


ENTRIES = ("opt_defense", "inference", "defend_npz", "attack_pgd",
           "remesh_defense", "train")
RUNS = ("one", "split", "same_card", "split_warm", "one_warm")
PAIRS = (("one", "split"), ("split", "same_card"), ("split", "split_warm"),
         ("one", "one_warm"))


def runs(run, tmp: str, name: str, data: dict, batch: int) -> dict:
    """run(data path, --device, devices) for each of RUNS, each on its
    own copy of the data -> the PAIRS' comparisons of the outputs (an
    array or a dict of them), the seconds of each run and the cards of
    the split."""
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.parallel import best_data_mesh

    cards = best_data_mesh(batch, "cuda").size
    args = {"one": ("cuda:0", None), "split": ("cuda", None),
            "same_card": ("cuda:0", ["cuda:0"] * cards)}
    outs, secs = {}, {}
    for tag in RUNS:
        device, devices = args[tag.replace("_warm", "")]
        src = save_npz(os.path.join(tmp, f"{name}-{tag}", "x.npz"), data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tag] = run(src, device, devices)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0

    def pair(a, b):
        if isinstance(a, dict):
            return {k: pair(a[k], b[k]) for k in a}
        if isinstance(a, np.ndarray):
            return compare(a, b)
        return a == b

    return {"cards": cards, "seconds": secs,
            **{f"{a}_vs_{b}": pair(outs[a], outs[b]) for a, b in PAIRS}}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "runs",
                                                 "multicard.json"))
    p.add_argument("--only", default=",".join(ENTRIES),
                   help="comma list of the entries to run")
    args = p.parse_args()
    only = set(args.only.split(","))
    if not only <= set(ENTRIES):
        p.error(f"--only: {sorted(only - set(ENTRIES))} not in {ENTRIES}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"needs two or more cards, {n} visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())

    from if_defense_tpu_torch.cli import (
        attack,
        defend_npz,
        inference,
        opt_defense,
        remesh_defense,
        train,
    )
    from if_defense_tpu_torch.data import load_npz
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.models.common import calibrate_batch_norm
    from if_defense_tpu_torch.ops import normalize_unit_sphere
    from if_defense_tpu_torch.parallel import best_data_mesh
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from if_defense_tpu_torch.utils.params_io import (
        flatten_params,
        init_params,
        load_params_npz,
        params_to_jax,
        save_params_npz,
    )

    pc = clouds(0, N_CLOUDS)
    label = np.arange(N_CLOUDS) % 40
    data = {"test_pc": pc, "test_label": label,
            "target_label": (label + 7) % 40}
    victim_pc = normalize_unit_sphere(torch.from_numpy(pc)).numpy()
    vdata = {**data, "test_pc": victim_pc}
    results = {"cards": n}
    deterministic = torch.are_deterministic_algorithms_enabled()
    with tempfile.TemporaryDirectory() as tmp:
        weights = save_params_npz(os.path.join(tmp, "convonet.npz"),
                                  init_params(0))
        torch.manual_seed(0)
        victim = calibrate_batch_norm(
            build_model("pointnet2").cuda(),
            torch.from_numpy(victim_pc[:16]).cuda(), 0)
        ckpt = save_eval_checkpoint(
            os.path.join(tmp, "victim.npz"),
            params_to_jax(victim.state_dict(), victim),
            {"model": "pointnet2"})
        del victim

        if "opt_defense" in only:
            def opt(src, device, devices):
                out, = opt_defense.main([
                    "--data_root", src, "--weights", weights,
                    "--batch_size", "48", "--iterations", "200",
                    "--sample_npoint", "1024", "--device", device],
                    devices=devices)
                return load_npz(out).test_pc
            torch.use_deterministic_algorithms(True)
            try:
                results["opt_defense"] = runs(opt, tmp, "opt", data, 48)
            finally:
                torch.use_deterministic_algorithms(deterministic)

        if "inference" in only:
            def score(src, device, devices):
                record = inference.main([
                    "--data", src, "--checkpoint", ckpt, "--batch_size",
                    "16", "--mode", "target", "--device", device],
                    devices=devices)
                return {k: record[k] for k in ("accuracy", "target_success")}
            results["inference"] = runs(score, tmp, "inference", vdata, 16)
            iargs = inference.parse_args(["--data", "unused", "--checkpoint",
                                          ckpt, "--batch_size", "16"])
            x = torch.from_numpy(victim_pc[:16]).cuda()
            cards = results["inference"]["cards"]
            logits = {tag: inference._load_eval_cached(
                iargs, best_data_mesh(16, devs))[2](x).cpu().numpy()
                for tag, devs in (("one", "cuda:0"), ("split", "cuda"),
                                  ("same_card", ["cuda:0"] * cards))}
            results["inference"]["logits"] = {
                "one_vs_split": compare(logits["one"], logits["split"]),
                "split_vs_same_card": compare(logits["split"],
                                              logits["same_card"])}

        if "defend_npz" in only:
            def defend(src, device, devices):
                return {name: load_npz(path).test_pc
                        for name, path in zip(("srs", "sor", "dup"),
                                              defend_npz.main([
                                                  "--data_root", src,
                                                  "--batch_size", "48",
                                                  "--device", device],
                                                  devices=devices))}
            results["defend_npz"] = runs(defend, tmp, "defend", data, 48)

        if "attack_pgd" in only:
            def pgd(src, device, devices):
                out, rate = attack.main([
                    "--attack", "pgd", "--data", src, "--checkpoint", ckpt,
                    "--num_iter", "10", "--batch_size", "16", "--output",
                    src + ".adv.npz", "--device", device], devices=devices)
                return {"adv": load_npz(out).test_pc, "success_rate": rate}
            results["attack_pgd"] = runs(
                pgd, tmp, "attack", {**vdata, "test_pc": victim_pc[:16]}, 16)

        if "remesh_defense" in only:
            def remesh(src, device, devices):
                out, = remesh_defense.main([
                    "--variant", "convonet", "--data_root", src, "--weights",
                    weights, "--batch_size", "8", "--resolution0", "32",
                    "--device", device], devices=devices)
                return load_npz(out).test_pc
            results["remesh_defense"] = runs(remesh, tmp, "remesh",
                                             {**data, "test_pc": pc[:8]}, 8)

        if "train" in only:
            def fit(src, device, devices):
                out = src + ".run"
                train.main(["--data", src, "--model", "pointnet2",
                            "--batch_size", "32", "--epochs", "1",
                            "--seed", "0", "--output", out, "--registry",
                            os.path.join(out, "registry.json"),
                            "--device", device], devices=devices)
                with open(os.path.join(out, "metrics.jsonl")) as f:
                    epochs = [r for r in map(json.loads, f) if "epoch" in r]
                final = flatten_params(load_params_npz(
                    os.path.join(out, "final.npz")))
                return {"weights": np.concatenate(
                            [np.ravel(v) for v in final.values()]),
                        "train_loss": np.array([r["train_loss"]
                                                for r in epochs]),
                        "test_acc": np.array([r["test_acc"]
                                              for r in epochs])}
            fit_data = {"train_pc": clouds(1, 320),
                        "train_label": np.arange(320) % 8,
                        "test_pc": clouds(2, 64),
                        "test_label": np.arange(64) % 8}
            torch.use_deterministic_algorithms(True)
            try:
                results["train"] = runs(fit, tmp, "train", fit_data, 32)
            finally:
                torch.use_deterministic_algorithms(deterministic)

    line = json.dumps(results)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
