"""Discriminative accuracy benchmark on the PyTorch/CUDA port: attack x
victim x defense matrix through the port's CLIs.

The port of `tools/accuracy_benchmark.py`, with its flags, defaults and
outputs, and one flag more, `--device` (default `cuda:0`, one card),
passed to every CLI. It runs the reference's evaluation protocol
(`baselines/command.txt`, Tables 2-5: attack -> defend -> classify) on the
hard synthetic family (`tools/synthetic_dataset.py`, numpy only: the same
seed gives the same clouds as the JAX tool's run).

Per seed: generate data -> train victim(s) -> train implicit net(s) ->
run each attack through the CLI -> run each defense on each adversarial
npz -> score everything with the inference CLI. Writes
<out_dir>/seed<k>/results.json (the JAX tool's key tree), an aggregated
<out_dir>/summary.json and <out_dir>/RESULTS.md, and beside each seed's
results <out_dir>/seed<k>/legs.json: every CLI call's seconds, device and
the TF32 settings it ran with.

Runs on the card unless given `--device cpu`; without a card it exits
with an error. All the CLIs run in this one process, so the cuBLAS
workspace that the attack CLI's deterministic algorithms need
(`CUBLAS_WORKSPACE_CONFIG=:4096:8`) is set at start-up, before the first
cuBLAS handle: set later, cuBLAS would ignore it.

Usage (the discriminative benchmark of RESULTS_DISCRIM_TORCH.md):
    python tools/accuracy_benchmark_torch.py --out_dir runs/acc --seeds 0 \
        --attacks clean knn drop perturb \
        --defenses none srs sor dup convonet_opt \
        --opt_modes f32 bf16_r16 --occ_steps 10000 --test_per_class 50
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPT_MODE_FLAGS = {
    "f32": [],
    "bf16": ["--compute_dtype", "bfloat16"],
    "bf16_r8": ["--compute_dtype", "bfloat16", "--interp_refresh", "8"],
    "bf16_r16": ["--compute_dtype", "bfloat16", "--interp_refresh", "16"],
    "bf16_r32": ["--compute_dtype", "bfloat16", "--interp_refresh", "32"],
    "bf16_r16_repc": ["--compute_dtype", "bfloat16", "--interp_refresh",
                      "16", "--rep_graph_cache"],
    "f32_r16_repc": ["--interp_refresh", "16", "--rep_graph_cache"],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir",
                   default=os.path.join(ROOT, "runs", "acc_bench"),
                   help="default runs/acc_bench in this checkout")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--victims", nargs="+", default=["pointnet"])
    p.add_argument("--attacks", nargs="+",
                   default=["knn", "drop", "perturb"])
    p.add_argument("--defenses", nargs="+",
                   default=["none", "sor", "convonet_opt"])
    p.add_argument("--opt_modes", nargs="+", default=["bf16_r16"],
                   help="ConvONet-Opt precision/fast-path modes "
                        f"({sorted(OPT_MODE_FLAGS)})")
    p.add_argument("--onet_modes", nargs="+", default=["f32"],
                   help="ONet-Opt precision modes (f32/bf16 only — the "
                        "corner cache is plane-latent ConvONet-specific)")
    p.add_argument("--family", default="hard", choices=["easy", "hard"])
    p.add_argument("--train_per_class", type=int, default=150)
    p.add_argument("--test_per_class", type=int, default=40)
    p.add_argument("--occ_per_class", type=int, default=60)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--occ_steps", type=int, default=4000)
    p.add_argument("--defense_iters", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--knn_iter", type=int, default=2500)
    p.add_argument("--cw_steps", type=int, nargs=2, default=[10, 500],
                   help="CW binary steps / iters for perturb-family")
    p.add_argument("--num_drop", type=int, default=200)
    p.add_argument("--fast", action="store_true",
                   help="tiny sizes for smoke iteration")
    p.add_argument("--data_npz", default=None,
                   help="use this classification npz (test_pc/test_label"
                        "/target_label, e.g. real ModelNet40) instead of "
                        "generating the synthetic family")
    p.add_argument("--occ_npz", default=None,
                   help="occupancy-training npz to pair with --data_npz; "
                        "only needed when an implicit net must be "
                        "trained (i.e. not provided via "
                        "--implicit_weights)")
    p.add_argument("--victim_ckpts", nargs="*", default=[],
                   metavar="NAME=PATH",
                   help="pre-trained victim checkpoints (npz, e.g. "
                        "converted from a reference .pth); named victims "
                        "skip training")
    p.add_argument("--implicit_weights", nargs="*", default=[],
                   metavar="VARIANT=NPZ",
                   help="pre-trained onet/convonet params npz; named "
                        "variants skip implicit training")
    p.add_argument("--resume", action="store_true",
                   help="reuse seed<k>/results.json where it exists")
    p.add_argument("--reuse_artifacts", action="store_true",
                   help="skip any producer (victim/implicit training, "
                        "attack, defense) whose output file already "
                        "exists under out_dir — resumes an interrupted "
                        "matrix run at cell granularity; scoring always "
                        "re-runs (cheap)")
    p.add_argument("--device", default="cuda:0",
                   help="torch device of every CLI (default one card, "
                        "cuda:0; cpu only when asked)")
    return p.parse_args(argv)


def attack_cli_args(attack, cw_steps, knn_iter, num_drop):
    """(CLI attack name, extra CLI flags) for a matrix attack cell.

    `attack` may be an alias for a reference-table parameter variant
    (Tables 2-5 report Add-CD vs Add-HD and Drop-100 vs Drop-200 as
    separate columns): `add_hd` = CW-Add with the Hausdorff adversarial
    distance (`baselines/attack_scripts/targeted_add_attack.py`
    --dist_func hausdorff), `drop100` = Saliency Drop with num_drop=100.
    """
    cli_attack = {"add_hd": "add", "drop100": "drop"}.get(attack, attack)
    extra = []
    if cli_attack == "perturb":
        extra = ["--binary_step", str(cw_steps[0]),
                 "--num_iter", str(cw_steps[1])]
    elif cli_attack in ("add", "add_cluster", "add_object"):
        extra = ["--binary_step", str(max(cw_steps[0] // 2, 1)),
                 "--num_iter", str(cw_steps[1])]
        if attack == "add_hd":
            extra += ["--adv_dist", "hausdorff"]
    elif cli_attack == "knn":
        extra = ["--num_iter", str(knn_iter)]
    elif cli_attack == "drop":
        extra = ["--num_drop",
                 "100" if attack == "drop100" else str(num_drop)]
    return cli_attack, extra


class Legs:
    """Every CLI call of a seed: its seconds, device and the TF32 settings
    it ran with (read when it returns: each CLI sets them at its start and
    none restores them), written to `path` after each call, after the
    rows of an earlier, interrupted run of the seed. Each call runs inside
    `context(leg)` (`tools/tpu_precision.py --mode_legs` sets it)."""

    context = staticmethod(lambda leg: contextlib.nullcontext())

    def __init__(self, path: str, device: str):
        self.path, self.device, self.rows = path, device, []
        if os.path.exists(path):
            with open(path) as f:
                self.rows = json.load(f)

    def run(self, leg: str, fn, argv: list[str]):
        import torch

        t0 = time.time()
        with self.context(leg):
            out = fn([*argv, "--device", self.device])
        self.rows.append({
            "leg": leg, "seconds": time.time() - t0, "device": self.device,
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        })
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.rows, f, indent=2)
        os.replace(tmp, self.path)
        return out


def run_seed(args, seed: int) -> dict:
    from if_defense_tpu_torch.cli.attack import main as attack_main
    from if_defense_tpu_torch.cli.defend_npz import main as defend_main
    from if_defense_tpu_torch.cli.inference import main as inf_main
    from if_defense_tpu_torch.cli.opt_defense import main as opt_main
    from if_defense_tpu_torch.cli.remesh_defense import main as remesh_main
    from if_defense_tpu_torch.cli.train import main as train_main
    from if_defense_tpu_torch.cli.train_implicit import main as timpl_main
    from tools.synthetic_dataset import main as make_data

    sd = os.path.join(args.out_dir, f"seed{seed}")
    os.makedirs(sd, exist_ok=True)
    results = {"seed": seed, "victims": {}}
    legs = Legs(os.path.join(sd, "legs.json"), args.device)

    if args.fast:
        tpc, tec, opc = 30, 10, 20
        epochs, occ_steps, d_iters = 8, 300, 20
        knn_iter, cw_steps, num_drop = 100, (2, 40), 32
    else:
        tpc, tec, opc = args.train_per_class, args.test_per_class, \
            args.occ_per_class
        epochs, occ_steps, d_iters = args.epochs, args.occ_steps, \
            args.defense_iters
        knn_iter, cw_steps = args.knn_iter, tuple(args.cw_steps)
        num_drop = args.num_drop

    provided_ckpts = dict(kv.split("=", 1) for kv in args.victim_ckpts)
    provided_iw = dict(kv.split("=", 1) for kv in args.implicit_weights)

    if args.data_npz:
        cls_npz, occ_npz = args.data_npz, args.occ_npz
    else:
        cls_npz, occ_npz = make_data([
            "--out_dir", sd, "--family", args.family,
            "--train_per_class", str(tpc), "--test_per_class", str(tec),
            "--occ_per_class", str(opc),
            "--num_points", str(args.num_points),
            "--seed", str(seed),
        ])

    # implicit nets (shared across victims)
    implicit_weights = dict(provided_iw)
    need_conv = any(d.startswith("convonet") for d in args.defenses)
    need_onet = any(d.startswith("onet") for d in args.defenses)
    for variant, needed in (("convonet", need_conv), ("onet", need_onet)):
        if not needed:
            continue
        if variant in provided_iw:
            print(f"[seed {seed}] provided implicit weights "
                  f"{provided_iw[variant]}", flush=True)
            continue
        if occ_npz is None:
            raise SystemExit(
                f"--data_npz given without --occ_npz, but defense set "
                f"needs a trained {variant}; pass --implicit_weights "
                f"{variant}=<npz> (converted from the reference .pth) "
                f"or an --occ_npz to train from")
        w_out = os.path.join(sd, f"{variant}_w")
        if args.reuse_artifacts and os.path.exists(w_out + ".npz"):
            print(f"[seed {seed}] reuse implicit weights {w_out}.npz",
                  flush=True)
            implicit_weights[variant] = w_out + ".npz"
            continue
        implicit_weights[variant] = legs.run(f"train_implicit {variant}",
                                             timpl_main, [
            "--variant", variant, "--data", occ_npz,
            "--steps", str(occ_steps), "--batch_size", "16",
            "--log_every", str(max(occ_steps // 10, 1)),
            "--save_every", str(occ_steps),
            "--seed", str(seed),
            "--output", w_out,
        ])

    from if_defense_tpu_torch.cli.opt_defense import (
        get_save_name as opt_name)
    from if_defense_tpu_torch.cli.remesh_defense import (
        get_save_name as remesh_name)

    def reuse(path):
        if args.reuse_artifacts and os.path.exists(path):
            print(f"[seed {seed}] reuse {path}", flush=True)
            return True
        return False

    def defended_paths(adv_path):
        """name -> defended npz path for every requested defense.

        Depends only on the input npz (defenses are victim-agnostic);
        with --reuse_artifacts the same defended files are shared
        across victims for the clean row.
        """
        out = {}
        adv_dir = os.path.dirname(os.path.abspath(adv_path))
        stem = os.path.basename(adv_path)
        for d in args.defenses:
            if d == "none":
                out["none"] = adv_path
            elif d in ("srs", "sor", "dup"):
                pred = os.path.join(adv_dir, d, f"{d}_{stem}")
                if reuse(pred):
                    out[d] = pred
                    continue
                path, = legs.run(f"defend {d} {stem}", defend_main, [
                    "--data_root", adv_path, "--defense", d,
                    "--batch_size", str(args.batch_size)])
                out[d] = path
            elif d in ("convonet_opt", "onet_opt"):
                variant = d.split("_")[0]
                modes = (args.opt_modes if variant == "convonet"
                         else args.onet_modes)
                for mode in modes:
                    key = d if len(modes) == 1 else f"{d}:{mode}"
                    pred = opt_name(adv_path, variant)
                    if len(modes) > 1:
                        pred = pred.replace(".npz", f".{mode}.npz")
                    if reuse(pred):
                        out[key] = pred
                        continue
                    path, = legs.run(f"defend {key} {stem}", opt_main, [
                        "--variant", variant, "--data_root", adv_path,
                        "--weights", implicit_weights[variant],
                        "--iterations", str(d_iters),
                        "--batch_size", str(args.batch_size),
                        "--seed", str(seed),
                        *OPT_MODE_FLAGS[mode],
                    ])
                    out[key] = path
                    if len(modes) > 1:
                        # distinct copies: opt_main overwrites per variant
                        keyed = path.replace(".npz", f".{mode}.npz")
                        os.replace(path, keyed)
                        out[key] = keyed
            elif d in ("convonet_mesh", "onet_mesh"):
                variant = d.split("_")[0]
                pred = remesh_name(adv_path, variant)
                if reuse(pred):
                    out[d] = pred
                    continue
                path, = legs.run(f"defend {d} {stem}", remesh_main, [
                    "--variant", variant, "--data_root", adv_path,
                    "--weights", implicit_weights[variant],
                    "--batch_size", str(args.batch_size),
                    "--seed", str(seed),
                    # sparse wire: bit-identical to int8 (plane-latent
                    # ConvONet only). ONet takes the coarse+refine path:
                    # bf16 compute + int8 refined-voxel wire
                    *(["--wire", "sparse"] if variant == "convonet"
                      else ["--compute_dtype", "bfloat16",
                            "--wire", "int8"]),
                    *(["--resolution0", "16", "--upsample", "2"]
                      if args.fast else []),
                ])
                out[d] = path
            else:
                raise ValueError(d)
        return out

    for victim in args.victims:
        vdir = os.path.join(sd, victim)
        os.makedirs(vdir, exist_ok=True)
        t0 = time.time()
        meta_p = os.path.join(vdir, "best.npz.meta.json")
        if victim in provided_ckpts:
            ckpt = os.path.abspath(provided_ckpts[victim])
            r = legs.run(f"score {victim} clean", inf_main, [
                "--data", cls_npz, "--checkpoint", ckpt,
                "--num_points", str(args.num_points),
                "--batch_size", str(args.batch_size)])
            clean_best = r["accuracy"]
            print(f"[seed {seed}] provided victim checkpoint {ckpt} "
                  f"(clean acc {clean_best:.3f})", flush=True)
        elif args.reuse_artifacts and os.path.exists(meta_p):
            with open(meta_p) as f:
                clean_best = float(json.load(f)["acc"])
            print(f"[seed {seed}] reuse victim checkpoint {vdir}/best "
                  f"(clean acc {clean_best:.3f})", flush=True)
        else:
            clean_best = legs.run(f"train {victim}", train_main, [
                "--data", cls_npz, "--model", victim,
                "--num_points", str(args.num_points),
                "--epochs", str(epochs),
                "--batch_size", "32",
                "--eval_every", str(max(epochs // 8, 1)),
                "--output", vdir, "--seed", str(seed),
                # keep a checked-in registry untouched
                "--registry", os.path.join(sd, "registry.json"),
            ])
        if victim not in provided_ckpts:
            ckpt = os.path.join(vdir, "best.npz")
        vres = {"clean_accuracy": clean_best,
                "train_seconds": time.time() - t0, "attacks": {}}

        def acc_of(path, num_points=None):
            return legs.run(f"score {victim} {os.path.basename(path)}",
                            inf_main, [
                "--data", path, "--checkpoint", ckpt,
                "--num_points", str(num_points or args.num_points),
                "--batch_size", str(args.batch_size), "--mode", "target"])

        def snapshot():
            # incremental results: a leg interrupted mid-attack keeps its
            # finished rows queryable — atomic tmp+replace so a concurrent
            # reader never sees a torn file
            results["victims"][victim] = vres
            tmp = os.path.join(sd, "results.json.tmp")
            with open(tmp, "w") as f:
                json.dump(results, f, indent=2, default=float)
            os.replace(tmp, os.path.join(sd, "results.json"))

        for attack in args.attacks:
            if attack == "clean":
                # pseudo-attack: defenses applied to the CLEAN test set —
                # each defense's fidelity tax (the reconstruction
                # ceiling for the implicit variants)
                ares = {"success_rate": 0.0, "attack_seconds": 0.0,
                        "attacked": acc_of(cls_npz), "defended": {}}
                for name, path in defended_paths(cls_npz).items():
                    dn = np.load(path)["test_pc"].shape[1]
                    ares["defended"][name] = acc_of(path, dn)
                vres["attacks"]["clean"] = ares
                print(f"[seed {seed}] {victim} x clean: defended "
                      + ", ".join(f"{k} {v['accuracy']:.3f}"
                                  for k, v in ares["defended"].items()),
                      flush=True)
                snapshot()
                continue
            cli_attack, extra = attack_cli_args(
                attack, cw_steps, knn_iter, num_drop)
            t0 = time.time()
            adv_out = os.path.join(vdir, f"{attack}-{victim}.npz")
            if (args.reuse_artifacts and os.path.exists(adv_out)
                    and os.path.exists(adv_out + ".metrics.jsonl")):
                with open(adv_out + ".metrics.jsonl") as f:
                    rate = float(
                        json.loads(f.readlines()[-1])["success_rate"])
                adv_path = adv_out
                print(f"[seed {seed}] reuse attack {adv_out} "
                      f"(success {rate:.3f})", flush=True)
            else:
                adv_path, rate = legs.run(f"attack {attack}", attack_main, [
                    "--attack", cli_attack, "--data", cls_npz,
                    "--checkpoint", ckpt,
                    "--num_points", str(args.num_points),
                    "--batch_size", str(args.batch_size),
                    "--seed", str(seed),
                    "--output", adv_out,
                    # batch-granular shards: a relaunch with
                    # --reuse_artifacts picks up inside the file
                    "--resume",
                    *extra,
                ])
            ares = {"success_rate": rate,
                    "attack_seconds": time.time() - t0}
            # Add-family outputs carry extra points
            n_pts = np.load(adv_path)["test_pc"].shape[1]
            ares["attacked"] = acc_of(adv_path, n_pts)
            ares["defended"] = {}
            for name, path in defended_paths(adv_path).items():
                dn = np.load(path)["test_pc"].shape[1]
                t0 = time.time()
                r = acc_of(path, dn)
                r["eval_seconds"] = time.time() - t0
                ares["defended"][name] = r
            vres["attacks"][attack] = ares
            print(f"[seed {seed}] {victim} x {attack}: "
                  f"success {rate:.3f}, attacked "
                  f"{ares['attacked']['accuracy']:.3f}, defended "
                  + ", ".join(f"{k} {v['accuracy']:.3f}"
                              for k, v in ares["defended"].items()),
                  flush=True)
            snapshot()
        results["victims"][victim] = vres

    with open(os.path.join(sd, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


def aggregate(all_results: list[dict]) -> dict:
    """mean/std of every accuracy cell across seeds."""
    out = {}

    def walk(res):
        cells = {}
        for victim, vres in res["victims"].items():
            cells[f"{victim}/clean"] = vres["clean_accuracy"]
            for attack, ares in vres["attacks"].items():
                base = f"{victim}/{attack}"
                cells[f"{base}/success_rate"] = ares["success_rate"]
                cells[f"{base}/attacked"] = ares["attacked"]["accuracy"]
                for d, r in ares["defended"].items():
                    cells[f"{base}/{d}"] = r["accuracy"]
        return cells

    per_seed = [walk(r) for r in all_results]
    keys = sorted(set().union(*[set(c) for c in per_seed]))
    for k in keys:
        vals = [c[k] for c in per_seed if k in c]
        out[k] = {"mean": float(np.mean(vals)),
                  "std": float(np.std(vals, ddof=1)) if len(vals) > 1
                  else 0.0,
                  "n": len(vals)}
    return out


def write_report(summary: dict, args, path: str):
    """Markdown accuracy matrix: one table per victim, rows = attacks,
    columns = defended-accuracy cells (mean +- std over seeds)."""

    def fmt(key):
        v = summary.get(key)
        if v is None:
            return "—"
        s = f"{100 * v['mean']:.1f}"
        if v["n"] > 1:
            s += f" ± {100 * v['std']:.1f}"
        return s

    defense_keys = []
    for d in args.defenses:
        if d == "convonet_opt" and len(args.opt_modes) > 1:
            defense_keys += [f"convonet_opt:{m}" for m in args.opt_modes]
        elif d == "onet_opt" and len(args.onet_modes) > 1:
            defense_keys += [f"onet_opt:{m}" for m in args.onet_modes]
        else:
            defense_keys.append(d)

    lines = [
        "# Attack x defense accuracy matrix "
        f"({len(args.seeds)} seed(s): {args.seeds})",
        "",
        f"Family: `{args.family}` synthetic "
        f"({args.test_per_class * 8} test clouds/seed, "
        f"{args.num_points} points). Accuracies in %, mean ± std over "
        "seeds. Protocol = the reference's Tables 2-5 "
        "(attack -> defend -> classify through the CLIs).",
        "",
    ]
    for victim in args.victims:
        lines.append(f"## {victim} (clean {fmt(f'{victim}/clean')})")
        lines.append("")
        hdr = ("| attack | success | attacked | "
               + " | ".join(defense_keys) + " |")
        lines.append(hdr)
        lines.append("|" + "---|" * (3 + len(defense_keys)))
        for attack in args.attacks:
            base = f"{victim}/{attack}"
            row = [attack, fmt(f"{base}/success_rate"),
                   fmt(f"{base}/attacked")]
            row += [fmt(f"{base}/{d}") for d in defense_keys]
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None):
    args = parse_args(argv)
    from if_defense_tpu_torch.cli import device_of
    from if_defense_tpu_torch.utils.determinism import CUBLAS_WORKSPACE

    # before any CUDA work: cuBLAS reads it when the process's first handle
    # is made (the victim's training makes it, long before the attacks)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    device_of(args.device)          # exits where no card is and none asked
    os.makedirs(args.out_dir, exist_ok=True)
    all_results = []
    for seed in args.seeds:
        done = os.path.join(args.out_dir, f"seed{seed}", "results.json")
        if args.resume and os.path.exists(done):
            with open(done) as f:
                prior = json.load(f)
            print(f"[seed {seed}] resume: loaded {done}")
            all_results.append(prior)
            continue
        all_results.append(run_seed(args, seed))
    summary = aggregate(all_results)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    write_report(summary, args, os.path.join(args.out_dir, "RESULTS.md"))
    for k, v in summary.items():
        print(f"{k:55s} {v['mean']:.4f} +- {v['std']:.4f} (n={v['n']})")
    return summary


if __name__ == "__main__":
    main()
