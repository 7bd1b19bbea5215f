#!/usr/bin/env python3
"""The port's accuracy table against the JAX package's, cell by cell.

    python3 tools/accuracy_vs_jax.py OUT_DIR [--jax RESULTS_DISCRIM.summary.json]

Reads every `OUT_DIR/seed<k>/results.json` that
`tools/accuracy_benchmark_torch.py` wrote, aggregates them as that tool
does, and prints a markdown table of every cell (accuracy in %, mean ±
std over the seeds) beside the JAX tool's 3-seed mean ± std. A cell is in
band when |port - JAX mean| <= 2 JAX std + 2 points. Then the checks of
the protocol: the kNN row's order none < SRS < SOR <= ConvONet-Opt (each
mode), bf16_r16 within 2 points of f32 on the kNN and clean rows; then
each seed's legs (`legs.json`): seconds by kind of CLI call, and the
TF32 settings they ran with. Needs no card.

    python3 tools/accuracy_vs_jax.py ARM_C --paired ARM_A

prints instead, for each seed and cell that both runs hold, this run
minus ARM_A's in points beside each run's band verdict (a seed's value
against JAX's band), as `tools/c3_arms.py` runs it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND_POINTS = 2.0
ORDER = ("none", "srs", "sor")
OPT = ("convonet_opt:f32", "convonet_opt:bf16_r16")
BARE_OPT_MODE = "f32"       # tools/c3_arms.py runs --opt_modes f32 alone


def aggregate(all_results: list[dict]) -> dict:
    """The port tool's `aggregate` (mean/std of every cell over seeds). A
    run with one `--opt_modes` keys its ConvONet-Opt cells `convonet_opt`
    alone; they are read as that mode's, `BARE_OPT_MODE` (f32)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from accuracy_benchmark_torch import aggregate as agg

    return {(f"{k}:{BARE_OPT_MODE}" if k.endswith("/convonet_opt") else k): v
            for k, v in agg(all_results).items()}


def in_band(port: float, jax: dict) -> tuple[bool, float]:
    """(in band, the band's half-width in points)."""
    band = 2 * 100 * jax["std"] + BAND_POINTS
    return abs(100 * port - 100 * jax["mean"]) <= band, band


def fmt(v: dict | None) -> str:
    if v is None:
        return "—"
    s = f"{100 * v['mean']:.1f}"
    return s + (f" ± {100 * v['std']:.1f}" if v["n"] > 1 else "")


def table(port: dict, jax: dict, victim: str) -> tuple[list[str], list]:
    """Markdown rows of one victim's cells; the cells out of band."""
    attacks = sorted({k.split("/")[1] for k in port
                      if k.startswith(victim + "/") and k.count("/") >= 2},
                     key=lambda a: ("clean", "knn", "drop", "perturb").index(a)
                     if a in ("clean", "knn", "drop", "perturb") else 9)
    cols = ["success_rate", "attacked", "none", "srs", "sor", "dup", *OPT]
    cols = [c for c in cols if any(f"{victim}/{a}/{c}" in port
                                   for a in attacks)]
    rows = ["| attack | " + " | ".join(cols) + " |",
            "|" + "---|" * (len(cols) + 1)]
    out = []
    for a in attacks:
        cells = []
        for c in cols:
            key = f"{victim}/{a}/{c}"
            p, j = port.get(key), jax.get(key)
            if p is None:
                cells.append("—")
                continue
            if j is None:
                cells.append(f"{fmt(p)} (JAX —)")
                continue
            ok, band = in_band(p["mean"], j)
            if not ok:
                out.append((key, p["mean"], j["mean"], band))
            cells.append(f"{fmt(p)} / {fmt(j)} {'in' if ok else '**OUT**'}")
        rows.append(f"| {a} | " + " | ".join(cells) + " |")
    return rows, out


def checks(port: dict, victim: str) -> list[str]:
    lines = []
    opts = [o for o in OPT if f"{victim}/knn/{o}" in port]
    knn = {d: port.get(f"{victim}/knn/{d}") for d in (*ORDER, *opts)}
    if opts and all(v is not None for v in knn.values()):
        m = {d: v["mean"] for d, v in knn.items()}
        order = (m["none"] < m["srs"] < m["sor"]
                 and all(m["sor"] <= m[o] for o in opts))
        lines.append(f"- kNN order none < SRS < SOR <= ConvONet-Opt: "
                     f"{'holds' if order else '**broken**'} ("
                     + ", ".join(f"{d} {100 * v:.2f}" for d, v in m.items())
                     + ")")
    for a in ("knn", "clean"):
        f32, bf = (port.get(f"{victim}/{a}/{o}") for o in OPT)
        if f32 and bf:
            gap = 100 * (f32["mean"] - bf["mean"])
            lines.append(f"- {a}: bf16_r16 {'within' if gap <= 2 else '**more than**'}"
                         f" 2 points below f32 (f32 - bf16_r16 = {gap:.2f})")
    return lines


def leg_kind(leg: str) -> str:
    """A leg's kind: the CLI and what it trains, runs or applies (a
    defense's or a score's calls summed over the files)."""
    words = leg.split()
    return " ".join(words[:1] if words[0] == "score" else words[:2])


def legs(out_dir: str) -> list[str]:
    """Seconds by kind of leg, a column a seed, and the TF32 settings the
    legs ran with."""
    seeds = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "seed*", "legs.json"))):
        with open(path) as f:
            seeds[os.path.basename(os.path.dirname(path))] = json.load(f)
    if not seeds:
        return []
    kinds = list(dict.fromkeys(leg_kind(r["leg"]) for rows in seeds.values()
                               for r in rows))
    lines = ["| leg | " + " | ".join(f"{s} s" for s in seeds) + " |",
             "|" + "---|" * (len(seeds) + 1)]
    for kind in kinds + ["all"]:
        cells = []
        for rows in seeds.values():
            got = [r["seconds"] for r in rows
                   if kind == "all" or leg_kind(r["leg"]) == kind]
            cells.append(f"{sum(got):.1f}" if got else "—")
        lines.append(f"| {kind} | " + " | ".join(cells) + " |")
    tf32 = sorted({(r["tf32_matmul"], r["tf32_cudnn"])
                   for rows in seeds.values() for r in rows})
    devices = sorted({r["device"] for rows in seeds.values() for r in rows})
    return lines + ["", f"TF32 (matmul, cuDNN) as the legs ran: {tf32}; "
                    f"devices {devices}; CLI calls "
                    f"{ {s: len(rows) for s, rows in seeds.items()} }."]


def seed_cells(out_dir: str) -> dict:
    """seed -> {cell: accuracy} of every `seed<k>/results.json` there."""
    out = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "seed*",
                                              "results.json"))):
        with open(path) as f:
            res = json.load(f)
        out[res["seed"]] = {k: v["mean"] for k, v in aggregate([res]).items()}
    return out


def paired(out_c: str, out_a: str, jax: dict) -> list[str]:
    """A row a seed and defended-accuracy cell held by both runs: each
    run's accuracy and band verdict, and C - A in points."""
    runs_c, runs_a = seed_cells(out_c), seed_cells(out_a)
    lines = [f"Paired: {out_c} (C) minus {out_a} (A), accuracy %, each "
             f"seed's value against JAX's band.", "",
             "| seed | cell | A | A band | C | C band | C - A |",
             "|---|---|---|---|---|---|---|"]
    for seed in sorted(set(runs_c) & set(runs_a)):
        c, a = runs_c[seed], runs_a[seed]
        for key in sorted(set(c) & set(a)):
            if key.count("/") < 2 or key.endswith("/success_rate") \
                    or key not in jax:
                continue
            verdicts = ["in" if in_band(v, jax[key])[0] else "**OUT**"
                        for v in (a[key], c[key])]
            lines.append(f"| {seed} | {key} | {100 * a[key]:.2f} | "
                         f"{verdicts[0]} | {100 * c[key]:.2f} | "
                         f"{verdicts[1]} | {100 * (c[key] - a[key]):+.2f} |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--jax", default=os.path.join(
        ROOT, "RESULTS_DISCRIM.summary.json"))
    ap.add_argument("--paired", metavar="ARM_A", default=None,
                    help="print out_dir minus ARM_A a seed and cell")
    args = ap.parse_args(argv)
    if args.paired:
        with open(args.jax) as f:
            print("\n".join(paired(args.out_dir, args.paired, json.load(f))))
        return 0
    runs = []
    for path in sorted(glob.glob(os.path.join(args.out_dir, "seed*",
                                              "results.json"))):
        with open(path) as f:
            runs.append(json.load(f))
    if not runs:
        raise SystemExit(f"no seed*/results.json under {args.out_dir}")
    port = aggregate(runs)
    with open(args.jax) as f:
        jax = json.load(f)
    victims = sorted({k.split("/")[0] for k in port})
    lines = [f"Seeds: {[r['seed'] for r in runs]}. Each cell: port / JAX "
             f"(accuracy %, mean ± std over seeds), in band when |port - "
             f"JAX mean| <= 2 JAX std + {BAND_POINTS:g} points.", ""]
    outside = []
    for victim in victims:
        lines.append(f"### {victim} (clean: port {fmt(port.get(victim + '/clean'))}"
                     f", JAX {fmt(jax.get(victim + '/clean'))})")
        lines.append("")
        rows, out = table(port, jax, victim)
        lines += rows + [""] + checks(port, victim) + [""]
        outside += out
    lines.append(f"Cells out of band: {len(outside)}"
                 + "".join(f"\n- {k}: port {100 * p:.2f}, JAX {100 * j:.2f} "
                           f"(band ± {b:.2f})" for k, p, j, b in outside))
    lines.append("")
    lines += legs(args.out_dir)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
