"""Merge sharded attack npz files into one (port of
`if_defense_tpu/cli/merge_results.py`).

The reference's DDP attack scripts write one npz per rank, merged by
`baselines/util/merge_attack_results.py:7-51`; the attack CLI writes one
npz and a metrics JSONL, so this tool serves shards made elsewhere: it
concatenates every array key across the inputs and aggregates their
`.metrics.jsonl` sidecars (success rate weighted by each shard's n).

Usage:
    python -m if_defense_tpu_torch.cli.merge_results shard0.npz \\
        shard1.npz --out merged.npz [--delete]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from if_defense_tpu_torch.data import save_npz


def merge_npz(paths: list[str], out: str) -> str:
    arrays: dict[str, list[np.ndarray]] = {}
    for p in paths:
        with np.load(p) as npz:
            for k in npz.files:
                arrays.setdefault(k, []).append(npz[k])
    save_npz(out, {k: np.concatenate(v, 0) for k, v in arrays.items()})
    return out


def merge_metrics(paths: list[str], out: str):
    records = []
    for p in paths:
        side = p + ".metrics.jsonl"
        if os.path.exists(side):
            with open(side) as f:
                records += [json.loads(line) for line in f if line.strip()]
    if not records:
        return None
    n = sum(r.get("n", 0) for r in records)
    succ = sum(r.get("success_rate", 0) * r.get("n", 0) for r in records)
    agg = {"n": n, "success_rate": succ / max(n, 1), "shards": len(paths)}
    with open(out + ".metrics.jsonl", "w") as f:
        f.write(json.dumps(agg) + "\n")
    return agg


def main(argv=None):
    p = argparse.ArgumentParser(description="Merge sharded attack npz files")
    p.add_argument("shards", nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--delete", action="store_true",
                   help="remove shard files after merging")
    args = p.parse_args(argv)
    merge_npz(args.shards, args.out)
    agg = merge_metrics(args.shards, args.out)
    if args.delete:
        for s in args.shards:
            os.remove(s)
            side = s + ".metrics.jsonl"
            if os.path.exists(side):
                os.remove(side)
    print(f"merged {len(args.shards)} shards -> {args.out}"
          + (f" ({agg})" if agg else ""))
    return args.out


if __name__ == "__main__":
    main()
