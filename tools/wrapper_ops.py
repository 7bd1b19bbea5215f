#!/usr/bin/env python3
"""Device operations and device time a call of the gather-backward,
pooled-max and scatter-mean wrappers of one checkout, on one card.

    python3 tools/wrapper_ops.py TREE

TREE is the root of a checkout of the repo (this one, or a parent commit
unpacked with `git archive`); its `if_defense_tpu_torch` is imported, and
this checkout's `chip_smoke.device_ms` (torch.profiler over 20 calls)
counts what each wrapper launches a call, on fixed seeded inputs: the
gather's backward at DGCNN's second EdgeConv block (`gather_backward_cuda`,
[32, 20480, 64] into 1024 points) and the encoder's pooled max, forward
and backward (`pooled_max_by_cell` with `chip_smoke.bare_grad`, [48, 600,
32] into a 64^2 plane's cells) and the encoder's scatter-mean into the
grid's 32^3 cells (`scatter_mean_cuda`, [48, 600, 32]). Each wrapper
builds its own sort or CSR, as its first call on an index does. Prints one
line a wrapper; run it once a tree, in turns (parent, change, change,
parent), to compare checkouts. Needs a card.
"""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import if_defense_tpu_torch
    from if_defense_tpu_torch.ops import cuda_gather, cuda_scatter
    from if_defense_tpu_torch.ops.scatter import pooled_max_by_cell

    if not if_defense_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {if_defense_tpu_torch.__file__}, not "
                         f"the package under {tree}")
    d = torch.device("cuda", 0)
    gen = torch.Generator(device=d).manual_seed(0)
    g = torch.randn((32, 20480, 64), generator=gen, device=d)
    idx = torch.randint(0, 1024, (32, 20480), generator=gen, device=d)
    f = torch.randn((48, 600, 32), generator=gen, device=d)
    gf = torch.randn((48, 600, 32), generator=gen, device=d)
    cells = torch.randint(0, 4096, (48, 600), generator=gen, device=d)
    grid = torch.randint(0, 32**3, (48, 600), generator=gen, device=d)
    for name, fn in (
            ("gather backward [32, 20480, 64] into 1024",
             lambda: cuda_gather.gather_backward_cuda(g, idx, 1024)),
            ("pooled max fwd+bwd [48, 600, 32] into 4096",
             lambda: cs.bare_grad(pooled_max_by_cell, f, gf, cells, 4096)),
            ("scatter-mean [48, 600, 32] into 32^3",
             lambda: cuda_scatter.scatter_mean_cuda(f, grid, 32**3))):
        ms, ours, _, ops = cs.device_ms(fn)
        print(f"{tree}: {name}: {ops} device operations a call, device "
              f"{ms:.4f} ms ({ {k: round(v, 4) for k, v in ours.items()} })",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ROOT)
