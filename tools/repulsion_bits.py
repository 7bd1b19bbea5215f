"""Compare the repulsion kernels' results (B1-B3) bit for bit between this
tree and another checkout of the port, on one CUDA card.

    python tools/repulsion_bits.py OTHER_TREE [--n 1024 3000 4096]

For each N, f32 and bf16 and k in {1, 4, 8}, each tree computes on its own
(a subprocess each, so the two packages never share an import) B1's loss
and gradient, B2's mask and B3's loss and gradient on clouds drawn from a
seed with half their points repeated. Prints one line per case with the
outputs that differ, and exits 1 if any does.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("loss", "grad", "mask", "masked_loss", "masked_grad")


def dump(tree: str, out: str, sizes: list[int]) -> None:
    """Every case's outputs from the port in `tree`, saved to `out`."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from if_defense_tpu_torch.ops import cuda_repulsion as cr

    res = {}
    w = torch.arange(1, 5, device="cuda", dtype=torch.float32)
    for n in sizes:
        pc = np.random.default_rng(n).uniform(-0.4, 0.4, (4, n, 3))
        pc = pc.astype(np.float32)
        pc[:, n // 2:] = pc[:, : n - n // 2]
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(pc).cuda().to(dt)
            for k in (1, 4, 8):
                xx = x.clone().requires_grad_(True)
                loss = cr.repulsion_loss_cuda(xx, k)
                (g,) = torch.autograd.grad((loss * w).sum(), xx)
                mask = cr.repulsion_mask_cuda(x, k)
                xx = x.clone().requires_grad_(True)
                lm = cr.repulsion_loss_masked_cuda(xx, mask, k)
                (gm,) = torch.autograd.grad((lm * w).sum(), xx)
                res[(n, str(dt).split(".")[-1], k)] = [
                    t.detach().cpu() for t in (loss, g, mask, lm, gm)]
    torch.save(res, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of another checkout of the port")
    ap.add_argument("--n", type=int, nargs="+", default=[1024, 3000, 4096])
    ap.add_argument("--dump", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        dump(*args.dump, args.n)
        return 0
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        res = {}
        for tag, tree in (("this", HERE), ("other", args.other)):
            out = os.path.join(tmp, tag + ".pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.other, "--n", *map(str, args.n),
                            "--dump", tree, out], check=True)
            res[tag] = torch.load(out)
    bad = 0
    for case, ours in res["this"].items():
        differ = [name for name, a, b in zip(NAMES, ours, res["other"][case])
                  if not torch.equal(a, b)]
        bad += bool(differ)
        print(f"N={case[0]} {case[1]} k={case[2]}: "
              + (f"differ: {', '.join(differ)}" if differ else "bit-equal"))
    print(f"{len(res['this']) - bad} of {len(res['this'])} cases bit-equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
