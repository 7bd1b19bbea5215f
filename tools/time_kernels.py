"""Time the port's kernels B1, B2, B5 and B6 on one CUDA card in this tree
and in another checkout of the port, in turns (other, this, this, other),
so that two versions are compared on one card in one call.

    python tools/time_kernels.py OTHER_TREE

Each turn is a subprocess that imports the port from its own tree (the two
packages never share an import) and reads, with `chip_smoke.py`'s
`device_ms` (torch.profiler over 20 calls of the wrapper alone, the self
device time of the kernels named), the device ms per call of:
- B1 forward + backward (f32) and B2 (f32 and bf16) at B=48, N=1024, on
  `chip_smoke.py` phase 2's random points;
- B5 and B6 (unmasked) at PU-Net's four set-abstraction levels of one
  batch of 128 of `chip_smoke.py` phase 7's clouds, and their sums;
- B6 at the victims' shapes (`chip_smoke.py` `victim_level_inputs`: 32 of
  those clouds normalised to the unit sphere, PointNet++ and RS-CNN
  set-abstraction levels 1 and 2), each on its own line and in no sum.
Prints one line per reading with the four turns' values, and the SM clock
that nvidia-smi read during each turn. The card's name and power limit come
first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("other", "this", "this", "other")


def smoke():
    """This tree's `chip_smoke.py` as a module (its helpers import the port
    lazily, so they take whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def readings(tree: str) -> dict:
    """{reading: device ms per call} for the port in `tree`, and the SM
    clock under the key "clock"."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from if_defense_tpu_torch.ops import cuda_repulsion as cr
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    cs = smoke()
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    pts = gen.uniform(-0.45, 0.45, (cs.B, cs.N, 3)).astype(np.float32)
    pts[:, cs.N - 24:] = pts[:, :24]
    pts = torch.from_numpy(pts).to(dev)
    w = torch.from_numpy(gen.uniform(0.5, 1.5, cs.B).astype(np.float32)).to(dev)
    clouds = cs.ellipsoids(np.random.default_rng(7), cs.DUP_CLOUDS)
    levels = cs.sa_level_inputs(dev, clouds[:cs.DUP_B])
    calls = {"B1 f32": (lambda: cs.bare_grad(cr.repulsion_loss_cuda, pts, w),
                        ("rep_fwd", "rows_to_loss", "rep_bwd"))}
    for dt in (torch.float32, torch.bfloat16):
        x = pts.to(dt)
        calls[f"B2 {str(dt).split('.')[-1]}"] = (
            lambda x=x: cr.repulsion_mask_cuda(x), ("rep_mask",))
    for i, (xyz, new, radius) in enumerate(levels):
        s = new.shape[1]
        calls[f"B5 level {i}"] = (lambda xyz=xyz, s=s: fps_cuda(xyz, s),
                                  ("fps_kernel", "fps_kernel_global"))
        calls[f"B6 level {i}"] = (
            lambda xyz=xyz, new=new, r=radius: ballquery_cuda(r, 32, xyz, new),
            ("ballquery_kernel",))
    for name, xyz, new, radius, ns in cs.victim_level_inputs(dev, clouds):
        calls[f"B6 {name}"] = (
            lambda xyz=xyz, new=new, r=radius, ns=ns: ballquery_cuda(
                r, ns, xyz, new), ("ballquery_kernel",))
    out = {}
    with cs.SmClock() as clock:
        for name, (fn, names) in calls.items():
            got = cs.device_ms(fn, names)
            out[name] = got[0] if got else cs.graph_ms(fn)
    for k in ("B5", "B6"):
        out[f"{k} sum"] = sum(v for n, v in out.items()
                              if n.startswith(f"{k} level"))
    out["clock"] = clock.text()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of another checkout of the port")
    ap.add_argument("--dump", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        with open(args.dump[1], "w") as f:
            json.dump(readings(args.dump[0]), f)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; turns: {', '.join(TURNS)} (other = {args.other})")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tag in enumerate(TURNS):
            tree = HERE if tag == "this" else args.other
            out = os.path.join(tmp, f"{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.other, "--dump", tree, out], check=True)
            with open(out) as f:
                runs.append(json.load(f))
    for name in runs[0]:
        vals = [r[name] for r in runs]
        text = ", ".join(v if isinstance(v, str) else f"{v:.4f}" for v in vals)
        print(f"{name}: {text}" if name == "clock" else
              f"{name} ms (device, per call): {text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
