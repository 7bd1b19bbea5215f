"""Convert a victim checkpoint of the JAX package (an orbax directory, as
`cli/train.py` and `utils/checkpoint.save_eval_checkpoint` write it) into
the flat npz that the PyTorch port's `cli/inference.py` reads.

    JAX_PLATFORMS=cpu python tools/victim_ckpt_to_npz.py CKPT_DIR OUT.npz

The npz holds the flax variables flattened with '/'-joined keys,
`params/...` and `batch_stats/...`; the metadata sidecar
`CKPT_DIR.meta.json`, which names the model (and, for a train checkpoint,
its epoch), is copied to `OUT.npz.meta.json`. A train checkpoint's
optimiser state (optax's Adam count and moments) and step go to the port's
optimiser sidecar `OUT.npz.opt.npz`, so that the port's `cli/train.py
--resume OUT.npz` continues the JAX run. Needs JAX and orbax (the port
itself needs neither).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def adam_state(opt_state) -> dict:
    """optax's `ScaleByAdamState` (count, mu, nu) out of a train state's
    optimiser state as orbax restores it without a template: the chain
    `add_decayed_weights` -> `scale_by_adam` -> `scale_by_learning_rate`
    gives [None, {"count", "mu", "nu"}, {"count"}]."""
    found = [p for p in opt_state if isinstance(p, dict)
             and {"count", "mu", "nu"} <= set(p)]
    if len(found) != 1:
        raise ValueError("no single Adam state (count, mu, nu) in the "
                         "checkpoint's optimiser state")
    return {k: found[0][k] for k in ("count", "mu", "nu")}


def convert(ckpt: str, out: str) -> str:
    """CKPT (orbax directory) -> OUT npz (+ sidecars); returns OUT's path."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from if_defense_tpu.utils.checkpoint import restore_checkpoint_raw
    from if_defense_tpu_torch.utils.checkpoint import (
        OPT_SUFFIX,
        save_eval_checkpoint,
    )
    from if_defense_tpu_torch.utils.params_io import save_params_npz

    raw = restore_checkpoint_raw(ckpt)
    variables = {"params": raw["params"]}
    if raw.get("batch_stats") is not None:
        variables["batch_stats"] = raw["batch_stats"]
    path = save_eval_checkpoint(out, variables)
    meta = os.path.abspath(ckpt) + ".meta.json"
    if os.path.exists(meta):
        shutil.copyfile(meta, path + ".meta.json")
    if raw.get("opt_state") is not None:
        save_params_npz(path + OPT_SUFFIX, {
            "opt_state": adam_state(raw["opt_state"]),
            "step": np.asarray(int(raw["step"]), np.int64)})
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="orbax checkpoint directory")
    ap.add_argument("out", help="npz to write")
    args = ap.parse_args(argv)
    print(convert(args.checkpoint, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
