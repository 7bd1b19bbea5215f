"""Convert a victim checkpoint of the JAX package (an orbax directory, as
`cli/train.py` and `utils/checkpoint.save_eval_checkpoint` write it) into
the flat npz that the PyTorch port's `cli/inference.py` reads.

    JAX_PLATFORMS=cpu python tools/victim_ckpt_to_npz.py CKPT_DIR OUT.npz

The npz holds the flax variables flattened with '/'-joined keys,
`params/...` and `batch_stats/...` (optimizer state and step are dropped);
the metadata sidecar `CKPT_DIR.meta.json`, which names the model, is copied
to `OUT.npz.meta.json`. Needs JAX and orbax (the port itself needs
neither).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def convert(ckpt: str, out: str) -> str:
    """CKPT (orbax directory) -> OUT npz (+ sidecar); returns OUT's path."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from if_defense_tpu.utils.checkpoint import restore_checkpoint_raw
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint

    raw = restore_checkpoint_raw(ckpt)
    variables = {"params": raw["params"]}
    if raw.get("batch_stats") is not None:
        variables["batch_stats"] = raw["batch_stats"]
    path = save_eval_checkpoint(out, variables)
    meta = os.path.abspath(ckpt) + ".meta.json"
    if os.path.exists(meta):
        shutil.copyfile(meta, path + ".meta.json")
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
