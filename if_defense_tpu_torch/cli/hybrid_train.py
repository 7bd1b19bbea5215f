"""Hybrid training CLI (clean + defended data), `baselines/hybrid_train.py`
(port of `if_defense_tpu/cli/hybrid_train.py`).

Thin entry point over `cli.train`: hybrid training is the same loop with
the concatenated ModelNet40Hybrid dataset and a second (defended-subset)
eval, the best checkpoint picked by defended accuracy — `--def_data` is
simply mandatory here. It runs under `cli.train`'s deterministic
algorithms, so two runs from one `--seed` write the same bytes.

Usage:
    python -m if_defense_tpu_torch.cli.hybrid_train --data mn40.npz \\
        --def_data ConvONet-Opt/convonet_opt-mn40.npz --model pointnet
"""

from __future__ import annotations

from if_defense_tpu_torch.cli.train import main as train_main, parse_args


def main(argv=None, devices=None):
    """`cli.train.main` with `--def_data` required; `devices` as there."""
    args = parse_args(argv)
    if not args.def_data:
        raise SystemExit("hybrid training requires --def_data")
    return train_main(argv, devices)


if __name__ == "__main__":
    main()
