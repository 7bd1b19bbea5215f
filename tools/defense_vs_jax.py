#!/usr/bin/env python3
"""ConvONet-Opt of the port against the JAX package's on one whole batch
of the accuracy protocol, on the CPU, and both scored by one victim.

    python tools/defense_vs_jax.py --out_dir runs/defense_vs_jax

Makes the hard synthetic family (`tools/synthetic_dataset.py`, numpy
only; `--clouds` test clouds, 40 = one protocol batch), trains a ConvONet
with the port's `cli/train_implicit.py` at the protocol's flags (batch 16,
`--occ_steps` steps: a few hundred do on the CPU, since the comparison is
between the two packages on the same weights) and a PointNet victim with
the port's `cli/train.py`. Then both packages restore the batch with the
flags the accuracy tool passes to `cli/opt_defense.py` in its f32 mode
(reference mode, 200 iterations, SOR, 600 encoder points, 1024 initial
points): JAX's `convonet_opt_defense` with its exact fused repulsion
selection (IFDEF_FORCE_FUSED_REPULSION=1, interpret mode on the CPU),
which is what the port computes on the CPU, and the port's with JAX's
draws of the encoder subset and initial points (`jax_draws`). The JAX
package runs in a thread beside the port.

Reports, and writes to `<out_dir>/defense_vs_jax.json`: the coordinates
within 1e-4 (chip_smoke's gate) and the largest and mean gaps, the
symmetric Chamfer distance between the two restorations beside the
clouds' point spacing, and, scored by the one victim (the port's
`cli/inference.py` on the CPU), each restoration's accuracy, their gap,
and the share of clouds the victim gives the same label. A second JAX
run, on the same clouds with half their coordinates moved by one unit
in the last place (`nudged`), measures how far f32 rounding alone moves
the 201 Adam steps.

This tool imports both packages; the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from if_defense_tpu.defense.ifdefense import (  # noqa: E402
    convonet_opt_defense as jax_defense,
)
from if_defense_tpu.defense.ifdefense import (  # noqa: E402
    sample_valid as jax_sample_valid,
)
from if_defense_tpu.defense.sor import sor_defense as jax_sor  # noqa: E402
from if_defense_tpu.implicit import (  # noqa: E402
    ConvOccupancyNetwork as JaxConvONet,
)
from if_defense_tpu.ops import normalize_unit_cube as jax_cube  # noqa: E402

# cli/opt_defense.py's defaults, as the accuracy tool's f32 mode runs it
FLAGS = dict(iterations=200, input_npoint=600, sample_npoint=1024,
             padding_scale=0.9, init_sigma=0.01, lr=1e-3, rep_weight=500.0,
             threshold=0.2, sor=True, sor_k=2, sor_alpha=1.1)
NEAR = 1e-4                       # chip_smoke's restoration gate: 99.9 %
TRAIN_THREADS = 4                 # the port's defense runs in one


@functools.partial(jax.jit, static_argnames=("flags",))
def _draws(pc, key, flags):
    f = dict(flags)
    pc, mask = jax_sor(pc, f["sor_k"], f["sor_alpha"])
    proc = jax_cube(pc, f["padding_scale"], mask)
    k_enc, k_init, k_noise = jax.random.split(key, 3)
    sel = jax_sample_valid(proc, mask, f["input_npoint"], k_enc)
    pts = jax_sample_valid(proc, mask, f["sample_npoint"], k_init)
    noise = jax.random.normal(k_noise, pts.shape) * f["init_sigma"]
    lim = 0.5 * f["padding_scale"]
    return sel, jnp.clip(pts + noise, -lim, lim)


def jax_draws(pc: np.ndarray, key, flags: dict = FLAGS):
    """The encoder subset and the initial points as JAX's `defend` draws
    them (`if_defense_tpu/defense/ifdefense.py:144-171`), as torch
    tensors for the port's `draws` seam."""
    return tuple(torch.from_numpy(np.array(a)) for a in _draws(
        jnp.asarray(pc), key, tuple(sorted(flags.items()))))


def restore_jax(pc: np.ndarray, variables: dict, key,
                flags: dict = FLAGS) -> np.ndarray:
    """JAX's ConvONet-Opt of `pc` [B, N, 3] from flax `variables`."""
    return np.asarray(jax_defense(JaxConvONet(), variables, **flags)(
        jnp.asarray(pc), key))


def restore_port(pc: np.ndarray, variables: dict, draws,
                 flags: dict = FLAGS, stats: dict | None = None
                 ) -> np.ndarray:
    """The port's ConvONet-Opt of `pc` on the CPU from the same weights,
    given JAX's `draws`."""
    from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    model = ConvOccupancyNetwork()
    model.load_state_dict(params_from_jax(variables, model))
    return convonet_opt_defense(model.eval(), **flags)(
        torch.from_numpy(pc), draws=draws, stats=stats).numpy()


def nudged(pc: np.ndarray, seed: int = 5) -> np.ndarray:
    """`pc` with half of its coordinates, drawn from `seed`, moved up by
    one unit in the last place: the least change of the input."""
    pick = np.random.default_rng(seed).random(pc.shape) < 0.5
    return np.where(pick, np.nextafter(pc, np.float32(np.inf)),
                    pc).astype(np.float32)


def in_thread(fn, *args):
    """Start `fn(*args)` in a thread; -> a call that joins it and returns
    its result (or raises its error)."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:       # re-raised in the caller
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return join


def gaps(a: np.ndarray, b: np.ndarray) -> dict:
    """Coordinate gaps and the symmetric Chamfer distance of two
    restorations [B, N, 3] (mean nearest distance each way, halved)."""
    e = np.abs(a - b)
    d = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
    chamfer = 0.5 * (np.sqrt(d.min(2)).mean() + np.sqrt(d.min(1)).mean())
    return {"within_1e-4": float((e <= NEAR).mean()), "max": float(e.max()),
            "mean": float(e.mean()), "chamfer": float(chamfer)}


def spacing(a: np.ndarray) -> float:
    """Mean nearest-neighbour distance within each restored cloud."""
    d = ((a[:, :, None] - a[:, None]) ** 2).sum(-1)
    d[:, np.arange(a.shape[1]), np.arange(a.shape[1])] = np.inf
    return float(np.sqrt(d.min(2)).mean())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out_dir",
                   default=os.path.join(ROOT, "runs", "defense_vs_jax"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clouds", type=int, default=40,
                   help="test clouds, 5 a class of 8 by default")
    p.add_argument("--train_per_class", type=int, default=40)
    p.add_argument("--occ_per_class", type=int, default=20)
    p.add_argument("--occ_steps", type=int, default=300)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--reuse", action="store_true",
                   help="keep the data, weights and victim that an earlier "
                        "run left in --out_dir")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from if_defense_tpu_torch.cli.inference import load_eval_model
    from if_defense_tpu_torch.cli.inference import main as inf_main
    from if_defense_tpu_torch.cli.train import main as train_main
    from if_defense_tpu_torch.cli.train_implicit import main as timpl_main
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.training import make_eval_step
    from if_defense_tpu_torch.utils.params_io import load_params_npz
    from tools.synthetic_dataset import HARD_CLASSES
    from tools.synthetic_dataset import main as make_data

    args = parse_args(argv)
    # the CPU, and JAX's fused repulsion kernel (interpret mode) on it
    jax.config.update("jax_platforms", "cpu")
    os.environ["IFDEF_FORCE_FUSED_REPULSION"] = "1"
    torch.set_num_threads(TRAIN_THREADS)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    per_class = -(-args.clouds // len(HARD_CLASSES))
    cls_npz, occ_npz = make_data([
        "--out_dir", args.out_dir, "--family", "hard",
        "--train_per_class", str(args.train_per_class),
        "--test_per_class", str(per_class),
        "--occ_per_class", str(args.occ_per_class),
        "--num_points", "1024", "--seed", str(args.seed)])
    weights = os.path.join(args.out_dir, "convonet_w.npz")
    vdir = os.path.join(args.out_dir, "pointnet")
    ckpt = os.path.join(vdir, "best.npz")
    reuse = args.reuse and os.path.exists(weights) and os.path.exists(ckpt)
    if not reuse:
        weights = timpl_main([
            "--variant", "convonet", "--data", occ_npz, "--steps",
            str(args.occ_steps), "--batch_size", "16", "--log_every",
            str(max(args.occ_steps // 5, 1)), "--save_every",
            str(args.occ_steps), "--seed", str(args.seed), "--output",
            weights.removesuffix(".npz"), "--device", "cpu"])
        train_main(["--data", cls_npz, "--model", "pointnet",
                    "--num_points", "1024", "--epochs", str(args.epochs),
                    "--batch_size", "32", "--eval_every",
                    str(max(args.epochs // 3, 1)), "--output",
                    vdir, "--seed", str(args.seed), "--registry",
                    os.path.join(args.out_dir, "registry.json"), "--device",
                    "cpu"])
    trained = time.time() - t0

    with np.load(cls_npz) as z:
        pc6 = z["test_pc"][:args.clouds]
        label = z["test_label"][:args.clouds]
        target = z["target_label"][:args.clouds]
    pc = np.ascontiguousarray(pc6[..., :3])
    variables = load_params_npz(weights)
    key = jax.random.key(args.seed)
    t1 = time.time()
    jobs = {"jax": in_thread(restore_jax, pc, variables, key),
            "jax, one ulp": in_thread(restore_jax, nudged(pc), variables,
                                      key)}
    stats = {}
    torch.set_num_threads(1)          # as the CPU parity tests run the port
    port = restore_port(pc, variables, jax_draws(pc, key), stats=stats)
    out = {name: job() for name, job in jobs.items()}
    defended = time.time() - t1
    np.savez(os.path.join(args.out_dir, "restored.npz"), port=port,
             **{k.replace(", ", "_"): v for k, v in out.items()})

    model, _ = load_eval_model(ckpt)
    eval_step = make_eval_step(model, ["cpu"])
    report = {"clouds": args.clouds, "occ_steps": args.occ_steps,
              "flags": FLAGS, "seconds": {"training": trained,
                                          "defenses": defended},
              "occ_loss": {k: float(v) for k, v in stats.items()},
              "spacing": spacing(port)}
    labels = {}
    for name, clouds in (("port", port), *out.items()):
        path = os.path.join(args.out_dir, f"defended_{name.split(',')[0]}"
                            f"{'_ulp' if ',' in name else ''}.npz")
        save_npz(path, {"test_pc": clouds.astype(np.float32),
                        "test_label": label, "target_label": target})
        scored = inf_main(["--data", path, "--checkpoint", ckpt,
                           "--num_points", "1024", "--batch_size", "40",
                           "--mode", "target", "--device", "cpu"])
        labels[name] = eval_step(torch.from_numpy(
            clouds.astype(np.float32))).argmax(-1).numpy()
        mine = float((labels[name] == label).mean())
        if abs(mine - scored["accuracy"]) > 1e-9:
            raise SystemExit(f"{name}: the victim's labels give accuracy "
                             f"{mine}, cli/inference.py {scored['accuracy']}")
        report[f"accuracy {name}"] = scored["accuracy"]
    for pair, a, b in (("port vs jax", "port", "jax"),
                       ("jax vs jax, one ulp", "jax, one ulp", "jax")):
        clouds = out | {"port": port}
        report[pair] = gaps(clouds[a], clouds[b]) | {
            "same label": float((labels[a] == labels[b]).mean()),
            "accuracy gap": report[f"accuracy {a}"]
            - report[f"accuracy {b}"]}
    with open(os.path.join(args.out_dir, "defense_vs_jax.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
