#!/usr/bin/env python3
"""The accuracy protocol's kNN attack, the port against the JAX package, on
the CPU.

    JAX_PLATFORMS=cpu python tools/knn_attack_vs_jax.py \\
        --out_dir runs/knn_vs_jax

The victim is a full-width PointNet (40 outputs, as the protocol trains
it) trained by the JAX package's own train step (`training.
create_train_state` and `make_train_step`: Adam 1e-3, L2 decay 1e-4, the
cosine schedule) on the hard synthetic family (`tools/synthetic_dataset.
py`, 8 classes, 1,024 points) for up to `--epochs` epochs, stopping at the
first whose clean test accuracy reaches `--target_acc` (printed; `--epochs
0` leaves JAX's initial weights), then carried into the port with
`params_from_jax`. The attacked clouds are `--clouds` test clouds, one a
class in turn, with the family's analytic normals and pair-partner targets
(label xor 1). Both packages run `cw_knn` with the protocol's flags
(`cli/attack.py`'s kNN attack): `--iters` (2,500) iterations, lr 1e-3,
kappa 15, budget 0.1, `chamfer_knn_dist`; JAX's initial noise
(`jax.random.normal(key, shape)`) goes to the port through its `draws`
seam. The port runs in one torch thread a run.

The yardstick is JAX against itself: the same attack on the clouds with
half of their coordinates moved by one unit in the last place
(`tools/defense_vs_jax.nudged`). At each iteration of `--checks` (1, 10,
100, 500, 2,500) the tool prints, for every run, the mean and largest
coordinate gap from JAX's iterate, the share of coordinates within 1e-4,
the attack's loss, and at the last each cloud's success and distance (all
read with JAX's victim and JAX's losses, so only the iterates differ). The
bound: the port's mean gap at most 1.5 times the yardstick's, or under the
floor 1e-6. The planted faults (`FAULTS`), run beside the others, must
miss it: lr x 1.05, `knn_weight` 3 -> 2.85, and the port with the
`torch.optim.Adam` it stepped the attack with before its optimiser took
optax's arithmetic (`optim.OptaxAdam`): whether that difference matters at
the attack's scale.

Writes `<out_dir>/knn_attack_vs_jax.json`. This tool imports both
packages; the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from if_defense_tpu.attack import cw as jcw  # noqa: E402
from if_defense_tpu.attack import losses as jlosses  # noqa: E402
from if_defense_tpu.models import build_model as jax_build_model  # noqa: E402
from if_defense_tpu.training import (  # noqa: E402
    create_train_state,
    eval_variables,
    make_eval_step,
    make_train_step,
)
from tools.defense_vs_jax import NEAR, in_thread, nudged  # noqa: E402

# cli/attack.py's kNN attack as tools/accuracy_benchmark_torch.py runs it
FLAGS = dict(attack_lr=1e-3, kappa=15.0, budget=0.1)
YARD_RATIO, FLOOR = 1.5, 1e-6
VICTIM = "pointnet"


def _old_adam(params, lr):
    """The port's attack optimiser before optax's arithmetic."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


# planted faults: (attack flags, knn_weight, optimiser) of a port run
FAULTS = {"lr x 1.05": (dict(FLAGS, attack_lr=FLAGS["attack_lr"] * 1.05),
                        3.0, None),
          "knn_weight 2.85": (FLAGS, 2.85, None),
          "torch.optim.Adam": (FLAGS, 3.0, _old_adam)}


def hard_data(args) -> dict:
    """The hard family's classification arrays (train xyz and labels, test
    xyz, normals, labels and targets)."""
    from tools.synthetic_dataset import make_classification_npz

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"hard8_{args.train_per_class}_"
                        f"{args.test_per_class}_{args.seed}.npz")
    if not os.path.exists(path):
        make_classification_npz(path, args.train_per_class,
                                args.test_per_class, args.num_points,
                                seed=args.seed, family="hard")
    with np.load(path) as z:
        return {"train_pc": z["train_pc"][..., :3],
                "train_label": z["train_label"].astype(np.int32),
                "test_pc": z["test_pc"][..., :3],
                "test_normal": z["test_pc"][..., 3:6],
                "test_label": z["test_label"].astype(np.int32),
                "target": z["target_label"].astype(np.int32)}


def train_victim(data: dict, args) -> tuple[dict, list]:
    """JAX's PointNet trained by the JAX package's step, epoch by epoch,
    until the clean test accuracy reaches `args.target_acc` (or
    `args.epochs` run out), kept in `args.out_dir` and read back by a
    later run of the same settings. -> (eval variables as numpy, test
    accuracy a epoch)."""
    from if_defense_tpu_torch.utils.params_io import (
        flatten_params,
        unflatten_params,
    )

    path = os.path.join(args.out_dir, f"victim_{args.train_per_class}_"
                        f"{args.epochs}_{args.target_acc}_{args.seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files if k != "accs"}
            return unflatten_params(flat), z["accs"].tolist()
    variables, accs = _train_victim(data, args)
    np.savez(path, accs=np.asarray(accs), **flatten_params(variables))
    return variables, accs


def _train_victim(data: dict, args) -> tuple[dict, list]:
    model = jax_build_model(VICTIM)
    n = len(data["train_label"])
    steps = n // args.batch_size
    key = jax.random.key(args.seed)
    state = create_train_state(model, key, data["train_pc"][:2],
                               total_epochs=max(args.epochs, 1),
                               steps_per_epoch=max(steps, 1))
    step, evaluate = make_train_step(model), make_eval_step(model)
    rng = np.random.default_rng(args.seed)
    accs = []
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for i in range(steps):
            idx = order[i * args.batch_size:(i + 1) * args.batch_size]
            key, sub = jax.random.split(key)
            state, _ = step(state, jnp.asarray(data["train_pc"][idx]),
                            jnp.asarray(data["train_label"][idx]), sub)
        logits = evaluate(eval_variables(state), data["test_pc"])
        accs.append(float((np.asarray(logits).argmax(-1)
                           == data["test_label"]).mean()))
        print(f"victim epoch {epoch + 1}: clean test accuracy "
              f"{accs[-1]:.4f}", flush=True)
        if accs[-1] >= args.target_acc:
            break
    return jax.tree_util.tree_map(np.asarray, eval_variables(state)), accs


def attack_jax(variables: dict, pc, normal, target, noise, checks) -> dict:
    """JAX's `cw_knn` loop (its own `_knn_chunk` segments, which the
    package's chunked path runs), the iterate read after each check."""
    model = jax_build_model(VICTIM)
    logits_fn = lambda x: model.apply(variables, x, train=False)[0]  # noqa
    opt = optax.adam(FLAGS["attack_lr"])
    adv = jnp.asarray(pc) + jnp.asarray(noise) * 1e-7
    carry, done, out = (adv, opt.init(adv)), 0, {}
    for c in checks:
        carry = jcw._knn_chunk(
            logits_fn, jlosses.chamfer_knn_dist, None, FLAGS["attack_lr"],
            FLAGS["budget"], c - done, carry, jnp.asarray(pc),
            jnp.asarray(target), jnp.asarray(normal), FLAGS["kappa"])
        done, out[c] = c, np.asarray(carry[0])
    return out


def attack_port(variables: dict, pc, normal, target, noise, checks,
                flags=FLAGS, knn_weight=3.0) -> dict:
    """The port's `cw_knn` with JAX's noise, the iterate read after each
    check: the loop evaluates the victim once an iteration on the iterate
    it steps from (and once more at the end), so the victim's (k + 1)-th
    call sees the iterate after k steps."""
    from if_defense_tpu_torch.attack import cw
    from if_defense_tpu_torch.attack.losses import chamfer_knn_dist
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    model = build_model(VICTIM)
    model.load_state_dict(params_from_jax(variables, model), strict=True)
    model.eval()
    out, calls = {}, [0]

    def logits_fn(x):
        if calls[0] in checks:
            out[calls[0]] = x.detach().numpy().copy()
        calls[0] += 1
        return model(x)[0]

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731 (a copy)
    cw.cw_knn(logits_fn, t(pc), t(target), None,
              functools.partial(chamfer_knn_dist, knn_weight=knn_weight),
              normal=t(normal), num_iter=max(checks), draws=t(noise),
              **flags)
    return out


def measures(variables: dict, pc, target, iterate) -> dict:
    """The attack's loss at an iterate and each cloud's success and
    distance, read with JAX's victim and losses."""
    model = jax_build_model(VICTIM)
    logits = model.apply(variables, jnp.asarray(iterate), train=False)[0]
    adv_loss = jlosses.logits_adv_loss(logits, jnp.asarray(target),
                                   kappa=FLAGS["kappa"])
    dist = jlosses.chamfer_knn_dist(jnp.asarray(iterate), jnp.asarray(pc))
    loss = jnp.mean(adv_loss) + jnp.mean(dist) * pc.shape[1]
    return {"loss": float(loss),
            "success": (np.asarray(logits).argmax(-1) == target).tolist(),
            "distance": np.asarray(dist).tolist()}


def coordinate_gaps(a: np.ndarray, b: np.ndarray) -> dict:
    e = np.abs(a.astype(np.float64) - b)
    return {"mean": float(e.mean()), "max": float(e.max()),
            "within_1e-4": float((e <= NEAR).mean())}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out_dir",
                   default=os.path.join(ROOT, "runs", "knn_vs_jax"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clouds", type=int, default=8)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--checks", type=int, nargs="+",
                   default=[1, 10, 100, 500, 2500])
    p.add_argument("--train_per_class", type=int, default=100)
    p.add_argument("--test_per_class", type=int, default=25)
    p.add_argument("--epochs", type=int, default=20,
                   help="at most; 0 attacks JAX's initial weights")
    p.add_argument("--target_acc", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--faults", nargs="*", default=sorted(FAULTS))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)            # each port run in one thread
    checks = sorted({c for c in args.checks if c <= args.iters}
                    | {args.iters})
    t0 = time.time()
    data = hard_data(args)
    variables, accs = train_victim(data, args)
    t_train = time.time() - t0
    per = args.test_per_class
    pick = [(i % 8) * per + i // 8 for i in range(args.clouds)]
    pc, normal = data["test_pc"][pick], data["test_normal"][pick]
    target = data["target"][pick]
    noise = np.asarray(jax.random.normal(jax.random.key(args.seed + 1),
                                         pc.shape), np.float32)

    from if_defense_tpu_torch.attack import cw

    jobs = {"jax": in_thread(attack_jax, variables, pc, normal, target,
                             noise, checks),
            "jax, one ulp": in_thread(attack_jax, variables, nudged(pc),
                                      normal, target, noise, checks)}
    port_adam = cw.adam
    # the runs with another optimiser first, each alone with the module's
    # optimiser swapped: it is read once, at the attack's start, and put
    # back at once, before the next run starts
    for name in sorted(args.faults, key=lambda n: FAULTS[n][2] is None):
        flags, weight, adam = FAULTS[name]
        if adam is not None:
            def swapped(params, lr, adam=adam):
                cw.adam = port_adam
                return adam(params, lr)
            cw.adam = swapped
        jobs[name] = in_thread(attack_port, variables, pc, normal, target,
                               noise, checks, flags, weight)
        while cw.adam is not port_adam:
            time.sleep(0.01)
    runs = {"port": attack_port(variables, pc, normal, target, noise,
                                checks)}
    runs.update({name: job() for name, job in jobs.items()})
    seconds = time.time() - t0

    names = ["port", "jax, one ulp", *args.faults]
    report = {"flags": FLAGS, "clouds": args.clouds, "iters": args.iters,
              "victim_epochs": len(accs), "victim_test_acc": accs,
              "seconds": seconds, "train_seconds": t_train, "checks": {},
              "misses": {}}
    print(f"victim: {len(accs)} epochs, clean test accuracy "
          f"{accs[-1] if accs else float('nan'):.4f}")
    for c in checks:
        want = runs["jax"][c]
        row = {"jax": measures(variables, pc, target, want)}
        for n in names:
            row[n] = {**coordinate_gaps(runs[n][c], want),
                      **measures(variables, pc, target, runs[n][c])}
        report["checks"][c] = row
        yard = row["jax, one ulp"]["mean"]
        for n in ("port", *args.faults):
            report["misses"].setdefault(n, {})[c] = \
                row[n]["mean"] > max(YARD_RATIO * yard, FLOOR)
        print(f"\niteration {c}: loss jax {row['jax']['loss']:.6f}")
        for n in names:
            r = row[n]
            verdict = ("" if n == "jax, one ulp" else
                       f", {r['mean'] / max(yard, 1e-30):.2f}x the "
                       "yardstick's mean, " + (
                           "MISSES" if report["misses"][n][c] else "within"))
            print(f"  {n}: gap mean {r['mean']:.3e} max {r['max']:.3e}, "
                  f"within 1e-4 {r['within_1e-4']:.4f}, loss "
                  f"{r['loss']:.6f}{verdict}")
    last = report["checks"][checks[-1]]
    print(f"\nafter {checks[-1]} iterations, each cloud's success and "
          "distance:")
    for n in ["jax", *names]:
        print(f"  {n}: " + ", ".join(
            f"{int(s)}/{d:.4f}" for s, d in zip(last[n]["success"],
                                                last[n]["distance"])))
    report["bound_held"] = not any(report["misses"]["port"].values())
    report["faults_missed"] = {n: report["misses"][n][checks[-1]]
                               for n in args.faults}
    print(f"port within the bound (mean <= {YARD_RATIO} x the yardstick's "
          f"or {FLOOR:g}) at every check: {report['bound_held']}; each "
          f"fault missed it at the last: {report['faults_missed']}; "
          f"{seconds:.0f} s")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "knn_attack_vs_jax.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
