#!/usr/bin/env python3
"""The protocol's full-width ConvONet training, the port against the JAX
package, on the CPU.

    python tools/train_vs_jax.py --out_dir runs/train_vs_jax

Both packages train `ConvOccupancyNetwork()` at full width (three 64^2
planes, 1,978,209 weights) from one tree, JAX's `init_occupancy_model`
draws carried across with `params_from_jax`, on JAX's own sampler batches
(which the port's sampler gives bit for bit) of a hard-family occupancy
npz (`tools/synthetic_dataset.py`), with the flags the accuracy protocol
passes to `cli/train_implicit.py`: batch 16, `pointcloud_n` 600,
`points_subsample` 2,048, noise 0.005, Adam at lr 1e-4, for `--steps` (50)
steps. The port runs on the CPU in one thread a run.

The yardstick is JAX against itself: the same training with every input
cloud moved by one unit in the last place (half of the coordinates, as
`tools/defense_vs_jax.py` moves them). A weight's relative gap is its
distance from JAX's over the largest JAX weight of its tensor. At the
steps of `--check_steps` (1, 10 and 50) the tool prints each tensor's
largest and mean relative gap for the port and the yardstick, and holds
the whole net's mean relative gap to the bound: at most 1.5 times the
yardstick's, or under the floor 1e-6 (rounding at any size). The largest
gap is printed beside the yardstick's, not bounded, as
`tests/test_torch_port_c3.py` prints the defense's: it is the largest of
a few sign flips of gradients within rounding of 0 (zero-initialised
biases after one step move by lr either way), so it parts by more than
1.5x between two runs that are equally right. The control: the port with
a planted fault of the size a port could make (`FAULTS`: Adam's lr 1.05
times, or the UNet's last skip connection left out) must miss the bound.
Also printed: every run's loss at each step, and each net's occupancy
accuracy on 2,048 held-out queries of test shapes (256 a shape, one
shape a class) before and after training.

Writes `<out_dir>/train_vs_jax.json`. This tool imports both packages;
the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from if_defense_tpu.implicit import (  # noqa: E402
    ConvOccupancyNetwork as JaxConvONet,
)
from if_defense_tpu.implicit.training import (  # noqa: E402
    OccupancyBatchSampler as JaxSampler,
)
from if_defense_tpu.implicit.training import (  # noqa: E402
    init_occupancy_model as jax_init_model,
)
from if_defense_tpu.implicit.training import (  # noqa: E402
    make_occupancy_train_step as jax_train_step,
)
from tools.defense_vs_jax import in_thread, nudged  # noqa: E402

# cli/train_implicit.py's flags as tools/accuracy_benchmark_torch.py runs it
FLAGS = dict(batch_size=16, pointcloud_n=600, points_subsample=2048,
             pointcloud_noise=0.005, lr=1e-4)
YARD_RATIO, FLOOR = 1.5, 1e-6
HELDOUT_QUERIES = 256               # a test shape; 8 shapes, 2,048 queries


def _lr_up(flags: dict) -> dict:
    return dict(flags, lr=flags["lr"] * 1.05)


def _drop_last_skip(model) -> None:
    """The UNet's last up block concatenates zeros where its skip
    connection's features belong."""
    up = getattr(model.encoder.unet, f"up_{model.encoder.unet.depth - 2}")
    forward = up.forward
    up.forward = lambda from_down, from_up: forward(
        torch.zeros_like(from_down), from_up)


# planted faults: (flags, model edit) of a port run the bound must see
FAULTS = {"lr x 1.05": (_lr_up, None),
          "UNet skip left out": (None, _drop_last_skip)}


def occupancy_arrays(per_class: int, seed: int, out_dir: str):
    """(pointcloud, points, points_occ) of a hard-family occupancy npz."""
    from tools.synthetic_dataset import make_occupancy_npz

    path = os.path.join(out_dir, f"occ_{per_class}_{seed}.npz")
    if not os.path.exists(path):
        make_occupancy_npz(path, per_class, 2048, 4096, seed=seed,
                           family="hard")
    with np.load(path) as z:
        return z["pointcloud"], z["points"], z["points_occ"]


def jax_batches(arrays, steps: int, seed: int, flags: dict = FLAGS) -> list:
    """`steps` batches of JAX's own sampler."""
    sampler = JaxSampler(*arrays, pointcloud_n=flags["pointcloud_n"],
                         pointcloud_noise=flags["pointcloud_noise"],
                         points_subsample=flags["points_subsample"],
                         seed=seed)
    return [sampler.sample(flags["batch_size"]) for _ in range(steps)]


def heldout(arrays, n_points: int, seed: int):
    """Each test shape's first `n_points` surface points with the
    sampler's noise, and its first HELDOUT_QUERIES queries and labels."""
    pcs, qs, occ = arrays
    rng = np.random.default_rng(seed)
    inputs = pcs[:, :n_points] + rng.normal(
        0, FLAGS["pointcloud_noise"], (len(pcs), n_points, 3))
    return (inputs.astype(np.float32), qs[:, :HELDOUT_QUERIES],
            occ[:, :HELDOUT_QUERIES])


def init_tree(seed: int) -> dict:
    """JAX's `init_occupancy_model` draws for the full-width ConvONet, as
    numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jax_init_model(JaxConvONet(), key))(jax.random.key(seed)))


def _flat(tree: dict) -> dict:
    from if_defense_tpu_torch.utils.params_io import flatten_params

    return flatten_params(jax.tree_util.tree_map(np.asarray, tree))


def train_jax(variables: dict, batches: list, lr: float, keep) -> dict:
    """JAX's train step over `batches`: the loss and accuracy of each
    step, the flat weights after each step in `keep`, the last params."""
    tx, step = jax_train_step(JaxConvONet(), lr)
    params = variables["params"]
    opt_state = tx.init(params)
    out = {"loss": [], "acc": [], "weights": {}}
    for i, batch in enumerate(batches, 1):
        params, _, opt_state, m = step(params, None, opt_state, *batch)
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["acc"]))
        if i in keep:
            out["weights"][i] = _flat({"params": params})
    out["params"] = params
    return out


def port_model(variables: dict, edit=None):
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    model = ConvOccupancyNetwork()
    model.load_state_dict(params_from_jax(variables, model), strict=True)
    if edit is not None:
        edit(model)
    return model


def port_flat(model) -> dict:
    from if_defense_tpu_torch.utils.params_io import params_to_jax

    return _flat(params_to_jax(model.state_dict(), model))


def train_port(variables: dict, batches: list, lr: float, keep,
               edit=None) -> dict:
    """The port's train step (`make_occupancy_train_step`) over the same
    batches on the CPU: as `train_jax`, with the model as "model"."""
    from if_defense_tpu_torch.implicit.training import (
        make_occupancy_train_step,
    )

    model = port_model(variables, edit)
    _, step = make_occupancy_train_step(model, lr)
    out = {"loss": [], "acc": [], "weights": {}}
    for i, batch in enumerate(batches, 1):
        m = step(*(torch.from_numpy(a) for a in batch))
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["acc"]))
        if i in keep:
            out["weights"][i] = port_flat(model)
    out["model"] = model
    return out


def relative_gaps(got: dict, want: dict) -> dict:
    """Per tensor (and "all" for the whole net): the largest and the mean
    of |got - want| over the largest |want| of the tensor."""
    per, sums, n, largest = {}, 0.0, 0, 0.0
    for k, w in want.items():
        r = np.abs(got[k].astype(np.float64) - w) / max(
            float(np.abs(w).max()), 1e-30)
        per[k] = (float(r.max()), float(r.mean()))
        largest = max(largest, per[k][0])
        sums, n = sums + float(r.sum()), n + r.size
    per["all"] = (largest, sums / n)
    return per


def misses(gap: tuple, yard: tuple) -> bool:
    """Whether the whole net's mean relative gap `gap[1]` misses the bound
    against the yardstick's `yard[1]`."""
    return gap[1] > max(YARD_RATIO * yard[1], FLOOR)


def occupancy_accuracy(logits, occ) -> float:
    return float(((np.asarray(logits) > 0) == (occ > 0.5)).mean())


def _port_grads(model, prefix: str) -> dict:
    """The flat flax-layout gradients of `model`'s parameters under
    `prefix` (those that got one)."""
    from if_defense_tpu_torch.utils.params_io import params_to_jax

    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    return {f"grad/{k}": v for k, v in _flat(params_to_jax(
        grads, model)["params"]).items() if k.startswith(prefix)}


def _stages(variables: dict, batch, seed: int):
    """-> {stage: (jax_fn(x) -> flat dict, port_fn(model, x) -> flat
    dict, x as numpy)}: each stage's outputs, its parameters' gradients
    and its input's gradient under a seeded cotangent, at full width on
    one protocol batch; the stages' inputs are JAX's own outputs of the
    stage before."""
    import optax
    import torch.nn.functional as F

    from if_defense_tpu.implicit.convonet import (
        LocalDecoder as JaxDecoder,
    )
    from if_defense_tpu.implicit.convonet import (
        LocalPoolPointnet as JaxEncoder,
    )
    from if_defense_tpu.implicit.unet2d import UNet2D as JaxUNet2D

    pc, q, occ = batch
    params = variables["params"]
    enc = {k: v for k, v in params["encoder"].items() if k != "unet"}
    rng = np.random.default_rng(seed + 77)

    def cot(tree):
        return jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(a.dtype), tree)

    def jax_stage(fn, p, prefix, x, c):
        out, vjp = jax.vjp(fn, p, x)
        gp, gx = vjp(c)
        flat = {f"out/{k}": v for k, v in _flat(
            out if isinstance(out, dict) else {"y": out}).items()}
        flat.update({f"grad/{prefix}/{k}": v for k, v in _flat(gp).items()})
        flat.update({f"grad/x/{k}": v for k, v in _flat(
            gx if isinstance(gx, dict) else {"x": gx}).items()})
        return flat

    def port_stage(model, run, prefix, x, c):
        dtype = next(model.parameters()).dtype
        model.zero_grad(set_to_none=True)
        leaves = jax.tree_util.tree_map(
            lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                   requires_grad=True), x)
        out = run(model, leaves)
        outs = out if isinstance(out, dict) else {"y": out}
        cots = c if isinstance(c, dict) else {"y": c}
        torch.autograd.backward(
            [outs[k] for k in outs],
            [torch.tensor(np.asarray(cots[k]), dtype=dtype) for k in outs])
        flat = {f"out/{k}": v.detach().numpy() for k, v in outs.items()}
        flat.update(_port_grads(model, prefix))
        xs = leaves if isinstance(leaves, dict) else {"x": leaves}
        flat.update({f"grad/x/{k}": v.grad.numpy() for k, v in xs.items()})
        return flat

    def no_unet(model, x):
        unet, model.encoder.unet = model.encoder.unet, None
        try:
            return model.encoder(x)
        finally:
            model.encoder.unet = unet

    def stage(jfn, jp, prefix, run, x):
        c = cot(jax.eval_shape(lambda a: jfn(jp, a), x))
        return (lambda xx: jax_stage(jfn, jp, prefix, xx, c),
                lambda model, xx: port_stage(model, run, prefix, xx, c),
                x)

    out = {}
    jenc = lambda p, x: JaxEncoder(unet=False).apply(  # noqa: E731
        {"params": p}, x)
    out["LocalPoolPointnet"] = stage(jenc, enc, "encoder", no_unet, pc)
    planes = {k: np.asarray(v) for k, v in jenc(enc, pc).items()}
    stacked = np.concatenate([planes[k] for k in sorted(planes)])
    junet = lambda p, x: JaxUNet2D(32, 4, 32).apply(  # noqa: E731
        {"params": p}, x)
    out["UNet2D 64^2"] = stage(
        junet, params["encoder"]["unet"], "encoder/unet",
        lambda m, x: m.encoder.unet(x), stacked)
    smoothed = {k: np.asarray(junet(params["encoder"]["unet"], v))
                for k, v in planes.items()}
    jdec = lambda p, c: JaxDecoder(32, 32).apply(  # noqa: E731
        {"params": p}, q, c)
    out["LocalDecoder"] = stage(
        jdec, params["decoder"], "decoder",
        lambda m, c: m.decoder(torch.from_numpy(q).to(
            next(m.parameters()).dtype), c), smoothed)
    logits = np.asarray(jdec(params["decoder"], smoothed))
    jloss = lambda p, x: jnp.mean(  # noqa: E731
        optax.sigmoid_binary_cross_entropy(x, occ))
    out["loss"] = stage(
        jloss, {}, "none", lambda m, x: F.binary_cross_entropy_with_logits(
            x, torch.from_numpy(occ).to(x.dtype)), logits)
    return out


def adam_stage(variables: dict, batch, steps: int, seed: int):
    """Adam alone: `steps` updates of both optimisers (optax's, jitted as
    the train step runs it, and the port's `OptaxAdam`, lr 1e-4) from
    JAX's initial weights on the same
    gradients
    (JAX's full gradient on `batch`, scaled by 1 + 0.1 N(0, 1) each step);
    -> (jax_fn(grads) -> flat weights, port_fn(dtype, grads) -> flat
    weights, the gradients)."""
    import optax

    params = variables["params"]
    tx, _ = jax_train_step(JaxConvONet(), FLAGS["lr"])

    def loss(p):
        logits = JaxConvONet().apply({"params": p}, *batch[:2])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, batch[2]))

    g = _flat(jax.grad(loss)(params))
    rng = np.random.default_rng(seed + 99)
    grads = [{k: (v * (1 + 0.1 * rng.normal(size=v.shape))).astype(
        np.float32) for k, v in g.items()} for _ in range(steps)]
    flat0 = _flat(params)

    @jax.jit
    def apply(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    def jax_fn(gs):
        from if_defense_tpu_torch.utils.params_io import unflatten_params

        p = params
        state = tx.init(p)
        for gi in gs:
            p, state = apply(unflatten_params(gi), state, p)
        return _flat(p)

    def port_fn(dtype, gs):
        from if_defense_tpu_torch.optim import OptaxAdam

        ws = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
              for k, v in flat0.items()}
        opt = OptaxAdam(list(ws.values()), lr=FLAGS["lr"])
        for gi in gs:
            for k, w in ws.items():
                w.grad = torch.tensor(gi[k], dtype=dtype)
            opt.step()
        return {k: w.detach().numpy() for k, w in ws.items()}

    return jax_fn, port_fn, grads


def bisect(variables: dict, batch, seed: int) -> dict:
    """Module by module at full width on one protocol batch: each stage's
    outputs and gradients, the port's f32 and f64 against JAX's f32 and
    JAX's on its input moved by one ulp."""
    report = {}

    def row(name, want, got, yard, got64):
        gaps = {"port vs jax": relative_gaps(got, want)["all"],
                "jax one ulp vs jax": relative_gaps(yard, want)["all"],
                "port vs port f64": relative_gaps(got, got64)["all"],
                "jax vs port f64": relative_gaps(want, got64)["all"]}
        report[name] = gaps
        print(f"  {name}: " + "; ".join(
            f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in gaps.items()),
            flush=True)

    print("bisect, largest / mean relative gap of each stage's outputs and "
          "gradients:")
    for name, (jfn, pfn, x) in _stages(variables, batch, seed).items():
        want = jfn(x)
        yard = jfn(jax.tree_util.tree_map(
            lambda a: nudged(np.asarray(a), seed), x))
        got = pfn(port_model(variables), x)
        got64 = pfn(port_model(variables).double(), x)
        row(name, want, got, yard, got64)
    jfn, pfn, grads = adam_stage(variables, batch, 10, seed)
    for n in (1, 10):
        gs = grads[:n]
        row(f"Adam, {n} step{'s' if n > 1 else ''}", jfn(gs),
            pfn(torch.float32, gs),
            jfn([{k: nudged(v, seed) for k, v in gi.items()} for gi in gs]),
            pfn(torch.float64, gs))
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out_dir",
                   default=os.path.join(ROOT, "runs", "train_vs_jax"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--check_steps", type=int, nargs="+", default=[1, 10, 50])
    p.add_argument("--occ_per_class", type=int, default=20,
                   help="training shapes a class (8 classes)")
    p.add_argument("--faults", nargs="*", default=sorted(FAULTS))
    p.add_argument("--bisect", action="store_true",
                   help="compare the modules one by one on the first batch "
                        "(no training)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)            # each port run in one thread
    os.makedirs(args.out_dir, exist_ok=True)
    keep = set(args.check_steps)
    t0 = time.time()
    train = occupancy_arrays(args.occ_per_class, args.seed + 1, args.out_dir)
    test = occupancy_arrays(1, args.seed + 1001, args.out_dir)
    batches = jax_batches(train, args.steps, args.seed)
    nudged_batches = [(nudged(b[0], seed=args.seed + i), *b[1:])
                      for i, b in enumerate(batches)]
    variables = init_tree(args.seed)
    if args.bisect:
        report = bisect(variables, batches[0], args.seed)
        with open(os.path.join(args.out_dir, "bisect.json"), "w") as f:
            json.dump(report, f, indent=2)
        return report
    lr = FLAGS["lr"]
    jobs = {"jax": in_thread(train_jax, variables, batches, lr, keep),
            "jax, one ulp": in_thread(train_jax, variables, nudged_batches,
                                      lr, keep)}
    for name in args.faults:
        flags, edit = FAULTS[name]
        jobs[name] = in_thread(train_port, variables, batches,
                               (flags(FLAGS) if flags else FLAGS)["lr"],
                               keep, edit)
    runs = {"port": train_port(variables, batches, lr, keep)}
    runs.update({name: job() for name, job in jobs.items()})
    seconds = time.time() - t0

    names = ["jax", "port", "jax, one ulp", *args.faults]
    print("step | " + " | ".join(f"loss {n}" for n in names))
    for i in range(args.steps):
        print(f"{i + 1} | " + " | ".join(
            f"{runs[n]['loss'][i]:.7f}" for n in names))
    report = {"flags": FLAGS, "steps": args.steps, "seconds": seconds,
              "loss": {n: runs[n]["loss"] for n in names},
              "train_acc": {n: runs[n]["acc"] for n in names},
              "gaps": {}, "misses": {}}
    for step in sorted(keep):
        want = runs["jax"]["weights"][step]
        gaps = {n: relative_gaps(runs[n]["weights"][step], want)
                for n in names[1:]}
        report["gaps"][step] = gaps
        print(f"\nstep {step}: relative weight gaps from JAX, largest / "
              "mean, per tensor")
        for k in [*want, "all"]:
            print(f"  {k}: " + "; ".join(
                f"{n} {gaps[n][k][0]:.3e} / {gaps[n][k][1]:.3e}"
                for n in names[1:]))
        for n in ("port", *args.faults):
            report["misses"].setdefault(n, {})[step] = misses(
                gaps[n]["all"], gaps["jax, one ulp"]["all"])
    # occupancy accuracy on held-out queries of test shapes
    inputs, queries, occ = heldout(test, FLAGS["pointcloud_n"], args.seed)
    acc = {}
    for n in names:
        if n.startswith("jax"):
            for tag, params in (("init", variables["params"]),
                                ("trained", runs[n]["params"])):
                acc[f"{n} {tag}"] = occupancy_accuracy(
                    JaxConvONet().apply({"params": params}, inputs, queries),
                    occ)
        else:
            with torch.no_grad():
                logits = runs[n]["model"].eval()(torch.from_numpy(inputs),
                                                 torch.from_numpy(queries))
            acc[f"{n} trained"] = occupancy_accuracy(logits.numpy(), occ)
    report["heldout_accuracy"] = acc
    report["bound_held"] = not any(report["misses"]["port"].values())
    report["control_missed"] = {n: all(report["misses"][n].values())
                                for n in args.faults}
    print("\nheld-out occupancy accuracy (2,048 queries of 8 test shapes): "
          + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()))
    for step in sorted(keep):
        gaps = report["gaps"][step]
        y = gaps["jax, one ulp"]["all"]
        print(f"step {step}, whole net, largest / mean relative gap: "
              f"yardstick {y[0]:.3e} / {y[1]:.3e}; " + "; ".join(
                  f"{n} {gaps[n]['all'][0]:.3e} / {gaps[n]['all'][1]:.3e} "
                  f"(mean {gaps[n]['all'][1] / y[1]:.2f}x, "
                  f"{'MISSES' if report['misses'][n][step] else 'within'})"
                  for n in ("port", *args.faults)))
    print(f"port within the bound (mean <= {YARD_RATIO} x the yardstick's "
          f"or {FLOOR:g}) at every step: {report['bound_held']}; each fault "
          f"missed it at every step: {report['control_missed']}; "
          f"{seconds:.0f} s")
    with open(os.path.join(args.out_dir, "train_vs_jax.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
