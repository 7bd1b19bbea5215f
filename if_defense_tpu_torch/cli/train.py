"""Victim-classifier training CLI (port of `if_defense_tpu/cli/train.py`).

Mirrors `baselines/train.py` (and, with --def_data, `hybrid_train.py`):
Adam(1e-3, wd 1e-4) + cosine anneal, periodic eval (every `--eval_every`
epochs and in the last 20), best-checkpoint snapshot by test accuracy (by
defended accuracy with --def_data), `--resume`. The flags and the
`metrics.jsonl` records are the JAX CLI's, plus `--device` (default `cuda`;
`cpu` only when asked). Eager; TF32 off.

The whole run is under deterministic algorithms
(`utils.determinism.deterministic`, entered before any CUDA work, since
cuBLAS reads its workspace setting when the process makes its first
handle; the caller's flags and `CUBLAS_WORKSPACE_CONFIG` are restored on
return), and the gathers' backward on the card is the port's fixed-order
kernel (`ops.pointops.index_points`), so two runs from one `--seed` write
the same bytes, on the CPU and on the card, on one card or split.

Each train and eval batch is split over `parallel.best_data_mesh(
--batch_size, --device)`, the most devices that divide the batch, as the
JAX CLI shards it: `--device cuda` is every visible card, `cuda:i` that
card alone, `cpu` one CPU device. A split train step computes what the
unsplit one does (the whole batch's batch-norm statistics, means and
gradient, the same dropout masks; `training.make_train_step`); one
device runs the same code as one shard. The split runs in one process,
one thread a card, under one interpreter lock, with a rendezvous at
every batch norm: on an H100 node a PointNet++ step at batch 32 split
over four cards took 5.9x as long as on one card (PERF.md, PR 15). So
`--device cuda:0` trains faster today than `--device cuda` on a node of
several cards.

The victim starts from `utils.params_io.flax_init_params(--seed)` (flax's
distributions, drawn with numpy), and dropout draws its keep masks from one
`torch.Generator` seeded with `--seed + 1`, as the JAX CLI splits its
dropout key from `key(seed + 1)`; both restart on `--resume`, as the JAX
CLI's do. Checkpoints are the port's flat npz (`<output>/best.npz`,
`<output>/final.npz`, each with its metadata and optimiser sidecars;
`utils/checkpoint.py`), and the registry records `<output>/best.npz`.

Usage:
    python -m if_defense_tpu_torch.cli.train --data mn40.npz \\
        --model pointnet --epochs 200 --batch_size 32 --output runs/pointnet
"""

from __future__ import annotations

import argparse
import os
import time
from collections.abc import Iterator

import numpy as np
import torch

from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.data import ModelNet40, ModelNet40Hybrid, batch_iterator
from if_defense_tpu_torch.models import build_model
from if_defense_tpu_torch.models.common import Draw, generator_draw
from if_defense_tpu_torch.parallel import best_data_mesh, mesh_devices
from if_defense_tpu_torch.training import (
    AverageMeter,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from if_defense_tpu_torch.utils import (
    MetricsWriter,
    flax_init_params,
    params_from_jax,
    restore_checkpoint,
    save_checkpoint,
)
from if_defense_tpu_torch.utils.determinism import deterministic


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a victim classifier")
    p.add_argument("--data", required=True, help="dataset npz path")
    p.add_argument("--def_data", default=None,
                   help="defended npz for hybrid training")
    p.add_argument("--model", default="pointnet",
                   choices=["pointnet", "pointnet2", "dgcnn", "pointconv", "rscnn"])
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--smoothing", action="store_true",
                   help="eps-0.2 label smoothing (off in the reference recipe)")
    p.add_argument("--feature_transform", action="store_true")
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--output", default="runs/train")
    p.add_argument("--registry", default=None,
                   help="registry JSON to record the best checkpoint in "
                        "(default weights/registry.json)")
    p.add_argument("--resume", default=None,
                   help="checkpoint npz to resume from (params, optimizer "
                        "state, batch stats, epoch — the reference's "
                        "train.py:228 can only hard-start)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p.parse_args(argv)


def initial_variables(name: str, seed: int, **kwargs) -> dict:
    """The victim's starting variables in the flax layout: flax's `init`
    distributions drawn with numpy (`flax_init_params`)."""
    return flax_init_params(seed, name, **kwargs)


def dropout_draws(seed: int, device: torch.device) -> Iterator[Draw]:
    """The dropout draw of each train step, in order: all from one
    `torch.Generator` on `device` seeded with `seed`."""
    draw = generator_draw(torch.Generator(device=device).manual_seed(seed))
    while True:
        yield draw


def evaluate(eval_step, dataset, batch_size: int) -> float:
    """Test accuracy: padded batches (`pad_last`, so each splits over the
    eval step's devices), only the valid rows scored."""
    correct, total = 0, 0
    for (pc, label), valid in batch_iterator(dataset, batch_size, pad_last=True):
        logits = eval_step(torch.from_numpy(pc.astype(np.float32)))
        pred = logits.argmax(-1).cpu().numpy()[:valid]
        correct += int((pred == label[:valid]).sum())
        total += valid
    return correct / max(total, 1)


def main(argv=None, devices=None):
    """Train; the best test accuracy. `devices` (for tests) replaces the
    devices `--device` names, repeats allowed."""
    args = parse_args(argv)
    with deterministic():
        return _train(args, devices)


def _train(args, devices) -> float:
    device_of(args.device)
    mesh = best_data_mesh(args.batch_size,
                          args.device if devices is None else devices)
    devices = mesh_devices(mesh)
    device = devices[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output, exist_ok=True)
    metrics = MetricsWriter(os.path.join(args.output, "metrics.jsonl"))

    if args.def_data:
        train_ds = ModelNet40Hybrid(
            args.data, args.def_data, args.num_points, partition="train",
            seed=args.seed)
        test_ds = ModelNet40Hybrid(
            args.data, args.def_data, args.num_points, partition="test",
            subset="ori", seed=args.seed)
        def_test_ds = ModelNet40Hybrid(
            args.data, args.def_data, args.num_points, partition="test",
            subset="def", seed=args.seed)
    else:
        train_ds = ModelNet40(args.data, args.num_points, partition="train",
                              seed=args.seed)
        test_ds = ModelNet40(args.data, args.num_points, partition="test",
                             seed=args.seed)
        def_test_ds = None

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    kwargs = ({"feature_transform": args.feature_transform}
              if args.model == "pointnet" else {})
    model = build_model(args.model, **kwargs)
    model.load_state_dict(params_from_jax(
        initial_variables(args.model, args.seed, **kwargs), model),
        strict=True)
    model.to(device)
    state = create_train_state(
        model, learning_rate=args.lr, weight_decay=args.weight_decay,
        total_epochs=args.epochs, steps_per_epoch=steps_per_epoch)
    start_epoch = 1
    if args.resume:
        state, meta = restore_checkpoint(args.resume, state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        print(f"resumed from {args.resume} at epoch {start_epoch} "
              f"(step {state.step})")

    train_step = make_train_step(
        model, smoothing=args.smoothing,
        fea_reg_weight=0.001 if args.feature_transform else 0.0,
        devices=devices,
    )
    eval_step = make_eval_step(model, devices)

    best_acc, best_epoch = 0.0, 0
    best_def_acc, best_def_epoch = 0.0, 0
    draws = dropout_draws(args.seed + 1, device)
    for epoch in range(start_epoch, args.epochs + 1):
        loss_meter, acc_meter = AverageMeter(), AverageMeter()
        t0 = time.time()
        steps = []
        for (pc, label), valid in batch_iterator(
            train_ds, args.batch_size, shuffle=True, drop_last=True,
            seed=args.seed + epoch,
        ):
            pc = torch.from_numpy(pc.astype(np.float32))
            label = torch.from_numpy(label).long()
            state, m = train_step(state, pc, label, next(draws))
            steps.append((torch.stack([m["loss"], m["acc"]]), len(label)))
        # the step metrics come back to the host once an epoch
        if steps:
            values = torch.stack([v for v, _ in steps]).cpu().numpy()
            for (loss, acc), (_, n) in zip(values, steps):
                loss_meter.update(loss, n)
                acc_meter.update(acc, n)
        if epoch % args.eval_every == 0 or epoch > args.epochs - 20:
            acc = evaluate(eval_step, test_ds, args.batch_size)
            record = {
                "epoch": epoch, "train_loss": loss_meter.avg,
                "train_acc": acc_meter.avg, "test_acc": acc,
                "epoch_time": time.time() - t0,
            }
            def_acc = None
            if def_test_ds is not None:
                def_acc = evaluate(eval_step, def_test_ds, args.batch_size)
                record["def_test_acc"] = def_acc
            metrics.write(**record)
            # ">= at first eval": an all-wrong eval (acc exactly 0.0) must
            # still produce a "best" checkpoint, or downstream consumers
            # (attack/inference on <output>/best.npz) hit a missing path
            if acc > best_acc or best_epoch == 0:
                best_acc, best_epoch = acc, epoch
            if def_acc is not None and (def_acc > best_def_acc
                                        or best_def_epoch == 0):
                best_def_acc, best_def_epoch = def_acc, epoch
            # hybrid training snapshots the best checkpoint by defended
            # accuracy (`baselines/hybrid_train.py:130-135`); clean training
            # by ori accuracy (`train.py:121-124`)
            is_best = (def_acc is not None and best_def_epoch == epoch
                       if def_test_ds is not None
                       else best_epoch == epoch)
            if is_best:
                save_checkpoint(
                    os.path.join(args.output, "best"),
                    state,
                    {"model": args.model, "epoch": epoch, "acc": acc,
                     **({"def_acc": def_acc} if def_acc is not None
                        else {}),
                     "num_points": args.num_points},
                )
        else:
            metrics.write(epoch=epoch, train_loss=loss_meter.avg,
                          train_acc=acc_meter.avg,
                          epoch_time=time.time() - t0)
    save_checkpoint(
        os.path.join(args.output, "final"), state,
        {"model": args.model, "epoch": args.epochs,
         "num_points": args.num_points},
    )
    if best_epoch > 0 or best_def_epoch > 0:
        from if_defense_tpu_torch.utils.registry import register_checkpoint

        register_checkpoint(
            os.path.basename(args.data).replace(".npz", ""), args.model,
            os.path.join(args.output, "best.npz"), args.num_points,
            path=args.registry)
    final = {"best_acc": best_acc, "best_epoch": best_epoch}
    if def_test_ds is not None:
        final.update(best_def_acc=best_def_acc,
                     best_def_epoch=best_def_epoch)
    metrics.write(**final)
    return best_acc


if __name__ == "__main__":
    main()
