"""Training engine for victim classifiers (port of
`if_defense_tpu/training.py`).

The recipe is the JAX package's: Adam(lr 1e-3) with L2 weight decay 1e-4
added to the gradient (optax's `add_decayed_weights` before
`scale_by_adam`), a per-step cosine decay to `eta_min` over the epoch
budget (`optax.cosine_decay_schedule`), all in optax's float32 arithmetic
(`optim.OptaxAdam`, `optim.cosine_decay_schedule`), cross
entropy with optional eps-0.2 label smoothing, and PointNet's optional
feature-transform regulariser. The step is eager; the batch-norm
statistics move inside the train-mode forward (the port's `BatchNorm` has
flax's semantics), and dropout draws its keep masks from the `draw` passed
to the step (`models.common.dropout`).

Data parallelism, as the JAX step's over a sharded batch: the steps split
each batch over a list of devices (one shard a device, one thread a
shard, `parallel.run_shards`), on replicas of the model made once. In a
train step every train-mode batch norm takes the whole batch's statistics
(`parallel.StatsExchange`), the losses and the accuracy are whole-batch
means (`parallel.batch_mean`), dropout takes the unsplit run's masks
(`models.common.split_draw`), and the replicas' gradients are added into
the model's (the master, the first replica) in shard order before Adam
steps it. One device is one shard of the same code.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.models import feature_transform_regularizer
from if_defense_tpu_torch.models.common import Draw, split_draw
from if_defense_tpu_torch.optim import (
    OptaxAdam,
    ScheduledRate,
    cosine_decay_schedule,
)
from if_defense_tpu_torch.parallel import (
    StatsExchange,
    batch_mean,
    data_parallel_mesh,
    mesh_devices,
    replicate,
    run_shards,
    shard_batch,
    shard_of,
)
from if_defense_tpu_torch.utils.params_io import params_to_jax


@dataclasses.dataclass
class TrainState:
    """What the JAX package's flax `TrainState` holds: the model (its
    parameters and batch statistics), the optimiser with its moments, the
    learning-rate schedule, and the count of applied updates."""

    model: nn.Module
    optimizer: OptaxAdam
    scheduler: ScheduledRate
    step: int = 0

    def set_step(self, step: int) -> None:
        """Move the count of applied updates and the schedule to `step`
        (after the optimiser's state is restored): the next step takes the
        rate at count `step`."""
        self.step = step
        self.scheduler = ScheduledRate(
            self.optimizer, self.scheduler.schedule, last_epoch=step - 1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: bool = False) -> torch.Tensor:
    """CE loss, optionally with eps=0.2 label smoothing; the mean over the
    batch is `batch_mean` (over the whole batch in a shard of a split
    step)."""
    n_class = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    if smoothing:
        eps = 0.2
        one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
        soft = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (n_class - 1)
        return batch_mean(-(soft * logp).sum(-1))
    return batch_mean(-logp.gather(-1, labels.long()[:, None])[:, 0])


def create_train_state(model: nn.Module, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-4, total_epochs: int = 200,
                       steps_per_epoch: int = 1,
                       eta_min: float = 1e-5) -> TrainState:
    """Adam (eps 1e-8, L2 weight decay on the gradient) and the per-step
    cosine schedule over the model's parameters, which it starts from (the
    JAX package initialises them here; the port's caller loads them, e.g.
    from `utils.params_io.flax_init_params`). Step k (1-based) takes the
    rate at count k - 1, as optax's `scale_by_learning_rate` does."""
    optimizer = OptaxAdam(model.parameters(), lr=learning_rate,
                          weight_decay=weight_decay)
    scheduler = ScheduledRate(optimizer, cosine_decay_schedule(
        learning_rate, max(1, total_epochs * steps_per_epoch),
        eta_min / learning_rate, next(model.parameters()).dtype))
    return TrainState(model, optimizer, scheduler)


def _shards(model: nn.Module, devices):
    """(the mesh over `devices`, or over the model's device where None;
    the model's replicas on it, the model itself first)."""
    home = next(model.parameters()).device
    mesh = data_parallel_mesh(device=[home] if devices is None else devices)
    if mesh_devices(mesh)[0] != home:
        raise ValueError(f"the model is on {home}, the first of the "
                         f"devices is {mesh_devices(mesh)[0]}")
    return mesh, replicate(model, mesh)


def _sync(replicas: list) -> None:
    """Set every replica's weights and batch statistics to the first's
    (the master's)."""
    master = replicas[0]
    with torch.no_grad():
        for r in replicas[1:]:
            for a, b in zip(master.parameters(), r.parameters()):
                b.copy_(a)
            for a, b in zip(master.buffers(), r.buffers()):
                b.copy_(a)


def _versions(module: nn.Module) -> tuple:
    """The version counters of a module's weights and buffers: every
    in-place write moves one (an optimiser step, a train-mode batch
    norm's running statistics, `load_state_dict`)."""
    return tuple(t._version for t in itertools.chain(module.parameters(),
                                                     module.buffers()))


def _add_grads(replicas: list) -> None:
    """Add the other replicas' gradients into the master's, in shard
    order."""
    master = list(replicas[0].parameters())
    for r in replicas[1:]:
        for p, q in zip(master, r.parameters()):
            if q.grad is None:
                continue
            if p.grad is None:
                p.grad = q.grad.to(p.device, copy=True)
            else:
                p.grad.add_(q.grad.to(p.device))


def make_train_step(model: nn.Module, smoothing: bool = False,
                    fea_reg_weight: float = 0.0, devices=None):
    """The train step: (state, xyz [B, N, 3], label [B], draw) -> (state,
    {"loss", "acc"} as 0-d tensors on the first device, read back only
    when the caller asks). A train-mode forward (the batch statistics move
    inside it), the loss (+ `fea_reg_weight` x PointNet's
    feature-transform regulariser where the forward returns
    `trans_feat`), backward, then the Adam and schedule steps. `draw` gives
    the dropout keep masks (`models.common.generator_draw`).

    `devices` (default: the model's device; the first must be the model's)
    split each batch into as many shards, one a device, repeats allowed;
    B must divide. Each shard's forward runs on its replica inside a
    `StatsExchange` shard, its losses and accuracy as its part of the
    whole batch's means, moved to the first device and added in shard
    order; one backward, then the replicas' gradients added into the
    master's in shard order. The replicas take the master's weights and
    statistics at the start of every step. `state` holds the master."""
    mesh, replicas = _shards(model, devices)
    devices = mesh_devices(mesh)

    def train_step(state: TrainState, xyz: torch.Tensor, label: torch.Tensor,
                   draw: Draw | None):
        _sync(replicas)
        state.optimizer.zero_grad(set_to_none=True)
        for r in replicas:
            r.train()
        for r in replicas[1:]:
            r.zero_grad(set_to_none=True)
        shards = shard_batch((xyz, label), mesh)
        total = len(label)
        exchange = StatsExchange(devices)
        draws = (None if draw is None
                 else split_draw(draw, [len(y) for _, y in shards]))

        def forward(i: int, shard):
            pc, y = shard
            with shard_of(total):
                with exchange.shard(i):
                    logits, aux = replicas[i](
                        pc, draw=None if draws is None else draws[i])
                loss = cross_entropy_loss(logits, y, smoothing)
                if fea_reg_weight > 0.0 and "trans_feat" in aux:
                    loss = loss + fea_reg_weight * \
                        feature_transform_regularizer(aux["trans_feat"])
                acc = batch_mean((logits.detach().argmax(-1) == y).float())
            return loss.to(devices[0]), acc.to(devices[0])

        parts = run_shards(forward, shards, devices, concat=False)
        loss, acc = parts[0]
        for shard_loss, shard_acc in parts[1:]:
            loss, acc = loss + shard_loss, acc + shard_acc
        loss.backward()
        _add_grads(replicas)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss.detach(), "acc": acc}

    return train_step


def make_eval_step(model: nn.Module, devices=None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval step: [B, N, 3] clouds -> logits [B, num_classes] on the
    first device, the model in eval mode (running batch-norm statistics,
    no dropout) and no autograd graph. `devices` splits the batch as
    `make_train_step`'s do (no exchange: eval mode mixes no clouds); the
    replicas take the master's weights at a call where these have moved
    since the last (a train step, a load). The JAX package's step takes
    the variables as an argument; here they live in the module."""
    mesh, replicas = _shards(model, devices)
    devices = mesh_devices(mesh)
    synced = None

    def eval_step(xyz: torch.Tensor) -> torch.Tensor:
        nonlocal synced
        if len(replicas) > 1 and _versions(model) != synced:
            _sync(replicas)
            synced = _versions(model)
        for r in replicas:
            r.eval()
        with torch.no_grad():
            return run_shards(
                lambda i, x: replicas[i](x)[0].to(devices[0]),
                shard_batch(xyz, mesh), devices)

    return eval_step


def eval_variables(state: TrainState) -> dict:
    """The eval variables of a `TrainState` in the flax layout:
    {"params": ..., "batch_stats": ...} (numpy trees)."""
    return params_to_jax(state.model.state_dict(), state.model)


@dataclasses.dataclass
class AverageMeter:
    """Running average accumulator (`baselines/util/utils.py:58-74`)."""

    sum: float = 0.0
    count: int = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
