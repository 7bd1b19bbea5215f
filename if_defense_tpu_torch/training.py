"""Training engine for victim classifiers (port of
`if_defense_tpu/training.py`).

The recipe is the JAX package's: Adam(lr 1e-3) with L2 weight decay 1e-4
added to the gradient (torch's `Adam(weight_decay=)`, which is optax's
`add_decayed_weights` before `scale_by_adam`), a per-step cosine decay to
`eta_min` over the epoch budget (`optax.cosine_decay_schedule`), cross
entropy with optional eps-0.2 label smoothing, and PointNet's optional
feature-transform regulariser. The step is eager on one device; the
batch-norm statistics move inside the train-mode forward (the port's
`BatchNorm` has flax's semantics), and dropout draws its keep masks from
the `draw` passed to the step (`models.common.dropout`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.models import feature_transform_regularizer
from if_defense_tpu_torch.models.common import Draw
from if_defense_tpu_torch.utils.params_io import params_to_jax


@dataclasses.dataclass
class TrainState:
    """What the JAX package's flax `TrainState` holds: the model (its
    parameters and batch statistics), the optimiser with its moments, the
    learning-rate schedule, and the count of applied updates."""

    model: nn.Module
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    def set_step(self, step: int) -> None:
        """Move the count of applied updates and the schedule to `step`
        (after the optimiser's state is restored): the next step takes the
        rate at count `step`."""
        self.step = step
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, self.scheduler.lr_lambdas[0],
            last_epoch=step - 1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: bool = False) -> torch.Tensor:
    """CE loss, optionally with eps=0.2 label smoothing."""
    n_class = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    if smoothing:
        eps = 0.2
        one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
        soft = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (n_class - 1)
        return -(soft * logp).sum(-1).mean()
    return -logp.gather(-1, labels.long()[:, None]).mean()


def cosine_decay(learning_rate: float, decay_steps: int,
                 eta_min: float) -> Callable[[int], float]:
    """`optax.cosine_decay_schedule(learning_rate, decay_steps, alpha =
    eta_min / learning_rate)` as a multiplier of `learning_rate`: count ->
    (1 - alpha) (1 + cos(pi min(count, T) / T)) / 2 + alpha."""
    alpha = eta_min / learning_rate

    def factor(count: int) -> float:
        t = min(count, decay_steps) / decay_steps
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha

    return factor


def create_train_state(model: nn.Module, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-4, total_epochs: int = 200,
                       steps_per_epoch: int = 1,
                       eta_min: float = 1e-5) -> TrainState:
    """Adam (eps 1e-8, L2 weight decay on the gradient) and the per-step
    cosine schedule over the model's parameters, which it starts from (the
    JAX package initialises them here; the port's caller loads them, e.g.
    from `utils.params_io.flax_init_params`). Step k (1-based) takes the
    rate at count k - 1, as optax's `scale_by_learning_rate` does."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, cosine_decay(
        learning_rate, max(1, total_epochs * steps_per_epoch), eta_min))
    return TrainState(model, optimizer, scheduler)


def make_train_step(model: nn.Module, smoothing: bool = False,
                    fea_reg_weight: float = 0.0):
    """The train step: (state, xyz [B, N, 3], label [B], draw) -> (state,
    {"loss", "acc"} as 0-d tensors on the model's device, read back only
    when the caller asks). A train-mode forward (the batch statistics move
    inside it), the loss (+ `fea_reg_weight` x PointNet's
    feature-transform regulariser where the forward returns
    `trans_feat`), backward, then the Adam and schedule steps. `draw` gives
    the dropout keep masks (`models.common.generator_draw`)."""

    def train_step(state: TrainState, xyz: torch.Tensor, label: torch.Tensor,
                   draw: Draw | None):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits, aux = model(xyz, draw=draw)
        loss = cross_entropy_loss(logits, label, smoothing)
        if fea_reg_weight > 0.0 and "trans_feat" in aux:
            loss = loss + fea_reg_weight * feature_transform_regularizer(
                aux["trans_feat"])
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        acc = (logits.detach().argmax(-1) == label).float().mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return train_step


def make_eval_step(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval step: [B, N, 3] clouds -> logits [B, num_classes], the
    model in eval mode (running batch-norm statistics, no dropout) and no
    autograd graph. The JAX package's step takes the variables as an
    argument; here they live in the module."""

    def eval_step(xyz: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            logits, _ = model(xyz)
        return logits

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
