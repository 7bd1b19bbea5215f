"""Victim evaluation (port of the eval half of `if_defense_tpu/training.py`;
the train step is still to be ported)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


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
