"""Mixed-precision victim forwards for the attack loops (port of
`if_defense_tpu/attack/mixed.py`).

The attack's own math (points, Adam state, losses, clips) stays f32; the
victim's trunk runs in bf16 and its classifier head in f32:

  - every floating parameter and buffer is cast to bf16, batch norms
    included, except the head: the `nn.Linear` layers whose output width is
    `num_classes` (no trunk layer of the five victims has that width),
    which take their input cast to f32;
  - the cloud goes in as bf16 and the logits come out f32, so the margins
    between logits are resolved at f32.

The victims' FPS and ball query select on the exact f32 upcast of the bf16
points (`ops.pointops`).
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn


def _head_to_f32(module: nn.Module, args):
    return tuple(a.float() for a in args)


def cast_trunk_bf16(model: nn.Module, num_classes: int) -> nn.Module:
    """A copy of `model` with every floating parameter and buffer in bf16
    but the head's (`nn.Linear` with `num_classes` outputs), whose input is
    cast to f32."""
    mixed = copy.deepcopy(model).to(torch.bfloat16)
    for m in mixed.modules():
        if isinstance(m, nn.Linear) and m.out_features == num_classes:
            m.float()
            m.register_forward_pre_hook(_head_to_f32)
    return mixed


def make_mixed_logits_fn(model: nn.Module, num_classes: int,
                         masked: bool = False) -> Callable:
    """`logits_fn(pc)` (or `(pc, mask)` when `masked`) through the victim's
    bf16 trunk and f32 head; logits come back f32."""
    mixed = cast_trunk_bf16(model, num_classes).eval()

    if masked:
        def logits_fn(pc, mask):
            return mixed(pc.to(torch.bfloat16), mask)[0].float()
    else:
        def logits_fn(pc):
            return mixed(pc.to(torch.bfloat16))[0].float()
    return logits_fn
