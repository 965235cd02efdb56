"""Exponential moving average of a module's state (port of
`pl_yolo_tpu/train/ema.py`): decay ramp d(t) = decay * (1 - exp(-t/2000)),
applied to every floating tensor of the state_dict, parameters and BatchNorm
running statistics alike. The EMA copy is updated in place."""

from __future__ import annotations

import math

import torch
from torch import nn


def _state_tensors(module: nn.Module) -> list[torch.Tensor]:
    """Parameters and buffers in module order: the state_dict's tensors
    without the cost of building the dict, plus any non-persistent scratch
    buffer, which it is harmless to average along."""
    return [*module.parameters(), *module.buffers()]


@torch.no_grad()
def ema_update(ema_module: nn.Module, module: nn.Module, updates: int,
               decay: float = 0.9999) -> None:
    """One EMA step, in place on `ema_module`. `updates` is the
    post-increment step count.

        ema <- d * ema + (1 - d) * new,  d = decay * (1 - exp(-updates/2000))

    Non-float buffers (`num_batches_tracked`) are copied."""
    d = decay * (1.0 - math.exp(-updates / 2000.0))
    ema_f, new_f = [], []
    for e, n in zip(_state_tensors(ema_module), _state_tensors(module)):
        if e.is_floating_point():
            ema_f.append(e)
            new_f.append(n.to(e.dtype))
        else:
            e.copy_(n)
    torch._foreach_mul_(ema_f, d)
    torch._foreach_add_(ema_f, new_f, alpha=1.0 - d)
