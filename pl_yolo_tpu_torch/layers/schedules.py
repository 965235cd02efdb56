"""LR schedules (port of `pl_yolo_tpu/layers/schedules.py`)."""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_schedule(base_lr: float, warmup_steps: float,
                           max_steps: int) -> Callable[[int], float]:
    """Cosine decay over `max_steps` with a linear warmup multiplier:
    factor = 0.5*(1+cos(pi*step/max_steps)), multiplied by
    (step + 1e-5)/warmup_steps while step <= warmup_steps. Returns a plain
    function step -> lr (python floats); `lambda n: schedule(n) / base_lr`
    is a `LambdaLR` factor."""
    warmup_steps = max(float(warmup_steps), 1e-8)

    def schedule(step: int) -> float:
        step = float(step)
        factor = 0.5 * (1.0 + math.cos(math.pi * step / max_steps))
        if step <= warmup_steps:
            factor *= (step + 1e-5) / warmup_steps
        return base_lr * factor

    return schedule
