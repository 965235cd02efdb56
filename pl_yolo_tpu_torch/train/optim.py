"""Optimizer factory (port of `pl_yolo_tpu/train/optim.py`), from the model
yaml's `optimizer` section:

    optimizer:
        name: SGD | AdamW | Adam
        learning_rate: 0.01
        momentum: 0.9          # SGD
        nesterov: false        # SGD
        weight_decay: 0.0005   # conv/linear weights only (SGD, AdamW)
        warmup: 0.1            # share of total_steps
        clip_grad_norm: 10.0   # global-norm clip before the update
        accumulate_steps: 4    # optax.MultiSteps: average the gradients of
                               # N micro-steps, one update every N-th

The returned optimizer schedules itself: a step pre-hook clips the gradients
and sets every group's learning rate to `schedule(n)` for update n, counting
from 0 (`optimizer.updates`), as optax counts. Under `accumulate_steps: N`
each `optimizer.step()` is a micro-step (`accumulate_` below); the schedule
then spans `total_steps // N` updates.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..layers.schedules import cosine_warmup_schedule


def _decay_split(module: nn.Module) -> tuple[list, list]:
    """(params that take weight decay, the rest): decay applies to the
    weights of conv and linear layers only (flax leaves named `kernel`);
    biases and BatchNorm weight/bias take none."""
    decay_ids = {id(m.weight) for m in module.modules()
                 if isinstance(m, (nn.modules.conv._ConvNd, nn.Linear))}
    params = [p for p in module.parameters() if p.requires_grad]
    return ([p for p in params if id(p) in decay_ids],
            [p for p in params if id(p) not in decay_ids])


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> None:
    """optax's rule, in place and without a host sync: a global norm below
    `max_norm` leaves the gradients alone, else g <- (g / norm) * max_norm
    (torch's `clip_grad_norm_` scales by max_norm / (norm + 1e-6) instead).
    `norm` is the gradients' global norm where they are shards of it (ZeRO),
    else it is theirs."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.to(torch.promote_types(
                g.dtype, torch.float32))) for g in grads]))
    small = norm < max_norm
    divisor = torch.where(small, 1.0, norm)
    factor = torch.where(small, 1.0, max_norm)
    for g in grads:
        g.div_(divisor.to(g.dtype)).mul_(factor.to(g.dtype))


def build_optimizer(module: nn.Module, opt_cfg: dict, total_steps: int,
                    param_view: Callable | None = None,
                    global_norm: Callable | None = None
                    ) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Create (optimizer over `module`'s parameters, schedule fn) from the
    model-yaml optimizer section. The optimizer lives where the module's
    parameters live. Under ZeRO (`parallel.zero`) it holds `param_view(p)`,
    this rank's shard of each parameter, in the parameters' order, and
    clips by `global_norm()`, the norm of the whole gradient."""
    name = opt_cfg.get("name", "SGD").lower()
    lr = float(opt_cfg.get("learning_rate", 0.01))
    accum = int(opt_cfg.get("accumulate_steps", 1))
    # total_steps counts micro-steps; the schedule counts updates
    total_steps = max(total_steps // accum, 1)
    schedule = cosine_warmup_schedule(
        base_lr=lr,
        warmup_steps=float(opt_cfg.get("warmup", 0.1)) * total_steps,
        max_steps=total_steps)
    wd = float(opt_cfg.get("weight_decay", 0.0))
    clip = float(opt_cfg.get("clip_grad_norm", 0.0))
    decay, no_decay = _decay_split(module)
    if param_view is not None:
        decay = [param_view(p) for p in decay]
        no_decay = [param_view(p) for p in no_decay]
    groups = [{"params": decay, "weight_decay": wd},
              {"params": no_decay, "weight_decay": 0.0}]
    lr0 = schedule(0)
    if name == "sgd":
        optimizer = torch.optim.SGD(
            groups, lr=lr0, momentum=float(opt_cfg.get("momentum", 0.9)),
            nesterov=bool(opt_cfg.get("nesterov", False)))
    elif name == "adamw":
        optimizer = torch.optim.AdamW(groups, lr=lr0)
    elif name == "adam":
        for g in groups:
            g["weight_decay"] = 0.0  # optax.adam takes no weight decay
        optimizer = torch.optim.Adam(groups, lr=lr0)
    else:
        raise ValueError(f"Unsupported optimizer: {opt_cfg.get('name')}")
    optimizer.updates = 0

    def before_step(opt, args, kwargs):
        if clip > 0:
            clip_by_global_norm_(
                [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None], clip,
                None if global_norm is None else global_norm())
        for g in opt.param_groups:
            g["lr"] = schedule(opt.updates)
        opt.updates += 1

    optimizer.register_step_pre_hook(before_step)
    if accum > 1:
        accumulate_(optimizer, accum)
    return optimizer, schedule


def accumulate_(optimizer: torch.optim.Optimizer, every: int) -> None:
    """Make `optimizer.step()` a micro-step of optax.MultiSteps(every_k=
    `every`): it folds the gradients into their running mean (Welford's
    update, acc += (g - acc) / (k + 1), as optax computes it, in
    `state[p]["grad_acc"]`, so a checkpoint carries it) and, on every
    `every`-th call, runs the inner step (clip, decay, momentum, schedule)
    on the mean and zeroes it; the other calls leave the parameters alone.
    `optimizer.mini_step` counts the micro-steps since the last update."""
    inner = optimizer.step
    optimizer.accumulate_steps = every
    optimizer.mini_step = 0

    @torch.no_grad()
    def step(closure=None):
        params = [p for g in optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        accs = []
        for p in params:
            st = optimizer.state[p]
            if "grad_acc" not in st:
                st["grad_acc"] = torch.zeros_like(p)
            accs.append(st["grad_acc"])
        k = optimizer.mini_step
        delta = torch._foreach_sub([p.grad for p in params], accs)
        torch._foreach_div_(delta, float(k + 1))
        torch._foreach_add_(accs, delta)
        if k + 1 < every:
            optimizer.mini_step = k + 1
            return None
        optimizer.mini_step = 0
        for p, a in zip(params, accs):
            p.grad.copy_(a)
        torch._foreach_zero_(accs)
        return inner(closure)

    optimizer.step = step
