"""Train state and the train/eval steps (port of
`pl_yolo_tpu/train/state.py`).

    state = TrainState.create(model.module, optimizer)
    step = make_train_step(model.loss.train_loss)
    losses = step(state, images, labels)

The JAX package's step is one pure jitted function over an immutable state;
here the state is mutable and a step updates it in place: the module's
parameters and BatchNorm statistics, the optimizer's moments, the step count
and the EMA copy. The step runs on the device the module lives on and moves
its inputs there.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Callable

import torch
from torch import nn

from .ema import ema_update


@dataclasses.dataclass
class TrainState:
    module: nn.Module                 # the trained module
    optimizer: torch.optim.Optimizer
    step: int                         # updates taken
    ema_module: nn.Module | None      # EMA of params and BN stats, eval mode

    @classmethod
    def create(cls, module: nn.Module, optimizer: torch.optim.Optimizer,
               use_ema: bool = True) -> "TrainState":
        ema = None
        if use_ema:
            ema = copy.deepcopy(module).eval().requires_grad_(False)
        return cls(module=module, optimizer=optimizer, step=0, ema_module=ema)

    @property
    def eval_module(self) -> nn.Module:
        """The module for validation: the EMA copy if there is one."""
        return self.module if self.ema_module is None else self.ema_module

    @property
    def raw_module(self) -> nn.Module:
        return self.module


def _accepts(fn: Callable, name: str) -> bool:
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def make_train_step(
    loss_fn: Callable,
    ema_decay: float = 0.9999,
    use_ema: bool = True,
    augment_fn: Callable | None = None,
    sanitize: bool = False,
    apply_fn: Callable | None = None,
) -> Callable:
    """Build the train step.

    loss_fn(head_outputs, labels[, use_l1=]) -> dict with 'loss' + metrics
    augment_fn(generator, images, labels[, enable=]) -> (images, labels)
    apply_fn(module, images) -> head outputs; default `module(images)`

    The returned `step(state, images, labels, generator=None,
    aug_enable=None, use_l1=None) -> losses` does, in this order: the
    optional augmentation, the train-mode forward (BatchNorm statistics
    move), the loss, the backward pass, the optimizer update, step += 1, and
    the EMA of params and BN stats at the new step count. `images` are
    [B,H,W,3] in 0-255, float or uint8, or whatever `augment_fn` hands to
    `apply_fn` (`data.augment.make_augment_fn(cfg, out_s2d=True)` gives the
    stem's space_to_depth layout, for an `apply_fn` that calls the module
    under `layers.blocks.stem_input_s2d()`). `aug_enable` and `use_l1` are the
    flags of the epoch-gated no-aug schedule (bools or 0/1 tensors), handed
    to `augment_fn`/`loss_fn` only when those accept them. `generator` seeds
    the augmentation. With `sanitize`, the losses also carry `grad_norm`
    (global) and `nonfinite_grads` (element count). The returned losses are
    detached tensors on the device; the step forces no host sync (the
    mosaic warp checks its tile indices on the card, with a device-side
    assert).

    `apply_fn` is the JAX step's, with the module in place of the
    variables (the state holds the module, in train mode). `donate`,
    `constrain_images` and `constrain_state`, which steer jit buffer
    donation and GSPMD sharding, have no counterpart."""
    aug_takes_enable = augment_fn is not None and _accepts(augment_fn, "enable")
    loss_takes_l1 = _accepts(loss_fn, "use_l1")

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None, aug_enable=None,
             use_l1=None) -> dict[str, torch.Tensor]:
        module = state.module
        device = next(module.parameters()).device
        images, labels = images.to(device), labels.to(device)
        if augment_fn is not None:
            if aug_takes_enable and aug_enable is not None:
                images, labels = augment_fn(generator, images, labels,
                                            enable=aug_enable)
            else:
                images, labels = augment_fn(generator, images, labels)
        if not images.is_floating_point():
            images = images.to(torch.float32)

        module.train()
        outputs = module(images) if apply_fn is None else apply_fn(module,
                                                                   images)
        if loss_takes_l1 and use_l1 is not None:
            losses = loss_fn(outputs, labels, use_l1=use_l1)
        else:
            losses = loss_fn(outputs, labels)
        state.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if sanitize:
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            losses["grad_norm"] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            losses["nonfinite_grads"] = torch.stack(
                [(~torch.isfinite(g)).sum() for g in grads]).sum().float()
        state.optimizer.step()
        state.step += 1
        if use_ema and state.ema_module is not None:
            ema_update(state.ema_module, module, state.step, ema_decay)
        return losses

    return step


def make_eval_step(decode_fn: Callable) -> Callable:
    """Eval step `eval_fn(module, images)`: the eval-mode forward and the
    decode (sigmoid/xyxy), without autograd. NMS happens in `postprocess`."""

    @torch.no_grad()
    def eval_fn(module: nn.Module, images: torch.Tensor) -> torch.Tensor:
        device = next(module.parameters()).device
        images = images.to(device)
        if not images.is_floating_point():
            images = images.to(torch.float32)
        return decode_fn(module.eval()(images))

    return eval_fn
