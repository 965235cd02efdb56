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

Several processes train one model through a `parallel.zero.DataParallel`
engine in the state (`TrainState.parallel`): the step then runs under its
layout (global BatchNorm, losses and augmentation, cout-sharded convs,
bands of rows with their halos, sharded experts, GPipe towers; see
`parallel.mesh`), reduces the gradients over the norm group, and under
ZeRO updates its shards of the parameters and of the EMA only. Under a
spatial width above 1 each rank keeps its band of the augmented images,
and the head maps are gathered along H before the loss. Without an engine
the step is the single-process one.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Callable

import torch
from torch import nn

from ..layers.drops import dropout_generator
from ..parallel import spatial
from ..parallel.mesh import spatial_layout, use_layout
from .ema import ema_update


@dataclasses.dataclass
class TrainState:
    module: nn.Module                 # the trained module
    optimizer: torch.optim.Optimizer
    step: int                         # updates taken
    ema_module: nn.Module | None      # EMA of params and BN stats, eval mode
    # the data-parallel engine of a multi-process run (parallel.zero); under
    # ZeRO, tensor or expert parallelism it keeps the EMA as this rank's
    # parts, and ema_module is None
    parallel: object | None = None

    @classmethod
    def create(cls, module: nn.Module, optimizer: torch.optim.Optimizer,
               use_ema: bool = True, parallel=None) -> "TrainState":
        ema = None
        if use_ema and (parallel is None or not parallel.sliced):
            ema = copy.deepcopy(module).eval().requires_grad_(False)
        if parallel is not None:
            parallel.attach(optimizer)
        return cls(module=module, optimizer=optimizer, step=0,
                   ema_module=ema, parallel=parallel)

    @property
    def sharded_ema(self) -> bool:
        """True when the EMA copy lives as parts in the engine (ZeRO,
        tensor or expert parallelism)."""
        return (self.parallel is not None
                and self.parallel.ema_entries is not None)

    @property
    def eval_module(self) -> nn.Module:
        """The module for validation: the EMA copy if there is one (under
        ZeRO, or tensor or expert parallelism, gathered from its slices: a
        collective call)."""
        if self.parallel is not None and self.parallel.sliced:
            return self.parallel.eval_module()
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
    move; DropBlock / DropPath layers draw from `generator` too), the loss,
    the backward pass, the optimizer update, step += 1, and the EMA of
    params and BN stats at the new step count. Under `optimizer:
    {accumulate_steps: N}` (`train.optim.accumulate_`) a step is a
    micro-step, as under optax.MultiSteps: the parameters change on every
    N-th only, while the BN statistics, `step` and the EMA move on each.
    `images` are [B,H,W,3] in 0-255, float or uint8, or whatever
    `augment_fn` hands to `apply_fn` (`data.augment.make_augment_fn(cfg,
    out_s2d=True)` gives the stem's space_to_depth layout, for an
    `apply_fn` that calls the module under
    `layers.blocks.stem_input_s2d()`). `aug_enable` and `use_l1` are the
    flags of the epoch-gated no-aug schedule (bools or 0/1 tensors), handed
    to `augment_fn`/`loss_fn` only when those accept them. `generator` seeds
    the augmentation and the dropout layers. With `sanitize`, the losses
    also carry `grad_norm` (global) and `nonfinite_grads` (element count).
    The returned losses are detached tensors on the device; the step forces
    no host sync (the mosaic warp checks its tile indices on the card, with
    a device-side assert).

    `apply_fn` is the JAX step's, with the module in place of the
    variables (the state holds the module, in train mode). `donate`,
    `constrain_images` and `constrain_state`, which steer jit buffer
    donation and GSPMD sharding, have no counterpart."""
    aug_takes_enable = augment_fn is not None and _accepts(augment_fn, "enable")
    loss_takes_l1 = _accepts(loss_fn, "use_l1")

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None, aug_enable=None,
             use_l1=None) -> dict[str, torch.Tensor]:
        par = state.parallel
        if par is None:
            return one_step(state, images, labels, generator, aug_enable,
                            use_l1)
        with use_layout(par.layout):
            return one_step(state, images, labels, generator, aug_enable,
                            use_l1)

    def one_step(state, images, labels, generator, aug_enable, use_l1):
        module, par = state.module, state.parallel
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
        sp = spatial_layout()
        if sp is not None:
            images = spatial.band(images, sp)

        module.train()
        if par is not None:
            par.before_forward()
        with dropout_generator(module, generator):
            outputs = (module(images) if apply_fn is None
                       else apply_fn(module, images))
        if sp is not None:
            outputs = [spatial.gather_rows(o, 1, sp) for o in outputs]
        if loss_takes_l1 and use_l1 is not None:
            losses = loss_fn(outputs, labels, use_l1=use_l1)
        else:
            losses = loss_fn(outputs, labels)
        state.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if par is not None:
            par.reduce_grads()
            losses = par.sum_losses(losses)
        if sanitize and par is not None and par.sliced:
            losses["grad_norm"], losses["nonfinite_grads"] = \
                par.grad_health()
        elif sanitize:
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            losses["grad_norm"] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            losses["nonfinite_grads"] = torch.stack(
                [(~torch.isfinite(g)).sum() for g in grads]).sum().float()
        state.optimizer.step()
        if par is not None:
            par.after_update()
        state.step += 1
        if use_ema and state.sharded_ema:
            par.ema_update(state.step, ema_decay)
        elif use_ema and state.ema_module is not None:
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
