"""Model summary: parameters and FLOPs an image (port of
`pl_yolo_tpu/utils/flops.py`, which reads XLA's cost analysis of the
compiled eval forward). Here `torch.utils.flop_counter.FlopCounterMode`
counts the eval forward's operations (a multiply-add is 2 FLOPs)."""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def model_summary(module: nn.Module, input_size=(640, 640),
                  batch_size: int = 1):
    """Returns (num_params, flops_per_image, text). Runs one eval-mode
    forward of zeros on the module's device; the module's train/eval mode is
    restored after."""
    n_params = sum(p.numel() for p in module.parameters())
    device = next(module.parameters()).device
    dummy = torch.zeros((batch_size, input_size[0], input_size[1], 3),
                        device=device)
    was_training = module.training
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), counter:
            module.eval()(dummy)
    finally:
        module.train(was_training)
    flops = counter.get_total_flops() / batch_size

    txt = f"Params: {n_params / 1e6:.2f}M"
    txt += f", FLOPs: {flops / 1e9:.2f}G @ {input_size[0]}x{input_size[1]}"
    return n_params, flops, txt
