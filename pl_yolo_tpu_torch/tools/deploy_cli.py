"""What the deploy tools share: the device they run on (the CUDA card
unless `--device cpu`; without a card they refuse to start), the eager
forward their artifacts are held against, and the bounds of that check."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def device_or_exit(device) -> torch.device:
    """The tool's device; SystemExit without a card unless `device` is
    "cpu". On the card, convs and matmuls run in full fp32 (no TF32), so
    that an fp32 artifact is held to the eager forward at fp32 bounds."""
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (--device cpu)")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def verify_tol(device) -> float:
    """The bound of an fp32 artifact against the eager fp32 forward on
    `device`, as max |a - b| / max(1, |b|): 1e-4 on the CPU (the JAX
    tools' bound), 1e-3 on the card, whose convs sum in another order."""
    return 1e-4 if torch.device(device).type == "cpu" else 1e-3


def random_images(size: int, batch: int = 1, seed: int = 0) -> np.ndarray:
    """NHWC float32 images of uniform 0-255 noise."""
    return np.random.default_rng(seed).uniform(
        0, 255, (batch, size, size, 3)).astype(np.float32)


def eager_predictions(model, images: np.ndarray) -> np.ndarray:
    """The port's eval forward and decode of NHWC 0-255 `images`, on the
    model's device, as numpy [B,A,5+C]."""
    device = next(model.module.parameters()).device
    with torch.no_grad():
        out = model.loss.eval_decode(model.module(
            torch.from_numpy(images).to(device)))
    return out.float().cpu().numpy()


def nchw(images: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(images.transpose(0, 3, 1, 2))
