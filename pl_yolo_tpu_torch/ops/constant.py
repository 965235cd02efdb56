"""Small constant tensors (anchor tables, level sizes) cached per device."""

from __future__ import annotations

import functools

import torch


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor (anchor tables, level sizes) on `device`,
    made once and never written: a tensor built from Python numbers on the
    card is a blocking copy, which would make every loss call a host
    sync. It is made outside inference mode, so that it is a normal tensor
    whichever context asks for it first, and autograd may save it."""
    def frozen(v):
        return tuple(map(frozen, v)) if isinstance(v, (list, tuple)) else v
    return _constant(frozen(values), dtype, torch.device(device))


@functools.lru_cache(maxsize=256)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def array_constant(make, *args, device) -> torch.Tensor:
    """`torch.from_numpy(make(*args))` on `device`, made once for each
    (make, args, device) and never written (masks and index tables of a
    layer, from the map size it meets); see `constant`."""
    return _array_constant(make, args, torch.device(device))


@functools.lru_cache(maxsize=256)
def _array_constant(make, args: tuple, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)
