"""Exact top-k values along the last dim (port of `pl_yolo_tpu/ops/topk.py`).

Three branches, as in the JAX package:

* a short row (`a <= block`): `torch.topk`;
* small k (`k <= ITER_K_MAX`, what the losses use): the row top-k kernel
  `ops.cuda.topk.topk_rows` on a CUDA tensor, its plain version on a CPU
  tensor. On the card this branch launches the kernel or raises;
* larger k: the blockwise hierarchy (per-block top-k, then the top-k of the
  survivors).

Values only, descending; the order among ties does not matter to callers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda.topk import topk_plain, topk_rows  # noqa: F401  (re-exported)

ITER_K_MAX = 16  # the kernel's largest k; beyond it the block hierarchy


def topk_lastdim(x: torch.Tensor, k: int, block: int = 64) -> torch.Tensor:
    """Exact top-k values (descending) along the last dim. Returns [..., k]."""
    a = x.shape[-1]
    if a <= block:
        return torch.topk(x, min(k, a), dim=-1).values
    if k <= ITER_K_MAX:
        return topk_rows(x, k)
    if k > block:
        raise ValueError(f"topk_lastdim takes k <= block, got k={k}, "
                         f"block={block}")
    x = F.pad(x, (0, (-a) % block), value=-torch.inf)
    xb = x.reshape(*x.shape[:-1], -1, block)
    tb = torch.topk(xb, k, dim=-1).values
    return torch.topk(tb.flatten(-2), k, dim=-1).values
