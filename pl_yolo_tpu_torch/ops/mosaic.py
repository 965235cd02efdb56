"""Mosaic and mixup sampling from a channel-major pool (port of
`pl_yolo_tpu/ops/pallas/mosaic_pallas.py`'s entries).

Both entries run `ops.cuda.mosaic_warp.mosaic_warp`: the hand-written
kernel on a CUDA tensor, its plain version on a CPU tensor. The TPU
kernel's block choices have no counterpart here.
"""

from __future__ import annotations

import torch

from .cuda.mosaic_warp import mosaic_warp

FILL = 114.0


def to_chw(imgs: torch.Tensor) -> torch.Tensor:
    """[N,H,W,3] -> contiguous channel-major pool [N,3,H,W]."""
    return imgs.permute(0, 3, 1, 2).contiguous()


def from_chw(imgs: torch.Tensor) -> torch.Tensor:
    """[N,3,H,W] -> [N,H,W,3] (a view; channels-last in memory)."""
    return imgs.permute(0, 2, 3, 1)


def mosaic_sample_idx(pool: torch.Tensor, tidx: torch.Tensor,
                      oxw: torch.Tensor, oyw: torch.Tensor,
                      xs_raw: torch.Tensor, ys_raw: torch.Tensor
                      ) -> torch.Tensor:
    """Mosaic sampling: pool [N,3,H,W], tidx [B,4] rows into the pool (the
    image itself + 3 partners), oxw/oyw [B,4] tile origins and xs_raw [B,W]
    / ys_raw [B,H] source coordinates in the 2H x 2W window. Where no tile
    covers, the fill is 114. Returns [B,3,H,W] in the pool's dtype."""
    _, _, h, w = pool.shape
    return mosaic_warp(pool, tidx, oxw, oyw, xs_raw, ys_raw, hix=2 * w,
                       hiy=2 * h, fill=FILL)


def warp_sample_idx(pool: torch.Tensor, idx: torch.Tensor,
                    xs_raw: torch.Tensor, ys_raw: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Single-image separable warp by index (the mixup partner): idx [B]
    rows into pool [N,3,H,W], coordinates valid on [0, W-1] / [0, H-1],
    `fill` outside. Returns [B,3,H,W] in the pool's dtype."""
    _, _, h, w = pool.shape
    return mosaic_warp(pool, idx[:, None], None, None, xs_raw, ys_raw,
                       hix=w, hiy=h, fill=fill)
