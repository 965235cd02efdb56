"""Structured dropout: DropBlock2d and DropPath (stochastic depth), port
of `pl_yolo_tpu/layers/drops.py`.

Each is split into a draw and a pure function of what was drawn:

    keep = draw_drop_path(generator, x, rate)
    y = drop_path(x, keep, rate)
    seeds = draw_drop_block(generator, x, rate, block_size)
    y = drop_block_2d(x, seeds, block_size)

so a test can hand both packages the same random numbers. The modules draw
from their `generator` attribute (torch's default generator of the
activations' device when None); the train step sets it for the duration of
its forward with `dropout_generator`, the counterpart of the JAX step's
'dropout' rng collection. Train mode only; identity in eval. NCHW.
Inside a data-parallel train step (`parallel.mesh.use_layout`) each rank
draws for the global batch and keeps its own rows, and DropBlock's rescale
takes the global batch's mask mean, as the JAX package computes both on
the global batch; on a band of rows (`parallel: {spatial}`) DropBlock
draws the whole map's seeds, grows the blocks on the whole map and keeps
the band's rows, as the JAX package draws and pools the whole map.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import data_layout, data_rows, data_sum, spatial_layout


def draw_drop_path(generator: torch.Generator | None, x: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """[B,1,..,1] bool: True where a sample's branch is kept, P = 1 - rate."""
    b, rows = data_rows(x.shape[0])
    shape = (b,) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=x.device)
    return u[rows] < 1.0 - rate


def drop_path(x: torch.Tensor, keep: torch.Tensor, rate: float
              ) -> torch.Tensor:
    """Zero the dropped samples' branch and rescale the kept by 1/(1-rate)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def drop_block_gamma(rate: float, h: int, w: int, block_size: int) -> float:
    """The seed probability that makes the expected dropped share `rate`."""
    return (rate * h * w / (block_size ** 2)
            / max((h - block_size + 1) * (w - block_size + 1), 1))


def draw_drop_block(generator: torch.Generator | None, x: torch.Tensor,
                    rate: float, block_size: int = 7) -> torch.Tensor:
    """fp32 Bernoulli(gamma) seeds shaped like x [B,C,H,W]; on a band of
    rows (`parallel: {spatial}`), shaped like the whole map of x's rows,
    whose H is the band's times the spatial width."""
    sp = spatial_layout()
    h = x.shape[2] * (1 if sp is None else sp.spatial)
    gamma = drop_block_gamma(rate, h, x.shape[3], block_size)
    b, rows = data_rows(x.shape[0])
    u = torch.rand((b, x.shape[1], h, x.shape[3]), generator=generator,
                   device=x.device)
    return (u[rows] < gamma).to(torch.float32)


def drop_block_2d(x: torch.Tensor, seeds: torch.Tensor, block_size: int = 7
                  ) -> torch.Tensor:
    """DropBlock given its seeds: each seed grows into a block_size² block
    (a stride-1 max pool, `block_size // 2` padding); the kept cells are
    rescaled by the mask's mean over the whole tensor (at least 1e-6). The
    result takes the fp32 of the mask, as the JAX version's does. On a
    band of rows the seeds are the whole map's (`draw_drop_block`): the
    blocks grow on the whole map, the mean is the whole map's, and the
    band keeps its rows of the mask."""
    block = F.max_pool2d(seeds, block_size, stride=1,
                         padding=block_size // 2)
    mask = 1.0 - block
    layout = data_layout()
    mean = (mask.mean() if layout is None
            else data_sum(mask.sum()) / (mask.numel() * layout.data))
    denom = torch.clamp(mean, min=1e-6)
    if mask.shape[2] != x.shape[2]:
        hb = x.shape[2]
        mask = mask.narrow(2, spatial_layout().spatial_index * hb, hb)
    return x * mask / denom


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return drop_path(x, draw_drop_path(self.generator, x, self.rate),
                         self.rate)


class DropBlock2d(nn.Module):
    def __init__(self, rate: float = 0.0, block_size: int = 7):
        super().__init__()
        self.rate = float(rate)
        self.block_size = int(block_size)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        seeds = draw_drop_block(self.generator, x, self.rate,
                                self.block_size)
        return drop_block_2d(x, seeds, self.block_size)


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator: torch.Generator | None):
    """Inside the block, every DropPath / DropBlock2d of `module` draws
    from `generator`; their own setting is back on exit."""
    drops = [m for m in module.modules()
             if isinstance(m, (DropPath, DropBlock2d))]
    before = [m.generator for m in drops]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m, g in zip(drops, before):
            m.generator = g
