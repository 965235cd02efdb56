"""Spatial parallelism (`parallel: {spatial: S}`): each spatial rank holds a
band of the rows of every map, and the windowed ops exchange the rows
their windows reach across a band's edge (port of `sp_constraint` and
`shard_batch`'s H sharding of `pl_yolo_tpu/parallel/mesh.py`; GSPMD inserts
the halo exchanges there).

  * `band`: after the augmentation, spatial rank s keeps rows [s·h/S,
    (s+1)·h/S) of the NHWC images (or of their space-to-depth layout, h =
    H/2). The JAX trainer's check H % (32·S) == 0 keeps every level's bands
    equal and even.
  * `conv_input` / `max_pool`: a conv or a pool fetches the
    rows its window and stride need above and below this band (`halo`):
    `pad` rows above and `k - stride - pad` below, which is one above and
    none below for a 3x3 stride-2 pad-1 conv. At the image's true top and
    bottom the fill is the pad: zero for a conv, -inf for a pool; no rows
    wrap. A halo may reach past the next rank's band (at 64 px and S = 2
    the last level holds one row a rank, and the 13-pool needs six above
    and six below): each rank contributes its top and bottom strips, as
    deep as any rank needs, in one all-gather, and picks the rows it needs
    from every rank's. The backward sends the gradients of the rows read
    back to their owners, summed (`collectives.gather_summed`).
  * A strided pool (ResNet's 3x3 stride-2 pad-1 stem pool) takes its
    halo as a conv does; a VALID pool whose window is its stride
    (E-ELAN's and VGG's 2x2) is local on bands of even rows
    (`models.backbones.eelan.max_pool_stride2`).
  * `band_mean`: a squeeze-excite's mean over the whole map: the band's
    sum all-reduced over the spatial group (not the data group) over the
    whole map's H·W; its backward all-reduces the gradient over the
    spatial group, since each rank's gate multiplies only its own band.
  * Nearest 2x upsampling, concat, 1x1 convs, per-pixel norms and
    space-to-depth are local on a band.
  * `gather_rows`: before the loss each level's head map is gathered along
    H; its backward keeps this rank's rows, unsummed (every spatial rank
    computes the same loss).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import collectives


def band(images: torch.Tensor, layout) -> torch.Tensor:
    """This spatial rank's rows (dim 1) of a [B, h, w, c] batch."""
    h = images.shape[1]
    if h % layout.spatial:
        raise ValueError(f"{h} rows do not split into "
                         f"parallel.spatial={layout.spatial} bands")
    n = h // layout.spatial
    return images[:, layout.spatial_index * n:(layout.spatial_index + 1) * n]


def gather_rows(t: torch.Tensor, dim: int, layout) -> torch.Tensor:
    """The spatial group's bands of t concatenated along `dim`; the
    gradient of this rank's band is its rows of the gradient."""
    return collectives.gather_along(t, dim, layout.spatial_group)


def halo(x: torch.Tensor, above: int, below: int, fill: float, layout
         ) -> torch.Tensor:
    """NCHW band x [B, C, hb, W] with `above` rows of the bands before it
    and `below` rows of the bands after it: [B, C, above + hb + below, W].
    Rows past the image's top or bottom are `fill`."""
    if above == 0 and below == 0:
        return x
    s, n_ranks = layout.spatial_index, layout.spatial
    b, c, hb, w = x.shape
    top, bot = min(below, hb), min(above, hb)
    # each rank's top rows (the below-halo of the rank before) and bottom
    # rows (the above-halo of the rank after), from every rank
    every = collectives.gather_summed(
        torch.cat([x[:, :, :top], x[:, :, hb - bot:]], 2),
        layout.spatial_group)                          # [S, B, C, strip, W]
    rows = every.permute(1, 2, 0, 3, 4).reshape(b, c, -1, w)
    rows = torch.cat([rows, rows.new_full((b, c, 1, w), fill)], 2)
    # (every rank reads `rows`, the fill row at least, so that each runs
    # the exchange's backward: a collective call)
    idx = _halo_index(s, n_ranks, hb, above, below, x.device)
    picked = rows.index_select(2, idx)
    return torch.cat([picked[:, :, :above], x, picked[:, :, above:]], 2)


@functools.lru_cache(maxsize=None)
def _halo_index(s: int, n_ranks: int, hb: int, above: int, below: int,
                device: torch.device) -> torch.Tensor:
    """The rows of `halo`'s gathered strips (and its fill row, last) that
    band s's `above` rows before it and `below` rows after it are."""
    top, bot = min(below, hb), min(above, hb)
    strip = top + bot
    pad = n_ranks * strip                              # the fill row

    def index(g: int) -> int:
        if g < 0 or g >= n_ranks * hb:
            return pad
        r, local = divmod(g, hb)
        # from a band before this one: its bottom strip; after: its top
        return r * strip + (top + local - (hb - bot) if r < s else local)
    return torch.tensor([index(g) for g in range(s * hb - above, s * hb)]
                        + [index(g) for g in range((s + 1) * hb,
                                                   (s + 1) * hb + below)],
                        device=device)


def conv_input(x: torch.Tensor, ksize: int, stride: int, pad: int, layout
               ) -> torch.Tensor:
    """A band with the halo rows a (ksize, stride, pad) conv reaches, zero
    beyond the image; the conv then pads only its columns."""
    return halo(x, pad, max(ksize - stride - pad, 0), 0.0, layout)


def max_pool(x: torch.Tensor, ksize: int, stride: int, pad: int, layout
             ) -> torch.Tensor:
    """A (ksize, stride, pad) max pool of a band (the SPPs' stride-1
    'SAME' pools, ResNet's stride-2 stem pool): the halo rows its window
    reaches, -inf beyond the image (`pad` above, `ksize - stride - pad`
    below), the columns padded as the pool pads them."""
    x = halo(x, pad, max(ksize - stride - pad, 0), float("-inf"), layout)
    return F.max_pool2d(x, ksize, stride=stride, padding=(0, pad))


def band_mean(x: torch.Tensor, layout) -> torch.Tensor:
    """The mean over the whole map's rows and columns of NCHW bands x [B,
    C, hb, W], [B, C, 1, 1] on every spatial rank: the band's sum (in fp32
    at least) all-reduced over the spatial group, over S·hb·W, in x's
    dtype. Its backward all-reduces the gradient over the spatial group:
    each rank's part of it comes from its own band's product."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    total = collectives.all_reduce_sum(
        x.sum((2, 3), keepdim=True, dtype=dtype), layout.spatial_group)
    count = layout.spatial * x.shape[2] * x.shape[3]
    return (total / count).to(x.dtype)
