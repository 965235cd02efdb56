"""The world in the five axes of `make_mesh`, the ZeRO rules, and the
ambient layout of a train step (port of the data / model / spatial / pipe /
expert / ZeRO part of `pl_yolo_tpu/parallel/mesh.py`).

`Layout(data, pipe, model=, spatial=, expert=)` lays the world out
rank-major, as `make_mesh` lays out its (data, model, spatial, pipe,
expert) devices: rank = (((d·M + m)·S + s)·P + p)·E + e. Each axis has a
group: the ranks that differ in that index alone (`data_group`: they hold
different rows of the batch; `model_group`: different cout slices of the
sharded convs; `spatial_group`: different bands of rows of every map;
`pipe_group`: the stages of one GPipe; `expert_group`: different experts of
each MoE layer). The norm group holds the ranks that differ in data or
spatial index: BatchNorm's (B, H, W) reductions and the gradients run over
it.

The step activates its layout around the augmentation, the forward and the
loss (`use_layout`), the same idiom as `use_pipeline_mesh` and
`set_compute_dtype`: modules deep in the model read it instead of taking it
as an argument.

  * `BatchNorm2d` in train mode normalises over the norm group's rows and
    bands (`global_batch_norm`): each rank's per-channel mean, sum of
    squared deviations and count, gathered in one differentiable call and
    combined exactly (Chan's parallel variance), as stable as one
    process's two-pass variance.
  * The losses divide their partial sums by global counts (`data_sum`,
    `batch_mean`, `global_batch`, over the data group: the loss is
    replicated over the model, spatial and expert ranks): each rank's loss
    is its share of the loss of the global batch, so the gradients are
    summed, not averaged.
  * The augmentation draws for the global batch and warps its data rank's
    rows (`data_rows`); so do DropBlock and DropPath.
  * The convs shard their cout over the model group (`parallel.tensor`),
    the maps their rows over the spatial group (`parallel.spatial`), the
    MoE FFN its experts over the expert group
    (`models.backbones.vit.moe_ffn`).
  * The ViT and MCTformer towers run as a GPipe over the pipe group.

Outside the context, or with every width 1, every helper here is the
identity and every path is the single-process one, bit for bit.

ZeRO (`parallel: {zero: true|3}`, `zero_spec`): level 1 shards the
optimizer moments, the accumulation buffer and the EMA copy over the data
group, level 3 the parameters too; a tensor shards along its first dim
that the data width divides and that no model or expert slice takes, and
stays replicated where there is none. BatchNorm statistics stay
replicated.
"""

from __future__ import annotations

import contextlib
import itertools

import torch
import torch.distributed as dist

from . import collectives

AXES = ("data", "model", "spatial", "pipe", "expert")


class Layout:
    """The world as `data` x `model` x `spatial` x `pipe` x `expert`
    process groups (`pipe` is the second positional argument, as before the
    other axes came). Every rank must build it, in the same order, since it
    creates the groups (`new_group` is a collective call). `<axis>_group`
    and `norm_group` are this rank's; the `*_ranks` lists hold their global
    ranks, in the order of the axis's index; `<axis>_index` is this rank's
    index along each axis."""

    def __init__(self, data: int, pipe: int = 1, *, model: int = 1,
                 spatial: int = 1, expert: int = 1):
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        sizes = {"data": data, "model": model, "spatial": spatial,
                 "pipe": pipe, "expert": expert}
        if data * model * spatial * pipe * expert != world:
            raise ValueError(
                f"layout {data}x{model}x{spatial}x{pipe}x{expert} (data x "
                f"model x spatial x pipe x expert) != {world} processes")
        self.data, self.model, self.spatial = data, model, spatial
        self.pipe, self.expert = pipe, expert
        self.rank, self.world = rank, world
        index, rest = {}, rank
        for axis in reversed(AXES):
            rest, index[axis] = divmod(rest, sizes[axis])
        self.index = index
        for axis in AXES:
            setattr(self, f"{axis}_index", index[axis])
        # one process: the default group (None), of rank 0 alone
        for axis in AXES + ("norm",):
            setattr(self, f"{axis}_group", None)
            setattr(self, f"{axis}_ranks", [rank])
        if world == 1:
            return

        def rank_of(ix: dict) -> int:
            r = 0
            for axis in AXES:
                r = r * sizes[axis] + ix[axis]
            return r

        def build(name: str, varying: tuple) -> None:
            """One group for each index of the other axes: the ranks that
            differ in the `varying` axes alone."""
            fixed = [a for a in AXES if a not in varying]
            for rest_ix in itertools.product(*(range(sizes[a])
                                               for a in fixed)):
                base = dict(zip(fixed, rest_ix))
                ranks = [rank_of({**base, **dict(zip(varying, v))})
                         for v in itertools.product(*(range(sizes[a])
                                                      for a in varying))]
                group = dist.new_group(ranks)
                if all(index[a] == base[a] for a in fixed):
                    setattr(self, f"{name}_group", group)
                    setattr(self, f"{name}_ranks", ranks)
        for axis in AXES:
            build(axis, (axis,))
        build("norm", ("data", "spatial"))

    @property
    def world_group(self):
        return dist.group.WORLD


# ----------------------------------------------------------------- ZeRO

def zero_spec(kind: str, shape: tuple, data_size: int, level: int,
              taken: int | None = None) -> int | None:
    """The dim a tensor of ZeRO state shards along over the data group, or
    None (replicated). `kind` is "opt_state" (moments, the accumulation
    buffer), "ema" (the EMA copy of params and BN statistics), "params" or
    "batch_stats". Level 1 shards "opt_state" and "ema"; level 3 also
    "params". A tensor shards along its first dim that the data width
    divides, other than `taken`, the dim a model or expert slice takes (any
    tensor, at a width of 1, as the JAX rule does: one shard). The JAX
    rule takes the first such axis of its own layout, so that the tensors
    it shards are these, along another dim where the layouts differ."""
    roots = (("opt_state", "ema", "params") if level >= 3
             else ("opt_state", "ema"))
    if level <= 0 or kind not in roots:
        return None
    for dim, n in enumerate(shape):
        if dim != taken and n > 0 and n % data_size == 0:
            return dim
    return None


# ------------------------------------------------------- the ambient layout

_LAYOUT: list = [None]


class use_layout(contextlib.ContextDecorator):
    """Inside, the helpers below and the modules that call them read
    `layout`; a layout with one rank, or None, leaves the single-process
    path."""

    def __init__(self, layout: Layout | None):
        if layout is not None and layout.world <= 1:
            layout = None
        self._layout = layout

    def __enter__(self):
        self._prev = _LAYOUT[0]
        _LAYOUT[0] = self._layout
        return self

    def __exit__(self, *exc):
        _LAYOUT[0] = self._prev
        return False


def current_layout() -> Layout | None:
    """The ambient layout (None outside a step's, or in one process), for
    a context that must run again under it later (the recompute of a
    checkpointed layer, `layers.blocks.maybe_checkpoint`)."""
    return _LAYOUT[0]


def data_layout() -> Layout | None:
    """The ambient layout if its data width is above 1, else None."""
    layout = _LAYOUT[0]
    return layout if layout is not None and layout.data > 1 else None


def _wide(axis: str) -> Layout | None:
    # (a layout that names no width for the axis has width 1 there)
    layout = _LAYOUT[0]
    return (layout if layout is not None and getattr(layout, axis, 1) > 1
            else None)


def pipe_layout() -> Layout | None:
    """The ambient layout if its pipe width is above 1, else None."""
    return _wide("pipe")


def model_layout() -> Layout | None:
    """The ambient layout if its model (tensor-parallel) width is above 1,
    else None."""
    return _wide("model")


def spatial_layout() -> Layout | None:
    """The ambient layout if its spatial width is above 1, else None."""
    return _wide("spatial")


def expert_layout() -> Layout | None:
    """The ambient layout if its expert width is above 1, else None."""
    return _wide("expert")


def norm_layout() -> Layout | None:
    """The ambient layout if its norm group (data x spatial) holds more
    than one rank, else None."""
    layout = _LAYOUT[0]
    if layout is None:
        return None
    return layout if layout.data * layout.spatial > 1 else None


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the data group (detached: a count or a normaliser);
    t itself outside a data-parallel step."""
    layout = data_layout()
    if layout is None:
        return t
    out = t.detach().clone()
    return collectives.all_reduce_(out, layout.data_group)


def global_batch(b: int) -> int:
    """The global batch of a rank that holds `b` rows (every data rank
    holds as many)."""
    layout = data_layout()
    return b if layout is None else b * layout.data


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """t.mean() over the global batch, as this rank's share: the sum of its
    elements over the global element count (t.mean() outside a
    data-parallel step)."""
    layout = data_layout()
    if layout is None:
        return t.mean()
    return t.sum() / (t.numel() * layout.data)


def data_rows(b: int) -> tuple[int, slice]:
    """(the global batch, this rank's rows of it) for a rank holding `b`
    rows: data rank d holds rows [d·b, (d+1)·b)."""
    layout = data_layout()
    if layout is None:
        return b, slice(0, b)
    start = layout.data_index * b
    return b * layout.data, slice(start, start + b)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The data group's rows of t, concatenated in data-rank order (t
    itself outside a data-parallel step)."""
    layout = data_layout()
    if layout is None:
        return t
    return collectives.all_gather_dim0(t, layout.data_group)


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float, layout: Layout
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of NCHW x over the norm group's rows and bands
    (data x spatial): each rank's per-channel mean m_r, sum of squared
    deviations from it M_r (two passes) and count n_r, gathered in one
    differentiable call (`collectives.gather_summed`: the gradient of a
    rank's statistics sums every rank's), combined as mean = Σ n_r·m_r / N
    and biased var = Σ (M_r + n_r·(m_r - mean)²) / N (Chan's parallel
    variance: the function of one process's statistics, without the
    cancellation of E[x²] - E[x]², which rounding in fp32 turns into ~1e-3
    of a squeeze-excite's [B, C, 1, 1] map, whose few values a channel lie
    close together); y = (x - mean)·rsqrt(var + eps)·weight + bias in fp32
    (float64 for a float64 x), cast back to x's dtype. Returns (y, mean,
    var), the statistics detached."""
    c = x.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = [d for d in range(x.ndim) if d != 1]
    shape = (1, c) + (1,) * (x.ndim - 2)
    # (torch's two passes, whose backward keeps no centred copy of x)
    local_var, local_mean = torch.var_mean(xf, dims, correction=0)
    count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
    local_m2 = local_var * count
    every = collectives.gather_summed(
        torch.cat([local_mean, local_m2, count]), layout.norm_group)
    counts = every[:, 2 * c:]                          # [R, 1]
    n = counts.sum()
    mean = (every[:, :c] * counts).sum(0) / n
    var = (every[:, c:2 * c]
           + counts * (every[:, :c] - mean).square()).sum(0) / n
    scale = torch.rsqrt(var + eps) * weight.to(xf.dtype)
    y = (xf - mean.reshape(shape)) * scale.reshape(shape) \
        + bias.to(xf.dtype).reshape(shape)
    return y.to(x.dtype), mean.detach(), var.detach()
