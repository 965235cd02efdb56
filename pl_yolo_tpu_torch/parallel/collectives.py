"""The collectives of the parallel paths, over a `torch.distributed` group.

NCCL takes CUDA tensors for every op here. gloo takes CUDA tensors for
`all_reduce` and `broadcast` only; for the other ops a CUDA tensor is
staged: copied to host memory, sent through the CPU op, and copied back.
That is transport only: the models, losses and kernels stay on the card.
`STAGED` counts the staged calls by op, so that a run can print what went
through the host. A reduce-scatter on gloo is an all-reduce of the whole
tensor and a slice of it (counted under "reduce_scatter (all_reduce)").

`all_reduce_sum` is differentiable: its gradient is the all-reduced sum of
the gradients, so that a quantity computed on the global batch (BatchNorm's
statistics, GPipe's broadcast of the last stage) back-propagates to every
rank's own rows. `send` / `recv` are GPipe's differentiable hand-over of an
activation to the next stage; the gradient goes back the other way, matched
by its tag (the microbatch).

The tensor, spatial and expert paths add four differentiable ops, Megatron's
pattern written out:

  * `copy_to_group`: the identity; its backward all-reduces the gradient
    (each rank's part of a replicated input's gradient is partial);
  * `reduce_from_group`: an all-reduce; its backward is the identity (every
    rank computes the same loss downstream);
  * `gather_along`: the ranks' slices concatenated along a dim; its backward
    slices out this rank's part of the gradient, with no sum (every rank
    computes the same loss downstream: a sum would give the group's width
    times the gradient);
  * `gather_summed`: the ranks' t stacked along a new dim 0; its backward
    sums each rank's gradient of every copy and keeps this rank's (a
    reduce-scatter: the halo rows that other ranks read send their
    gradients back to their owner).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# op -> the number of calls staged through host memory
STAGED: collections.Counter = collections.Counter()


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _stage(op: str, t: torch.Tensor, group) -> bool:
    """True when `op` on `t` must go through host memory (gloo, CUDA)."""
    if t.is_cuda and _gloo(group):
        STAGED[op] += 1
        return True
    return False


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group`."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' t [k, ...] concatenated along dim 0, in rank order (on
    gloo gathered into the rows of one host buffer, copied to t's device
    at once)."""
    n, k = group_size(group), t.shape[0]
    if _stage("all_gather", t, group) or _gloo(group):
        out = torch.empty((k * n,) + t.shape[1:], dtype=t.dtype)
        dist.all_gather([out[i * k:(i + 1) * k] for i in range(n)],
                        t.cpu().contiguous(), group=group)
        return out.to(t.device)
    out = t.new_empty((k * n,) + t.shape[1:])
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk along dim 0 of the sum of the ranks' t."""
    n, r = group_size(group), group_rank(group)
    k = t.shape[0] // n
    if _gloo(group):
        STAGED["reduce_scatter (all_reduce)"] += 1
        s = t.clone()
        dist.all_reduce(s, group=group)
        return s.narrow(0, r * k, k).clone()
    out = t.new_empty((k,) + t.shape[1:])
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def _by_dtype(tensors: list) -> dict:
    """{dtype: [(index, tensor)]} in the list's order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append((i, t))
    return groups


def all_reduce_many_(tensors: list, group) -> None:
    """In place, each tensor summed over `group`: one all-reduce of a flat
    buffer for each dtype, as DDP buckets its gradients."""
    for items in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for _, t in items])
        dist.all_reduce(flat, group=group)
        offset = 0
        for _, t in items:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_many_(tensors: list, src: int, group) -> None:
    """In place, each tensor takes global rank `src`'s value: one
    broadcast of a flat buffer for each dtype."""
    for items in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for _, t in items])
        dist.broadcast(flat, src, group=group)
        offset = 0
        for _, t in items:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather_many(shards: list, group) -> list:
    """For each shard [k, ...], the ranks' shards concatenated along dim 0
    in rank order: one all-gather of a flat buffer for each dtype."""
    n = group_size(group)
    out = [None] * len(shards)
    for items in _by_dtype(shards).values():
        flat = torch.cat([t.reshape(-1) for _, t in items])
        every = all_gather_dim0(flat, group).view(n, -1)
        offset = 0
        for i, t in items:
            piece = every[:, offset:offset + t.numel()]
            out[i] = piece.reshape((n * t.shape[0],) + t.shape[1:])
            offset += t.numel()
    return out


def reduce_scatter_many(tensors: list, group) -> list:
    """For each t [n·k, ...], this rank's chunk along dim 0 of the ranks'
    sum: one reduce-scatter of a flat, rank-major buffer for each dtype."""
    n = group_size(group)
    out = [None] * len(tensors)
    for items in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(n, -1) for _, t in items], dim=1)
        own = reduce_scatter_dim0(flat.reshape(-1), group)
        offset = 0
        for i, t in items:
            size = t.numel() // n
            out[i] = own[offset:offset + size].view(
                (t.shape[0] // n,) + t.shape[1:])
            offset += size
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' t, differentiable (its gradient: the sum of the
    ranks' gradients)."""
    return _AllReduceSum.apply(t, group)


def _send(t: torch.Tensor, dst: int, group, tag: int):
    """Start sending t to global rank dst; returns (work, the buffer sent),
    the buffer kept alive until the work completes."""
    buf = t.detach().cpu().contiguous() if _stage("send", t, group) \
        else t.detach().contiguous()
    return dist.isend(buf, dst, group=group, tag=tag), buf


def _recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    """Receive a tensor shaped like `like` from global rank src."""
    if _stage("recv", like, group):
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src, group=group, tag=tag)
        return buf.to(like.device)
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(buf, src, group=group, tag=tag)
    return buf


class _Send(torch.autograd.Function):
    """Forward: send y to the next stage, return a 0-d zero to tie into the
    graph. Backward: receive y's gradient from that stage."""

    @staticmethod
    def forward(ctx, y, dst, group, tag, pending):
        ctx.like, ctx.dst, ctx.group, ctx.tag = (
            torch.empty_like(y), dst, group, tag)
        pending.append(_send(y, dst, group, tag))
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _grad):
        return _recv(ctx.like, ctx.dst, ctx.group, ctx.tag), None, None, \
            None, None


class _Recv(torch.autograd.Function):
    """Forward: receive the previous stage's activation (shaped like
    `like`, which only anchors the op in the graph). Backward: send the
    activation's gradient back to that stage."""

    @staticmethod
    def forward(ctx, like, src, group, tag):
        ctx.src, ctx.group, ctx.tag = src, group, tag
        return _recv(like, src, group, tag)

    @staticmethod
    def backward(ctx, grad):
        work, _buf = _send(grad, ctx.src, ctx.group, ctx.tag)
        work.wait()
        return torch.zeros_like(grad), None, None, None


def send(y: torch.Tensor, dst: int, group, tag: int, pending: list
         ) -> torch.Tensor:
    """Differentiable send of y to global rank dst: returns a 0-d zero that
    the caller adds into its output, so that the backward pass receives
    y's gradient from dst. The send's (work, buffer) goes to `pending`;
    wait on each before the step ends."""
    return _Send.apply(y, dst, group, tag, pending)


def recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    """Differentiable receive from global rank src of a tensor shaped like
    `like`; the backward pass sends its gradient back to src."""
    return _Recv.apply(like, src, group, tag)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """t itself; its gradient is the sum of the group's gradients."""
    return _CopyToGroup.apply(t, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's t; its gradient passes through unchanged."""
    return _ReduceFromGroup.apply(t, group)


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.rank = group_rank(group)
        every = all_gather_dim0(t[None], group)           # [n, ...]
        return every.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, \
            None


def gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of a tensor concatenated along `dim`, in rank
    order; the gradient of this rank's slice is its part of the gradient,
    not summed over the group."""
    return _GatherAlong.apply(t, dim, group)


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_dim0(t[None], group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim0(grad, ctx.group)[0], None


def gather_summed(t: torch.Tensor, group) -> torch.Tensor:
    """The group's t stacked along a new dim 0, in rank order; the gradient
    of this rank's t is the sum over the group of the gradients of its
    copy."""
    return _GatherSummed.apply(t, group)
