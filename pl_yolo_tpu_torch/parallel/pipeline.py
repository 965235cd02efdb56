"""GPipe over the pipe group (port of `pl_yolo_tpu/parallel/pipeline.py`).

The JAX package runs the S stages under `shard_map` with one `ppermute` a
tick and `psum`s the last stage's outputs; here each pipe rank runs its own
stage on M microbatches over M + S - 1 ticks, hands each activation to the
next stage by a differentiable send / receive, and the last stage's outputs
reach every pipe rank by a differentiable all-reduce of (outputs on the
last stage, zeros elsewhere), which is the `psum`. Every pipe rank holds
the whole replicated tower and the same input rows (the parts of the model
around the tower run redundantly on each, as under `shard_map`); stage s
applies blocks [s·L/S, (s+1)·L/S).

The backward pass is the same schedule reversed: the all-reduce hands each
pipe rank's output gradient to the last stage (summed over the S ranks, as
`psum`'s transpose does), each receive sends its gradient back. The tower's
gradients then sit on the rank of their stage: summed over the pipe group,
and the redundant parts' gradients divided by S, every rank holds the
single-process gradient (`zero.DataParallel.reduce_grads`).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import collectives
from .mesh import Layout


def pipeline_apply(stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
                   x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Run x [B, ...] through the S = layout.pipe stages, GPipe-style, on
    M = S microbatches (the JAX package's default, which every caller
    there takes).

    stage_fn(s, x_mb) -> y_mb applies stage s; y_mb.shape == x_mb.shape.
    B % S == 0. Returns y [B, ...], the same on every pipe rank."""
    S, s = layout.pipe, layout.pipe_index
    M = S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} % microbatches {M} != 0")
    xs = x.reshape((M, B // M) + x.shape[1:]).unbind(0)
    group, ranks = layout.pipe_group, layout.pipe_ranks
    outs, ties, pending = [], [], []
    for t in range(M + S - 1):
        m = t - s
        if not 0 <= m < M:
            continue
        inp = xs[m] if s == 0 else collectives.recv(xs[m], ranks[s - 1],
                                                    group, m)
        y = stage_fn(s, inp)
        if s < S - 1:
            ties.append(collectives.send(y, ranks[s + 1], group, m, pending))
        else:
            outs.append(y)
    if s == S - 1:
        out = torch.cat(outs)
    else:
        out = torch.zeros_like(x) + torch.stack(ties).sum()
    for work, _buf in pending:
        work.wait()
    return collectives.all_reduce_sum(out, group)


def check_depth(depth: int, stages: int, what: str) -> None:
    """The JAX package's error for a tower that does not split evenly."""
    if depth % stages:
        raise ValueError(
            f"parallel.pipeline={stages} must divide {what} depth {depth}")
