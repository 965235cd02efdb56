"""Tensor and expert parallelism: which weights shard, the sharded conv,
and the moves between the one-process module and a rank's shards (port of
`tp_spec`, `ep_spec` and `state_specs` of `pl_yolo_tpu/parallel/mesh.py`,
whose collectives GSPMD inserts there).

  * `parallel: {model: M}`: a 4-D parameter whose JAX last axis the model
    width divides shards along it over the model group, in the torch dim
    the bridge gives that axis: a conv kernel on cout (dim 0), the
    implicit head's [1, C, 1, 1] priors on C (dim 1; [1, 1, 1, C] in
    flax); biases, BatchNorm parameters and statistics replicate. Each
    model rank holds its slice as the parameter, so its optimizer moments
    and its EMA copy are slices too. A module that uses such a parameter
    whole declares the dim (`GATHERED_DIM`) and gathers it where it uses
    it (`whole`).
  * `parallel: {expert: X}`: the MoE FFN's `blocks_moe_w*` / `blocks_moe_b*`
    tensors [L, E, ...] shard on E (dim 1) over the expert group where X
    divides E; the router replicates (see `models.backbones.vit.moe_ffn`).

The sharded conv is Megatron's: the replicated input enters through
`copy_to_group` (its backward all-reduces the input's gradient over the
model group), the local conv runs on the weight slice, and its output
leaves through `gather_along` the channels (its backward keeps this rank's
channels, unsummed: every model rank computes the same loss downstream). A
bias is added after the gather, so that its gradient is whole on every
rank. A conv whose weight holds fewer output channels than the module's
`out_channels` is a sharded one; it runs only inside a train step's layout.
A gathered parameter (`whole`) takes the same gather: its backward keeps
this rank's slice of the gradient, unsummed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from . import collectives
from .mesh import model_layout


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one tensor splits: along `dim` over `group` (of `width` ranks,
    this rank's index `index`): the model group's or the expert group's
    here, the data group's under ZeRO (`parallel.zero`)."""
    dim: int
    group: object
    index: int
    width: int

    def narrow(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor t (a view)."""
        n = t.shape[self.dim] // self.width
        return t.narrow(self.dim, self.index * n, n)


def tp_spec(shape: tuple, model: int, dim: int = 0) -> int | None:
    """The dim a state tensor shards along over the model group: `dim`,
    the torch dim of the JAX leaf's last axis (0, cout, for a conv kernel),
    for a 4-D tensor whose extent there the model width divides, else None
    (replicated), the JAX package's `tp_spec` in torch's layout."""
    if len(shape) == 4 and shape[dim] % model == 0:
        return dim
    return None


def ep_spec(name: str, shape: tuple, expert: int) -> int | None:
    """The dim an MoE expert tensor ([L, E, ...], named `blocks_moe_w*` or
    `blocks_moe_b*`) shards along over the expert group: 1 where the expert
    width divides E, else None (the router and every other tensor
    replicate), the JAX package's `ep_spec`."""
    leaf = name.rsplit(".", 1)[-1]
    if (("moe_w" in leaf or "moe_b" in leaf) and len(shape) >= 2
            and shape[1] % expert == 0):
        return 1
    return None


def _jax_last_dim(owner: nn.Module, leaf: str) -> int:
    """The torch dim of a 4-D parameter that holds its flax leaf's last
    axis (`bridge`'s layouts): cout of a conv kernel, C of a transposed
    conv's [cin, cout, kh, kw] and of the implicit head's priors; a free
    parameter keeps the flax layout."""
    if isinstance(owner, nn.Conv2d) and leaf == "weight":
        return 0
    if isinstance(owner, nn.ConvTranspose2d) and leaf == "weight":
        return 1
    return getattr(owner, "GATHERED_DIM", 3)


def shard_specs(module: nn.Module, layout) -> dict[str, Shard]:
    """{parameter name: its Shard} for the parameters of `module` that the
    layout's model and expert widths shard (the expert rule first, as
    `state_specs` applies it). A conv kernel shards on cout; a grouped
    conv (`depthwise: true`) where the model width divides its groups, so
    that a cout slice holds whole groups. A 4-D parameter of a module
    that gathers it (`GATHERED_DIM`) shards along that dim. Any other
    4-D parameter that the JAX spec shards, and a grouped conv whose
    groups the width does not divide, raise instead of replicating a
    tensor that the JAX spec shards."""
    owners = {id(p): (m, leaf) for m in module.modules()
              for leaf, p in m.named_parameters(recurse=False)}
    specs = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        if layout.expert > 1 and ep_spec(name, shape, layout.expert):
            specs[name] = Shard(1, layout.expert_group,
                                layout.expert_index, layout.expert)
            continue
        if layout.model <= 1 or len(shape) != 4:
            continue
        owner, leaf = owners[id(p)]
        dim = tp_spec(shape, layout.model, _jax_last_dim(owner, leaf))
        if dim is None:
            continue
        conv = isinstance(owner, nn.Conv2d) and leaf == "weight"
        if not (conv or hasattr(owner, "GATHERED_DIM")):
            raise NotImplementedError(
                f"parallel.model={layout.model}: {name} {list(shape)} is "
                "neither a conv kernel nor a parameter its module gathers; "
                "tensor parallelism covers the conv families (ROADMAP "
                "queue A, item 12c)")
        if conv and owner.groups > 1 and owner.groups % layout.model:
            raise NotImplementedError(
                f"parallel.model={layout.model}: {name} is a conv of "
                f"{owner.groups} groups, which the model width does not "
                "divide; a cout slice would cut a group, and the JAX "
                "spec shards it all the same (ROADMAP queue A, item 12c)")
        specs[name] = Shard(dim, layout.model_group, layout.model_index,
                            layout.model)
    return specs


def shard_module(module: nn.Module, specs: dict[str, Shard]) -> None:
    """Replace each sharded parameter of the one-process `module` by this
    rank's slice of it, in place (the parameter objects stay)."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, spec in specs.items():
            p = params[name]
            p.data = spec.narrow(p.data).clone()


def shard_state_dict(sd: dict, specs: dict[str, Shard]) -> dict:
    """A one-process state_dict cut to this rank's slices."""
    return {k: (specs[k].narrow(v).clone() if k in specs else v)
            for k, v in sd.items()}


def whole(p: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """A parameter its module uses whole (`GATHERED_DIM`), of `size`
    elements along `dim` in one process: p itself, or, where this rank
    holds a slice of it, the model group's slices gathered (backward:
    this rank's slice of the gradient, unsummed; every model rank
    computes the same loss)."""
    if p.shape[dim] == size:
        return p
    layout = model_layout()
    if layout is None:
        raise RuntimeError(
            "a parameter sliced over the model group runs only inside a "
            "train step's layout (parallel.mesh.use_layout); gather the "
            "module first (DataParallel.eval_module)")
    return collectives.gather_along(p, dim, layout.model_group)


def is_sharded(conv: nn.Conv2d) -> bool:
    """True when the conv holds a cout slice of its weight."""
    return conv.weight.shape[0] != conv.out_channels


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           stride, padding, dilation, groups: int, layout) -> torch.Tensor:
    """The conv of the replicated input x with a weight whose cout is
    sharded over the layout's model group: copy in, the local conv on the
    slice, the channels gathered, then the bias. A conv of `groups` groups
    holds groups / M whole groups a rank (`shard_specs`), whose input
    channels are this rank's channel slice of x: the local conv reads
    those, in groups / M groups (its input gradient is zero elsewhere, and
    the copy's all-reduce makes it whole)."""
    if layout is None:
        raise RuntimeError(
            "a conv whose cout is sharded over the model group runs only "
            "inside a train step's layout (parallel.mesh.use_layout); "
            "gather the module first (DataParallel.eval_module)")
    x = collectives.copy_to_group(x, layout.model_group)
    if groups > 1:
        n = x.shape[1] // layout.model
        x = x.narrow(1, layout.model_index * n, n)
        groups //= layout.model
    y = F.conv2d(x, weight, None, stride, padding, dilation, groups)
    y = collectives.gather_along(y, 1, layout.model_group)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)
