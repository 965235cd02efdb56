"""The data-parallel engine of a train step: gradient reduction, and the
sharded optimizer and EMA of ZeRO-1 / ZeRO-3 (port of `zero_spec`,
`state_specs`, `shard_tp(zero=)` and `zero_constraint` of
`pl_yolo_tpu/parallel/mesh.py`, which GSPMD carries out there).

Hand-written collectives, not `torch.distributed.fsdp`: the JAX layout is a
per-tensor rule (dim 0 over the data group where it divides, the rest
replicated) and the update is the port's own optimizer with its clip,
schedule and `accumulate_steps` wrapper, which FSDP's flat parameters would
have to be taught; with one all-gather or reduce-scatter a tensor, the
state keeps the single-process layout of each tensor, so that a checkpoint
is gathered and re-sharded tensor by tensor.

  * level 0 (plain data parallelism): the gradients are summed over the
    data group; each rank's loss is its share of the global batch's
    (`parallel.mesh`). Under a pipe width S > 1 they are summed over the
    whole world and divided by S (`parallel.pipeline`).
  * level 1 (`parallel: {zero: true}`): each sharded gradient is
    reduce-scattered (this rank's shard of the sum), the others summed as
    at level 0; each rank updates its shard of each sharded parameter (its
    optimizer holds views of those shards, so the moments and the
    `accumulate_steps` buffer are shard-sized), then the new parameters
    are all-gathered. The EMA copy is kept as shards.
  * level 3 (`parallel: {zero: 3}`): the parameters are shards at rest too:
    one all-gather of each before the forward, a reduce-scatter of its
    gradient after the backward, and the full tensors released again.

Every update is elementwise (SGD, AdamW; weight decay on conv / linear
weights only), so any partition gives the single-process numbers. The
global norm of `clip_grad_norm` is an all-reduce of the shards' squared
sums plus the replicated tensors' own.

Under a model or expert width above 1 (`parallel.tensor`) the engine cuts
the module's sharded convs and experts to this rank's slices when it is
built; the optimizer, its moments and the EMA copy then hold slices. A
ZeRO shard and a model or expert slice are both parts here (a
`tensor.Shard`: a dim, a group, this rank's index, the group's width),
and a tensor may hold both: under ZeRO with these axes its model (or
expert) slice is cut first, and ZeRO then shards the slice over the data
group along another dim (`zero_spec`'s `taken`), as the JAX rule shards a
leaf over 'data' on an axis the 'model' or 'expert' spec leaves free. The
module holds the slice (at level 3 gathered over the data group before
each forward); the optimizer and the EMA hold the slice's data part. The
EMA, the gathers, the byte counts and the state_dict moves take one path
for every kind of part. Each gradient is summed over the ranks that hold
the same tensor and saw other rows or bands: the norm group (data x
spatial), for the replicated tensors (the model and expert ranks already
hold their whole gradient) and the slices alike; a ZeRO part's gradient is
reduce-scattered over the data group and then summed over the spatial
group. The clip's global norm counts each part once: its squares summed
over its groups (data, and model or expert), never over the spatial
replicas. `eval_module()`, the checkpoint's state_dicts and their loads
gather both levels to, or cut them from, the one-process format. ZeRO with
a pipe width above 1 is not ported (ROADMAP queue A, item 12c).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from . import collectives, tensor
from .mesh import Layout, zero_spec


@dataclasses.dataclass
class _Entry:
    """One tensor of the module (`name`) and the parts of it this rank
    holds. `tp`: the model or expert slice (tensor or expert parallelism),
    which the module's tensor is. `zero`: this rank's ZeRO part of the
    module's tensor (of its slice, where there is one) over the data
    group; the module keeps that tensor whole (at level 3 gathered before
    each forward). `own`: a part with storage of its own (the level-3
    master shard of a parameter, the EMA copy's part)."""
    name: str
    tensor: torch.Tensor          # the module's parameter or buffer
    tp: tensor.Shard | None = None
    zero: tensor.Shard | None = None
    own: torch.Tensor | None = None

    @property
    def parts(self) -> list[tensor.Shard]:
        """The cuts from the one-process tensor to this rank's, in order."""
        return [s for s in (self.tp, self.zero) if s is not None]

    @property
    def width(self) -> int:
        """How many such parts one process's tensor holds."""
        return math.prod(s.width for s in self.parts)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the one-process tensor `full` (a view)."""
        for s in self.parts:
            full = s.narrow(full)
        return full


def _release(t: torch.Tensor) -> None:
    t.data = t.data.new_empty(0)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _buckets(shards: list) -> list[list[int]]:
    """The indices of the shards (None skipped) of one group and dim, a
    list each, in the order of their first shard: one flat collective
    each."""
    buckets: dict = {}
    for i, s in enumerate(shards):
        if s is not None:
            buckets.setdefault((id(s.group), s.dim), []).append(i)
    return list(buckets.values())


def _gather(parts: list, shards: list) -> list:
    """Each part gathered into the whole along its shard's dim over its
    shard's group (as it is where the shard is None; a collective call)."""
    out = list(parts)
    for idx in _buckets(shards):
        s = shards[idx[0]]
        fulls = collectives.all_gather_many(
            [parts[i].detach().movedim(s.dim, 0) for i in idx], s.group)
        for i, full in zip(idx, fulls):
            out[i] = full.movedim(0, s.dim).contiguous()
    return out


def _scatter(tensors: list, shards: list) -> list:
    """Each tensor summed over its shard's group, this rank's part of the
    sum kept (a collective call)."""
    out = [None] * len(tensors)
    for idx in _buckets(shards):
        s = shards[idx[0]]
        parts = collectives.reduce_scatter_many(
            [tensors[i].movedim(s.dim, 0) for i in idx], s.group)
        for i, part in zip(idx, parts):
            out[i] = part.movedim(0, s.dim).contiguous()
    return out


class DataParallel:
    """The engine `train.state.make_train_step` drives when the state has
    one (`TrainState.parallel`): `before_forward()`, `reduce_grads()` after
    the backward, `after_update()` after the optimizer step,
    `ema_update(step)` and `sum_losses(losses)`. Build it before the
    optimizer, and hand the optimizer its views:
    `engine.attach(build_optimizer(module, cfg, total,
    **engine.optimizer_views())[0])`."""

    def __init__(self, module: nn.Module, layout: Layout, zero: int = 0,
                 use_ema: bool = True):
        if zero and layout.pipe > 1:
            raise NotImplementedError(
                f"ZeRO (level {zero}) with pipeline={layout.pipe} is not "
                "ported yet (ROADMAP queue A, item 12c)")
        self.module, self.layout, self.zero = module, layout, int(zero)
        self.group, self.size = layout.data_group, layout.data
        self.rank = layout.data_index
        # every rank starts from rank 0's module, as DDP does
        with torch.no_grad():
            collectives.broadcast_many_(
                [t.data for t in [*module.parameters(), *module.buffers()]],
                0, layout.world_group)
        # tensor / expert parallelism: the module keeps this rank's slices
        self.specs = tensor.shard_specs(module, layout)
        tensor.shard_module(module, self.specs)
        self.params = [self._entry(n, p, "params" if self.zero >= 3
                                   else "opt_state")
                       for n, p in module.named_parameters()
                       if p.requires_grad]
        self._by_id = {id(e.tensor): e for e in self.params}
        self._held: dict[int, torch.Tensor] = {}
        self.optimizer = None
        self.ema_entries = self.template = None
        self._eval_ready = False
        if self.sliced:
            # a whole module (released) to gather the EMA into for
            # validation, and the EMA copy as this rank's parts
            self.template = copy.deepcopy(module).eval()
            self.template.requires_grad_(False)
            for t in self._template_tensors():
                _release(t)
            if use_ema:
                self.ema_entries = [
                    self._entry(n, t, "ema") for n, t in
                    [*module.named_parameters(), *module.named_buffers()]]
                for e in self.ema_entries:
                    e.own = self._part(e).detach().clone()
        if self.zero >= 3:
            for e in self.params:
                if e.zero is not None:
                    e.own = self._part(e).detach().clone()
                    _release(e.tensor)

    def _entry(self, name: str, t: torch.Tensor, kind: str) -> _Entry:
        """The entry of the module's tensor t: its slice (the module holds
        it) and the ZeRO part of that slice, as `zero_spec` shards a `kind`
        of state."""
        tp = self.specs.get(name)
        dim = (zero_spec(kind, tuple(t.shape), self.size, self.zero,
                         None if tp is None else tp.dim)
               if t.is_floating_point() else None)
        return _Entry(name, t, tp, None if dim is None else tensor.Shard(
            dim, self.group, self.rank, self.size))

    @staticmethod
    def _part(e: _Entry) -> torch.Tensor:
        """This rank's ZeRO part of the module's tensor (a view)."""
        t = e.tensor.data
        return t if e.zero is None else e.zero.narrow(t)

    def _template_tensors(self) -> list[torch.Tensor]:
        return [*self.template.parameters(), *self.template.buffers()]

    def _device(self) -> torch.device:
        return self.params[0].tensor.device

    @property
    def sliced(self) -> bool:
        """True when this rank holds parts of the parameters' state (ZeRO,
        or tensor or expert parallelism)."""
        return bool(self.zero or self.specs)

    # ------------------------------------------------------------ optimizer

    def optimizer_views(self) -> dict:
        """`build_optimizer`'s keywords: the tensor the optimizer holds for
        each parameter (its ZeRO part: a view into the parameter at level
        1, the master shard at level 3; else the parameter itself, a slice
        under tensor or expert parallelism) and the gradient's global norm
        for the clip. Plain data parallelism needs neither."""
        if not self.sliced:
            return {}

        def view(p):
            e = self._by_id[id(p)]
            held = p if e.zero is None else (
                e.own if e.own is not None else self._part(e))
            self._held[id(p)] = held
            return held
        return {"param_view": view, "global_norm": self.grad_norm}

    def attach(self, optimizer: torch.optim.Optimizer) -> None:
        self.optimizer = optimizer

    def held(self, e: _Entry) -> torch.Tensor:
        """The tensor the optimizer holds for entry e."""
        return self._held.get(id(e.tensor), e.tensor)

    def _part_sums(self, value) -> torch.Tensor:
        """The sum over the parameters of `value(gradient)` (a float64
        scalar), each part counted once: the parts' sums all-reduced over
        each of their groups in turn (ZeRO's data group, the model or
        expert group), the spatial replicas' never."""
        whole = torch.zeros((), dtype=torch.float64, device=self._device())
        parts: dict = {}   # the parts' groups' ids -> [groups, their sum]
        for e in self.params:
            g = self.held(e).grad
            if g is None:
                continue
            if not e.parts:
                whole = whole + value(g).double()
            else:
                groups = [s.group for s in e.parts]
                acc = parts.setdefault(tuple(map(id, groups)), [
                    groups, torch.zeros_like(whole)])
                acc[1] = acc[1] + value(g).double()
        for groups, v in parts.values():
            for group in groups:
                v = collectives.all_reduce_(v, group)
            whole = whole + v
        return whole

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the gradient the optimizer holds: the parts'
        squared sums all-reduced over their groups, plus the replicated
        tensors' own."""
        return torch.sqrt(self._part_sums(
            lambda g: g.to(torch.promote_types(g.dtype, torch.float32))
            .pow(2).sum()))

    def grad_health(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(the gradient's global norm, its count of non-finite elements)
        from the parts the optimizer holds (a collective call)."""
        bad = self._part_sums(lambda g: (~torch.isfinite(g)).sum())
        return self.grad_norm().float(), bad.float()

    # ------------------------------------------------------------- the step

    def before_forward(self) -> None:
        """Level 3: all-gather each sharded parameter into the module. The
        EMA's gathered eval module is released."""
        if self._eval_ready:
            for t in self._template_tensors():
                _release(t)
            self._eval_ready = False
        self.gather_params()

    def gather_params(self) -> None:
        """Level 3: all-gather each ZeRO-sharded parameter into the module
        (its slice, under tensor or expert parallelism; a collective call),
        until `release_params` or the next backward."""
        if self.zero < 3:
            return
        sharded = [e for e in self.params if e.zero is not None]
        for e, full in zip(sharded, _gather([e.own for e in sharded],
                                            [e.zero for e in sharded])):
            e.tensor.data = full

    def reduce_grads(self) -> None:
        """Sum the gradients over the norm group (data x spatial; over the
        world, divided by the pipe width, under GPipe), each dtype in one
        flat call: under ZeRO each sharded gradient is reduce-scattered over
        the data group into the part the optimizer holds and that part
        summed over the spatial group (at level 3 the whole parameter is
        released), the others are all-reduced over the norm group. A model
        or expert slice's gradient is whole for its slice on its rank, as a
        replicated tensor's is."""
        layout = self.layout
        for e in self.params:
            if e.tensor.grad is None:
                e.tensor.grad = torch.zeros_like(e.tensor)
        if layout.pipe > 1:
            grads = [e.tensor.grad for e in self.params]
            collectives.all_reduce_many_(grads, layout.world_group)
            torch._foreach_div_(grads, float(layout.pipe))
            return
        scattered = [e for e in self.params if e.zero is not None]
        if scattered:
            parts = _scatter([e.tensor.grad for e in scattered],
                             [e.zero for e in scattered])
            if layout.spatial > 1:
                collectives.all_reduce_many_(parts, layout.spatial_group)
            for e, g in zip(scattered, parts):
                self.held(e).grad = g
                e.tensor.grad = None
                if self.zero >= 3:
                    _release(e.tensor)
        collectives.all_reduce_many_(
            [e.tensor.grad for e in self.params if e.zero is None],
            layout.norm_group)

    def after_update(self) -> None:
        """Level 1: all-gather the updated parts into the module's
        parameters, in one flat call a dim (after an update, not after an
        accumulating micro-step)."""
        if self.zero != 1 or getattr(self.optimizer, "mini_step", 0):
            return
        sharded = [e for e in self.params if e.zero is not None]
        fulls = _gather([self._part(e) for e in sharded],
                        [e.zero for e in sharded])
        for e, full in zip(sharded, fulls):
            e.tensor.data.copy_(full)

    @torch.no_grad()
    def ema_update(self, updates: int, decay: float = 0.9999) -> None:
        """The EMA step of `train.ema.ema_update` on this rank's parts."""
        d = decay * (1.0 - math.exp(-updates / 2000.0))
        ema_f, new_f = [], []
        for e in self.ema_entries:
            p = self._by_id.get(id(e.tensor))
            new = p.own if p is not None and p.own is not None \
                else self._part(e)
            if e.own.is_floating_point():
                ema_f.append(e.own)
                new_f.append(new.to(e.own.dtype))
            else:
                e.own.copy_(new)
        torch._foreach_mul_(ema_f, d)
        torch._foreach_add_(ema_f, new_f, alpha=1.0 - d)

    def sum_losses(self, losses: dict) -> dict:
        """Each rank's losses are its shares: their sums over the data
        group are the global batch's losses, on every rank."""
        names = sorted(losses)
        dtype = (torch.float64 if any(v.dtype == torch.float64
                                      for v in losses.values())
                 else torch.float32)
        flat = torch.stack([losses[k].to(dtype) for k in names])
        collectives.all_reduce_(flat, self.group)
        return {k: flat[i].to(losses[k].dtype) for i, k in enumerate(names)}

    # ------------------------------------------------------ gathers, parts

    @staticmethod
    def _whole(entries: list, parts: list, zero: bool = True) -> list:
        """Each entry's one-process tensor from this rank's part of it
        (with `zero` false: from the module's tensor, the slice): the ZeRO
        parts gathered into the slices, then the slices into the whole (a
        collective call); the replicated ones as they are."""
        if zero:
            parts = _gather(parts, [e.zero for e in entries])
        return _gather(parts, [e.tp for e in entries])

    def eval_module(self) -> nn.Module:
        """The EMA copy (or, without one, the module) gathered into a whole
        module, in eval mode (a collective call: every rank makes it).
        Released again at the next step."""
        if not self._eval_ready:
            if self.ema_entries is not None:
                whole = dict(zip(
                    [e.name for e in self.ema_entries],
                    self._whole(self.ema_entries,
                                [e.own for e in self.ema_entries])))
            else:
                whole = {**dict(self.module.named_buffers()),
                         **self.module_state_dict()}
            for name, t in [*self.template.named_parameters(),
                            *self.template.named_buffers()]:
                t.data = whole[name].detach()
            self._eval_ready = True
        return self.template

    def release_params(self) -> None:
        if self.zero >= 3:
            for e in self.params:
                if e.zero is not None:
                    _release(e.tensor)

    def module_state_dict(self) -> dict:
        """The module's single-process state_dict (collective at level 3,
        and where the model or expert width slices it)."""
        self.gather_params()
        sd = {k: v.detach().clone()
              for k, v in self.module.state_dict().items()}
        self.release_params()
        sliced = [e for e in self.params if e.tp is not None]
        for e, whole in zip(sliced, self._whole(
                sliced, [sd[e.name] for e in sliced], zero=False)):
            sd[e.name] = whole
        return sd

    def load_module_state_dict(self, sd: dict) -> None:
        self.gather_params()
        self.module.load_state_dict(tensor.shard_state_dict(sd, self.specs))
        if self.zero >= 3:
            for e in self.params:
                if e.zero is not None:
                    e.own.copy_(self._part(e))
        self.release_params()

    def ema_state_dict(self) -> dict:
        """The EMA copy's single-process state_dict (a collective call)."""
        return {k: v.detach().clone()
                for k, v in self.eval_module().state_dict().items()}

    def load_ema_state_dict(self, sd: dict) -> None:
        for e in self.ema_entries:
            if e.name not in sd:
                continue  # a non-persistent scratch buffer
            e.own.copy_(e.cut(sd[e.name].to(e.own.device, e.own.dtype)))
        self._eval_ready = False

    def _opt_entries(self) -> list[_Entry]:
        """The entries in the optimizer's parameter order."""
        order = {id(self.held(e)): e for e in self.params}
        return [order[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def optimizer_state_dict(self) -> dict:
        """The optimizer's single-process state_dict: each part of a moment
        (and of the accumulation buffer) gathered (a collective call)."""
        sd = self.optimizer.state_dict()
        if not self.sliced:
            return sd
        state = {i: dict(st) for i, st in sd["state"].items()}
        keys, entries, parts = [], [], []
        for i, e in enumerate(self._opt_entries()):
            for k, v in state.get(i, {}).items():
                if isinstance(v, torch.Tensor) and v.ndim >= 1:
                    keys.append((i, k))
                    entries.append(e)
                    parts.append(v)
        for (i, k), full in zip(keys, self._whole(entries, parts)):
            state[i][k] = full
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state_dict(self, sd: dict) -> None:
        """Load a single-process optimizer state_dict: each rank keeps its
        part of each tensor it holds a part of."""
        if self.sliced:
            state = {}
            for i, e in enumerate(self._opt_entries()):
                st = sd["state"].get(i)
                if st is None:
                    continue
                state[i] = {k: (e.cut(v).clone()
                                if isinstance(v, torch.Tensor) and v.ndim
                                else v) for k, v in st.items()}
            sd = {"state": state, "param_groups": sd["param_groups"]}
        self.optimizer.load_state_dict(sd)

    def state_bytes(self) -> dict:
        """This rank's bytes of optimizer state, EMA copy and parameters
        (the parts where it holds parts), and one process's: a part counts
        as many times for one process as one process's tensor holds such
        parts."""
        out = dict.fromkeys(("opt_state", "ema", "params"), 0)
        out.update(dict.fromkeys(("opt_state_one_process", "ema_one_process",
                                  "params_one_process"), 0))

        def add(kind: str, t: torch.Tensor, width: int) -> None:
            out[kind] += _nbytes(t)
            out[kind + "_one_process"] += _nbytes(t) * width
        for e in self.params:
            # the module's parameter: its slice (or the whole) under ZeRO-1,
            # its master part at level 3
            if e.own is not None:
                add("params", e.own, e.width)
            else:
                add("params", e.tensor, 1 if e.tp is None else e.tp.width)
            for t in self.optimizer.state.get(self.held(e), {}).values():
                if isinstance(t, torch.Tensor) and t.ndim >= 1:
                    add("opt_state", t, e.width)
        for e in self.ema_entries or []:
            add("ema", e.own, e.width)
        return out
