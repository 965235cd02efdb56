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
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from . import collectives
from .mesh import Layout, zero_spec


@dataclasses.dataclass
class _Entry:
    """One tensor of the module and its part on this rank: dim 0's
    [start, start + length) where it is sharded (`dim` 0), else all of it."""
    tensor: torch.Tensor          # the module's parameter or buffer
    dim: int | None
    start: int = 0
    length: int = 0
    shard: torch.Tensor | None = None   # a shard with storage of its own


def _release(t: torch.Tensor) -> None:
    t.data = t.data.new_empty(0)


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
                "parallel: {zero} with pipeline > 1 is not ported yet "
                "(ROADMAP queue A, item 12b)")
        self.module, self.layout, self.zero = module, layout, int(zero)
        self.group, self.size = layout.data_group, layout.data
        self.rank = layout.data_index
        # every rank starts from rank 0's module, as DDP does
        with torch.no_grad():
            collectives.broadcast_many_(
                [t.data for t in [*module.parameters(), *module.buffers()]],
                0, layout.world_group)
        self.params = [self._entry(p, "params" if self.zero >= 3
                                   else "opt_state")
                       for p in module.parameters() if p.requires_grad]
        self._by_id = {id(e.tensor): e for e in self.params}
        self._held: dict[int, torch.Tensor] = {}
        self.optimizer = None
        self.ema_entries = self.eval_template = None
        self._eval_ready = False
        if self.zero and use_ema:
            named = [*module.named_parameters(), *module.named_buffers()]
            self.ema_names = [n for n, _ in named]
            self.ema_entries = [self._entry(t, "ema") for _, t in named]
            for e in self.ema_entries:
                e.shard = self._part(e).detach().clone()
            self.eval_template = copy.deepcopy(module).eval()
            self.eval_template.requires_grad_(False)
            for t in self._template_tensors():
                _release(t)
        if self.zero >= 3:
            for e in self.params:
                if e.dim is not None:
                    e.shard = self._part(e).detach().clone()
                    _release(e.tensor)

    def _entry(self, t: torch.Tensor, kind: str) -> _Entry:
        dim = (zero_spec(kind, tuple(t.shape), self.size, self.zero)
               if t.is_floating_point() else None)
        if dim is None:
            return _Entry(t, None)
        n = t.shape[0] // self.size
        return _Entry(t, dim, self.rank * n, n)

    @staticmethod
    def _part(e: _Entry) -> torch.Tensor:
        """This rank's part of the module's tensor (a view)."""
        t = e.tensor.data
        return t if e.dim is None else t.narrow(0, e.start, e.length)

    def _template_tensors(self) -> list[torch.Tensor]:
        named = dict([*self.eval_template.named_parameters(),
                      *self.eval_template.named_buffers()])
        return [named[n] for n in self.ema_names]

    def _device(self) -> torch.device:
        return self.params[0].tensor.device

    # ------------------------------------------------------------ optimizer

    def optimizer_views(self) -> dict:
        """`build_optimizer`'s keywords: the tensor the optimizer holds for
        each parameter (its shard under ZeRO: a view into the parameter at
        level 1, the master shard at level 3) and the gradient's global
        norm for the clip. Plain data parallelism needs neither."""
        if not self.zero:
            return {}

        def view(p):
            e = self._by_id[id(p)]
            held = p if e.dim is None else (
                e.shard if e.shard is not None else self._part(e))
            self._held[id(p)] = held
            return held
        return {"param_view": view, "global_norm": self.grad_norm}

    def attach(self, optimizer: torch.optim.Optimizer) -> None:
        self.optimizer = optimizer

    def held(self, e: _Entry) -> torch.Tensor:
        """The tensor the optimizer holds for entry e."""
        return self._held.get(id(e.tensor), e.tensor)

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the gradient the optimizer holds: the shards'
        squared sums all-reduced over the data group, plus the replicated
        tensors' own."""
        sq = torch.zeros((), dtype=torch.float64, device=self._device())
        whole = torch.zeros_like(sq)
        for e in self.params:
            g = self.held(e).grad
            if g is not None:
                g2 = g.to(torch.promote_types(g.dtype, torch.float32)).pow(2)
                if e.dim is None:
                    whole = whole + g2.sum().double()
                else:
                    sq = sq + g2.sum().double()
        if self.zero:
            collectives.all_reduce_(sq, self.group)
        return torch.sqrt(sq + whole)

    def grad_health(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(the gradient's global norm, its count of non-finite elements)
        from the shards the optimizer holds (a collective call)."""
        bad = torch.zeros((), dtype=torch.float64, device=self._device())
        whole = torch.zeros_like(bad)
        for e in self.params:
            g = self.held(e).grad
            if g is not None:
                n = (~torch.isfinite(g)).sum().double()
                if e.dim is None:
                    whole = whole + n
                else:
                    bad = bad + n
        collectives.all_reduce_(bad, self.group)
        return self.grad_norm().float(), (bad + whole).float()

    # ------------------------------------------------------------- the step

    def before_forward(self) -> None:
        """Level 3: all-gather each sharded parameter into the module. The
        EMA's gathered eval module is released."""
        if self.eval_template is not None and self._eval_ready:
            for t in self._template_tensors():
                _release(t)
            self._eval_ready = False
        self.gather_params()

    def gather_params(self) -> None:
        """Level 3: all-gather each sharded parameter into the module (a
        collective call), until `release_params` or the next backward."""
        if self.zero < 3:
            return
        sharded = [e for e in self.params if e.dim is not None]
        for e, full in zip(sharded, collectives.all_gather_many(
                [e.shard for e in sharded], self.group)):
            e.tensor.data = full

    def reduce_grads(self) -> None:
        """Sum the gradients over the data group (over the world, divided
        by the pipe width, under GPipe), each dtype in one flat call: under
        ZeRO each sharded gradient is reduce-scattered into the shard the
        optimizer holds (at level 3 the whole parameter is released), the
        others are all-reduced."""
        layout = self.layout
        for e in self.params:
            if e.tensor.grad is None:
                e.tensor.grad = torch.zeros_like(e.tensor)
        if layout.pipe > 1:
            grads = [e.tensor.grad for e in self.params]
            collectives.all_reduce_many_(grads, layout.world_group)
            torch._foreach_div_(grads, float(layout.pipe))
            return
        # (no entry is sharded at level 0)
        scattered = [e for e in self.params if e.dim is not None]
        if scattered:
            shards = collectives.reduce_scatter_many(
                [e.tensor.grad for e in scattered], self.group)
            for e, g in zip(scattered, shards):
                self.held(e).grad = g
                e.tensor.grad = None
                if self.zero >= 3:
                    _release(e.tensor)
        collectives.all_reduce_many_(
            [e.tensor.grad for e in self.params if e.dim is None],
            self.group)

    def after_update(self) -> None:
        """Level 1: all-gather the updated shards into the module's
        parameters, in one flat call (after an update, not after an
        accumulating micro-step)."""
        if self.zero != 1 or getattr(self.optimizer, "mini_step", 0):
            return
        sharded = [e for e in self.params if e.dim is not None]
        fulls = collectives.all_gather_many(
            [self._part(e).clone() for e in sharded], self.group)
        for e, full in zip(sharded, fulls):
            e.tensor.data.copy_(full)

    @torch.no_grad()
    def ema_update(self, updates: int, decay: float = 0.9999) -> None:
        """The EMA step of `train.ema.ema_update` on this rank's shards."""
        d = decay * (1.0 - math.exp(-updates / 2000.0))
        ema_f, new_f = [], []
        for e in self.ema_entries:
            p = self._by_id.get(id(e.tensor))
            new = p.shard if p is not None and p.shard is not None \
                else self._part(e)
            if e.shard.is_floating_point():
                ema_f.append(e.shard)
                new_f.append(new.to(e.shard.dtype))
            else:
                e.shard.copy_(new)
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

    # ------------------------------------------------------ gathers, shards

    def _gather(self, entries: list, shards: list) -> list:
        """Each entry's whole tensor from its shards (one flat all-gather
        for the sharded ones; the replicated ones as they are)."""
        out = list(shards)
        idx = [i for i, e in enumerate(entries) if e.dim is not None]
        fulls = collectives.all_gather_many([shards[i] for i in idx],
                                            self.group)
        for i, full in zip(idx, fulls):
            out[i] = full
        return out

    def eval_module(self) -> nn.Module:
        """The EMA copy gathered into a whole module, in eval mode (a
        collective call: every rank of the data group makes it). Released
        again at the next step."""
        if not self._eval_ready:
            fulls = self._gather(self.ema_entries,
                                 [e.shard for e in self.ema_entries])
            for t, full in zip(self._template_tensors(), fulls):
                t.data = full
            self._eval_ready = True
        return self.eval_template

    def release_params(self) -> None:
        if self.zero >= 3:
            for e in self.params:
                if e.dim is not None:
                    _release(e.tensor)

    def module_state_dict(self) -> dict:
        """The module's single-process state_dict (collective at level 3)."""
        self.gather_params()
        sd = {k: v.detach().clone()
              for k, v in self.module.state_dict().items()}
        self.release_params()
        return sd

    def load_module_state_dict(self, sd: dict) -> None:
        self.gather_params()
        self.module.load_state_dict(sd)
        if self.zero >= 3:
            for e in self.params:
                if e.dim is not None:
                    e.shard.copy_(e.tensor.data.narrow(0, e.start, e.length))
        self.release_params()

    def ema_state_dict(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.eval_module().state_dict().items()}

    def load_ema_state_dict(self, sd: dict) -> None:
        for name, e in zip(self.ema_names, self.ema_entries):
            if name not in sd:
                continue  # a non-persistent scratch buffer
            full = sd[name].to(e.shard.device, e.shard.dtype)
            e.shard.copy_(full if e.dim is None
                          else full.narrow(0, e.start, e.length))
        self._eval_ready = False

    def _opt_entries(self) -> list[_Entry]:
        """The entries in the optimizer's parameter order."""
        order = {id(self.held(e)): e for e in self.params}
        return [order[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def optimizer_state_dict(self) -> dict:
        """The optimizer's single-process state_dict: each sharded moment
        (and accumulation buffer) all-gathered (a collective call)."""
        sd = self.optimizer.state_dict()
        if not self.zero:
            return sd
        state = {i: dict(st) for i, st in sd["state"].items()}
        keys, entries, shards = [], [], []
        for i, e in enumerate(self._opt_entries()):
            for k, v in state.get(i, {}).items():
                if isinstance(v, torch.Tensor) and v.ndim >= 1:
                    keys.append((i, k))
                    entries.append(e)
                    shards.append(v)
        for (i, k), full in zip(keys, self._gather(entries, shards)):
            state[i][k] = full
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state_dict(self, sd: dict) -> None:
        """Load a single-process optimizer state_dict: each rank keeps its
        shard of each sharded tensor."""
        if self.zero:
            state = {}
            for i, e in enumerate(self._opt_entries()):
                st = sd["state"].get(i)
                if st is None:
                    continue
                state[i] = {k: (v.narrow(0, e.start, e.length).clone()
                                if isinstance(v, torch.Tensor) and v.ndim >= 1
                                and e.dim is not None else v)
                            for k, v in st.items()}
            sd = {"state": state, "param_groups": sd["param_groups"]}
        self.optimizer.load_state_dict(sd)

    def state_bytes(self) -> dict:
        """This rank's bytes of optimizer state, EMA copy and parameters
        (the shards where they are sharded), and one process's."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        opt = [v for st in self.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.ndim >= 1]
        full_opt = 0
        for e in self.params:
            for t in self.optimizer.state.get(self.held(e), {}).values():
                if isinstance(t, torch.Tensor) and t.ndim >= 1:
                    full_opt += (t.numel() * t.element_size()
                                 * (self.size if e.dim is not None else 1))
        ema = ([e.shard for e in self.ema_entries]
               if self.ema_entries is not None else [])
        full_ema = sum(
            e.shard.numel() * e.shard.element_size()
            * (self.size if e.dim is not None else 1)
            for e in (self.ema_entries or []))
        params = [(e.shard if e.shard is not None else e.tensor)
                  for e in self.params]
        full_params = sum(
            e.tensor.element_size() * (
                e.shard.numel() * self.size if e.shard is not None
                else e.tensor.numel()) for e in self.params)
        return {"opt_state": nbytes(opt), "ema": nbytes(ema),
                "params": nbytes(params), "opt_state_one_process": full_opt,
                "ema_one_process": full_ema,
                "params_one_process": full_params}
