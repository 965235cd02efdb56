"""Weight bridge between the JAX package's flax variables and the port's
torch state_dict.

The port names its submodules and parameters after the flax modules and
leaves, so a flax path maps to a torch key by a rename, plus a layout
change for kernels:

    params/<path>/kernel   [kh,kw,cin/g,cout] HWIO  <-> <path>.weight OIHW
        (a `Conv1x1` kernel [1,1,cin,cout] and a depthwise kernel
         [kh,kw,1,c] are the same case: the group layout is kept)
    params/<path>/kernel   [kh,kw,cin,cout] of an   <-> <path>.weight
        nn.ConvTranspose (kernel = stride)               [cin,cout,kh,kw],
                                                         spatially flipped
    params/<path>/kernel   [in,out] (nn.Dense)      <-> <path>.weight [out,in]
    params/<path>/kernel   3-D: [k,cin/g,cout] of a <-> <path>.weight, its
        1-D nn.Conv; [in,heads,hd] / [heads,hd,out]      axes reversed
        of nn.MultiHeadDotProductAttention               (Conv1d's
                                                         [cout,cin/g,k]; the
                                                         attention layers'
                                                         `DenseGeneral`)
    params/<path>/bias                              <-> <path>.bias
    params/<path>/scale    (BatchNorm, LayerNorm)   <-> <path>.weight
    batch_stats/<path>/mean, var                    <-> <path>.running_mean,
                                                        running_var
    params/<path>/ia{k}, im{k} [1,1,1,C]            <-> <path>.ia{k}, im{k}
                                                        [1,C,1,1]
    params/<path>/<any other leaf>                  <-> <path>.<leaf>, as is
        (the transformer backbones' free parameters: `pos_embed`,
         `cls_token`, `relative_position_bias_table`, `logit_scale`, the
         stacked towers' `blocks_*` [L, ...], ...; the attention modules'
         `gamma`, `rate1`, ..., and SGE's `weight` / `bias` [1,1,1,g])

flax's transposed conv with kernel = stride is torch's `conv_transpose2d`
with the kernel flipped in both spatial axes. A `ConvTranspose2d`'s weight
has the shape of a conv weight, so the functions that go from torch to
flax, and from flax to torch without a module, tell it apart only by the
`module` they are given (`load_variables` always has one). In the same way,
a free parameter named `weight` (SGE's) maps as is only where the `module`
given shows that its owner is no conv, dense or norm layer; without a
module a 4-D `weight` is a conv kernel.
`ia{k}` and `im{k}` are the implicit head's priors.

`num_batches_tracked` (torch only) is written as 0 and dropped on the way
back. Input is the numpy tree of `jax.device_get(model.init(...))` or the
flat `params/...`, `batch_stats/...` keys of the exported npz.

A whole JAX `TrainState` maps piece by piece: `params` + `batch_stats` to the
trained module, `ema_params` + `ema_batch_stats` (as {"params": ...,
"batch_stats": ...}) to the EMA module through the same functions, and the
SGD momentum trace (optax `TraceState.trace`, a tree shaped like `params`)
to the optimizer's `momentum_buffer`s (`load_momentum`, `momentum_to_trace`).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_NPZ_META = "__meta__"
_IMPLICIT = re.compile(r"i[am]\d+")  # the implicit head's priors


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = prefix + tuple(str(k).split("/"))
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        elif k != _NPZ_META:
            flat[path] = np.asarray(v)
    return flat


def _conv_transposes(module: nn.Module | None) -> frozenset[str]:
    """The paths of `module`'s transposed convs."""
    if module is None:
        return frozenset()
    return frozenset(name for name, m in module.named_modules()
                     if isinstance(m, nn.ConvTranspose2d))


def _free_weights(module: nn.Module | None) -> frozenset[str]:
    """The paths of `module`'s submodules whose own `weight` parameter is a
    free one (SGE's [1,1,1,g]): of at least 2 dims, on a module that is no
    conv or dense layer (norms' weights are 1-D; a module whose `weight` is
    a flax kernel in another layout says so by `WEIGHT_IS_KERNEL`)."""
    if module is None:
        return frozenset()
    layers = (nn.modules.conv._ConvNd, nn.Linear)
    return frozenset(
        name for name, m in module.named_modules()
        if not isinstance(m, layers)
        and not getattr(m, "WEIGHT_IS_KERNEL", False)
        and isinstance(getattr(m, "weight", None), nn.Parameter)
        and m.weight.ndim >= 2)


def _to_torch_key(path: tuple, value: np.ndarray,
                  conv_transposes: frozenset[str] = frozenset()
                  ) -> tuple[str, np.ndarray]:
    collection, *mod, leaf = path
    if collection == "params":
        if _IMPLICIT.fullmatch(leaf) and value.ndim == 4:
            return ".".join(mod + [leaf]), value.transpose(0, 3, 1, 2)
        if leaf == "kernel" and value.ndim == 4:
            if ".".join(mod) in conv_transposes:
                return (".".join(mod + ["weight"]),
                        value[::-1, ::-1].transpose(2, 3, 0, 1))
            return ".".join(mod + ["weight"]), value.transpose(3, 2, 0, 1)
        if leaf == "kernel" and value.ndim in (2, 3):
            return ".".join(mod + ["weight"]), value.transpose()
        if leaf == "scale":
            return ".".join(mod + ["weight"]), value
        if leaf != "kernel":  # "bias" and the free parameters
            return ".".join(mod + [leaf]), value
    elif collection == "batch_stats" and leaf in ("mean", "var"):
        return ".".join(mod + [f"running_{leaf}"]), value
    raise KeyError(f"unmapped flax variable: {'/'.join(path)} "
                   f"{tuple(value.shape)}")


def variables_to_state_dict(variables: Mapping,
                            module: nn.Module | None = None
                            ) -> dict[str, torch.Tensor]:
    """flax variables -> torch state_dict. With `module`, raises KeyError on
    any key missing from or unknown to its state_dict, and ValueError on a
    shape that differs."""
    sd: dict[str, torch.Tensor] = {}
    convt = _conv_transposes(module)
    for path, value in _flatten(variables).items():
        key, arr = _to_torch_key(path, value, convt)
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
        if key.endswith("running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    if module is not None:
        want = module.state_dict()
        missing = sorted(set(want) - set(sd))
        unknown = sorted(set(sd) - set(want))
        if missing or unknown:
            raise KeyError(f"state_dict mismatch: missing {missing}, "
                           f"unmapped {unknown}")
        for key, t in want.items():
            if tuple(t.shape) != tuple(sd[key].shape):
                raise ValueError(f"{key}: shape {tuple(sd[key].shape)}, "
                                 f"module has {tuple(t.shape)}")
    return sd


def load_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax variables into `module` (strict) and return it."""
    sd = variables_to_state_dict(variables, module)
    module.load_state_dict(sd, strict=True)
    return module


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor],
                            module: nn.Module | None = None) -> dict:
    """torch state_dict -> nested numpy {"params": ..., "batch_stats": ...}
    in the flax layout, each array a copy (the module may train on).
    `module`, the state_dict's own, is needed where it holds a
    ConvTranspose2d or a free `weight`. Raises KeyError on a key it cannot
    map."""
    convt = _conv_transposes(module)
    free = _free_weights(module)
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        value = t.detach().cpu().numpy()
        collection, name = "params", leaf
        if leaf == "num_batches_tracked":
            continue
        if _IMPLICIT.fullmatch(leaf) and value.ndim == 4:
            value = value.transpose(0, 2, 3, 1)
        elif leaf == "weight" and ".".join(mod) in free:
            pass
        elif leaf == "weight" and value.ndim == 4:
            name = "kernel"
            value = (value.transpose(2, 3, 0, 1)[::-1, ::-1]
                     if ".".join(mod) in convt
                     else value.transpose(2, 3, 1, 0))
        elif leaf == "weight" and value.ndim in (2, 3):
            name, value = "kernel", value.transpose()
        elif leaf == "weight" and value.ndim == 1:
            name = "scale"
        elif leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            raise KeyError(f"unmapped torch key: {key} {tuple(value.shape)}")
        node = out[collection]
        for part in mod:
            node = node.setdefault(part, {})
        node[name] = np.array(value, order="C")  # a copy, never a view
    return out


def load_momentum(optimizer: torch.optim.Optimizer, module: nn.Module,
                  trace: Mapping) -> None:
    """Write a momentum trace (a tree shaped like flax `params`) into the
    `momentum_buffer` of each of `module`'s parameters in `optimizer` (SGD).
    Raises KeyError unless the trace names exactly the module's parameters."""
    named = dict(module.named_parameters())
    convt = _conv_transposes(module)
    bufs = dict(_to_torch_key(path, value, convt)
                for path, value in _flatten(trace, ("params",)).items())
    if set(bufs) != set(named):
        raise KeyError(
            f"momentum trace mismatch: missing {sorted(set(named) - set(bufs))}"
            f", unmapped {sorted(set(bufs) - set(named))}")
    for key, arr in bufs.items():
        p = named[key]
        optimizer.state[p]["momentum_buffer"] = torch.from_numpy(
            np.array(arr, np.float32)).to(p.device)


def momentum_to_trace(optimizer: torch.optim.Optimizer,
                      module: nn.Module) -> dict:
    """The optimizer's `momentum_buffer`s (SGD, after at least one update)
    as a numpy tree shaped like flax `params`."""
    bufs = {name: optimizer.state[p]["momentum_buffer"]
            for name, p in module.named_parameters()}
    return state_dict_to_variables(bufs, module)["params"]
