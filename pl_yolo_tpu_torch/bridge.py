"""Weight bridge between the JAX package's flax variables and the port's
torch state_dict.

The port names its submodules after the flax modules, so a flax path maps
to a torch key by a rename, plus a transpose for conv kernels:

    params/<path>/kernel   [kh,kw,cin/g,cout] HWIO  <-> <path>.weight OIHW
        (a `Conv1x1` kernel [1,1,cin,cout] and a depthwise kernel
         [kh,kw,1,c] are the same case: the group layout is kept)
    params/<path>/bias                              <-> <path>.bias
    params/<path>/bn/scale, bn/bias                 <-> <path>.bn.weight, bn.bias
    batch_stats/<path>/bn/mean, bn/var              <-> <path>.bn.running_mean,
                                                        bn.running_var

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

from typing import Mapping

import numpy as np
import torch
from torch import nn

_NPZ_META = "__meta__"


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = prefix + tuple(str(k).split("/"))
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        elif k != _NPZ_META:
            flat[path] = np.asarray(v)
    return flat


def _to_torch_key(path: tuple, value: np.ndarray) -> tuple[str, np.ndarray]:
    collection, *mod, leaf = path
    in_bn = bool(mod) and mod[-1] == "bn"
    if collection == "params":
        if leaf == "kernel" and value.ndim == 4 and not in_bn:
            return ".".join(mod + ["weight"]), value.transpose(3, 2, 0, 1)
        if leaf == "bias":
            return ".".join(mod + ["bias"]), value
        if leaf == "scale" and in_bn:
            return ".".join(mod + ["weight"]), value
    elif collection == "batch_stats" and in_bn:
        if leaf in ("mean", "var"):
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
    for path, value in _flatten(variables).items():
        key, arr = _to_torch_key(path, value)
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


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """torch state_dict -> nested numpy {"params": ..., "batch_stats": ...}
    in the flax layout. Raises KeyError on a key it cannot map."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        value = t.detach().cpu().numpy()
        in_bn = bool(mod) and mod[-1] == "bn"
        if leaf == "num_batches_tracked" and in_bn:
            continue
        if leaf == "weight" and not in_bn and value.ndim == 4:
            collection, name, value = "params", "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            collection, name = "params", "bias"
        elif leaf == "weight" and in_bn:
            collection, name = "params", "scale"
        elif leaf in ("running_mean", "running_var") and in_bn:
            collection, name = "batch_stats", leaf[len("running_"):]
        else:
            raise KeyError(f"unmapped torch key: {key} {tuple(value.shape)}")
        node = out[collection]
        for part in mod:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(value)
    return out


def load_momentum(optimizer: torch.optim.Optimizer, module: nn.Module,
                  trace: Mapping) -> None:
    """Write a momentum trace (a tree shaped like flax `params`) into the
    `momentum_buffer` of each of `module`'s parameters in `optimizer` (SGD).
    Raises KeyError unless the trace names exactly the module's parameters."""
    named = dict(module.named_parameters())
    bufs = dict(_to_torch_key(path, value)
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
    return state_dict_to_variables(bufs)["params"]
