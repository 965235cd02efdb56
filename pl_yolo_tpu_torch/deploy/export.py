"""The port's exporters: npz, TorchScript, ONNX and a served `torch.export`
program, each from a `DetectionModel` (a seeded init, or a checkpoint's EMA
weights loaded into one).

- `export_npz`: the weights as the flat npz of fp32 arrays and JSON meta
  that `deploy.numpy_infer` runs with numpy alone (the JAX package's
  `tools/export_npz.py` layout, reached through `bridge`), for the YOLOX,
  YOLOv7 and YOLOv5 families.
- `export_torchscript` / `export_onnx`: `DeployModule`, the fp32 eval
  forward and decode with RepConvs fused and BatchNorms folded, traced by
  `torch.jit.trace` (saved with `torch.jit.save`), or turned into an
  opset-13 ONNX graph by torch's symbolic tracer and written without the
  `onnx` package (`deploy.torch_onnx`). Images [B,3,S,S] 0-255 in,
  `predictions` [B,A,5+C] out (xyxy, sigmoid obj and cls), the contract of
  the npz runtime; the same three families.
- `export_program` / `load_program`: `torch.export` of the eval forward,
  decode and `postprocess` in the config's own compute dtype, images
  [B,S,S,3] in, (boxes, scores, classes, valid) out, saved with
  `torch.export.save`. Its suppression step is the registered operator
  `pl_yolo_tpu_torch::nms_suppress`, which on the card launches the NMS
  kernel. Any model the port builds.

Traps that shape this code: a traced function over the port's modules
would bake the weights in as constants (so a module is traced); the
anchor tables of the anchor decodes are cached constants (`ops.constant`),
made by the first call, so each module runs once before a trace; and a
TorchScript trace keeps the device it was traced on in its constants and
`arange`s, so it is traced on the device that will serve it, where an
exported program moves (`load_program`).
"""

from __future__ import annotations

import copy
import json
import warnings
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..bridge import state_dict_to_variables
from ..layers.blocks import ConvBlock
from ..models.losses.yolov5 import DEFAULT_V5_ANCHORS
from ..models.losses.yolov7 import DEFAULT_V7_ANCHORS
from ..ops.nms import postprocess
from ..utils.fuse import fold_bn_, fuse_repconvs_

FAMILIES = {("cspdarknet", "csppafpn", "decoupled_head"): "yolox",
            ("eelan", "yolov7neck", "implicit_head"): "yolov7",
            ("cspdarknet", "csppafpn", "simple_head"): "yolov5"}


def family_of(cfg: dict) -> str:
    """The npz family of a model config; SystemExit for any other model,
    with the JAX package's message."""
    names = (cfg["backbone"]["name"], cfg["neck"]["name"],
             cfg["head"]["name"])
    if names not in FAMILIES:
        raise SystemExit(
            "npz deploy covers the YOLOX family (cspdarknet + csppafpn + "
            "decoupled_head), the YOLOv7 family (eelan + yolov7neck + "
            "implicit_head), and the YOLOv5 family (cspdarknet + csppafpn "
            f"+ simple_head); got {names}")
    return FAMILIES[names]


def _flatten(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v, np.float32)
    return flat


def npz_meta(cfg: dict, num_classes: int) -> dict:
    """The npz's meta record (`tools/export_npz.py` of the JAX package)."""
    family = family_of(cfg)
    meta = {
        "family": family,
        "num_classes": num_classes,
        "backbone_depths": list(cfg["backbone"].get("depths", [3, 9, 9, 3])),
        "backbone_outputs": list(cfg["backbone"].get(
            "outputs", ["stage2", "stage3", "stage4"])),
        "neck_depths": list(cfg["neck"].get("depths", [1, 1, 1, 1])),
        "backbone_depthwise": bool(cfg["backbone"].get("depthwise", False)),
        "neck_depthwise": bool(cfg["neck"].get("depthwise", False)),
        "head_depthwise": bool(cfg["head"].get("depthwise", False)),
        "strides": list(cfg.get("loss", {}).get("stride", [8, 16, 32])),
        "layout": "NHWC, kernels HWIO, pixels 0-255 float32",
    }
    if family in ("yolov7", "yolov5"):
        default = (DEFAULT_V7_ANCHORS if family == "yolov7"
                   else DEFAULT_V5_ANCHORS)
        meta["anchors"] = [[list(a) for a in lvl] for lvl in
                           cfg["loss"].get("anchors", default)]
        meta["num_anchor"] = int(cfg["head"].get("num_anchor", 3))
    return meta


def export_npz(cfg: dict, model, path) -> dict:
    """Write `model`'s weights (`model.module`'s state, e.g. EMA weights
    loaded into it) as the npz artifact; returns the meta record."""
    meta = npz_meta(cfg, model.num_classes)
    variables = state_dict_to_variables(model.module.state_dict(),
                                        model.module)
    arrays = _flatten(variables["params"], "params")
    arrays.update(_flatten(variables.get("batch_stats", {}), "batch_stats"))
    arrays["__meta__"] = np.asarray(json.dumps(meta))
    np.savez(path, **arrays)
    return meta


def load_model(config, num_classes: int, device=None, checkpoint=None,
               step: int | None = None, fp32: bool = True):
    """The exporters' model: `build_model` of the YAML `config` (with
    `dtype: float32` where `fp32`, as the fp32 artifacts are made and
    held) on `device`, from the seeded init or, with `checkpoint`, a port
    checkpoint's EMA weights (`restore_eval_weights`). Returns (model,
    step), step None for the seeded init."""
    from ..models.detector import build_model
    from ..utils.config import load_config
    cfg = dict(load_config(config))
    if fp32:
        cfg["dtype"] = "float32"
    model = build_model(cfg, num_classes=num_classes, device=device)
    if checkpoint:
        step = restore_eval_weights(model, checkpoint, step)
    return model, step


def restore_eval_weights(model, directory, step: int | None = None) -> int:
    """Load a port checkpoint's EMA weights (BN statistics included; the
    trained weights where it kept no EMA) into `model.module`, from the
    step directory `step` of `directory` (default the latest). Returns the
    step."""
    from ..train.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory)
    step = mgr.latest_step if step is None else step
    device = next(model.module.parameters()).device
    tree = mgr.restore(step, map_location=device)
    model.module.load_state_dict(tree["ema_module"] or tree["module"])
    return int(tree["step"])


def eval_copy(model, device=None) -> nn.Module:
    """An fp32 eval-mode copy of `model.module` on `device` (default: the
    module's own) with its RepConvs fused and its BatchNorms folded into
    the convs; no parameter requires grad."""
    module = copy.deepcopy(model.module).float().eval().requires_grad_(False)
    for m in module.modules():
        if isinstance(m, ConvBlock):
            m.dtype = None
    fold_bn_(fuse_repconvs_(module))
    if device is not None:
        module = module.to(device)
    return module


class DeployModule(nn.Module):
    """NCHW images [B,3,S,S] float 0-255 -> `predictions` [B,A,5+C]: the
    eval forward of `module`, then `decode` (the model's eval decode)."""

    def __init__(self, module: nn.Module, decode):
        super().__init__()
        self.module = module
        self.decode = decode

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.decode(self.module(images.permute(0, 2, 3, 1)))


def deploy_module(model, device=None) -> DeployModule:
    """The DeployModule of an fp32, folded eval copy of `model`."""
    family_of(model.cfg)
    return DeployModule(eval_copy(model, device), model.loss.eval_decode)


def _warmed_example(module: nn.Module, shape, device) -> torch.Tensor:
    """A zero input of `shape`, after one call of `module` on one image of
    it: the first call makes the cached constants (`ops.constant`), which a
    tracer would otherwise record half-made (`torch.jit.trace`) or leave in
    the cache as its own fake tensors (`torch.export`)."""
    with torch.no_grad():
        module(torch.zeros((1, *shape[1:]), device=device))
    return torch.zeros(shape, device=device)


def _trace(dm: DeployModule, shape, device) -> torch.jit.ScriptModule:
    """`torch.jit.trace` of `dm` at `shape`, after a warming call. The
    tracer's own re-trace check is off: the exporters' callers hold the
    artifact against the eager forward instead (`--verify`, the tests)."""
    example = _warmed_example(dm, shape, device)
    with torch.no_grad():
        return torch.jit.trace(dm, example, check_trace=False)


def export_torchscript(model, path, size: int = 640, batch: int = 1
                       ) -> torch.jit.ScriptModule:
    """Trace the fp32 folded DeployModule at [batch,3,size,size] on the
    module's device and `torch.jit.save` it to `path`. The trace serves on
    that device only."""
    device = next(model.module.parameters()).device
    traced = _trace(deploy_module(model, device), (batch, 3, size, size),
                    device)
    torch.jit.save(traced, str(path))
    return traced


def opset13_forms(nodes: list, initializers: dict) -> list:
    """Rewrite torch's ONNX op list so that `onnx_writer` writes what it
    means, in opset 13's forms: the writer stores a 0-d tensor as shape [1]
    (so a scalar Gather index would give a rank-1 result), so each 0-d
    constant or initializer is written as [1] and squeezed back to 0-d by a
    node of its own; and a Split's `split` attribute (the opset-11 form
    that torch's constant folding leaves) becomes its second input. Adds
    the initializers it needs to `initializers`; returns the new list."""
    axes0 = "pl_yolo_tpu_torch::axes0"
    out = []

    def scalar(name, value):
        initializers[axes0] = np.zeros(1, np.int64)
        initializers[name + "::1d"] = np.reshape(value, (1,))
        out.append(("Squeeze", [name + "::1d", axes0], [name], {}))

    for name in [k for k, v in initializers.items() if np.ndim(v) == 0]:
        scalar(name, initializers.pop(name))
    for op, ins, outs, attrs in nodes:
        if op == "Constant" and np.ndim(attrs.get("value", 0)) == 0 \
                and "value" in attrs:
            scalar(outs[0], np.asarray(attrs["value"]))
            continue
        if op == "Split" and "split" in attrs and len(ins) == 1:
            attrs = dict(attrs)
            sizes = outs[0] + "::split"
            initializers[sizes] = np.asarray(attrs.pop("split"), np.int64)
            ins = [ins[0], sizes]
        out.append((op, ins, outs, attrs))
    return out


def export_onnx(model, batch: int = 1, size: int = 640) -> bytes:
    """The fp32 folded DeployModule as ONNX bytes (opset 13, IR 8, input
    `images` [batch,3,size,size], output `predictions`), from torch's
    symbolic tracer on the CPU, in opset 13's forms (`opset13_forms`)."""
    from .torch_onnx import extract_torch_onnx_ir, ir_to_model_bytes
    shape = (batch, 3, size, size)
    traced = _trace(deploy_module(model, "cpu"), shape, "cpu")
    example = torch.zeros(shape)
    with warnings.catch_warnings():
        # torch warns that a nearest Resize may differ from torch before
        # opset 11; the 2x nearest upsampling here does not, and the
        # exporters' tests run the graph against the eager forward
        warnings.filterwarnings("ignore", message=".*onnx:Resize.*")
        warnings.filterwarnings("ignore", message=".*already a ScriptModule")
        # (tracing the traced module again is a no-op)
        nodes, inits, inputs, outputs = extract_torch_onnx_ir(traced,
                                                              example)
    nodes = opset13_forms(nodes, inits)
    return ir_to_model_bytes(nodes, inits, inputs, outputs)


class ServeModule(nn.Module):
    """NHWC images [B,S,S,3] 0-255 -> (boxes, scores, classes, valid): the
    eval forward, decode and `postprocess` (`conf`, `nms` thresholds)."""

    def __init__(self, module: nn.Module, decode, conf: float = 0.25,
                 nms: float = 0.5):
        super().__init__()
        self.module = module
        self.decode = decode
        self.conf, self.nms = conf, nms

    def forward(self, images: torch.Tensor):
        preds = self.decode(self.module(images))
        det = postprocess(preds, conf_threshold=self.conf,
                          iou_threshold=self.nms, device=preds.device)
        return det.boxes, det.scores, det.classes, det.valid


def export_program(model, path, batch: int = 1, size: int = 640,
                   conf: float = 0.25, nms: float = 0.5
                   ) -> torch.export.ExportedProgram:
    """`torch.export` of the served function (`ServeModule`) of `model` in
    its config's compute dtype, at [batch,size,size,3] on the module's
    device, saved to `path` with `torch.export.save`."""
    module = model.module.eval()
    device = next(module.parameters()).device
    serve = ServeModule(module, model.loss.eval_decode, conf, nms)
    example = _warmed_example(serve, (batch, size, size, 3), device)
    with torch.no_grad():
        program = torch.export.export(serve, (example,))
    # the zero example would be saved in the file (79 MB at B=16, 640^2)
    program.example_inputs = None
    torch.export.save(program, str(path))
    return program


def max_abs_err(got, want, relative: bool = False) -> float:
    """max |got - want| (over max(1, |want|) where `relative`) of two
    arrays: equal entries (the same infinity, NaN on both sides: a trained
    model's decode may overflow) count 0, and an entry finite on one side
    only counts inf."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        err = np.abs(got - want)
        if relative:
            err = err / np.maximum(1.0, np.abs(want))
    return float(np.nan_to_num(np.where(same, 0.0, err), nan=np.inf).max(
        initial=0.0))


def detections_err(got, want) -> dict:
    """How far a served tuple (boxes, scores, classes, valid) `got` is from
    `want`: `same_valid` (the valid masks equal, and the classes where
    valid), the valid count, and the largest |a - b| / max(1, |b|) of the
    valid boxes and scores (inf where the masks differ)."""
    gb, gs, gc, gv = (t.detach().cpu() for t in got)
    wb, ws, wc, wv = (t.detach().cpu() for t in want)
    same = bool(torch.equal(gv, wv) and torch.equal(gc[wv], wc[wv]))
    err = float("inf")
    if same:
        err = max(max_abs_err(g[wv].float().numpy(), w[wv].float().numpy(),
                              relative=True) for g, w in ((gb, wb), (gs, ws)))
    return {"same_valid": same, "n_valid": int(wv.sum()), "max_rel": err}


def program_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device of an exported program's weights."""
    for t in (*program.state_dict.values(), *program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the exported program holds no tensor")


def load_program(path, device=None) -> nn.Module:
    """Load an `export_program` file onto `device` (default the CUDA card),
    moved there if it was exported on another; returns the callable
    module."""
    program = torch.export.load(str(Path(path)))
    return on_device(program, resolve_device(device)).module()


def on_device(program: torch.export.ExportedProgram, device
              ) -> torch.export.ExportedProgram:
    """`program`, moved to `device` (its weights, constants and the device
    arguments of its nodes) unless it is there already."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if program_device(program) == device:
        return program
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(program, device)
