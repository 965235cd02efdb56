"""Tensor, spatial and expert parallelism (`pl_yolo_tpu_torch/parallel/`:
cout-sharded convs, bands of rows with halo exchanges, sharded MoE experts),
their combinations with ZeRO, remat, DropBlock and depthwise convs, the
conv families beyond YOLOX under them (the tiny YOLOv7, YOLOv5 and e-YOLOX
of `FAMILIES`, and the registry's other conv backbones of `BACKBONES`:
MobileNetV3-S/L, ShuffleNetV2, CSPMobileNext and the six extras), and the
MoE FFN of the global batch under data parallelism, on the CPU over gloo,
at narrow widths and 64 px.

One 4-process spawn (`python tests/test_torch_parallel_tp_sp_ep.py ranks
RANK 4 PORT OUT COCO`) runs every multi-rank case in turn: model 2 x
spatial 2 (the narrow `yolox_s_tp2sp2.yaml`, its train steps and
`Trainer.fit`), data 2 x spatial 2 and data 2 x model 2 (each axis alone
beside the data axis), data 2 x expert 2 (the tiny MoE ViT of
`tests/test_parallel_ep.py`, whose experts overflow); the combinations of
`F64_LAYOUTS`: ZeRO-3 (accumulate 2, clip) over data 2 x model 2, ZeRO-1
over data 2 x spatial 2 and over data 2 x expert 2, remat and DropBlock
over model 2 x spatial 2, depthwise convs over data 2 x model 2, with a
state-dict round trip of the ZeRO-3 engine; the tiny YOLOv7, YOLOv5 and
e-YOLOX over model 2 x spatial 2 and e-YOLOX with ZeRO-3 over data 2 x
model 2; the ten backbones of `BACKBONES` over model 2 x spatial 2 and
MobileNetV3-S also over data 2 x spatial 2; the MoE FFN on the data 2
ranks, and the halo exchange (ResNet's strided pool and `SameConv2d`'s
7x7 among its ops), the squeeze-excites' band mean and AL-PAFPN's
bicubic upsampling on spatial 2 and spatial 4. A fifth child (`jax`)
runs the JAX package's steps of `JAX_CHILD` (the narrow YOLOX, the tiny
YOLOv7 and the tiny ConvNeXt on `make_mesh(model=2, spatial=2)`, the
tiny MobileNetV3-S on one device, the MoE ViT on `make_mesh(data=2,
expert=2)` of the conftest's virtual devices), its `state_specs`, and
its `moe_ffn` of the global batch. This process meanwhile computes the
one-process references, fits one process, and runs the JAX steps of
`JAX_HERE` on `make_mesh(data=2, model=2)` (ZeRO-3, the depthwise YOLOX)
and the tiny MobileNetV3-S's on `make_mesh(model=2, spatial=2)`. The
parametrised tests below assert on the children's files.

Tolerances:
  * float64, the ranks against one process's run of the same config on
    the global batch (two augmented steps of each layout): 1e-9 of each
    tensor's change, and of each loss and of the clip's global norm, and
    of the scale of the eval predictions through the gathered EMA. The
    same function; only the order of the sums differs (BatchNorm's
    statistics over the norm group, the gradients summed, the conv's
    input gradient summed over the model group). The MoE router, whose
    logits are fp32 in both packages, to ROUTER_TOL (1e-6);
  * fp32, two steps of the 4 ranks against the JAX package's mesh steps
    (1x2x2, the narrow YOLOX, and the tiny YOLOv7, MobileNetV3-S and
    ConvNeXt, whose first conv's kernel (ConvNeXt: bias) that mesh step
    moves by half its change: that leaf is held to half the ranks'
    change; 2x2 with ZeRO-3; 2x2 with the depthwise YOLOX):
    the bounds of `tests/test_parallel_sp.py`, each loss at rtol 2e-4 and each
    parameter at rtol 2e-3 / atol 2e-5; and each parameter's change at
    SLICE_TOL (5e-3) of the JAX step's change (worst seen 1.8e-3), under
    a tenth of MobileNetV3-S's leaves to the JAX package's one-device
    step instead at the same bounds (its squeeze-excites' fp32
    BatchNorms on 4 values a channel round apart in the two JAX steps);
  * the tiny MoE ViT in fp32 (un-augmented): against one process, each
    loss at 1e-5 relative and each parameter's change at 1e-3 of the
    change; against the JAX package's data 2 x expert 2 step, the loss at
    1e-3 relative (`tests/test_parallel_ep.py`) and each parameter's
    change at 5e-3 of the change (the state bound of
    `tests/test_torch_train.py`);
  * the halo exchange, the band mean and the MoE FFN, float64: 1e-12 of
    the scale (the same sums on rows fetched from other ranks); the
    bicubic upsampling
    of a band, bit for bit in bf16, and to BICUBIC_FP32_TOL (1e-6) of the
    scale in fp32 with its input gradient;
  * the trainer, fp32: the 4-rank fit's checkpoint against the
    one-process fit's, each tensor to 5e-3 of its change; the resumed 4
    ranks gather the checkpoint back bit for bit; the ZeRO-3 engine's
    state dicts likewise.

A tensor whose change is below 1e-3 of the largest change of its tree is
held to that floor instead.
"""

from __future__ import annotations

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# (the child processes run this file as a script: the repo root and the
# tests directory, which pytest's conftest puts on the path, by hand)
from pl_yolo_tpu_torch.data.augment import (  # noqa: E402
    AugmentConfig, make_augment_fn)
from pl_yolo_tpu_torch.layers import blocks  # noqa: E402
from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d  # noqa: E402
from pl_yolo_tpu_torch.models.backbones.vit import moe_ffn  # noqa: E402
from pl_yolo_tpu_torch.models.detector import build_model  # noqa: E402
from pl_yolo_tpu_torch.ops.resize import upsample_bicubic_2x  # noqa: E402
from pl_yolo_tpu_torch.parallel import distributed, mesh  # noqa: E402
from pl_yolo_tpu_torch.parallel import tensor  # noqa: E402
from pl_yolo_tpu_torch.parallel.zero import DataParallel  # noqa: E402
from pl_yolo_tpu_torch.train.optim import build_optimizer  # noqa: E402
from pl_yolo_tpu_torch.train.state import (  # noqa: E402
    TrainState, make_eval_step, make_train_step)
from pl_yolo_tpu_torch.train.trainer import Trainer  # noqa: E402
from pl_yolo_tpu_torch.utils.config import (  # noqa: E402
    CONFIG_DIR, load_config)

# one intra-op thread a test process: the suite runs in parallel workers
torch.set_num_threads(1)

NUM_CLASSES, SIZE, BATCH, STEPS, BASE_LR = 3, 64, 4, 2, 5e-4
F64_TOL, HALO_TOL, FP32_RATIO_TOL = 1e-9, 1e-12, 1e-6
# fp32 band against whole map: the sums of a band's matmuls may round
# apart (1 ulp seen)
BICUBIC_FP32_TOL = 1e-6
SP_LOSS_RTOL, SP_PARAM_RTOL, SP_PARAM_ATOL = 2e-4, 2e-3, 2e-5
MOE_LOSS_TOL, MOE_TOL, JAX_MOE_LOSS_TOL, SLICE_TOL = 1e-5, 1e-3, 1e-3, 5e-3
# the MoE router's logits are fp32 in a float64 module, as in the JAX
# package (`moe_ffn`): its gradient is an fp32 sum over each rank's tokens
# (3.6e-8 of its change from one process's seen), every other tensor
# float64 (1e-11)
ROUTER, ROUTER_TOL = "blocks_moe_router", 1e-6
# yolox_s_zero.yaml's clip, which binds on the narrow YOLOX's gradients
# (a global norm of 130-190 in its first steps)
CLIP = 35.0
# the configs of the runs: the narrow yolox_s_tp2sp2 (`_yolox_cfg`) with
# these changes, and the tiny MoE ViT (`_moe_cfg`)
VARIANTS = {
    "base": {},
    "zero3_accumulate": {"optimizer": {"accumulate_steps": 2,
                                       "clip_grad_norm": CLIP}},
    "zero3_clip": {"optimizer": {"clip_grad_norm": CLIP}},
    "remat_dropblock": {"remat": True,
                        "backbone": {"drop_block": {"rate": 0.1,
                                                    "size": 7}}},
    "depthwise": {part: {"depthwise": True}
                  for part in ("backbone", "neck", "head")},
    "moe": None,
    # the conv families beyond YOLOX (`FAMILIES`)
    "yolov7": None, "yolov5": None, "eyolox": None,
}
# the conv families of ROADMAP item 12c.4 part 1 at the tiny widths of
# their own tests (`tests/test_torch_yolov7.py`, `test_torch_anchor.py`,
# `test_torch_mobile.py`), 3 classes, fp32: {variant: (model YAML,
# changes)}; the YOLOv7 neck with its RepConvs
FAMILIES = {
    "yolov7": ("yolov7.yaml", {
        "backbone": {"channels": [8, 16, 32, 64, 64], "depths": [1, 1, 1, 1]},
        "neck": {"channels": [32, 64, 64], "depths": [1, 1, 1, 1],
                 "use_repconv": True},
        "head": {"channels": [16, 32, 64]}}),
    "yolov5": ("yolov5_s.yaml", {
        "backbone": {"channels": [8, 16, 32, 64, 128],
                     "depths": [1, 1, 1, 1]},
        "neck": {"channels": [32, 64, 128], "depths": [1, 1, 1, 1]},
        "head": {"channels": [32, 64, 128]}}),
    "eyolox": ("e-yolox_s.yaml", {
        "backbone": {"channels": [8, 16, 32, 64, 128]},
        "neck": {"channels": [32, 64, 128]},
        "head": {"channels": [32, 64, 128]}}),
}


def _around(backbone: dict, widths, yaml="yolox_s.yaml") -> tuple:
    """A registry backbone in a model YAML's place of its own (the section
    replaced, since it names the backbone), the neck and head as wide as
    its stage2-4 maps, the neck's depths 1."""
    return (yaml, {"backbone": backbone,
                   "neck": {"channels": list(widths), "depths": [1, 1, 1, 1]},
                   "head": {"channels": list(widths)}})


# ROADMAP item 12c.4 part 2: the registry's other conv backbones, at the
# narrow widths of `tests/test_torch_mobile.py` and
# `tests/test_torch_extras.py` (MobileNetV3 and GhostNet at their tables'
# only widths), each with a CSP-PAFPN neck (AL-PAFPN for CSPMobileNext,
# in e-YOLOX's place of ECMNet) and a decoupled head
BACKBONES = {
    "mobilenetv3s": _around({"name": "mobilenetv3s"}, (24, 48, 96)),
    "mobilenetv3l": _around({"name": "mobilenetv3l"}, (40, 80, 160)),
    "shufflenetv2": _around({"name": "shufflenetv2", "use_se": True,
                             "channels": [24, 48, 96, 192]}, (48, 96, 192)),
    "cspmobilenext": ("e-yolox_s.yaml", {
        "backbone": {"name": "cspmobilenext", "depths": [1, 3, 3, 1],
                     "channels": [8, 16, 32, 64, 128],
                     "outputs": ["stage2", "stage3", "stage4"]},
        "neck": {"channels": [32, 64, 128]},
        "head": {"channels": [32, 64, 128]}}),
    "efficientrep": _around({"name": "efficientrep", "depths": [1, 1, 1, 1],
                             "channels": [8, 16, 32, 64, 128]},
                            (32, 64, 128)),
    "resnet": _around({"name": "resnet", "depths": [1, 1, 1, 1],
                       "channels": [8, 16, 32, 64]}, (16, 32, 64)),
    "convnext": _around({"name": "convnext", "depths": [1, 1, 1, 1],
                         "channels": [8, 16, 32, 64]}, (16, 32, 64)),
    "ghostnet": _around({"name": "ghostnet"}, (40, 112, 160)),
    "vgg": _around({"name": "vgg", "channels": [8, 16, 32, 64, 64]},
                   (32, 64, 64)),
    "mobilenext": _around({"name": "mobilenext", "depths": [1, 1, 1, 1],
                           "channels": [8, 16, 32, 64, 128]}, (32, 64, 128)),
}
FAMILIES.update(BACKBONES)
VARIANTS.update(dict.fromkeys(BACKBONES))
# the float64 layouts, (data, Layout keywords, ZeRO level, variant),
# against one process's run of the variant
F64_LAYOUTS = {
    "model2_spatial2": (1, {"model": 2, "spatial": 2}, 0, "base"),
    "data2_spatial2": (2, {"spatial": 2}, 0, "base"),
    "data2_model2": (2, {"model": 2}, 0, "base"),
    "data2_model2_zero3": (2, {"model": 2}, 3, "zero3_accumulate"),
    "data2_spatial2_zero1": (2, {"spatial": 2}, 1, "base"),
    "data2_expert2_zero1": (2, {"expert": 2}, 1, "moe"),
    "model2_spatial2_remat_dropblock": (1, {"model": 2, "spatial": 2}, 0,
                                        "remat_dropblock"),
    "data2_model2_depthwise": (2, {"model": 2}, 0, "depthwise"),
    "yolov7_model2_spatial2": (1, {"model": 2, "spatial": 2}, 0, "yolov7"),
    "yolov5_model2_spatial2": (1, {"model": 2, "spatial": 2}, 0, "yolov5"),
    "eyolox_model2_spatial2": (1, {"model": 2, "spatial": 2}, 0, "eyolox"),
    "eyolox_data2_model2_zero3": (2, {"model": 2}, 3, "eyolox"),
    # item 12c.4 part 2; MobileNetV3-S's squeeze-excites on bands also
    # beside the data axis, whose ranks the band mean leaves out
    **{f"{v}_model2_spatial2": (1, {"model": 2, "spatial": 2}, 0, v)
       for v in BACKBONES},
    "mobilenetv3s_data2_spatial2": (2, {"spatial": 2}, 0, "mobilenetv3s")}
# the fp32 layouts held to the JAX package's mesh steps, un-augmented
JAX_LAYOUTS = {"model2_spatial2": (1, {"model": 2, "spatial": 2}, 0, "base"),
               "data2_model2_zero3": (2, {"model": 2}, 3, "zero3_clip"),
               "data2_model2_depthwise": (2, {"model": 2}, 0, "depthwise"),
               "yolov7_model2_spatial2": (1, {"model": 2, "spatial": 2}, 0,
                                          "yolov7"),
               "mobilenetv3s_model2_spatial2": (1, {"model": 2, "spatial": 2},
                                                0, "mobilenetv3s"),
               "convnext_model2_spatial2": (1, {"model": 2, "spatial": 2}, 0,
                                            "convnext")}
# the flax leaf of the tiny YOLOv7 that the JAX package's step on
# make_mesh(model=2, spatial=2) moves by half its change (the first conv,
# on the raw image; see the YOLOv7 mesh test)
STEM_KERNEL = ("params", "backbone", "stem0", "conv", "kernel")
# the parts of `_jax_refs` the JAX child computes, and this process
JAX_CHILD, JAX_HERE = (("tp_sp", "yolov7", "ep", "convnext",
                         "mobilenetv3s_one_device"),
                        ("combos", "mobilenetv3s"))
# the halo cases: (op, ksize, stride) of the YOLOX path x (spatial width,
# rows a band); the 13-pool on one-row bands reaches past the next band
HALO_OPS = {"conv3": (3, 1), "conv3_s2": (3, 2), "pool5": (5, 1),
            "pool9": (9, 1), "pool13": (13, 1),
            # ResNet's stem pool (pad 1, -inf) and ConvNeXt's 7x7 'SAME'
            # depthwise-sized window (`SameConv2d`, the whole map's pads)
            "pool3_s2": (3, 2), "conv7_same": (7, 1)}
HALO_BANDS = {"s2_rows1": (2, 1), "s2_rows4": (2, 4), "s4_rows1": (4, 1),
              "s4_rows2": (4, 2)}
# (a stride-2 conv takes bands of even rows)
HALO_CASES = [(op, band) for op in sorted(HALO_OPS)
              for band in sorted(HALO_BANDS)
              if HALO_BANDS[band][1] % HALO_OPS[op][1] == 0]
# AL-PAFPN's bicubic 2x upsampling on bands: (whole map H, W, spatial
# width); a tall map whose bands are wider than tall (the whole map's
# order of the two contractions, not the band's), a wide map, one-row
# bands (the halo of 2 rows reaches past the next band, the edge weights
# of the image's top and bottom on both)
BICUBIC_MAPS = {"tall_s2": (4, 4, 2), "tall_s4": (8, 6, 4),
                "wide_s2": (2, 8, 2), "rows1_s2": (2, 2, 2),
                "rows1_s4": (4, 3, 4)}
BICUBIC_CASES = [(m, d) for m in sorted(BICUBIC_MAPS)
                 for d in ("bfloat16", "float32")]
# the squeeze-excites' mean over the whole map on bands: (spatial width,
# rows a band) of a [2, 4, rows·width, 5] map
MEAN_BANDS = {"s2_rows1": (2, 1), "s2_rows3": (2, 3), "s4_rows1": (4, 1),
              "s4_rows2": (4, 2)}


# ------------------------------------------------------------------ inputs

def _yolox_cfg():
    """yolox_s_tp2sp2.yaml at the narrow widths of `__graft_entry__.py`,
    in fp32."""
    cfg = load_config(CONFIG_DIR / "model" / "yolox_s_tp2sp2.yaml")
    cfg["backbone"].update(channels=[8, 16, 32, 64, 128], depths=[1, 1, 1, 1])
    cfg["neck"]["channels"] = cfg["head"]["channels"] = [32, 64, 128]
    cfg["dtype"] = None
    cfg["optimizer"]["learning_rate"] = BASE_LR
    return cfg


def _moe_cfg():
    """`tests/test_parallel_ep.py`'s tiny MoE ViT detector, its experts
    overflowing (capacity factor 0.5), at a base LR of 5e-4."""
    return {"name": "tiny_vit_moe_ep", "dtype": "float32",
            "backbone": {"name": "vision_transformer", "embed_dim": 32,
                         "depth": 2, "num_heads": 2, "patch_size": 16,
                         "moe_experts": 4, "moe_capacity": 0.5},
            "neck": {"name": "csppafpn", "channels": [16, 16, 32],
                     "depths": [1, 1, 1, 1]},
            "head": {"name": "decoupled_head", "channels": [16, 16, 32]},
            "loss": {"name": "yolox"},
            "optimizer": {"name": "sgd", "learning_rate": BASE_LR,
                          "momentum": 0.9, "weight_decay": 0.0005,
                          "warmup": 0.1}}


def _family_cfg(variant):
    """A conv family of `FAMILIES` at its tiny widths, in fp32, at a base
    LR of 5e-4."""
    name, changes = FAMILIES[variant]
    cfg = load_config(CONFIG_DIR / "model" / name)
    for part, value in changes.items():
        # (a section that names its module replaces the YAML's)
        cfg[part] = ({**value} if "name" in value
                     else {**cfg[part], **value})
    cfg["dtype"] = None
    cfg["optimizer"]["learning_rate"] = BASE_LR
    return cfg


def _cfg(variant):
    """The model config of a variant (`VARIANTS`)."""
    if variant == "moe":
        return _moe_cfg()
    if variant in FAMILIES:
        return _family_cfg(variant)
    cfg = _yolox_cfg()
    for key, value in VARIANTS[variant].items():
        if isinstance(value, dict):
            cfg[key] = {**cfg.get(key, {}), **value}
        else:
            cfg[key] = value
    return cfg


def _batch(seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3)).astype(dtype)
    labels = np.zeros((BATCH, 6, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NUM_CLASSES, (BATCH, 3))
    labels[:, :3, 1:3] = rng.uniform(12, 52, (BATCH, 3, 2))
    labels[:, :3, 3:] = rng.uniform(8, 40, (BATCH, 3, 2))
    return torch.from_numpy(images), torch.from_numpy(labels)


def _moe_params(dtype=torch.float64):
    """One MoE layer ([E=4, d=8, m=16]) whose router favours expert 0, so
    that it overflows at a capacity factor of 0.5."""
    g = torch.Generator().manual_seed(0)
    p = {"moe_router": torch.randn(8, 4, generator=g, dtype=dtype) * 0.1,
         "moe_w1": torch.randn(4, 8, 16, generator=g, dtype=dtype) * 0.1,
         "moe_b1": torch.randn(4, 16, generator=g, dtype=dtype) * 0.1,
         "moe_w2": torch.randn(4, 16, 8, generator=g, dtype=dtype) * 0.1,
         "moe_b2": torch.randn(4, 8, generator=g, dtype=dtype) * 0.1}
    p["moe_router"][:, 0] += 0.3
    y = torch.randn(BATCH, 6, 8, generator=g, dtype=dtype).abs()
    return p, y


def _halo_input(name, band_rows, width):
    """The whole map of a halo case [2, 4, band_rows·width, 8] and the
    weights of its conv and of its output's test function."""
    ksize, stride = HALO_OPS[name]
    g = torch.Generator().manual_seed(ksize * 10 + band_rows + width)
    h = band_rows * width
    x = torch.randn(2, 4, h, 8, generator=g, dtype=torch.float64)
    w = torch.randn(6, 4, ksize, ksize, generator=g, dtype=torch.float64)
    out = torch.randn(2, 6 if name.startswith("conv") else 4, h // stride,
                      8 // stride, generator=g, dtype=torch.float64)
    return x, w, out


def _bicubic_input(name, dtype):
    """The whole map of a bicubic case [2, 3, H, W] in `dtype` and the
    weights of its output's test function."""
    h, w, width = BICUBIC_MAPS[name]
    g = torch.Generator().manual_seed(h * 100 + w * 10 + width)
    x = torch.randn(2, 3, h, w, generator=g).to(getattr(torch, dtype))
    return x, torch.randn(2, 3, 2 * h, 2 * w, generator=g)


def _bicubic_run(name, dtype, layout=None):
    """`upsample_bicubic_2x` of the whole map, or of this spatial rank's
    band under `layout`, and (fp32) the gradient of sum(out · weights)
    w.r.t. its input."""
    x, ow = _bicubic_input(name, dtype)
    if layout is not None:
        n = x.shape[2] // layout.spatial
        rows = slice(layout.spatial_index * n, (layout.spatial_index + 1) * n)
        x, ow = x[:, :, rows], ow[:, :, 2 * rows.start:2 * rows.stop]
    x = x.clone().requires_grad_(dtype == "float32")
    with mesh.use_layout(layout):
        y = upsample_bicubic_2x(x)
    if dtype != "float32":
        return {"out": y.detach()}
    (y * ow).sum().backward()
    return {"out": y.detach(), "grad": x.grad}


def _halo_apply(name, x, w):
    ksize, stride = HALO_OPS[name]
    if name == "pool3_s2":
        return blocks.max_pool(x, ksize, stride, 1)
    if name.startswith("pool"):
        return blocks.max_pool_same(x, ksize)
    if name == "conv7_same":
        conv = blocks.SameConv2d(4, 6, ksize, bias=False).double()
        with torch.no_grad():
            conv.weight.copy_(w)
        return conv(x)
    conv = torch.nn.Conv2d(4, 6, ksize, stride, (ksize - 1) // 2,
                           bias=False).double()
    with torch.no_grad():
        conv.weight.copy_(w)
    return blocks._conv(conv, x, None)


def _halo_run(name, x, w, out_weight, rows=None):
    """The op on x (or on its rows `rows`), and the gradient of
    sum(op · out_weight) w.r.t. x."""
    x = (x if rows is None else x[:, :, rows]).clone().requires_grad_()
    y = _halo_apply(name, x, w)
    stride = HALO_OPS[name][1]
    ow = out_weight if rows is None else out_weight[
        :, :, rows.start // stride:rows.stop // stride]
    (y * ow).sum().backward()
    return {"out": y.detach(), "grad": x.grad}


def _mean_run(name, layout=None):
    """A squeeze-excite's gate on a [2, 4, H, 5] map of a band mean case
    (`MEAN_BANDS`): y = x · sigmoid(W · mean(x)), the mean over the whole
    map (`blocks.spatial_mean`), or over this spatial rank's band under
    `layout`; the mean, y, and the gradient of sum(y · weights) w.r.t. x
    (each rank's loss holds its band's rows: the gate's gradient is
    partial on each)."""
    width, band_rows = MEAN_BANDS[name]
    g = torch.Generator().manual_seed(width * 10 + band_rows)
    h = width * band_rows
    x = torch.randn(2, 4, h, 5, generator=g, dtype=torch.float64)
    w = torch.randn(4, 4, generator=g, dtype=torch.float64)
    ow = torch.randn(2, 4, h, 5, generator=g, dtype=torch.float64)
    if layout is not None:
        rows = slice(layout.spatial_index * band_rows,
                     (layout.spatial_index + 1) * band_rows)
        x, ow = x[:, :, rows], ow[:, :, rows]
    x = x.clone().requires_grad_()
    with mesh.use_layout(layout):
        s = blocks.spatial_mean(x)
        y = x * torch.sigmoid(torch.einsum("bcij,cd->bdij", s, w))
    (y * ow).sum().backward()
    return {"mean": s.detach(), "out": y.detach(), "grad": x.grad}


# -------------------------------------------------------------- the runs

def _run(variant, layout, rows, dtype=torch.float64, augment=True, zero=0,
         roundtrip=False):
    """Two train steps of a variant (`VARIANTS`: the narrow YOLOX, or the
    tiny MoE ViT) on rows `rows` of the global batch (augmented: the s2d
    augmentation for a Focus stem, as the trainer feeds it, else the NHWC
    one), under `layout` through the engine at ZeRO level `zero`, else in
    one process; the state gathered as one process keeps it, the clip's
    global norm at each update, and the eval predictions of the global
    batch through the state's `eval_module` (under the layout the EMA
    gathered from the ranks' parts). With `roundtrip`, the gathered
    state loaded into a new engine and gathered back."""
    cfg = _cfg(variant)
    cfg["dtype"] = None
    model = build_model(cfg, NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE))
    model.module.to(dtype)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    engine = (DataParallel(model.module, layout, zero=zero)
              if layout is not None else None)
    # (the slices a rank holds of ConvNeXt's init, against the bridge's)
    held_init = ({k: v.clone() for k, v in model.module.state_dict().items()}
                 if engine is not None and variant == "convnext" else None)
    views = engine.optimizer_views() if engine is not None else {}
    norm = views.get("global_norm") or (lambda: torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad.to(
            torch.promote_types(p.dtype, torch.float32)))
            for p in model.module.parameters() if p.grad is not None])))
    norms = []

    def recorded():
        n = norm()
        norms.append(float(n))
        return n
    views["global_norm"] = recorded
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10,
                                   **views)
    state = TrainState.create(model.module, optimizer, parallel=engine)
    s2d = getattr(type(model.module.backbone), "STEM_S2D", False)

    def apply(module, x):
        if not (augment and s2d):
            return module(x.to(dtype))
        with stem_input_s2d():
            return module(x.to(dtype))
    step = make_train_step(
        model.loss.train_loss,
        augment_fn=(make_augment_fn(AugmentConfig(
            max_labels=20, pixel_dtype="float32"), out_s2d=s2d)
            if augment else None), apply_fn=apply)
    generator = torch.Generator().manual_seed(1)
    images, labels = _batch(5 if variant == "moe" else 0)
    if not augment:
        images = images.float()
    losses = [{k: float(v) for k, v in step(
        state, images[rows], labels[rows], generator=generator).items()}
        for _ in range(STEPS)]
    preds = make_eval_step(model.loss.eval_decode)(state.eval_module,
                                                   images.to(dtype))
    if engine is not None:
        order = [e.name for e in engine._opt_entries()]
        # (the EMA as validation takes it: gathered from the ranks' parts
        # where they hold parts, the EMA copy itself where they do not)
        out = {"params": engine.module_state_dict(),
               "ema": state.eval_module.state_dict(),
               "optimizer": engine.optimizer_state_dict(),
               "bytes": engine.state_bytes(), "specs": sorted(engine.specs),
               "zero_params": sorted(e.name for e in engine.params
                                     if e.zero is not None),
               "zero_ema": sorted(e.name for e in engine.ema_entries or []
                                  if e.zero is not None and e.name in init)}
        if roundtrip:
            out["roundtrip"] = _roundtrip(variant, layout, zero, dtype, out)
        if held_init is not None:
            out["held_init"] = held_init
    else:
        names = {id(p): n for n, p in model.module.named_parameters()}
        order = [names[id(p)] for g in optimizer.param_groups
                 for p in g["params"]]
        out = {"params": state.module.state_dict(),
               "ema": state.ema_module.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    out["opt_state"] = {f"{order[i]}/{k}": v for i, st in out.pop(
        "optimizer")["state"].items() for k, v in st.items()
        if isinstance(v, torch.Tensor) and v.ndim}
    out.update(losses=losses, init=init, preds=preds, norms=norms)
    return _detach(out)


def _roundtrip(variant, layout, zero, dtype, saved):
    """A new engine of the variant under `layout` at ZeRO level `zero`
    loads the gathered module, EMA and optimizer state dicts `saved`
    (each rank keeps its parts) and gathers them back; with the shapes of
    the parts it holds."""
    cfg = _cfg(variant)
    cfg["dtype"] = None
    model = build_model(cfg, NUM_CLASSES, device="cpu",
                        input_size=(SIZE, SIZE), seed=7)
    model.module.to(dtype)
    engine = DataParallel(model.module, layout, zero=zero)
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"], 10,
                                   **engine.optimizer_views())
    state = TrainState.create(model.module, optimizer, parallel=engine)
    engine.load_module_state_dict(saved["params"])
    engine.load_ema_state_dict(saved["ema"])
    engine.load_optimizer_state_dict(saved["optimizer"])
    order = [e.name for e in engine._opt_entries()]
    return {"params": engine.module_state_dict(),
            "ema": state.eval_module.state_dict(),
            "opt_state": {f"{order[i]}/{k}": v for i, st in
                          engine.optimizer_state_dict()["state"].items()
                          for k, v in st.items()
                          if isinstance(v, torch.Tensor) and v.ndim},
            "held": {e.name: tuple(engine.held(e).shape)
                     for e in engine.params}}


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detach(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _rows(layout):
    per = BATCH // layout.data
    return slice(layout.data_index * per, (layout.data_index + 1) * per)


# ----------------------------------------------------------- the trainer

def _trainer_cfgs(root, out_dir, parallel=True):
    model_cfg = _yolox_cfg()
    # mosaic on in the one epoch: the no-aug epochs' L1 term takes the
    # sign of residuals near zero, so that two fp32 runs of one process on
    # 1 and 4 threads already differ by ~1e-2 of an early conv's change
    model_cfg.update(name="tiny", schedule={"no_aug_epochs": 0})
    if not parallel:
        model_cfg.pop("parallel")
    data_cfg = load_config(CONFIG_DIR / "data" / "coco2017.yaml")
    data_cfg["dataset"].update(
        dir=str(root), train="images", val="images", test="images",
        train_json="annotations/instances.json",
        val_json="annotations/instances.json",
        test_json="annotations/instances.json", train_size=[SIZE, SIZE],
        val_size=[SIZE, SIZE], train_batch_size=BATCH, val_batch_size=2)
    data_cfg["num_classes"] = NUM_CLASSES
    data_cfg["classes"] = [f"class{i}" for i in range(NUM_CLASSES)]
    return model_cfg, data_cfg, dict(max_epochs=1, logger="csv",
                                     output_dir=str(out_dir), device="cpu",
                                     log_every_n_steps=1)


def _fit(root, out_dir, parallel=True):
    """Trainer.fit for one epoch of 2 steps and its validation; under the
    layout, the checkpoint then resumed by 4 new ranks (no step left), their
    state gathered back."""
    model_cfg, data_cfg, kw = _trainer_cfgs(root, out_dir, parallel)
    trainer = Trainer(model_cfg, data_cfg, **kw)
    trainer.fit()
    out = {"mAP": trainer.best_map,
           "ckpt": str(Path(out_dir) / "tiny" / "checkpoints")}
    if parallel:
        resumed = Trainer(model_cfg, data_cfg, **kw)
        resumed.fit(resume=True)
        par = resumed.state.parallel
        out["resumed"] = _detach({
            "step": resumed.state.step, "module": par.module_state_dict(),
            "ema_module": par.ema_state_dict(),
            "optimizer": par.optimizer_state_dict(),
            "held": {n: tuple(p.shape) for n, p in
                     resumed.state.module.named_parameters()}})
    return out


# ------------------------------------------------------------ the children

def _ranks(rank: int, world: int, port: int, out: str, coco: str) -> None:
    distributed.initialize(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world, local_world_size=world)
    res = {}
    layouts = {}   # (data, Layout keywords) -> its Layout, made once
    for name, (data, kw, zero, variant) in F64_LAYOUTS.items():
        key = (data, tuple(sorted(kw.items())))
        layout = layouts.setdefault(key, mesh.Layout(data, **kw))
        res[f"f64/{name}"] = _run(variant, layout, _rows(layout), zero=zero,
                                  roundtrip=name == "data2_model2_zero3")
        del res[f"f64/{name}"]["init"]    # (one process's is the same)
        res[f"index/{name}"] = layout.index
    for name, (data, kw, zero, variant) in JAX_LAYOUTS.items():
        layout = layouts[data, tuple(sorted(kw.items()))]
        res[f"f32/{name}"] = _run(variant, layout, _rows(layout),
                                  dtype=torch.float32, augment=False,
                                  zero=zero)
    tp_sp = layouts[1, (("model", 2), ("spatial", 2))]
    # the MoE FFN of the global batch on the data 2 ranks (model 2 alike)
    data2 = layouts[2, (("model", 2),)]
    p, y = _moe_params()
    with mesh.use_layout(data2):
        res["moe_ffn"] = moe_ffn(p, y[_rows(data2)], 0.5)
    ep = layouts[2, (("expert", 2),)]
    res["ep"] = _run("moe", ep, _rows(ep), dtype=torch.float32,
                     augment=False)
    # the halo exchange: every op on every band layout; the bicubic
    # upsampling on every band layout
    sp4 = mesh.Layout(1, spatial=4)
    for name, dtype in BICUBIC_CASES:
        res[f"bicubic/{name}/{dtype}"] = _bicubic_run(
            name, dtype, tp_sp if BICUBIC_MAPS[name][2] == 2 else sp4)
    for op, band_name in HALO_CASES:
        width, band_rows = HALO_BANDS[band_name]
        layout = tp_sp if width == 2 else sp4
        rows = slice(layout.spatial_index * band_rows,
                     (layout.spatial_index + 1) * band_rows)
        x, w, ow = _halo_input(op, band_rows, width)
        with mesh.use_layout(layout):
            res[f"halo/{op}/{band_name}"] = _halo_run(op, x, w, ow, rows)
    for name in sorted(MEAN_BANDS):
        res[f"mean/{name}"] = _mean_run(
            name, tp_sp if MEAN_BANDS[name][0] == 2 else sp4)
    res["fit"] = _fit(coco, Path(out).parent / "runs4")
    torch.save(res, out)
    distributed.shutdown()


def _jax(out: str) -> None:
    """The JAX child: the references of `_jax_refs(*JAX_CHILD)`, under
    the conftest's JAX settings (8 virtual devices)."""
    import conftest  # noqa: F401
    torch.save(_jax_refs(*JAX_CHILD), out)


def _compiled(jitted, *args):
    """The jitted JAX function lowered for `args` and compiled at XLA's
    backend optimization level 0: the same function, compiled in about
    three quarters of the time at these sizes (a mesh step's losses
    agree with level 2's to 1e-7, relative)."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_sharded(variables, mesh_, module=None) -> list:
    """The torch names of the params whose JAX `state_specs` on `mesh_`
    names a mesh axis."""
    import jax
    from pl_yolo_tpu.parallel.mesh import state_specs
    from pl_yolo_tpu_torch import bridge
    convt = bridge._conv_transposes(module)
    leaves = bridge._flatten({"params": variables["params"]})
    specs = state_specs({"params": variables["params"]}, mesh_)
    names = []
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(
                s, jax.sharding.PartitionSpec))[0]:
        key = tuple(str(k.key) for k in path)
        if any(a is not None for a in spec):
            names.append(bridge._to_torch_key(key, leaves[key], convt)[0])
    return sorted(names)


def _jax_on_axis(variables, mesh_, zero, axis, module=None) -> dict:
    """The torch names of the params, and of the EMA copy's params and BN
    statistics, whose leaf `state_specs` of a TrainState at ZeRO level
    `zero` shards over `axis`: {"params": [...], "ema": [...]}."""
    import jax
    from pl_yolo_tpu.parallel.mesh import state_specs
    from pl_yolo_tpu.train.optim import build_optimizer as jax_optimizer
    from pl_yolo_tpu.train.state import TrainState as JState
    from pl_yolo_tpu_torch import bridge
    convt = bridge._conv_transposes(module)
    tx, _ = jax_optimizer({"name": "sgd"}, total_steps=10)
    specs = state_specs(JState.create(variables, tx), mesh_, zero=zero)
    out = {}
    for part, trees in (("params", {"params": specs.params}),
                        ("ema", {"params": specs.ema_params,
                                 "batch_stats": specs.ema_batch_stats})):
        names = []
        for coll, tree in trees.items():
            leaves = bridge._flatten({coll: variables[coll]})
            for path, spec in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda s: isinstance(
                        s, jax.sharding.PartitionSpec))[0]:
                key = (coll,) + tuple(str(k.key) for k in path)
                if axis in tuple(spec):
                    names.append(bridge._to_torch_key(
                        key, leaves[key], convt)[0])
        out[part] = sorted(names)
    return out


def _jax_refs(*parts: str) -> dict:
    """The JAX package's references, from the port's initial weights:
    "tp_sp", the fp32 step of the narrow YOLOX on make_mesh(model=2,
    spatial=2) with `sp_constraint`; "combos", its ZeRO-3 step (with the
    clip, `zero_constraint`) and the depthwise YOLOX's step on
    make_mesh(data=2, model=2); "yolov7", "mobilenetv3s" and "convnext",
    the tiny YOLOv7's, MobileNetV3-S's and ConvNeXt's steps on
    make_mesh(model=2, spatial=2), "mobilenetv3s_one_device" MobileNetV3-S's
    on one device; "ep", the MoE ViT's step on make_mesh(
    data=2, expert=2) and `moe_ffn` of the global batch; each with the
    leaves `state_specs` shards. The JAX child computes some of them
    while the test process computes the others (`_jax`)."""
    import jax
    import jax.numpy as jnp
    from pl_yolo_tpu.layers import blocks as jb
    from pl_yolo_tpu.models.backbones.vit import moe_ffn as jax_moe_ffn
    from pl_yolo_tpu.models.detector import build_model as jax_build_model
    from pl_yolo_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                           shard_batch, shard_tp,
                                           sp_constraint, zero_constraint)
    from pl_yolo_tpu.train.optim import build_optimizer as jax_optimizer
    from pl_yolo_tpu.train.state import TrainState as JState
    from pl_yolo_tpu.train.state import make_train_step as jax_step
    from pl_yolo_tpu_torch import bridge

    def flat(state):
        return dict(bridge._flatten(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats})))

    def mesh_steps(variant, mesh_, zero=0):
        """The fp32 step of a YOLOX variant on `mesh_` (ZeRO at `zero`,
        with `zero_constraint`), two un-augmented steps from the port's
        initial weights: the losses and the parameters."""
        cfg = _cfg(variant)
        init = build_model(cfg, NUM_CLASSES, device="cpu",
                           input_size=(SIZE, SIZE)).module.state_dict()
        variables = bridge.state_dict_to_variables(
            {k: v.float() for k, v in init.items()})
        model = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
        tx, _ = jax_optimizer(cfg["optimizer"], total_steps=10)
        state = shard_tp(JState.create(variables, tx), mesh_, zero=zero)
        step = jax_step(
            model.module.apply, model.loss.train_loss, donate=False,
            constrain_images=sp_constraint(mesh_),
            constrain_state=(zero_constraint(state, mesh_, zero) if zero
                             else None))
        images, labels = _batch(0)
        b = shard_batch(mesh_, {"images": jnp.asarray(images.numpy(),
                                                      jnp.float32),
                                "labels": jnp.asarray(labels.numpy())})
        # (each step's state laid out as the first's: the step is lowered
        # and compiled once)
        layout = jax.tree.map(lambda x: x.sharding, state)
        losses = []
        with mesh_:
            run = _compiled(step, state, b["images"], b["labels"],
                            jax.random.key(0))
            for i in range(STEPS):
                state, lo = run(state, b["images"], b["labels"],
                                jax.random.key(i))
                state = jax.device_put(state, layout)
                losses.append({k: float(v) for k, v in lo.items()})
        return {"losses": losses, "params": flat(state)}, variables

    res = {}
    prev = jb.get_compute_dtype()
    jb.set_compute_dtype(None)
    try:
        if "tp_sp" in parts:     # the narrow YOLOX on a 1 x 2 x 2 mesh
            mesh_ = make_mesh(model=2, spatial=2, devices=jax.devices()[:4])
            res["tp_sp"], variables = mesh_steps("base", mesh_)
            res["tp_sp_specs"] = _jax_sharded(variables, mesh_)
        if "combos" in parts:    # ZeRO-3 and depthwise on data 2 x model 2
            mesh_ = make_mesh(data=2, model=2, devices=jax.devices()[:4])
            res["data2_model2_zero3"], variables = mesh_steps(
                "zero3_clip", mesh_, zero=3)
            res["zero3_specs"] = {axis: _jax_on_axis(variables, mesh_, 3,
                                                     axis)
                                  for axis in ("data", "model")}
            res["data2_model2_depthwise"], variables = mesh_steps(
                "depthwise", mesh_)
            res["depthwise_specs"] = _jax_sharded(variables, mesh_)
        # the tiny YOLOv7, MobileNetV3-S and ConvNeXt on a 1 x 2 x 2 mesh;
        # MobileNetV3-S also on one device: the JAX package's own fp32
        # spread between the two (`_assert_matches_jax_mesh_step`)
        for variant in ("yolov7", "mobilenetv3s", "convnext"):
            if variant in parts:
                mesh_ = make_mesh(model=2, spatial=2,
                                  devices=jax.devices()[:4])
                res[f"{variant}_model2_spatial2"], _ = mesh_steps(variant,
                                                                  mesh_)
        if "mobilenetv3s_one_device" in parts:
            res["mobilenetv3s_one_device"], _ = mesh_steps(
                "mobilenetv3s", make_mesh(devices=jax.devices()[:1]))
        if "ep" not in parts:
            return res
        # the MoE ViT on data 2 x expert 2
        cfg = _moe_cfg()
        port = build_model(copy.deepcopy(cfg), NUM_CLASSES, device="cpu",
                           input_size=(SIZE, SIZE)).module
        variables = bridge.state_dict_to_variables(port.state_dict(), port)
        mesh_ = make_mesh(data=2, expert=2, devices=jax.devices()[:4])
        res["ep_specs"] = _jax_sharded(variables, mesh_, port)
        res["ep_zero1_specs"] = {axis: _jax_on_axis(variables, mesh_, 1,
                                                    axis, port)
                                 for axis in ("data", "expert")}
        model = jax_build_model(copy.deepcopy(cfg), NUM_CLASSES)
        tx, _ = jax_optimizer(cfg["optimizer"], total_steps=10)
        state = shard_tp(JState.create(variables, tx), mesh_)
        step = jax_step(model.module.apply, model.loss.train_loss,
                        donate=False)
        images, labels = _batch(5, np.float32)
        imgs = jax.device_put(jnp.asarray(images.numpy()),
                              batch_sharding(mesh_))
        labs = jax.device_put(jnp.asarray(labels.numpy()),
                              batch_sharding(mesh_))
        layout = jax.tree.map(lambda x: x.sharding, state)
        losses = []
        with mesh_:
            run = _compiled(step, state, imgs, labs, jax.random.key(0))
            for i in range(STEPS):
                state, lo = run(state, imgs, labs, jax.random.key(i))
                state = jax.device_put(state, layout)
                losses.append({k: float(v) for k, v in lo.items()})
        convt = bridge._conv_transposes(port)
        res["ep"] = {"losses": losses, "params": {
            bridge._to_torch_key(k, v, convt)[0]: torch.from_numpy(
                np.array(bridge._to_torch_key(k, v, convt)[1]))
            for k, v in flat(state).items() if k[0] == "params"}}
        # the MoE FFN of the global batch
        p, y = _moe_params()
        res["moe_ffn"] = torch.from_numpy(np.array(jax.jit(
            jax_moe_ffn, static_argnums=2)(
            {k: jnp.asarray(v.float().numpy()) for k, v in p.items()},
            jnp.asarray(y.float().numpy()), 0.5)))
    finally:
        jb.set_compute_dtype(prev)
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(kind: str, world: int, tmp: Path, coco: Path) -> list:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        out = tmp / f"{kind}_{rank}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, __file__, kind, str(rank), str(world),
             str(port), str(out), str(coco)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out))
    return procs


def _collect(procs, timeout=300) -> list[dict]:
    results = []
    for proc, out in procs:
        log, _ = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, log[-4000:]
        # (mapped: the tests read the tensors they compare)
        results.append(torch.load(out, weights_only=False, mmap=True))
    return results


# ----------------------------------------------------------------- fixture

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from synthetic_coco import make_coco
    tmp = tmp_path_factory.mktemp("tp_sp_ep")
    coco = make_coco(tmp / "coco", num_images=8, num_classes=NUM_CLASSES)
    ranks = _spawn("ranks", 4, tmp, coco)
    jax_child = _spawn("jax", 1, tmp, coco)
    one = {"f64": {v: _run(v, None, slice(0, BATCH)) for v in sorted(
               {variant for *_, variant in F64_LAYOUTS.values()})},
           "moe": _run("moe", None, slice(0, BATCH), dtype=torch.float32,
                       augment=False),
           "fit": _fit(coco, tmp / "runs1", parallel=False)}
    p, y = _moe_params()
    one["moe_ffn"] = moe_ffn(p, y, 0.5)
    one["halo"] = {(op, band): _halo_run(op, *_halo_input(
        op, HALO_BANDS[band][1], HALO_BANDS[band][0]))
        for op, band in HALO_CASES}
    one["bicubic"] = {case: _bicubic_run(*case) for case in BICUBIC_CASES}
    one["mean"] = {name: _mean_run(name) for name in MEAN_BANDS}
    combos = _jax_refs(*JAX_HERE)
    return {"one": one, "ranks": _collect(ranks),
            "jax": {**_collect(jax_child)[0], **combos}}


# --------------------------------------------------------------- helpers

def _scale(t):
    return float(t.double().abs().max()) if t.numel() else 0.0


def _assert_changes_close(got: dict, want: dict, init: dict, tol: float,
                          what: str, fp32_keys: str | None = None,
                          other: dict | None = None):
    """Each tensor's |got - want| <= tol x its change since `init` (at
    least 1e-3 of the tree's largest change), plus 2 ulps of its value;
    those whose key holds `fp32_keys` (computed in fp32 whatever the
    module's dtype) within ROUTER_TOL instead. With `other`, a second
    answer of the same function, a tensor past that bound may be held to
    `other` the same way instead, and fewer than a tenth of them are."""
    def bounds(ref):
        changes = {k: _scale(ref[k].double() - init[k].double())
                   for k in want if want[k].is_floating_point()}
        floor = 1e-3 * max(changes.values())
        return {k: (ROUTER_TOL if fp32_keys and fp32_keys in k else tol)
                * max(change, floor)
                + 2 * torch.finfo(ref[k].dtype).eps * _scale(ref[k])
                for k, change in changes.items()}, changes
    bound, changes = bounds(want)
    other_bound = bounds(other)[0] if other else {}
    held_to_other = []
    for k in bound:
        err = _scale(got[k].double() - want[k].double())
        if err > bound[k] and other:
            held_to_other.append(k)
            err = _scale(got[k].double() - other[k].double())
            assert err <= other_bound[k], (
                f"{what}: {k} differs by {err:.3e} from either answer, "
                f"change {changes[k]:.3e}")
            continue
        assert err <= bound[k], (
            f"{what}: {k} differs by {err:.3e}, change {changes[k]:.3e}")
    assert len(held_to_other) < 0.1 * len(bound), (what, held_to_other)


def _assert_losses(got: list, want: list, rtol: float, what: str):
    """Each logged loss within rtol (relative, at least 1.0 absolute);
    `proportion`, a ratio of counts the loss keeps in fp32 whatever the
    maps' dtype (each data rank's share summed), within fp32 rounding."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), what
        for k in w:
            tol = max(rtol, FP32_RATIO_TOL) if k == "proportion" else rtol
            assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1.0), (
                what, k, g[k], w[k])


# ------------------------------------------------------------------ tests

def test_ranks_lie_out_as_the_mesh_does(runs):
    """rank = (((d·M + m)·S + s)·P + p)·E + e, as `make_mesh` reshapes
    its devices (data, model, spatial, pipe, expert)."""
    for rank, res in enumerate(runs["ranks"]):
        assert res["index/model2_spatial2"] == {
            "data": 0, "model": rank // 2, "spatial": rank % 2, "pipe": 0,
            "expert": 0}
        assert res["index/data2_spatial2"]["data"] == rank // 2
        assert res["index/data2_model2"]["model"] == rank % 2


@pytest.mark.parametrize("layout", sorted(F64_LAYOUTS))
@pytest.mark.parametrize("part", ["params", "ema", "opt_state", "losses",
                                  "preds"])
def test_float64_steps_equal_one_process(runs, layout, part):
    """Two augmented steps under each layout of `F64_LAYOUTS`: the narrow
    yolox_s_tp2sp2 under model 2 x spatial 2, data 2 x spatial 2 and data
    2 x model 2; ZeRO-3 (accumulate 2, clip) under data 2 x model 2 and
    ZeRO-1 under data 2 x spatial 2; the tiny MoE ViT under data 2 x
    expert 2 with ZeRO-1; remat and DropBlock under model 2 x spatial 2;
    depthwise convs under data 2 x model 2; the tiny YOLOv7 (E-ELAN, the
    YOLOv7 neck with RepConvs, the implicit head), YOLOv5 (the simple
    head) and e-YOLOX (ECMNet, AL-PAFPN) under model 2 x spatial 2, where
    the 64 px stride-32 level holds one row a band, and e-YOLOX under
    data 2 x model 2 with ZeRO-3; MobileNetV3-S/L, ShuffleNetV2 with its
    SE, CSPMobileNext, EfficientRep, ResNet, ConvNeXt, GhostNet, VGG and
    MobileNeXt under model 2 x spatial 2 (the squeeze-excites' band
    means, the strided and VALID pools, `SameConv2d`'s 'SAME' pads, the
    SE's bare convs), and MobileNetV3-S under data 2 x spatial 2 (the
    band mean over the spatial ranks alone). Every rank's gathered
    parameters, BN statistics, EMA and moments equal one process's run of
    the same config on the global batch to 1e-9 of their change (the MoE
    router, fp32 in both packages, to ROUTER_TOL), and so do its losses
    and the clip's global norm at each update (which binds: the norm is
    above the clip); the eval predictions of the global batch through the
    EMA gathered for validation (`TrainState.eval_module`) equal those of
    one process's EMA to 1e-9 of their scale, the boxes and the scores
    each."""
    ref = runs["one"]["f64"][F64_LAYOUTS[layout][3]]
    assert ref["losses"][0]["proportion"] > 0
    clip = _cfg(F64_LAYOUTS[layout][3])["optimizer"].get("clip_grad_norm")
    assert len(ref["norms"]) == (1 if clip else 0)
    assert all(n > clip for n in ref["norms"])
    for rank, res in enumerate(runs["ranks"]):
        got = res[f"f64/{layout}"]
        if part == "losses":
            _assert_losses(got["losses"], ref["losses"], F64_TOL,
                           f"rank {rank} {layout}")
            assert len(got["norms"]) == len(ref["norms"])
            for g, w in zip(got["norms"], ref["norms"]):
                assert abs(g - w) <= F64_TOL * w, (rank, layout, g, w)
        elif part == "preds":
            assert got["preds"].shape == ref["preds"].shape
            for cols in (slice(0, 4), slice(4, None)):
                err = _scale(got["preds"][..., cols] - ref["preds"][..., cols])
                assert err <= F64_TOL * _scale(ref["preds"][..., cols]), (
                    rank, layout, cols, err)
        else:
            # (the moments start at zero)
            init = (ref["init"] if part != "opt_state" else
                    {k: torch.zeros_like(v) for k, v in ref[part].items()})
            assert set(got[part]) == set(ref[part])
            _assert_changes_close(got[part], ref[part], init, F64_TOL,
                                  f"rank {rank} {layout} {part}", ROUTER)


def test_model_slices_hold_half_the_sharded_state(runs):
    """Under model 2 each rank holds half of every sharded conv kernel,
    and so half of its moments and EMA: the held bytes against one
    process's."""
    for res in runs["ranks"]:
        b = res["f64/model2_spatial2"]["bytes"]
        for part in ("params", "opt_state", "ema"):
            assert 0.5 * b[f"{part}_one_process"] < b[part] < \
                0.55 * b[f"{part}_one_process"], (part, b)
        b = res["f64/data2_spatial2"]["bytes"]
        assert b["params"] == b["params_one_process"]


def test_zero3_over_model_slices_holds_a_quarter_of_the_state(runs):
    """ZeRO-3 under data 2 x model 2: each rank holds its data part of
    its cout slice of every sharded conv kernel, and its data part of the
    tensors no slice takes; its params, moments and EMA are at most 0.35
    of one process's (chip_smoke.py's bound for phase 19 (a)). ZeRO-1
    under data 2 x spatial 2 halves the moments and the EMA only."""
    for res in runs["ranks"]:
        b = res["f64/data2_model2_zero3"]["bytes"]
        for part in ("params", "opt_state", "ema"):
            assert b[part] <= 0.35 * b[f"{part}_one_process"], (part, b)
        b = res["f64/data2_spatial2_zero1"]["bytes"]
        assert b["params"] == b["params_one_process"]
        for part in ("opt_state", "ema"):
            assert b[part] < 0.55 * b[f"{part}_one_process"], (part, b)


@pytest.mark.parametrize("part", ["params", "ema", "opt_state"])
def test_zero3_state_dicts_round_trip_over_model_slices(runs, part):
    """ZeRO-3 under data 2 x model 2: the engine's gathered module, EMA
    and optimizer state dicts, loaded into a new engine (each rank cuts
    its slice, then its data part) and gathered back, are the same bit for
    bit; each rank's optimizer then holds a quarter of a sharded kernel."""
    for rank, res in enumerate(runs["ranks"]):
        got = res["f64/data2_model2_zero3"]
        back = got["roundtrip"]
        assert set(back[part]) == set(got[part])
        for k, v in got[part].items():
            assert torch.equal(back[part][k], v), (rank, part, k)
        w = got["params"]["backbone.stem.conv.conv.weight"]
        assert tuple(back["held"]["backbone.stem.conv.conv.weight"]) == (
            w.shape[0] // 2, w.shape[1] // 2) + tuple(w.shape[2:])


def _assert_matches_jax_mesh_step(runs, layout, part, halved=(),
                                  spread=None):
    """The 4 ranks' fp32 run of a layout of `JAX_LAYOUTS` against the JAX
    package's mesh step: the losses of each step at SP_LOSS_RTOL, the
    parameters at SP_PARAM_RTOL / SP_PARAM_ATOL, and each parameter's
    change since the init within SLICE_TOL of the JAX step's change. The
    flax leaves `halved` are held to half the ranks' change instead. With
    `spread`, the JAX package's step of the same config on one device, a
    leaf past those bounds may be held to that step's instead (fewer
    than a tenth of the leaves): the JAX package's other answer of the
    same function, whose fp32 rounding differs."""
    from pl_yolo_tpu_torch import bridge
    want = runs["jax"]["tp_sp" if layout == "model2_spatial2" else layout]
    for rank, res in enumerate(runs["ranks"]):
        got = res[f"f32/{layout}"]
        if part == "losses":
            for g, w in zip(got["losses"], want["losses"]):
                np.testing.assert_allclose(g["loss"], w["loss"],
                                           rtol=SP_LOSS_RTOL)
            continue
        def flat(sd):
            return {k: torch.from_numpy(np.array(v)) for k, v in dict(
                bridge._flatten(bridge.state_dict_to_variables(sd))).items()}
        params, init = flat(got["params"]), flat(got["init"])
        for k in halved:
            params[k] = init[k] + 0.5 * (params[k] - init[k])
        keys = [k for k in want["params"] if k[0] == "params"]
        assert keys and set(keys) <= set(params)
        def leaves(tree):
            return {k: torch.from_numpy(np.array(tree["params"][k]))
                    for k in keys}
        mesh_step = leaves(want)
        one_device = leaves(spread) if spread else None
        for k in keys:
            refs = [mesh_step[k]] + ([one_device[k]] if spread else [])
            assert any(np.allclose(params[k].numpy(), r.numpy(),
                                   rtol=SP_PARAM_RTOL, atol=SP_PARAM_ATOL)
                       for r in refs), f"rank {rank} {k}"
        _assert_changes_close(
            {k: params[k] for k in keys}, mesh_step,
            {k: init[k] for k in keys}, SLICE_TOL, f"rank {rank} vs JAX",
            other=one_device)


@pytest.mark.parametrize("part", ["losses", "params"])
def test_model2_spatial2_step_matches_the_jax_mesh_step(runs, part):
    """fp32, two un-augmented steps: the 4 ranks against the JAX package's
    step on make_mesh(model=2, spatial=2) with `sp_constraint`, as
    `tests/test_parallel_sp.py` runs it and at its bounds: the losses of
    each step and the parameters; and each parameter's change since the
    init within SLICE_TOL of the JAX step's change (the first step's
    learning rate is the warmup's 1e-5 of the base, so that the second
    step makes the change this holds).
    (Not the BatchNorm running statistics: that mesh step keeps twice the
    single-device ones, where make_mesh(spatial=2) and make_mesh(model=2)
    keep them; the port keeps the single-device function's, which the
    float64 test holds it to.)"""
    _assert_matches_jax_mesh_step(runs, "model2_spatial2", part)


@pytest.mark.parametrize("layout", ["data2_model2_zero3",
                                    "data2_model2_depthwise"])
@pytest.mark.parametrize("part", ["losses", "params"])
def test_zero3_and_depthwise_steps_match_the_jax_mesh_steps(runs, layout,
                                                            part):
    """fp32, two un-augmented steps on data 2 x model 2, as the test above
    holds model 2 x spatial 2 and at its bounds: ZeRO-3 with the clip
    against the JAX package's step with `shard_tp(zero=3)` and
    `zero_constraint`, and the depthwise narrow YOLOX (grouped convs, each
    rank its cout slice of whole groups) against the JAX step with the
    depthwise kernels sharded on cout. (Parameters, not the BatchNorm
    running statistics, as above.)"""
    _assert_matches_jax_mesh_step(runs, layout, part)


@pytest.mark.parametrize("part", ["losses", "params"])
def test_yolov7_model2_spatial2_step_matches_the_jax_mesh_step(runs, part):
    """fp32, two un-augmented steps of the tiny YOLOv7 (RepConvs, the
    implicit head's priors sliced on C and gathered) on model 2 x spatial
    2 against the JAX package's step on make_mesh(model=2, spatial=2), at
    the bounds of the YOLOX test above (parameters, not the BatchNorm
    running statistics, as there). That mesh step moves the kernel of
    E-ELAN's first conv, whose input is the raw NHWC image, by half the
    change of the JAX package's own single-device step and of its
    make_mesh(model=2) and make_mesh(spatial=2) steps (0.50003 of it by
    least squares, every other leaf within 1.4e-2 of its change; ROADMAP,
    "Known semantic traps"): that kernel is held to half the ranks'
    change, which the float64 test holds to one process's."""
    _assert_matches_jax_mesh_step(runs, "yolov7_model2_spatial2", part,
                                  halved=[STEM_KERNEL])


# the flax leaves of the first conv, on the raw image, that the JAX
# package's step on make_mesh(model=2, spatial=2) moves by half its change
# (ROADMAP, "Known semantic traps"): MobileNetV3-S's kernel, as the tiny
# YOLOv7's, and ConvNeXt's patchify bias (its kernel moves in full)
HALVED = {"mobilenetv3s": [("params", "backbone", "stem", "conv", "kernel")],
          "convnext": [("params", "backbone", "stem", "bias")]}


@pytest.mark.parametrize("variant", sorted(HALVED))
@pytest.mark.parametrize("part", ["losses", "params"])
def test_backbone_model2_spatial2_steps_match_the_jax_mesh_step(runs,
                                                               variant,
                                                               part):
    """fp32, two un-augmented steps of the tiny MobileNetV3-S detector
    (the squeeze-excites' band means, its depthwise convs) and of the tiny
    ConvNeXt (`SameConv2d` on bands, the replicated `nn.Linear` layers)
    on model 2 x spatial 2 against the JAX package's step on make_mesh(
    model=2, spatial=2), at the bounds of the YOLOX test above, but for
    the first conv's leaf that mesh step moves by half (`HALVED`; the
    float64 test holds the ranks to one process there).
    MobileNetV3-S's squeeze-excite BatchNorms see 4 values a channel
    (B=4), close together on noise images: flax's E[x²] - E[x]² variance
    cancels in fp32 and amplifies each run's rounding, so that the JAX
    package's own mesh step and its one-device step differ by up to
    7.3e-2 of the change on 30 of the 291 leaves (1.4e-2 was the tiny
    YOLOv7's worst): a leaf of MobileNetV3-S past the bounds of the mesh
    step is held to the one-device step's at the same bounds instead,
    and fewer than a tenth of them are (4 seen: stage 4's SE BatchNorm
    scales, where the ranks, one process and JAX's one device agree)."""
    _assert_matches_jax_mesh_step(
        runs, f"{variant}_model2_spatial2", part, halved=HALVED[variant],
        spread=(runs["jax"]["mobilenetv3s_one_device"]
                if variant == "mobilenetv3s" else None))


def _port_specs(variant, num_classes=NUM_CLASSES, model=2):
    """The names `tensor.shard_specs` shards under a model width, for the
    variant's module (no process group: the specs depend on the shapes
    alone), and its state dict."""
    from types import SimpleNamespace
    module = build_model(_cfg(variant), num_classes, device="cpu",
                         input_size=(SIZE, SIZE)).module
    layout = SimpleNamespace(model=model, expert=1, model_group=None,
                             model_index=0)
    return sorted(tensor.shard_specs(module, layout)), module


def _jax_specs(sd, zero=None, **axes):
    """The torch names of the leaves JAX's `state_specs` shards on
    make_mesh(**axes) of a state dict's variables (at ZeRO level `zero`:
    those over each axis of the params and of the EMA)."""
    import jax
    from pl_yolo_tpu.parallel.mesh import make_mesh
    from pl_yolo_tpu_torch import bridge
    mesh_ = make_mesh(**axes, devices=jax.devices()[:4])
    variables = bridge.state_dict_to_variables(sd)
    if zero is None:
        return _jax_sharded(variables, mesh_)
    return {axis: _jax_on_axis(variables, mesh_, zero, axis)
            for axis in axes}


def test_sharded_weights_are_the_jax_specs_leaves(runs):
    """The port's model and expert slices are the leaves the JAX package's
    `state_specs` shards: every conv kernel whose cout the model width
    divides (the narrow yolox_s_tp2sp2, 3 classes; the depthwise kernels
    too), and the MoE experts. Under ZeRO its data parts are the leaves
    `state_specs(..., zero=)` shards over 'data': at level 3 on data 2 x
    model 2 the params (beside the 'model' ones) and the EMA, and at level
    1 on data 2 x expert 2 the EMA copy's params and BN statistics (and
    the moments, by the same rule)."""
    jax_res = runs["jax"]
    rank0 = runs["ranks"][0]
    tp = rank0["f64/model2_spatial2"]["specs"]
    assert tp == jax_res["tp_sp_specs"]
    assert "head.obj_pred0.weight" not in tp      # cout 1
    assert "head.reg_pred0.weight" in tp          # cout 4
    assert rank0["f64/data2_spatial2"]["specs"] == []
    ep = rank0["ep"]["specs"]
    assert ep == jax_res["ep_specs"]
    assert sorted(k.split(".")[-1] for k in ep) == [
        "blocks_moe_b1", "blocks_moe_b2", "blocks_moe_w1", "blocks_moe_w2"]
    dw = rank0["f64/data2_model2_depthwise"]["specs"]
    assert dw == jax_res["depthwise_specs"]
    assert "backbone.stage1_down.dconv.conv.weight" in dw
    z3, want = rank0["f64/data2_model2_zero3"], jax_res["zero3_specs"]
    assert z3["specs"] == want["model"]["params"]
    assert z3["zero_params"] == want["data"]["params"]
    assert z3["zero_ema"] == want["data"]["ema"]
    # the prediction conv of cout 1: no model slice, a data part on cin
    assert "head.obj_pred0.weight" in z3["zero_params"]
    ez, want = rank0["f64/data2_expert2_zero1"], jax_res["ep_zero1_specs"]
    assert ez["specs"] == want["expert"]["params"]
    assert want["data"]["params"] == []          # level 1: params whole
    assert ez["zero_ema"] == want["data"]["ema"]
    # (at level 1 a parameter's ZeRO part is its moments' part: the EMA
    # copy's rule, on the same shapes)
    assert ez["zero_params"] == [k for k in want["data"]["ema"]
                                 if not k.endswith(("running_mean",
                                                    "running_var"))]
    # the conv families beyond YOLOX on model 2 x spatial 2: the implicit
    # head's priors on C (flax's last axis), its 24-wide prediction convs
    # and multiplicative priors (3 classes), the simple head's convs, the
    # depthwise kernels of ECMNet's sandglass blocks
    for variant in FAMILIES:
        got = rank0[f"f64/{variant}_model2_spatial2"]["specs"]
        assert got == _jax_specs(runs["one"]["f64"][variant]["init"],
                                 model=2, spatial=2), variant
    yolov7 = rank0["f64/yolov7_model2_spatial2"]["specs"]
    assert {"head.ia0", "head.im2", "head.conv1.weight",
            "neck.n3_out.rbr_dense_conv.weight",
            "neck.n3_out.rbr_1x1_conv.weight"} <= set(yolov7)
    assert "head.conv0.weight" in rank0[
        "f64/yolov5_model2_spatial2"]["specs"]
    assert "backbone.stage2_block.conv3_0.conv0.conv.weight" in rank0[
        "f64/eyolox_model2_spatial2"]["specs"]
    # the registry's other conv backbones (item 12c.4 part 2): the
    # squeeze-excites' convs (MobileNetV3's ConvBlocks, ShuffleNetV2's and
    # GhostNet's bare biased ones), the depthwise kernels, ConvNeXt's
    # `SameConv2d` kernels (its `nn.Linear` layers are 2-D: replicated)
    def specs_of(variant):
        return set(rank0[f"f64/{variant}_model2_spatial2"]["specs"])
    assert {"backbone.stage1_b0.dw.conv.weight",
            "backbone.stage1_b0.se.fc1.conv.weight"} <= specs_of(
                "mobilenetv3s")
    assert {"backbone.stage1_b0.se.fc1.weight",
            "backbone.stage1_b0.dw.conv.weight"} <= specs_of("shufflenetv2")
    assert {"backbone.stage2_b0.se_fc1.weight",
            "backbone.stage2_b0.se_fc2.weight"} <= specs_of("ghostnet")
    convnext = specs_of("convnext")
    assert {"backbone.stem.weight", "backbone.down1.weight",
            "backbone.stage0_b0.dwconv.weight"} <= convnext
    assert not {k for k in convnext if "pwconv" in k or "norm" in k}
    # ZeRO-3 over e-YOLOX's model slices: its data parts are JAX's
    z3 = rank0["f64/eyolox_data2_model2_zero3"]
    want = _jax_specs(runs["one"]["f64"]["eyolox"]["init"], zero=3, data=2,
                      model=2)
    assert z3["specs"] == want["model"]["params"]
    assert z3["zero_params"] == want["data"]["params"]
    assert z3["zero_ema"] == want["data"]["ema"]
    # COCO's 255-wide prediction convs replicate: at 2 classes the tiny
    # YOLOv7's are 21 wide, which the model width does not divide; its
    # additive priors still shard
    specs, module = _port_specs("yolov7", num_classes=2)
    assert specs == _jax_specs(module.state_dict(), model=2, spatial=2)
    assert not {"head.conv0.weight", "head.im0"} & set(specs)
    assert "head.ia0" in specs


@pytest.mark.parametrize("op,band", HALO_CASES)
def test_halo_exchange_equals_the_unsharded_op(runs, op, band):
    """Every windowed op of the YOLOX path on bands of rows (spatial 2 and
    4, one to four rows a band; the 13-pool on one-row bands reaches three
    bands away): each rank's output rows and its input gradient (the
    halo rows' gradients sent back and summed) are the unsharded op's."""
    width, band_rows = HALO_BANDS[band]
    stride = HALO_OPS[op][1]
    want = runs["one"]["halo"][op, band]
    for rank, res in enumerate(runs["ranks"]):
        s = rank % 2 if width == 2 else rank
        got = res[f"halo/{op}/{band}"]
        rows = slice(s * band_rows, (s + 1) * band_rows)
        out_rows = slice(rows.start // stride, rows.stop // stride)
        for part, r in (("out", out_rows), ("grad", rows)):
            err = _scale(got[part] - want[part][:, :, r])
            assert err <= HALO_TOL * _scale(want[part]), (op, band, rank,
                                                          part, err)


@pytest.mark.parametrize("band", sorted(MEAN_BANDS))
def test_band_mean_is_the_whole_maps_mean(runs, band):
    """The squeeze-excites' mean over the whole map on bands of rows
    (spatial 2, beside model 2, and spatial 4; one to three rows a band):
    every rank's mean is the whole map's, its gated rows the whole map's,
    and its input gradient its rows of the whole map's, each rank's gate
    gradient holding only its band's part (the mean's backward sums them
    over the spatial group)."""
    width, band_rows = MEAN_BANDS[band]
    want = runs["one"]["mean"][band]
    for rank, res in enumerate(runs["ranks"]):
        s = rank % 2 if width == 2 else rank
        got = res[f"mean/{band}"]
        rows = slice(s * band_rows, (s + 1) * band_rows)
        for part, w in (("mean", want["mean"]),
                        ("out", want["out"][:, :, rows]),
                        ("grad", want["grad"][:, :, rows])):
            err = _scale(got[part] - w)
            assert err <= HALO_TOL * _scale(want[part]), (band, rank, part,
                                                          err)


@pytest.mark.parametrize("name,dtype", BICUBIC_CASES)
def test_bicubic_upsampling_of_a_band_is_the_whole_maps(runs, name, dtype):
    """AL-PAFPN's bicubic 2x upsampling on bands of rows (spatial 2 and 4):
    each rank's output rows are the whole map's, bit for bit in bf16 (the
    whole map's order of the two contractions and edge weights) and to
    fp32 rounding in fp32 (BICUBIC_FP32_TOL of the scale, with its input
    gradient: the halo rows' gradients sent back and summed)."""
    h, _, width = BICUBIC_MAPS[name]
    n = h // width
    want = runs["one"]["bicubic"][name, dtype]
    for rank, res in enumerate(runs["ranks"]):
        s = rank % 2 if width == 2 else rank
        got = res[f"bicubic/{name}/{dtype}"]
        out = want["out"][:, :, 2 * s * n:2 * (s + 1) * n]
        if dtype == "bfloat16":
            assert got["out"].dtype == torch.bfloat16
            assert torch.equal(got["out"], out), (rank, name)
            continue
        for part, w in (("out", out),
                        ("grad", want["grad"][:, :, s * n:(s + 1) * n])):
            err = _scale(got[part] - w)
            assert err <= BICUBIC_FP32_TOL * _scale(want[part]), (
                rank, name, part, err)


@pytest.mark.parametrize("part", ["losses", "params"])
def test_expert_parallel_step_equals_one_process(runs, part):
    """data 2 x expert 2, the tiny MoE ViT with overflowing experts, two
    steps in fp32: against one process on the global batch."""
    ref = runs["one"]["moe"]
    for rank, res in enumerate(runs["ranks"]):
        got = res["ep"]
        if part == "losses":
            _assert_losses(got["losses"], ref["losses"], MOE_LOSS_TOL,
                           f"rank {rank}")
        else:
            _assert_changes_close(got["params"], ref["params"], ref["init"],
                                  MOE_TOL, f"rank {rank}")


@pytest.mark.parametrize("part", ["losses", "params"])
def test_expert_parallel_step_matches_the_jax_mesh_step(runs, part):
    """data 2 x expert 2 against the JAX package's step on make_mesh(
    data=2, expert=2), from the same weights on the same batch."""
    want = runs["jax"]["ep"]
    got = runs["ranks"][0]["ep"]
    if part == "losses":
        for g, w in zip(got["losses"], want["losses"]):
            assert abs(g["loss"] - w["loss"]) <= JAX_MOE_LOSS_TOL * abs(
                w["loss"]), (g, w)
    else:
        init = {k: got["init"][k] for k in want["params"]}
        _assert_changes_close({k: got["params"][k] for k in want["params"]},
                              want["params"], init, SLICE_TOL, "vs JAX")


@pytest.mark.parametrize("ref", ["one_process", "jax"])
def test_moe_ffn_of_data_ranks_is_the_global_function(runs, ref):
    """The C7 repair: two data ranks' `moe_ffn`, each on its rows of a
    batch whose expert 0 overflows, give their rows of the function of the
    global batch (one process's, and the JAX package's): the capacity
    counts every rank's tokens and a token's position counts its expert's
    tokens on the ranks before."""
    want = (runs["one"]["moe_ffn"] if ref == "one_process"
            else runs["jax"]["moe_ffn"].double())
    tol = HALO_TOL if ref == "one_process" else 1e-5
    per = BATCH // 2
    p, y = _moe_params()
    local = moe_ffn(p, y[:per], 0.5)   # rank 0's rows alone: other drops
    assert _scale(local - want[:per]) > 1e-3
    for rank, res in enumerate(runs["ranks"]):
        d = rank // 2
        err = _scale(res["moe_ffn"] - want[d * per:(d + 1) * per])
        assert err <= tol * _scale(want), (rank, err)


@pytest.mark.parametrize("part", ["module", "ema_module"])
def test_four_rank_fit_checkpoint_matches_one_process(runs, part):
    """`Trainer.fit` under model 2 x spatial 2 (torchrun's layout from
    yolox_s_tp2sp2.yaml's `parallel:`) writes, from rank 0, a checkpoint
    in the one-process format that a one-process fit's equals."""
    def load(ckpt):
        steps = sorted(Path(ckpt).glob("*/state.pt"),
                       key=lambda p: int(p.parent.name))
        return torch.load(steps[-1], weights_only=True)
    four = load(runs["ranks"][0]["fit"]["ckpt"])
    one = load(runs["one"]["fit"]["ckpt"])
    assert four["step"] == one["step"] == 2
    init = build_model(_yolox_cfg(), NUM_CLASSES, device="cpu",
                       input_size=(SIZE, SIZE), seed=96).module.state_dict()
    assert {k: v.shape for k, v in four[part].items()} == {
        k: v.shape for k, v in one[part].items()}
    _assert_changes_close(four[part], one[part], init, SLICE_TOL, part)


def test_four_ranks_resume_the_checkpoint(runs):
    """4 new ranks resume the 4-rank checkpoint: each holds its slices,
    and gathers the checkpoint's module, EMA and optimizer back bit for
    bit."""
    ckpt = runs["ranks"][0]["fit"]["ckpt"]
    steps = sorted(Path(ckpt).glob("*/state.pt"),
                   key=lambda p: int(p.parent.name))
    saved = torch.load(steps[-1], weights_only=True)
    for rank, res in enumerate(runs["ranks"]):
        got = res["fit"]["resumed"]
        assert got["step"] == saved["step"]
        for part in ("module", "ema_module"):
            assert set(got[part]) == set(saved[part])
            for k, v in saved[part].items():
                assert torch.equal(got[part][k], v), (rank, part, k)
        for i, st in saved["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"]["state"][i][k], v)
        held = got["held"]["backbone.stem.conv.conv.weight"]
        assert held[0] * 2 == saved["module"][
            "backbone.stem.conv.conv.weight"].shape[0]


def test_four_rank_fit_validates(runs):
    """The 4-rank fit validated its gathered EMA on its ranks' share of
    the images: an mAP in [0, 1] on every rank, the same on each."""
    maps = [res["fit"]["mAP"] for res in runs["ranks"]]
    assert all(0.0 <= m <= 1.0 for m in maps) and len(set(maps)) == 1


def test_trainer_refuses_what_the_layout_cannot_take(tmp_path):
    """The JAX trainer's messages for the axes' sizes (no process group:
    a world of one), and the combinations that name ROADMAP item 12c:
    a pipe width with a model width (item 12c.5), the transformer
    backbones and `neck: none` under a model or spatial width (item
    12c.4 part 3). ZeRO with the model or spatial axis, depthwise convs
    under the model axis, remat and DropBlock under the spatial axis, the
    YOLOv7, YOLOv5 and e-YOLOX families under both axes, alone and with
    ZeRO and remat, and MobileNetV3, ShuffleNetV2, CSPMobileNext and the
    six extras under both axes with ZeRO-3, pass that gate."""
    from synthetic_coco import make_coco
    root = make_coco(tmp_path / "coco", num_images=2)
    model_cfg, data_cfg, kw = _trainer_cfgs(root, tmp_path / "runs")
    with pytest.raises(ValueError, match="must divide the device count 1"):
        Trainer(model_cfg, data_cfg, **kw)
    moe = _moe_cfg()
    moe["backbone"]["moe_experts"] = 3
    moe["parallel"] = {"expert": 1}
    Trainer(moe, data_cfg, **kw)
    moe["parallel"] = {"expert": 3}
    with pytest.raises(ValueError, match="must divide the device count"):
        Trainer(moe, data_cfg, **kw)
    # ZeRO with the model axis, depthwise convs under it and remat with
    # DropBlock under the spatial axis pass the port's gate: only the
    # world's size stops them here
    for depthwise, parallel in ((False, {"model": 2, "zero": True}),
                                (True, {"model": 2}),
                                (False, {"spatial": 2, "zero": 3})):
        cfg = copy.deepcopy(model_cfg)
        cfg["parallel"] = parallel
        cfg["remat"] = "spatial" in parallel
        cfg["backbone"].update(depthwise=depthwise,
                               drop_block={"rate": 0.1, "size": 7})
        with pytest.raises(ValueError, match="must divide the device count"):
            Trainer(cfg, data_cfg, **kw)
    for variant, parallel in (("yolov7", {"model": 2, "spatial": 2}),
                              ("yolov5", {"model": 2, "zero": 3}),
                              ("eyolox", {"spatial": 2, "zero": True})):
        cfg = _cfg(variant)
        cfg.update(parallel=parallel, remat=True)
        with pytest.raises(ValueError, match="must divide the device count"):
            Trainer(cfg, data_cfg, **kw)
    # the registry's other conv backbones pass it too (item 12c.4 part
    # 2); the transformer backbones and `neck: none` do not (part 3)
    # (each axis alone: tests/test_torch_trainer.py's `check_ported` test)
    for variant in BACKBONES:
        cfg = _cfg(variant)
        cfg["parallel"] = {"model": 2, "spatial": 2, "zero": 3}
        with pytest.raises(ValueError, match="must divide the device count"):
            Trainer(cfg, data_cfg, **kw)
    for part, name in (("backbone", "vision_transformer"),
                       ("backbone", "swin_transformer"), ("neck", "none")):
        for parallel in ({"model": 2}, {"spatial": 2}):
            cfg = copy.deepcopy(model_cfg)
            cfg[part] = {**cfg[part], "name": name}
            cfg["parallel"] = parallel
            with pytest.raises(NotImplementedError,
                               match=f"{part} '{name}'.*item 12c.4 part 3"):
                Trainer(cfg, data_cfg, **kw)
    for variant in FAMILIES:
        cfg = _cfg(variant)
        cfg["parallel"] = {"model": 2, "pipeline": 2}
        with pytest.raises(NotImplementedError,
                           match="`pipeline`.*item 12c.5"):
            Trainer(cfg, data_cfg, **kw)
    model_cfg["parallel"] = {"model": 2, "pipeline": 2}
    with pytest.raises(NotImplementedError, match="`pipeline`.*item 12c"):
        Trainer(model_cfg, data_cfg, **kw)
    moe["parallel"] = {"model": 2, "zero": True}
    with pytest.raises(NotImplementedError, match="item 12c"):
        Trainer(moe, data_cfg, **kw)


def test_parallel_checks_name_the_jax_messages(monkeypatch, tmp_path):
    """The checks that need a world of several ranks, with the world's
    size stubbed (no process group is made): the experts the expert width
    does not divide, H against 32·spatial, and the batch against the data
    width."""
    from synthetic_coco import make_coco
    root = make_coco(tmp_path / "coco", num_images=2)
    monkeypatch.setattr(distributed, "world", lambda: (0, 4))
    monkeypatch.setattr(distributed, "host_info", lambda: (0, 1, 0, 4))
    from pl_yolo_tpu_torch.train import trainer as trainer_module
    monkeypatch.setattr(trainer_module, "Layout",
                        lambda *a, **k: ("layout", a, k))
    model_cfg, data_cfg, kw = _trainer_cfgs(root, tmp_path / "runs")
    tr = Trainer(model_cfg, data_cfg, **kw)
    assert tr.data_par == 1 and tr.non_data == 4
    moe = _moe_cfg()
    moe["backbone"]["moe_experts"] = 3
    moe["parallel"] = {"expert": 2}
    with pytest.raises(ValueError, match="moe_experts divisible by it"):
        Trainer(moe, data_cfg, **kw)
    data_cfg["dataset"]["train_size"] = [96, 96]
    with pytest.raises(ValueError, match="divisible by 32\\*2"):
        Trainer(model_cfg, data_cfg, **kw)
    # the registry's other conv backbones reach the same check
    for variant in ("convnext", "mobilenetv3s"):
        cfg = _cfg(variant)
        cfg["parallel"] = {"model": 2, "spatial": 2}
        with pytest.raises(ValueError, match="divisible by 32\\*2"):
            Trainer(cfg, data_cfg, **kw)
    data_cfg["dataset"]["train_size"] = [SIZE, SIZE]
    data_cfg["dataset"]["train_batch_size"] = 3
    model_cfg["parallel"] = {"spatial": 2}
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        Trainer(model_cfg, data_cfg, **kw)


def test_sharded_modules_refuse_to_run_outside_a_layout():
    """A conv holding a cout slice, or an MoE layer holding some experts,
    runs only inside a train step's layout: outside it raises instead of
    computing with the slice."""
    conv = torch.nn.Conv2d(4, 8, 3, padding=1, bias=False)
    spec = tensor.Shard(0, None, 1, 2)
    conv.weight.data = spec.narrow(conv.weight.data).clone()
    assert tensor.is_sharded(conv)
    with pytest.raises(RuntimeError, match="inside a train step's layout"):
        blocks._conv(conv, torch.zeros(1, 4, 4, 4), None)
    p, y = _moe_params()
    p = {k: (v[:2] if k != "moe_router" else v) for k, v in p.items()}
    with pytest.raises(RuntimeError, match="holds 2 of 4 experts"):
        moe_ffn(p, y, 0.5)


def test_same_convs_and_se_convs_refuse_to_run_sharded_outside_a_layout():
    """ConvNeXt's `SameConv2d` and the squeeze-excites' bare 1x1 convs
    (ShuffleNetV2's `SELayer`, GhostNet's `se_fc*`) holding a cout slice
    run only inside a train step's layout, as the other sharded convs."""
    from pl_yolo_tpu_torch.models.backbones import extras, shufflenetv2
    spec = tensor.Shard(0, None, 1, 2)

    def cut(conv):
        conv.weight.data = spec.narrow(conv.weight.data).clone()
        assert tensor.is_sharded(conv)
    same = blocks.SameConv2d(4, 8, 7, groups=4)
    se = shufflenetv2.SELayer(8)
    ghost = extras.GhostBottleneck(8, 8, 8, use_se=True)
    for module, conv in ((same, same), (se, se.fc1), (ghost, ghost.se_fc2)):
        cut(conv)
        with pytest.raises(RuntimeError,
                           match="inside a train step's layout"):
            module(torch.zeros(1, 8 if module is not same else 4, 4, 4))


@pytest.mark.parametrize("rank", range(4))
def test_bridged_state_cuts_to_each_ranks_slices(runs, rank):
    """`tensor.shard_state_dict` of the state the bridge makes of the
    flax tree of ConvNeXt's one-process init is, bit for bit, what each
    rank of model 2 x spatial 2 holds after the engine sliced its module:
    its `SameConv2d` kernels (the patchify stem, the downsamples, the 7x7
    depthwise) cut on cout, its `nn.Linear` layers and every 1-D tensor
    whole."""
    from types import SimpleNamespace
    from pl_yolo_tpu_torch import bridge
    init = runs["one"]["f64"]["convnext"]["init"]
    module = build_model(_cfg("convnext"), NUM_CLASSES, device="cpu",
                         input_size=(SIZE, SIZE)).module.double()
    bridged = bridge.variables_to_state_dict(
        bridge.state_dict_to_variables(init, module), module)
    res = runs["ranks"][rank]
    layout = SimpleNamespace(model=2, expert=1, model_group=None,
                             model_index=res["index/model2_spatial2"][
                                 "model"])
    cut = tensor.shard_state_dict(bridged,
                                  tensor.shard_specs(module, layout))
    held = res["f64/convnext_model2_spatial2"]["held_init"]
    assert set(cut) == set(held)
    for k, v in held.items():
        assert torch.equal(cut[k].to(v.dtype), v), (rank, k)
    for k in ("backbone.stem.weight", "backbone.down2.weight",
              "backbone.stage1_b0.dwconv.weight"):
        assert held[k].shape[0] * 2 == init[k].shape[0], k
    for k in ("backbone.stage1_b0.pwconv1.weight",
              "backbone.stage1_b0.pwconv2.weight", "backbone.stem.bias",
              "backbone.stage1_b0.gamma"):
        assert held[k].shape == init[k].shape, k


def test_spec_rules_follow_the_jax_ones():
    """`tp_spec`: a 4-D kernel whose cout the model width divides (dim 0
    in torch's layout), nothing else; `ep_spec`: the experts' [L, E, ...]
    tensors on E, not the router. `zero_spec`: level 1 shards the moments
    and the EMA, level 3 the params too, each along its first dim the data
    width divides; over a model or expert slice, along the first such dim
    the slice leaves free (JAX's "first free axis after the tp / ep
    spec"), so that a [1, C] prediction kernel (no model slice) shards on
    cin and a cout slice [C/M, C', 3, 3] on C'."""
    assert tensor.tp_spec((32, 16, 3, 3), 2) == 0
    assert tensor.tp_spec((7, 16, 3, 3), 2) is None
    assert tensor.tp_spec((32,), 2) is None
    assert tensor.ep_spec("backbone.blocks_moe_w1", (2, 4, 8, 16), 4) == 1
    assert tensor.ep_spec("backbone.blocks_moe_b1", (2, 4, 16), 2) == 1
    assert tensor.ep_spec("backbone.blocks_moe_router", (2, 8, 4), 4) is None
    assert tensor.ep_spec("backbone.blocks_moe_w1", (2, 3, 8, 16), 2) is None
    assert mesh.zero_spec("opt_state", (32, 16, 3, 3), 2, 1) == 0
    assert mesh.zero_spec("ema", (32,), 2, 1) == 0
    assert mesh.zero_spec("params", (32, 16, 3, 3), 2, 1) is None
    assert mesh.zero_spec("params", (32, 16, 3, 3), 2, 3) == 0
    assert mesh.zero_spec("batch_stats", (32,), 2, 3) is None
    assert mesh.zero_spec("opt_state", (1, 16, 1, 1), 2, 1) == 1
    assert mesh.zero_spec("opt_state", (3, 3, 3, 3), 2, 3) is None
    assert mesh.zero_spec("opt_state", (16, 16, 3, 3), 2, 3, taken=0) == 1
    assert mesh.zero_spec("opt_state", (16, 3, 3, 3), 2, 3, taken=0) is None
    assert mesh.zero_spec("ema", (2, 2, 8, 16), 2, 1, taken=1) == 0
    assert mesh.zero_spec("ema", (3, 2, 8, 16), 2, 1, taken=1) == 2
    assert mesh.zero_spec("opt_state", (32,), 4, 0) is None


def test_gathered_priors_shard_on_c_and_other_free_leaves_raise():
    """A 4-D parameter that is no conv kernel shards along the torch dim
    of its flax leaf's last axis: the implicit head's [1, C, 1, 1] priors
    on C (dim 1, where the model width divides C; `GATHERED_DIM`), used
    through `tensor.whole`, which is the parameter itself where it is
    whole and raises outside a layout where it is a slice. A free 4-D
    parameter of a module that does not gather it raises naming item 12c
    where JAX's spec shards it, and replicates where it does not."""
    from types import SimpleNamespace
    from pl_yolo_tpu_torch.models.heads.implicit_head import ImplicitHead
    layout = SimpleNamespace(model=2, expert=1, model_group=None,
                             model_index=1)
    head = ImplicitHead(num_classes=1, n_anchors=1, in_channels=(4, 6))
    specs = tensor.shard_specs(head, layout)
    assert {k: spec.dim for k, spec in specs.items()} == {
        "ia0": 1, "ia1": 1, "im0": 1, "im1": 1, "conv0.weight": 0,
        "conv1.weight": 0}
    ia = torch.zeros(1, 4, 1, 1)
    assert tensor.whole(ia, 1, 4) is ia
    with pytest.raises(RuntimeError, match="inside a train step's layout"):
        tensor.whole(specs["ia0"].narrow(ia), 1, 4)

    class Free(torch.nn.Module):
        def __init__(self, g):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.zeros(1, 1, 1, g))
    assert tensor.shard_specs(Free(3), layout) == {}
    with pytest.raises(NotImplementedError, match="weight.*item 12c"):
        tensor.shard_specs(Free(4), layout)


def test_grouped_conv_slices_hold_whole_groups():
    """Under a model width M a grouped conv shards on cout where M divides
    its groups, and its local conv reads its groups' input channels; where
    M does not divide the groups, it raises naming item 12c instead of
    replicating a kernel that JAX's spec shards."""
    from types import SimpleNamespace
    layout = SimpleNamespace(model=2, expert=1, model_group=None,
                             model_index=1)
    dw = torch.nn.Sequential(torch.nn.Conv2d(8, 8, 3, groups=8),
                             torch.nn.Conv2d(8, 4, 1))
    assert sorted(tensor.shard_specs(dw, layout)) == ["0.weight",
                                                      "1.weight"]
    odd = torch.nn.Sequential(torch.nn.Conv2d(6, 6, 3, groups=3))
    with pytest.raises(NotImplementedError, match="3 groups.*item 12c"):
        tensor.shard_specs(odd, layout)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(sys.argv[5])
    else:
        _ranks(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5], sys.argv[6])
