"""One-stage detector assembly + registry, port of
`pl_yolo_tpu/models/detector.py` for the YOLOX family, the anchor-based
YOLOv7 / YOLOv5 / YOLOv3 families, the transformer backbones (Swin,
SwinV2, ViT with its MoE FFN, ResTv2, MCTformer; `neck: none`), the
mobile backbones (e-YOLOX's ECMNet with the AL-PAFPN neck, CSPMobileNext,
MobileNetV3-S/L, ShuffleNetV2) and the extra backbones (EfficientRep,
ResNet, ConvNeXt, GhostNet, VGG, MobileNeXt).

`build_model(cfg, num_classes)` composes backbone -> neck -> head from the
YAML config sections and returns a `DetectionModel`: the torch module, its
loss and decode (`loss.train_loss`, `loss.eval_decode`), the class count and
the config. Images enter
as [B,H,W,3] 0-255 float and per-level maps leave as [B,H,W,5+C], the JAX
package's layouts; the modules run NCHW in between (the permute of a
contiguous NHWC tensor is already channels_last, so it copies nothing).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import Any, Callable, Sequence

import torch
from torch import nn

from .. import resolve_device
from ..layers.blocks import compute_dtype
from .backbones.cspdarknet import CSPDarkNet
from .backbones import extras
from .backbones.eelan import EELAN
from .backbones.mctformer import MCTformer
from .backbones.mobile import CSPMobileNext, ECMNet, MobileNetV3
from .backbones.restv2 import ResTV2
from .backbones.shufflenetv2 import ShuffleNetV2
from .backbones.swin import SwinTransformer
from .backbones.swinv2 import SwinTransformerV2
from .backbones.vit import VisionTransformer
from .heads.decoupled_head import DecoupledHead
from .heads.implicit_head import ImplicitHead
from .heads.simple_head import SimpleHead
from .losses.yolov3 import (DEFAULT_V3_ANCHORS, yolov3_eval_decode,
                            yolov3_loss)
from .losses.yolov5 import (DEFAULT_V5_ANCHORS, yolov5_eval_decode,
                            yolov5_loss)
from .losses.yolov7 import (DEFAULT_V7_ANCHORS, yolov7_eval_decode,
                            yolov7_loss)
from .losses.yolox import yolox_eval_decode, yolox_loss
from .necks.csppafpn import CSPPAFPN
from .necks.pafpn_al import AL_PAFPN
from .necks.yolov7_neck import YOLOv7NECK


class OneStageDetector(nn.Module):
    """backbone -> neck -> head: [B,H,W,3] -> per-level [B,h,w,5+C]."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.head(self.neck(self.backbone(x.permute(0, 3, 1, 2))))


class NoNeck(nn.Identity):
    """`neck: none`: the backbone's maps go to the head as they are."""

    def __init__(self, feat_channels: Sequence[int]):
        super().__init__()
        self.out_channels = list(feat_channels)


# ---------------------------------------------------------------------------
# Registries. Each factory: (cfg-dict, input widths, dtype) -> torch module;
# a backbone's takes the input size in place of the widths. Torch modules
# need their input widths at build time, where flax infers them; the Swin
# backbones' position tables depend on the input size, as a flax init's do.
# The transformer backbones compute in fp32 whatever `dtype`: the JAX
# package's compute dtype reaches only its conv blocks, and they use none.
# ---------------------------------------------------------------------------

def _cspdarknet(cfg: dict, dtype, input_size) -> nn.Module:
    db = cfg.get("drop_block", {}) or {}
    return CSPDarkNet(
        depths=tuple(cfg["depths"]),
        channels=tuple(cfg["channels"]),
        outputs=tuple(cfg["outputs"]),
        depthwise=bool(cfg.get("depthwise", False)),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        drop_block_rate=float(db.get("rate", 0.0)),
        drop_block_size=int(db.get("size", 7)),
        dtype=dtype,
    )


def _csppafpn(cfg: dict, feat_channels: Sequence[int], dtype) -> nn.Module:
    return CSPPAFPN(
        depths=tuple(cfg["depths"]),
        in_channels=tuple(cfg["channels"]),
        depthwise=bool(cfg.get("depthwise", False)),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        feat_channels=tuple(feat_channels),
        dtype=dtype,
    )


def _decoupled_head(cfg: dict, num_classes: int,
                    feat_channels: Sequence[int], dtype) -> nn.Module:
    return DecoupledHead(
        num_classes=num_classes,
        n_anchors=int(cfg.get("num_anchor", 1)),
        in_channels=tuple(cfg["channels"]),
        depthwise=bool(cfg.get("depthwise", False)),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        feat_channels=tuple(feat_channels),
        dtype=dtype,
    )


def _eelan(cfg: dict, dtype, input_size) -> nn.Module:
    return EELAN(
        depths=tuple(cfg["depths"]),
        channels=tuple(cfg["channels"]),
        outputs=tuple(cfg["outputs"]),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        dtype=dtype,
    )


def _yolov7neck(cfg: dict, feat_channels: Sequence[int], dtype) -> nn.Module:
    return YOLOv7NECK(
        depths=tuple(cfg["depths"]),
        in_channels=tuple(cfg["channels"]),
        use_repconv=bool(cfg.get("use_repconv", False)),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        feat_channels=tuple(feat_channels),
        dtype=dtype,
    )


def _implicit_head(cfg: dict, num_classes: int,
                   feat_channels: Sequence[int], dtype) -> nn.Module:
    # fp32 whatever `dtype` (see ImplicitHead)
    return ImplicitHead(
        num_classes=num_classes,
        n_anchors=int(cfg.get("num_anchor", 3)),
        in_channels=tuple(feat_channels),
    )


def _simple_head(cfg: dict, num_classes: int,
                 feat_channels: Sequence[int], dtype) -> nn.Module:
    # fp32 whatever `dtype` (see SimpleHead)
    return SimpleHead(
        num_classes=num_classes,
        n_anchors=int(cfg.get("num_anchor", 3)),
        in_channels=tuple(feat_channels),
    )


def _staged_mobile(cls):
    def make(cfg: dict, dtype, input_size) -> nn.Module:
        return cls(
            depths=tuple(cfg["depths"]),
            channels=tuple(cfg["channels"]),
            outputs=tuple(cfg["outputs"]),
            norm=cfg.get("norm", "bn"),
            act=cfg.get("act", "silu"),
            dtype=dtype,
        )
    return make


def _shufflenetv2(cfg: dict, dtype, input_size) -> nn.Module:
    return ShuffleNetV2(
        channels=tuple(cfg.get("channels", (36, 104, 208, 416))),
        outputs=tuple(cfg.get("outputs", ("stage2", "stage3", "stage4"))),
        act=cfg.get("act", "hswish"),
        use_se=bool(cfg.get("use_se", False)),
        dtype=dtype,
    )


def _mobilenetv3(size: str):
    # reads only `outputs`, as the JAX package: the table sets the rest
    def make(cfg: dict, dtype, input_size) -> nn.Module:
        return MobileNetV3(
            size=size,
            outputs=tuple(cfg.get("outputs",
                                  ("stage2", "stage3", "stage4"))),
            dtype=dtype,
        )
    return make


def _al_pafpn(cfg: dict, feat_channels: Sequence[int], dtype) -> nn.Module:
    return AL_PAFPN(
        depths=tuple(cfg["depths"]),
        in_channels=tuple(cfg["channels"]),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        feat_channels=tuple(feat_channels),
        dtype=dtype,
    )


def _swin(cfg: dict, dtype, input_size, v2: bool = False) -> nn.Module:
    klass = SwinTransformerV2 if v2 else SwinTransformer
    return klass(
        embed_dim=int(cfg.get("embed_dim", 96)),
        depths=tuple(cfg.get("depths", (2, 2, 6, 2))),
        num_heads=tuple(cfg.get("num_heads", (3, 6, 12, 24))),
        window_size=int(cfg.get("window_size", 7)),
        mlp_ratio=float(cfg.get("mlp_ratio", 4.0)),
        out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))),
        drop_path_rate=float(cfg.get("drop_path_rate", 0.0)),
        input_size=tuple(input_size),
    )


def _vit(cfg: dict, dtype, input_size) -> nn.Module:
    return VisionTransformer(
        embed_dim=int(cfg.get("embed_dim", 768)),
        depth=int(cfg.get("depth", 12)),
        num_heads=int(cfg.get("num_heads", 12)),
        patch_size=int(cfg.get("patch_size", 16)),
        mlp_ratio=float(cfg.get("mlp_ratio", 4.0)),
        moe_experts=int(cfg.get("moe_experts", 0)),
        moe_capacity=float(cfg.get("moe_capacity", 1.25)),
    )


def _restv2(cfg: dict, dtype, input_size) -> nn.Module:
    return ResTV2(
        depths=tuple(cfg.get("depths", (1, 2, 6, 2))),
        embed_dims=tuple(cfg.get("embed_dims", (96, 192, 384, 768))),
        num_heads=tuple(cfg.get("num_heads", (1, 2, 4, 8))),
        sr_ratios=tuple(cfg.get("sr_ratios", (8, 4, 2, 1))),
        drop_path_rate=float(cfg.get("drop_path_rate", 0.0)),
        outputs=tuple(cfg.get("outputs", ("stage2", "stage3", "stage4"))),
    )


def _mctformer(cfg: dict, dtype, input_size) -> nn.Module:
    return MCTformer(
        num_classes=int(cfg.get("num_cls_tokens", 80)),
        embed_dim=int(cfg.get("embed_dim", 384)),
        depth=int(cfg.get("depth", 12)),
        num_heads=int(cfg.get("num_heads", 6)),
        patch_size=int(cfg.get("patch_size", 16)),
        mlp_ratio=float(cfg.get("mlp_ratio", 4.0)),
    )


def _extras(cls):
    # `depths` / `channels` only where the class has them (GhostNet reads
    # neither, VGG no `depths`), `dtype` where its ConvBlocks take one
    # (ConvNeXt computes in fp32), as the JAX package's `_extras`
    def make(cfg: dict, dtype, input_size) -> nn.Module:
        params = inspect.signature(cls).parameters
        kwargs = {k: tuple(cfg[k]) for k in ("depths", "channels", "outputs")
                  if k in cfg and k in params}
        if "dtype" in params:
            kwargs["dtype"] = dtype
        return cls(**kwargs)
    return make


BACKBONES: dict[str, Callable[..., nn.Module]] = {
    "cspdarknet": _cspdarknet,
    "eelan": _eelan,
    "cspmobilenext": _staged_mobile(CSPMobileNext),
    "ecmnet": _staged_mobile(ECMNet),
    "shufflenetv2": _shufflenetv2,
    "mobilenetv3s": _mobilenetv3("small"),
    "mobilenetv3l": _mobilenetv3("large"),
    "swin_transformer": _swin,
    "swin_transformerv2": functools.partial(_swin, v2=True),
    "vision_transformer": _vit,
    "restv2": _restv2,
    "mctformer": _mctformer,
    "efficientrep": _extras(extras.EfficientRep),
    "resnet": _extras(extras.ResNet),
    "convnext": _extras(extras.ConvNeXt),
    "ghostnet": _extras(extras.GhostNet),
    "vgg": _extras(extras.VGG),
    "mobilenext": _extras(extras.MobileNeXt),
}
NECKS: dict[str, Callable[..., nn.Module]] = {
    "csppafpn": _csppafpn,
    "al_pafpn": _al_pafpn,
    "yolov7neck": _yolov7neck,
    "none": lambda cfg, feat_channels, dtype: NoNeck(feat_channels),
}
HEADS: dict[str, Callable[..., nn.Module]] = {
    "decoupled_head": _decoupled_head,
    "implicit_head": _implicit_head,
    "simple_head": _simple_head,
}


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """Pairs a train-mode loss fn with an eval-mode decode fn."""
    train_loss: Callable[..., dict]          # (head_outputs, labels) -> loss dict
    eval_decode: Callable[..., torch.Tensor]  # (head_outputs) -> [B, A, 5+C]
    strides: Sequence[int]


def _yolox_loss_spec(cfg: dict, num_classes: int) -> LossSpec:
    strides = tuple(cfg.get("stride", (8, 16, 32)))
    return LossSpec(
        train_loss=functools.partial(
            yolox_loss, num_classes=num_classes, strides=strides,
            use_l1=bool(cfg.get("use_l1", False)),
            # loss: {assign_chunk: N}: label-axis-chunked SimOTA, the same
            # outputs with [B, N, A] peak temporaries
            assign_chunk=(int(cfg["assign_chunk"])
                          if cfg.get("assign_chunk") else None),
            # loss: {pallas_assign: true}: the fused assignment kernel
            # (ops.simota), in place of the dense or chunked SimOTA
            pallas_assign=bool(cfg.get("pallas_assign", False))),
        eval_decode=functools.partial(yolox_eval_decode, strides=strides),
        strides=strides,
    )


def _anchors(cfg: dict, default) -> tuple:
    return tuple(tuple(tuple(a) for a in lvl)
                 for lvl in cfg.get("anchors", default))


def _yolov7_loss_spec(cfg: dict, num_classes: int) -> LossSpec:
    strides = tuple(cfg.get("stride", (8, 16, 32)))
    anchors = _anchors(cfg, DEFAULT_V7_ANCHORS)
    return LossSpec(
        train_loss=functools.partial(
            yolov7_loss, num_classes=num_classes, strides=strides,
            anchors=anchors,
            label_smoothing=float(cfg.get("label_smoothing", 0.0)),
            # the ultralytics order (4.0 on stride 8), as the JAX package
            balance=tuple(cfg.get("balance", (4.0, 1.0, 0.4))),
            gain=dict(cfg.get("gain", {}))),
        eval_decode=functools.partial(
            yolov7_eval_decode, strides=strides, anchors=anchors,
            num_classes=num_classes),
        strides=strides,
    )


def _yolov5_loss_spec(cfg: dict, num_classes: int) -> LossSpec:
    strides = tuple(cfg.get("stride", (8, 16, 32)))
    anchors = _anchors(cfg, DEFAULT_V5_ANCHORS)
    return LossSpec(
        train_loss=functools.partial(
            yolov5_loss, num_classes=num_classes, strides=strides,
            anchors=anchors,
            anchor_threshold=float(cfg.get("anchor_thre", 4.0)),
            balance=tuple(cfg.get("balance", (4.0, 1.0, 0.4))),
            gain=dict(cfg.get("gain", {}))),
        eval_decode=functools.partial(
            yolov5_eval_decode, strides=strides, anchors=anchors,
            num_classes=num_classes),
        strides=strides,
    )


def _yolov3_loss_spec(cfg: dict, num_classes: int) -> LossSpec:
    strides = tuple(cfg.get("stride", (32, 16, 8)))
    anchors = _anchors(cfg, DEFAULT_V3_ANCHORS)
    img_size = tuple(cfg.get("img_size", (640, 640)))
    return LossSpec(
        train_loss=functools.partial(
            yolov3_loss, num_classes=num_classes, anchors=anchors,
            img_size=img_size,
            ignore_threshold=float(cfg.get("ignore_threshold", 0.5))),
        eval_decode=functools.partial(
            yolov3_eval_decode, strides=strides, anchors=anchors,
            num_classes=num_classes, img_size=img_size),
        strides=strides,
    )


LOSSES: dict[str, Callable[[dict, int], LossSpec]] = {
    "yolox": _yolox_loss_spec,
    "yolov7": _yolov7_loss_spec,
    "yolov5": _yolov5_loss_spec,
    "yolov3": _yolov3_loss_spec,
}


@dataclasses.dataclass(frozen=True)
class DetectionModel:
    """User-facing bundle: torch module + loss/decode + config."""
    module: OneStageDetector
    loss: LossSpec
    num_classes: int
    cfg: dict[str, Any]


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                   fan_in: int | None = None) -> None:
    """flax's default conv and dense init: truncated normal (+-2 sd) of
    variance 1/fan_in (default: a conv or linear weight's, all but the
    leading axis), the sd corrected for the truncation."""
    fan_in = fan_in or weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def build_model(cfg: dict, num_classes: int, device=None,
                seed: int = 0, input_size: Sequence[int] = (640, 640)
                ) -> DetectionModel:
    """Compose a detector from a model-config dict, on `device` (default
    the CUDA card), in eval mode, with conv and dense kernels (and the
    implicit head's priors, the transformer backbones' free parameters)
    drawn from a `torch.Generator` seeded with `seed`. `input_size` is the
    (H, W) a flax init would see: the Swin backbones size their position
    tables from it (a stage whose map is below the window has a smaller
    window), and refuse another size that needs other tables.
    Top-level `dtype: bfloat16` runs conv/BN in bf16 with fp32 params;
    decode stays fp32. Top-level `remat: true` makes the backbone and neck
    that support it (CSPDarkNet, CSPPAFPN) recompute their CSP layers in
    the backward pass (`layers.blocks.maybe_checkpoint`); the parameters
    are the same either way."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg.get("dtype", None) or None)
    b_cfg, n_cfg, h_cfg, l_cfg = cfg["backbone"], cfg["neck"], cfg["head"], cfg["loss"]
    for section, registry, name in (
        ("backbone", BACKBONES, b_cfg["name"]),
        ("neck", NECKS, n_cfg["name"]),
        ("head", HEADS, h_cfg["name"]),
        ("loss", LOSSES, l_cfg["name"]),
    ):
        if name not in registry:
            raise KeyError(
                f"Unknown {section} '{name}'. Available: {sorted(registry)}")
    # nn.Module constructors draw from the global RNG; keep it untouched
    # and draw every kernel from the explicit generator instead. What the
    # constructors draw and no init below replaces (a conv's bias) comes
    # from the global RNG seeded with `seed` inside the fork, so that one
    # seed builds one module in every process.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        backbone = BACKBONES[b_cfg["name"]](b_cfg, dtype, input_size)
        neck = NECKS[n_cfg["name"]](n_cfg, backbone.out_channels, dtype)
        head = HEADS[h_cfg["name"]](h_cfg, num_classes, neck.out_channels,
                                    dtype)
    remat = bool(cfg.get("remat", False))
    for part in (backbone, neck):
        if hasattr(part, "remat"):
            part.remat = remat
    module = OneStageDetector(backbone, neck, head)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, gen)
            elif isinstance(m, (nn.Linear, nn.ConvTranspose2d)):
                # a transposed conv's weight is [in, out, kh, kw]; flax's
                # fan_in of its [kh, kw, in, out] kernel is kh·kw·in
                fan_in = (m.weight.numel() // m.weight.shape[1]
                          if isinstance(m, nn.ConvTranspose2d) else None)
                _lecun_normal_(m.weight, gen, fan_in)
                if m.bias is not None:
                    m.bias.zero_()  # flax's zero biases
            elif isinstance(m, ImplicitHead):
                m.reset_implicit_(gen)
        for m in module.modules():
            if hasattr(m, "init_weights_"):
                m.init_weights_(gen)
    module = module.to(device).eval()
    loss = LOSSES[l_cfg["name"]](l_cfg, num_classes)
    return DetectionModel(module=module, loss=loss, num_classes=num_classes,
                          cfg=cfg)
