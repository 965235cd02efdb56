"""One-stage detector assembly + registry, port of
`pl_yolo_tpu/models/detector.py` for the YOLOX family.

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
import math
from typing import Any, Callable, Sequence

import torch
from torch import nn

from .. import resolve_device
from ..layers.blocks import compute_dtype
from .backbones.cspdarknet import CSPDarkNet
from .heads.decoupled_head import DecoupledHead
from .losses.yolox import yolox_eval_decode, yolox_loss
from .necks.csppafpn import CSPPAFPN


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


# ---------------------------------------------------------------------------
# Registries. Each factory: (cfg-dict, input widths, dtype) -> torch module.
# Torch modules need their input widths at build time; flax infers them.
# ---------------------------------------------------------------------------

def _cspdarknet(cfg: dict, dtype) -> nn.Module:
    db = cfg.get("drop_block", {}) or {}
    return CSPDarkNet(
        depths=tuple(cfg["depths"]),
        channels=tuple(cfg["channels"]),
        outputs=tuple(cfg["outputs"]),
        depthwise=bool(cfg.get("depthwise", False)),
        norm=cfg.get("norm", "bn"),
        act=cfg.get("act", "silu"),
        drop_block_rate=float(db.get("rate", 0.0)),
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


BACKBONES: dict[str, Callable[..., nn.Module]] = {"cspdarknet": _cspdarknet}
NECKS: dict[str, Callable[..., nn.Module]] = {"csppafpn": _csppafpn}
HEADS: dict[str, Callable[..., nn.Module]] = {"decoupled_head": _decoupled_head}


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


LOSSES: dict[str, Callable[[dict, int], LossSpec]] = {"yolox": _yolox_loss_spec}


@dataclasses.dataclass(frozen=True)
class DetectionModel:
    """User-facing bundle: torch module + loss/decode + config."""
    module: OneStageDetector
    loss: LossSpec
    num_classes: int
    cfg: dict[str, Any]


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv init: truncated normal (+-2 sd) of variance
    1/fan_in, the sd corrected for the truncation."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def build_model(cfg: dict, num_classes: int, device=None,
                seed: int = 0) -> DetectionModel:
    """Compose a detector from a model-config dict, on `device` (default
    the CUDA card), in eval mode, with conv kernels drawn from a
    `torch.Generator` seeded with `seed`. Top-level `dtype: bfloat16` runs
    conv/BN in bf16 with fp32 params; decode stays fp32."""
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
    # and draw every kernel from the explicit generator instead.
    with torch.random.fork_rng(devices=[]):
        backbone = BACKBONES[b_cfg["name"]](b_cfg, dtype)
        neck = NECKS[n_cfg["name"]](n_cfg, backbone.out_channels, dtype)
        head = HEADS[h_cfg["name"]](h_cfg, num_classes, neck.out_channels,
                                    dtype)
    module = OneStageDetector(backbone, neck, head)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, gen)
    module = module.to(device).eval()
    loss = LOSSES[l_cfg["name"]](l_cfg, num_classes)
    return DetectionModel(module=module, loss=loss, num_classes=num_classes,
                          cfg=cfg)
