"""MCTformer: the multi-class-token Vision Transformer, port of
`pl_yolo_tpu/models/backbones/mctformer.py`.

A DeiT-small encoder carrying one class token per class. `forward` (the
detection-backbone protocol) runs the encoder and returns the simple
pyramid of `vit.py` (strides 8 / 16 / 32, NCHW) built from the patch
tokens. `classify` reproduces MCTformerV2's forward: class-token logits,
patch logits from a 3x3 conv CAM head, and the fused class activation
maps; its head exists only in a module built with `cam_head=True`, as the
`head` leaf exists only in a flax tree initialised through `classify`.

The L blocks keep one stacked parameter tree (`blocks_<name>` [L, ...]),
as in `vit.py`, and take no weight decay. Under an ambient pipe width
(`parallel: {pipeline: S}`) the detection path's tower runs as a GPipe
(`vit.apply_tower`), without collecting the attentions, as in the JAX
package; `classify` keeps the sequential tower.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import LayerNorm, SameConv2d
from ...ops.resize import resize_bicubic
from .vit import (_gelu, apply_pyramid, apply_tower, init_tower_,
                  layer_norm, register_tower, simple_pyramid, tower_layer,
                  truncated_normal_)


def mct_block(p: dict, x: torch.Tensor, num_heads: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm ViT block on one layer's parameter slice (one fused qkv
    projection, softmax(q kᵀ · hd^-0.5) in fp32); also returns the
    attention [B, heads, N, N] for the CAM path."""
    b, n, c = x.shape
    hd = c // num_heads
    y = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = y @ p["wqkv"] + p["bqkv"]
    q, k, v = [qkv[..., i * c:(i + 1) * c].reshape(b, n, num_heads, hd)
               for i in range(3)]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    attn = torch.softmax(logits * hd ** -0.5, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v)
    x = x + out.reshape(b, n, c) @ p["wproj"] + p["bproj"]
    y = layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    y = _gelu(y @ p["w1"] + p["b1"])
    return x + y @ p["w2"] + p["b2"], attn


def mct_tower_spec(d: int, mlp: int) -> dict:
    return {"ln1_scale": ((d,), "ones"), "ln1_bias": ((d,), "zeros"),
            "wqkv": ((d, 3 * d), "trunc"), "bqkv": ((3 * d,), "zeros"),
            "wproj": ((d, d), "trunc"), "bproj": ((d,), "zeros"),
            "ln2_scale": ((d,), "ones"), "ln2_bias": ((d,), "zeros"),
            "w1": ((d, mlp), "trunc"), "b1": ((mlp,), "zeros"),
            "w2": ((mlp, d), "trunc"), "b2": ((d,), "zeros")}


class MCTformer(nn.Module):
    """DeiT-small defaults."""

    STEM_S2D = False  # a patch-embed stem: the trainer feeds NHWC images
    PIPELINE_TOWER = True  # the tower takes `parallel: {pipeline: S}`

    def __init__(self, num_classes: int = 80, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, patch_size: int = 16,
                 mlp_ratio: float = 4.0, ref_grid: int = 14,
                 out_strides: Sequence[int] = (8, 16, 32),
                 cam_head: bool = False):
        super().__init__()
        self.num_classes, self.embed_dim = num_classes, embed_dim
        self.num_heads, self.patch_size = num_heads, patch_size
        self.out_strides = tuple(out_strides)
        self.patch_embed = SameConv2d(3, embed_dim, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, num_classes, embed_dim))
        self.pos_embed_cls = nn.Parameter(
            torch.zeros(1, num_classes, embed_dim))
        self.pos_embed_patch = nn.Parameter(
            torch.zeros(1, ref_grid, ref_grid, embed_dim))
        register_tower(self, depth, mct_tower_spec(
            embed_dim, int(embed_dim * mlp_ratio)))
        self.norm = LayerNorm(embed_dim)
        self.out_channels = simple_pyramid(self, embed_dim, patch_size,
                                           out_strides)
        self.head = (SameConv2d(embed_dim, num_classes, 3) if cam_head
                     else None)

    def encode(self, x: torch.Tensor, collect_attn: bool = False):
        """Patch embed + class tokens + position embeddings + blocks + LN:
        (class tokens [B,C,D], patch map [B,h,w,D], the attentions [L, B,
        heads, N, N] or None)."""
        b, _, hh, ww = x.shape
        p, d, ncls = self.patch_size, self.embed_dim, self.num_classes
        h, w = hh // p, ww // p
        x = self.patch_embed(x).permute(0, 2, 3, 1).reshape(b, h * w, d)
        x = torch.cat([self.cls_token.expand(b, ncls, d), x], dim=1)
        pos_patch = resize_bicubic(self.pos_embed_patch, h, w)
        x = x + torch.cat([self.pos_embed_cls,
                           pos_patch.reshape(1, h * w, d)], dim=1)
        attns = []
        if collect_attn:
            for i in range(self.tower_depth):
                x, attn = mct_block(tower_layer(self, i), x, self.num_heads)
                attns.append(attn)
        else:
            x = apply_tower(self, x, lambda p, y: mct_block(
                p, y, self.num_heads)[0], "MCTformer")
        x = self.norm(x)
        patches = x[:, ncls:].reshape(b, h, w, d)
        return (x[:, :ncls], patches,
                torch.stack(attns) if collect_attn else None)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        _, feat, _ = self.encode(x)
        return apply_pyramid(self, feat.permute(0, 3, 1, 2), self.patch_size,
                             self.out_strides)

    def classify(self, x: torch.Tensor, n_layers: int = 12,
                 attention_type: str = "fused"):
        """MCTformerV2's forward on NCHW images: (class logits [B,C], patch
        logits [B,C], CAMs [B,h,w,C]); "fused" CAMs are the class-to-patch
        attention (head mean, summed over the last `n_layers`) times the
        relu of the CAM head's map, which takes no gradient there."""
        if self.head is None:
            raise ValueError("classify needs a module built with "
                             "cam_head=True")
        ncls = self.num_classes
        cls_tokens, patches, attns = self.encode(x, collect_attn=True)
        b, h, w, _ = patches.shape
        cam_map = self.head(patches.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        patch_logits = cam_map.mean(dim=(1, 2))
        cls_logits = cls_tokens.mean(dim=-1)
        stack = attns.mean(dim=2)                      # [L, B, N, N]
        mtatt = stack[-n_layers:, :, :ncls, ncls:].sum(dim=0)
        mtatt = mtatt.reshape(b, ncls, h, w).permute(0, 2, 3, 1)
        feature_map = F.relu(cam_map).detach()
        if attention_type == "fused":
            cams = mtatt * feature_map
        elif attention_type == "patchcam":
            cams = feature_map
        else:
            cams = mtatt
        return cls_logits, patch_logits, cams

    def init_weights_(self, generator: torch.Generator) -> None:
        """The class tokens, the position embeddings and the tower, as flax
        initialises them (truncated normal, sd 0.02); the convs are
        `build_model`'s."""
        for param in (self.cls_token, self.pos_embed_cls,
                      self.pos_embed_patch):
            truncated_normal_(param, generator)
        init_tower_(self, generator)
