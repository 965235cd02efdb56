"""Vision Transformer detection backbone (ViTDet-style simple pyramid), port
of `pl_yolo_tpu/models/backbones/vit.py`.

A plain ViT encoder over 16x16 patches with a position embedding resized
from its 14x14 grid (JAX's bicubic `jax.image.resize`, rebuilt in
`ops/resize.py`), then a simple pyramid: a stride-2 transposed conv up to
stride 8, the stride-16 map itself, a stride-2 conv down to stride 32.
NCHW in and out, tokens in between.

The L blocks keep one stacked parameter tree, as the JAX package's scanned
tower does: `blocks_<name>` parameters with a leading axis L, named after
the flax leaves, applied layer by layer by `vit_block`. They are plain
parameters, not `nn.Linear`s, so that they take no weight decay: the JAX
package decays only leaves named `kernel`. With `moe_experts` > 1 the FFN
is the switch top-1 mixture of experts of `moe_ffn`. Inside a train step
whose layout has a pipe width S > 1 (`parallel: {pipeline: S}`), the tower
runs as a GPipe over the pipe group (`apply_tower`,
`parallel.pipeline.pipeline_apply`): stage s applies blocks [s·L/S,
(s+1)·L/S) on S microbatches. The parameters, the state_dict and the
sequential path elsewhere (init, eval, export) are unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import LayerNorm, SameConv2d, get_activation
from ...ops.resize import resize_bicubic
from ...parallel import collectives
from ...parallel.mesh import data_layout, expert_layout, pipe_layout
from ...parallel.pipeline import check_depth, pipeline_apply

_gelu = get_activation("gelu")  # jax.nn.gelu: the tanh approximation


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The tower's LayerNorm (`_ln`): a two-pass variance, eps 1e-6."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def moe_ffn(p: dict, y: torch.Tensor, capacity_factor: float = 1.25
            ) -> torch.Tensor:
    """Switch top-1 mixture-of-experts FFN, the function of the JAX
    package's `moe_ffn` computed by index instead of by one-hot matmuls.

    p["moe_router"] [d, E], p["moe_w1"/"moe_b1"/"moe_w2"/"moe_b2"]
    [E, d, m] / [E, m] / [E, m, d] / [E, d]. The router runs in fp32; each
    token goes to its argmax expert (the first on a tie), at the position
    it has among that expert's tokens in the flattened batch's order; an
    expert holds C = ceil(int(n·capacity_factor) / E) tokens, and a token
    past it contributes 0. The kept tokens are scattered into [E, C, d]
    buffers, run through their expert's FFN, gathered back and scaled by
    their gate probability. The JAX package's dense dispatch builds [n, E,
    C] one-hot tensors, 3.3 GB a layer at B=16, 640²; this keeps [E, C, d].

    Inside a train step with a data width D > 1 (and no GPipe, whose stage
    sees a microbatch's tokens, as JAX's `shard_map` stage does) it is the
    function of the global batch, as the JAX package's jitted step is under
    GSPMD: n counts every data rank's tokens, and a token's position is its
    position on its rank plus its expert's tokens on the data ranks before
    (one all-gather of the [E] counts). With an expert width X > 1 the
    expert tensors hold this rank's E/X experts (`parallel.tensor`): the
    router, the gate and the positions are computed on every expert rank
    alike, outside the expert region, so that the router's gradient is
    whole; the tokens and the gates enter it through `copy_to_group`, each
    rank runs its experts' buffers, and the combine leaves through
    `reduce_from_group` over the expert group.
    """
    n_b, t, d = y.shape
    n_exp = p["moe_router"].shape[-1]
    n = n_b * t
    data = None if pipe_layout() is not None else data_layout()
    n_all = n if data is None else n * data.data
    cap = -(-int(n_all * capacity_factor) // n_exp)
    yt = y.reshape(n, d)
    logits = yt.to(torch.float32) @ p["moe_router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                  # [n, E]
    gate, expert = probs.max(dim=-1)
    # [E, n], scanned along its last axis (a comparison, not F.one_hot,
    # which reads its input's range back; a scan along the tokens of an
    # [n, E] tensor runs E threads down n rows on the card)
    onehot = (expert[None, :]
              == torch.arange(n_exp, device=y.device)[:, None]).long()
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(0) - 1  # [n]
    kept = pos
    if data is not None:
        counts = collectives.all_gather_dim0(onehot.sum(1)[None],
                                             data.data_group)  # [D, E]
        kept = pos + counts[:data.data_index].sum(0)[expert]
    ex = expert_layout()
    per, first = p["moe_w1"].shape[0], 0
    if ex is not None:
        first = ex.expert_index * per
        mine = (kept < cap) & (expert >= first) & (expert < first + per)
        yt = collectives.copy_to_group(yt, ex.expert_group)
        gate = collectives.copy_to_group(gate, ex.expert_group)
    elif per != n_exp:
        raise RuntimeError(
            f"the MoE FFN holds {per} of {n_exp} experts: it runs only "
            "inside a train step's layout with their expert width "
            "(parallel.mesh.use_layout); gather the module first")
    else:
        mine = kept < cap
    # token i's row: its expert's slot (its position on this rank, below
    # C where its global position is), or, past the capacity or on another
    # expert rank, a zero row of its own after the slots, so that no two
    # tokens share a row (the scatter and the gather then need no atomics)
    slot = torch.where(mine, (expert - first) * cap + pos,
                       per * cap + torch.arange(n, device=y.device))
    buf = yt.new_zeros(per * cap + n, d).index_copy(0, slot, yt)
    expert_in = buf[:per * cap].reshape(per, cap, d)
    h = _gelu(torch.bmm(expert_in, p["moe_w1"]) + p["moe_b1"][:, None, :])
    out = torch.bmm(h, p["moe_w2"]) + p["moe_b2"][:, None, :]
    picked = torch.cat([out.reshape(per * cap, d),
                        out.new_zeros(n, d)])[slot]
    res = picked * gate[:, None].to(out.dtype)
    if ex is not None:
        res = collectives.reduce_from_group(res, ex.expert_group)
    return res.reshape(n_b, t, d)


def vit_block(p: dict, x: torch.Tensor, num_heads: int,
              moe_capacity: float = 1.25) -> torch.Tensor:
    """Pre-LN encoder block on one layer's parameter slice: LN, MHA
    (q kᵀ / sqrt(hd)), residual, LN, MLP (gelu) or the MoE FFN, residual."""
    b, t, d = x.shape
    hd = d // num_heads
    y = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q = (y @ p["wq"] + p["bq"]).reshape(b, t, num_heads, hd)
    k = (y @ p["wk"] + p["bk"]).reshape(b, t, num_heads, hd)
    v = (y @ p["wv"] + p["bv"]).reshape(b, t, num_heads, hd)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    o = torch.einsum("bhqk,bkhd->bqhd", att.softmax(-1), v).reshape(b, t, d)
    x = x + o @ p["wo"] + p["bo"]
    y = layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    if "moe_router" in p:
        return x + moe_ffn(p, y, moe_capacity)
    y = _gelu(y @ p["w1"] + p["b1"])
    return x + y @ p["w2"] + p["b2"]


def stacked_lecun_normal_(param: torch.Tensor,
                          generator: torch.Generator) -> None:
    """flax `stacked_init(lecun_normal())`: each layer's slice its own
    truncated normal of variance 1/fan_in (fan_in: all but the last axis)."""
    with torch.no_grad():
        for layer in param:
            fan_in = layer.numel() // layer.shape[-1]
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(layer, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)


def truncated_normal_(param: torch.Tensor, generator: torch.Generator,
                      std: float = 0.02) -> None:
    """flax `truncated_normal(std)`: a normal cut at ±2 sd, times sd."""
    nn.init.trunc_normal_(param, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def register_tower(module: nn.Module, depth: int, spec: dict) -> None:
    """Give `module` the L blocks' parameters `blocks_<name>` [L, ...], the
    flax leaves' names (`spec`: name -> (per-layer shape, init: "ones",
    "zeros", "lecun" or "trunc"))."""
    module.tower_depth, module.tower_spec = depth, dict(spec)
    for name, (shape, init) in spec.items():
        value = torch.ones if init == "ones" else torch.zeros
        module.register_parameter(f"blocks_{name}", nn.Parameter(
            value((depth,) + tuple(shape))))


def tower_layer(module: nn.Module, i: int) -> dict:
    """Layer i's slice of `module`'s tower parameters."""
    return {k: getattr(module, f"blocks_{k}")[i] for k in module.tower_spec}


def apply_tower(module: nn.Module, x: torch.Tensor, block, what: str
                ) -> torch.Tensor:
    """x through `module`'s L blocks, `block(layer_params, x) -> x`: in turn,
    or, under an ambient pipe width S > 1, as a GPipe of S stages of L/S
    blocks (the JAX package's `_apply_tower`, with its depth check)."""
    layout = pipe_layout()
    depth = module.tower_depth
    if layout is None:
        for i in range(depth):
            x = block(tower_layer(module, i), x)
        return x
    check_depth(depth, layout.pipe, what)
    per = depth // layout.pipe

    def stage(s, xm):
        for i in range(s * per, (s + 1) * per):
            xm = block(tower_layer(module, i), xm)
        return xm
    return pipeline_apply(stage, x, layout)


def init_tower_(module: nn.Module, generator: torch.Generator) -> None:
    for name, (_, init) in module.tower_spec.items():
        param = getattr(module, f"blocks_{name}")
        if init == "lecun":
            stacked_lecun_normal_(param, generator)
        elif init == "trunc":
            with torch.no_grad():
                for layer in param:
                    truncated_normal_(layer, generator)


def vit_tower_spec(d: int, mlp: int, experts: int) -> dict:
    spec = {"ln1_scale": ((d,), "ones"), "ln1_bias": ((d,), "zeros")}
    for name in ("q", "k", "v", "o"):
        spec[f"w{name}"] = ((d, d), "lecun")
        spec[f"b{name}"] = ((d,), "zeros")
    spec.update({"ln2_scale": ((d,), "ones"), "ln2_bias": ((d,), "zeros")})
    if experts > 1:
        spec.update({
            "moe_router": ((d, experts), "lecun"),
            "moe_w1": ((experts, d, mlp), "lecun"),
            "moe_b1": ((experts, mlp), "zeros"),
            "moe_w2": ((experts, mlp, d), "lecun"),
            "moe_b2": ((experts, d), "zeros")})
    else:
        spec.update({"w1": ((d, mlp), "lecun"), "b1": ((mlp,), "zeros"),
                     "w2": ((mlp, d), "lecun"), "b2": ((d,), "zeros")})
    return spec


def simple_pyramid(module: nn.Module, embed_dim: int, patch_size: int,
                   out_strides: Sequence[int]) -> list[int]:
    """Add the pyramid's `up{s}` (transposed conv, embed_dim // 2 wide) and
    `down{s}` (strided conv) layers to `module`; their output widths."""
    widths = []
    for s in out_strides:
        if s < patch_size:
            f = patch_size // s
            module.add_module(f"up{s}", nn.ConvTranspose2d(
                embed_dim, embed_dim // 2, f, stride=f))
            widths.append(embed_dim // 2)
        elif s > patch_size:
            f = s // patch_size
            module.add_module(f"down{s}", SameConv2d(embed_dim, embed_dim,
                                                     f, f))
            widths.append(embed_dim)
        else:
            widths.append(embed_dim)
    return widths


def apply_pyramid(module: nn.Module, feat: torch.Tensor, patch_size: int,
                  out_strides: Sequence[int]) -> list[torch.Tensor]:
    """The stride-`patch_size` NCHW map -> one NCHW map a stride."""
    return [feat if s == patch_size else
            getattr(module, f"up{s}" if s < patch_size else f"down{s}")(feat)
            for s in out_strides]


class VisionTransformer(nn.Module):
    STEM_S2D = False  # a patch-embed stem: the trainer feeds NHWC images
    PIPELINE_TOWER = True  # the tower takes `parallel: {pipeline: S}`

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 mlp_ratio: float = 4.0, ref_grid: int = 14,
                 out_strides: Sequence[int] = (8, 16, 32),
                 moe_experts: int = 0, moe_capacity: float = 1.25):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.patch_size, self.out_strides = patch_size, tuple(out_strides)
        self.moe_experts, self.moe_capacity = moe_experts, moe_capacity
        self.patch_embed = SameConv2d(3, embed_dim, patch_size, patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, ref_grid, ref_grid, embed_dim))
        register_tower(self, depth, vit_tower_spec(
            embed_dim, int(embed_dim * mlp_ratio), moe_experts))
        self.norm = LayerNorm(embed_dim)
        self.out_channels = simple_pyramid(self, embed_dim, patch_size,
                                           out_strides)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        b, _, hh, ww = x.shape
        p, d = self.patch_size, self.embed_dim
        h, w = hh // p, ww // p
        x = self.patch_embed(x).permute(0, 2, 3, 1).reshape(b, h * w, d)
        x = x + resize_bicubic(self.pos_embed, h, w).reshape(1, h * w, d)
        x = apply_tower(self, x, lambda p, y: vit_block(
            p, y, self.num_heads, self.moe_capacity), "ViT")
        feat = self.norm(x).reshape(b, h, w, d).permute(0, 3, 1, 2)
        return apply_pyramid(self, feat, p, self.out_strides)

    def init_weights_(self, generator: torch.Generator) -> None:
        """The position embedding (truncated normal, sd 0.02) and the
        tower, as flax initialises them; the convs are `build_model`'s."""
        truncated_normal_(self.pos_embed, generator)
        init_tower_(self, generator)
