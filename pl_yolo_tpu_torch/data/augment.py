"""Device augmentation: mosaic + random affine + mixup + HSV + flip, on a
batch, channel-major (port of `pl_yolo_tpu/data/augment.py`).

    draws = sample_draws(generator, batch, (h, w), cfg)
    images, labels = device_augment(draws, images, labels, cfg, out_s2d=True)

or, for `train.state.make_train_step(augment_fn=...)`,
`make_augment_fn(cfg, out_s2d=True)(generator, images, labels, enable=)`.

Every random number of a batch is drawn up front into one `AugmentDraws`
record by `sample_draws` (from a `torch.Generator`); every function after it
is deterministic given the draws. The JAX package draws inside its
functions from a key tree, which torch cannot reproduce, so the tests
rebuild the same record from a JAX key and feed both sides the same numbers.

The port has one sampling route, the JAX package's channel-major "chw" one:
the mosaic (4 tiles: the image and the partners `perm[(b+i) % B]`, i=1..3)
and the mixup partner (`mix_idx[b]`) are sampled from one [B,3,H,W] pool by
`ops.mosaic` (the hand-written CUDA kernel on the card), then the blend,
HSV and flip run on full channel planes. Only separable affines are ported
(degrees = shear = perspective = 0, as every shipped data config sets);
the general-gather path raises `NotImplementedError`. Images are 0..255
throughout; the fill is 114.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.mosaic import (from_chw, mosaic_sample_idx, to_chw,
                          warp_sample_idx)


class AugmentConfig(NamedTuple):
    """Mirrors the data-yaml `transform` section (JAX `AugmentConfig`).

    `pixel_dtype` is the pixel compute dtype ("bfloat16", else fp32); label
    math stays fp32. `use_pallas` is read for config parity: "auto" and "on"
    take the port's one route (the CUDA kernel on the card, its plain
    version on the CPU); "off" and "interpret" name JAX-only routes and
    raise `ValueError`."""
    mosaic_prob: float = 0.9
    mosaic_scale: tuple = (0.1, 2.0)
    degrees: float = 0.0
    translate: float = 0.1
    shear: float = 0.0
    perspective: float = 0.0
    mixup_prob: float = 1.0
    mixup_scale: tuple = (0.5, 1.5)
    hsv_prob: float = 0.5
    flip_prob: float = 0.5
    max_labels: int = 100
    pixel_dtype: str = "bfloat16"
    use_pallas: str = "auto"

    @classmethod
    def from_dict(cls, t: dict, max_labels: int = 100) -> "AugmentConfig":
        return cls(
            mosaic_prob=float(t.get("mosaic_prob", 0.9)),
            mosaic_scale=tuple(t.get("mosaic_scale", (0.1, 2.0))),
            degrees=float(t.get("degrees", 0.0)),
            translate=float(t.get("translate", 0.1)),
            shear=float(t.get("shear", 0.0)),
            perspective=float(t.get("perspective", 0.0)),
            mixup_prob=float(t.get("mixup_prob", 1.0)),
            mixup_scale=tuple(t.get("mixup_scale", (0.5, 1.5))),
            hsv_prob=float(t.get("hsv_prob", 0.5)),
            flip_prob=float(t.get("flip_prob", 0.5)),
            max_labels=max_labels,
            use_pallas=str(t.get("use_pallas", "auto")),
        )

    @property
    def separable(self) -> bool:
        """True when the affine has no rotation, shear or perspective."""
        return (self.degrees == 0.0 and self.shear == 0.0
                and self.perspective == 0.0)


def check_config(cfg: AugmentConfig) -> None:
    """Raise on the options the port does not take."""
    if not cfg.separable:
        raise NotImplementedError(
            "degrees, shear and perspective != 0 need the general-gather "
            "augmentation path, which is not ported yet (ROADMAP queue A, "
            "item 11)")
    if cfg.use_pallas not in ("auto", "on"):
        raise ValueError(
            f"use_pallas={cfg.use_pallas!r}: the port has one sampling route "
            f"(the CUDA kernel on the card); take 'auto' or 'on'")


def _pixel_dtype(cfg: AugmentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.pixel_dtype == "bfloat16" else torch.float32


# ------------------------------------------------------------------ draws

class AugmentDraws(NamedTuple):
    """Every random number of one batch's augmentation (B images)."""
    perm: torch.Tensor        # [B] int64, mosaic partners perm[(b+i) % B]
    mix_idx: torch.Tensor     # [B] int64, mixup partner of image b
    gates: torch.Tensor       # [B,4] U[0,1): mosaic, mixup, HSV, flip
    center: torch.Tensor      # [B,2] mosaic centre (cx ~ U[w/2, 3w/2), cy)
    affine: torch.Tensor      # [B,6] angle (rad), scale, tan shear x, y,
    #                           translate fractions x, y
    hsv_gains: torch.Tensor   # [B,3] U[-1,1): hue, saturation, value
    mix_scale: torch.Tensor   # [B] mixup jitter factor ~ U(mixup_scale)
    mix_flip: torch.Tensor    # [B] bool, mixup partner flipped
    mix_offset: torch.Tensor  # [B,2] U[0,1): crop offset fractions y, x

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in self))


def sample_draws(generator: torch.Generator | None, batch: int,
                 size: tuple[int, int], cfg: AugmentConfig,
                 device=None) -> AugmentDraws:
    """Draw one batch's `AugmentDraws` from `generator`, on its device (with
    no generator: torch's default one, on `device`, default the card; pass
    `device="cpu"` for the CPU). `size` is the images' (H, W). The
    distributions are the JAX package's."""
    device = (generator.device if generator is not None
              else resolve_device(device))
    h, w = size

    def uniform(lo, hi, *shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    deg2rad = math.pi / 180.0
    perm = torch.randperm(batch, generator=generator, device=device)
    mix_idx = torch.randperm(batch, generator=generator, device=device)
    affine = torch.stack([
        uniform(-cfg.degrees, cfg.degrees, batch) * deg2rad,
        uniform(*cfg.mosaic_scale, batch),
        torch.tan(uniform(-cfg.shear, cfg.shear, batch) * deg2rad),
        torch.tan(uniform(-cfg.shear, cfg.shear, batch) * deg2rad),
        uniform(0.5 - cfg.translate, 0.5 + cfg.translate, batch),
        uniform(0.5 - cfg.translate, 0.5 + cfg.translate, batch)], dim=1)
    return AugmentDraws(
        perm=perm, mix_idx=mix_idx, gates=uniform(0.0, 1.0, batch, 4),
        center=torch.stack([uniform(0.5 * w, 1.5 * w, batch),
                            uniform(0.5 * h, 1.5 * h, batch)], dim=1),
        affine=affine, hsv_gains=uniform(-1.0, 1.0, batch, 3),
        mix_scale=uniform(*cfg.mixup_scale, batch),
        mix_flip=uniform(0.0, 1.0, batch) > 0.5,
        mix_offset=uniform(0.0, 1.0, batch, 2))


# ----------------------------------------------------------------- affines

def _affine_matrix(params: torch.Tensor, h: int, w: int, margin_y: float,
                   margin_x: float) -> torch.Tensor:
    """[B,3,3] forward matrices, margin-canvas coords -> output coords:
    T @ Sh @ R(scale) @ C, C centring the conceptual 2w x 2h canvas."""
    ang, s, shx, shy, tx, ty = params.to(torch.float32).unbind(-1)
    one, zero = torch.ones_like(s), torch.zeros_like(s)

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    C = mat((one, zero, zero - (w + margin_x)),
            (zero, one, zero - (h + margin_y)), (zero, zero, one))
    cos, sin = torch.cos(ang) * s, torch.sin(ang) * s
    R = mat((cos, sin, zero), (-sin, cos, zero), (zero, zero, one))
    Sh = mat((one, shx, zero), (shy, one, zero), (zero, zero, one))
    T = mat((one, zero, tx * w), (zero, one, ty * h), (zero, zero, one))
    return T @ Sh @ R @ C


def _apply_affine_to_points(M: torch.Tensor, pts: torch.Tensor
                            ) -> torch.Tensor:
    """M [B,3,3], pts [B,...,2] -> transformed [B,...,2]."""
    b = pts.shape[0]
    flat = pts.reshape(b, -1, 2)
    ones = torch.ones(flat.shape[:-1] + (1,), dtype=pts.dtype,
                      device=pts.device)
    out = torch.cat([flat, ones], dim=-1) @ M.transpose(-1, -2)
    return out[..., :2].reshape(pts.shape)


# ------------------------------------------------------------------ mosaic

def _mosaic_geometry(draws: AugmentDraws, labels4: torch.Tensor, h: int,
                     w: int):
    """Mosaic geometry and transformed labels for the batch (separable).
    labels4 [B,4,M,5] (the image's own, then its 3 partners'). Returns
    (oxw, oyw [B,4] int32 tile origins in 2Hx2W window coords, xs_raw [B,W],
    ys_raw [B,H] source coords in the window, cand [B,4M,5], valid [B,4M])."""
    mh, mw = h // 2, w // 2
    cx = draws.center[:, 0] + mw
    cy = draws.center[:, 1] + mh
    # tiles so that their inner corners touch (cx, cy): TL, TR, BL, BR; the
    # cast truncates, as the JAX package's astype(int32)
    ox = torch.stack([cx - w, cx, cx - w, cx], dim=1).to(torch.int32)
    oy = torch.stack([cy - h, cy - h, cy, cy], dim=1).to(torch.int32)
    M = _affine_matrix(draws.affine, h, w, mh, mw)
    ar_w = torch.arange(w, dtype=torch.float32, device=M.device)
    ar_h = torch.arange(h, dtype=torch.float32, device=M.device)
    xs_raw = (ar_w[None] - M[:, 0, 2:3]) / M[:, 0, 0:1] - mw
    ys_raw = (ar_h[None] - M[:, 1, 2:3]) / M[:, 1, 1:2] - mh
    cand, valid = _mosaic_labels(M, labels4, ox, oy, h, w, mh, mw)
    return ox - mw, oy - mh, xs_raw, ys_raw, cand, valid


def _mosaic_labels(M, labels4, ox, oy, h, w, mh, mw):
    """Tile coords -> canvas (+ origin) -> affine -> output, with the
    reference's box_candidates as a mask. Returns [B,4M,5], [B,4M]."""
    b, nk, m, _ = labels4.shape
    area_scale = torch.abs(M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0])
    v = labels4.abs().sum(dim=-1) > 0                       # [B,4,M]
    off = torch.stack([ox, oy], dim=-1).to(labels4.dtype)   # [B,4,2]
    cxy = labels4[..., 1:3] + off[:, :, None, :]
    wh = labels4[..., 3:5]
    hx, hy = wh[..., 0] / 2, wh[..., 1] / 2
    corners = torch.stack([
        cxy + torch.stack([-hx, -hy], -1),
        cxy + torch.stack([hx, -hy], -1),
        cxy + torch.stack([-hx, hy], -1),
        cxy + torch.stack([hx, hy], -1),
    ], dim=3)                                               # [B,4,M,4,2]
    # crop boxes to the 2h x 2w canvas window (margin content is fill)
    lo = torch.tensor([mw, mh], dtype=torch.float32, device=M.device)
    hi = torch.tensor([mw + 2 * w, mh + 2 * h], dtype=torch.float32,
                      device=M.device)
    corners = torch.minimum(torch.maximum(corners, lo), hi)
    tc = _apply_affine_to_points(M, corners)
    x1 = tc[..., 0].amin(-1).clamp(0, w)
    y1 = tc[..., 1].amin(-1).clamp(0, h)
    x2 = tc[..., 0].amax(-1).clamp(0, w)
    y2 = tc[..., 1].amax(-1).clamp(0, h)
    nw, nh = x2 - x1, y2 - y1
    # box_candidates: wh > 2 px, aspect < 20, warped area ratio > 0.2
    pre_area = torch.clamp(wh[..., 0] * wh[..., 1], min=1e-8) \
        * area_scale[:, None, None]
    ar = torch.maximum(nw / torch.clamp(nh, min=1e-9),
                       nh / torch.clamp(nw, min=1e-9))
    keep = v & (nw > 2) & (nh > 2) & (ar < 20) & (nw * nh / pre_area > 0.2)
    cand = torch.stack([labels4[..., 0], (x1 + x2) / 2, (y1 + y2) / 2, nw,
                        nh], dim=-1)
    return cand.reshape(b, nk * m, 5), keep.reshape(b, nk * m)


def _compact_labels(cand: torch.Tensor, valid: torch.Tensor,
                    max_labels: int) -> torch.Tensor:
    """Keep up to max_labels valid rows in their order (a stable sort of
    ~valid), zero the rest: [B,R,5] -> [B,min(R, max_labels),5]."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    cand = torch.gather(cand, 1, order[..., None].expand_as(cand))
    valid = torch.gather(valid, 1, order)
    cand, valid = cand[:, :max_labels], valid[:, :max_labels]
    return torch.where(valid[..., None], cand, torch.zeros_like(cand))


# --------------------------------------------------------------------- HSV

def _rgb_to_hsv_planes(r, g, b):
    """Plane-wise RGB(0..255) -> (h [0,1), s [0,1], v [0,255])."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    rcp = 1.0 / torch.clamp(delta, min=1e-12)
    hr = ((g - b) * rcp) % 6.0           # floor-mod, as jnp's %
    hg = (b - r) * rcp + 2.0
    hb = (r - g) * rcp + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    h = torch.where(delta > 0, h * (1.0 / 6.0), torch.zeros_like(h))
    s = delta / torch.clamp(maxc, min=1e-12)
    return h, s, maxc


def _hsv_to_rgb_planes(h, s, v):
    """Branchless sector formula: f(n) = v (1 - s clip(min(k, 4-k), 0, 1)),
    k = (n + 6h) mod 6; (r, g, b) = (f(5), f(3), f(1))."""
    def chan(n):
        k = (n + h * 6.0) % 6.0
        t = torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)
        return v * (1.0 - s * t)
    return chan(5.0), chan(3.0), chan(1.0)


def hsv_jitter(gains: torch.Tensor, img: torch.Tensor, hgain=0.015,
               sgain=0.7, vgain=0.4, enable=None) -> torch.Tensor:
    """HSV gains on channel-major images: img [B,3,H,W], gains [B,3] in
    [-1,1), enable [B] bool (gates the gains to identity; the roundtrip runs
    either way, as in the JAX package). fp32 math, cast back to img's dtype."""
    if enable is not None:
        gains = torch.where(enable[:, None], gains, torch.zeros_like(gains))
    g = gains.to(torch.float32)[:, :, None, None]
    rc, gc, bc = img.to(torch.float32).unbind(1)
    h, sat, v = _rgb_to_hsv_planes(rc, gc, bc)
    h = (h * (g[:, 0] * hgain + 1.0)) % 1.0
    sat = torch.clamp(sat * (g[:, 1] * sgain + 1.0), 0.0, 1.0)
    v = torch.clamp(v * (g[:, 2] * vgain + 1.0), 0.0, 255.0)
    return torch.stack(_hsv_to_rgb_planes(h, sat, v), dim=1).to(img.dtype)


# ------------------------------------------------------------------- mixup

def _mixup_geometry(draws: AugmentDraws, labels: torch.Tensor,
                    h: int, w: int):
    """Mixup partner geometry and labels: jitter-scale by f, flip, crop.
    labels [B,M,5] (the partners'). Returns (xs [B,W], ys [B,H] source
    coords, cand [B,M,5], valid [B,M])."""
    f = draws.mix_scale.to(torch.float32)
    flip = draws.mix_flip
    sh, sw = h * f, w * f
    y_off = draws.mix_offset[:, 0] * torch.clamp(sh - h, min=0.0)
    x_off = draws.mix_offset[:, 1] * torch.clamp(sw - w, min=0.0)
    ar_w = torch.arange(w, dtype=torch.float32, device=f.device)
    ar_h = torch.arange(h, dtype=torch.float32, device=f.device)
    xj = ar_w[None] + x_off[:, None]
    xj = torch.where(flip[:, None], (sw - 1.0)[:, None] - xj, xj)
    xs = (xj + 0.5) / f[:, None] - 0.5
    ys = (ar_h[None] + y_off[:, None] + 0.5) / f[:, None] - 0.5

    v = labels.abs().sum(dim=-1) > 0
    fc = f[:, None]
    cx, cy = labels[..., 1] * fc, labels[..., 2] * fc
    bw, bh = labels[..., 3] * fc, labels[..., 4] * fc
    x1, x2 = cx - bw / 2, cx + bw / 2
    fx1 = torch.where(flip[:, None], sw[:, None] - x2, x1)
    fx2 = torch.where(flip[:, None], sw[:, None] - x1, x2)
    x1n = torch.clamp(fx1 - x_off[:, None], 0.0, w)
    x2n = torch.clamp(fx2 - x_off[:, None], 0.0, w)
    y1n = torch.clamp(cy - bh / 2 - y_off[:, None], 0.0, h)
    y2n = torch.clamp(cy + bh / 2 - y_off[:, None], 0.0, h)
    nw, nh = x2n - x1n, y2n - y1n
    cand = torch.stack([labels[..., 0], (x1n + x2n) / 2, (y1n + y2n) / 2,
                        nw, nh], dim=-1)
    return xs, ys, cand, v & (nw > 1) & (nh > 1)


# ------------------------------------------------------------- the batch

def _augment_batch(draws: AugmentDraws, img: torch.Tensor,
                   labels: torch.Tensor, cfg: AugmentConfig,
                   enable: torch.Tensor, mosaic, mixup):
    """The JAX `_augment_one` over the batch, channel-major: img [B,3,H,W]
    in the pixel dtype; mosaic / mixup the sampled (img, cand, valid)
    triples (None where their prob is 0). `enable` [] bool gates mosaic and
    mixup; HSV and flip stay on."""
    b, _, _, w = img.shape
    gates = draws.gates
    base_valid = labels.abs().sum(dim=-1) > 0
    out, cand, valid = img, labels, base_valid
    use_mosaic = torch.zeros(b, dtype=torch.bool, device=img.device)
    if mosaic is not None:
        mo_img, mo_cand, mo_valid = mosaic
        use_mosaic = (gates[:, 0] < cfg.mosaic_prob) & enable
        out = torch.where(use_mosaic[:, None, None, None], mo_img, img)
        m, rows = labels.shape[1], mo_cand.shape[1]
        plain_cand = torch.cat([labels, labels.new_zeros(
            (b, rows - m, 5))], dim=1)
        plain_valid = torch.cat([base_valid, base_valid.new_zeros(
            (b, rows - m))], dim=1)
        cand = torch.where(use_mosaic[:, None, None], mo_cand, plain_cand)
        valid = torch.where(use_mosaic[:, None], mo_valid, plain_valid)

    if mixup is not None:
        # only after mosaic; a 0.5/0.5 blend in the pixel dtype, the
        # partner's labels concatenated
        use_mix = use_mosaic & (gates[:, 1] < cfg.mixup_prob)
        mix_t, mix_cand, mix_v = mixup
        out = torch.where(use_mix[:, None, None, None],
                          0.5 * out + 0.5 * mix_t, out)
        cand = torch.cat([cand, mix_cand], dim=1)
        valid = torch.cat([valid, mix_v & use_mix[:, None]], dim=1)

    if cfg.hsv_prob > 0:
        out = hsv_jitter(draws.hsv_gains, out,
                         enable=gates[:, 2] < cfg.hsv_prob)

    if cfg.flip_prob > 0:
        do_flip = gates[:, 3] < cfg.flip_prob
        out = torch.where(do_flip[:, None, None, None], out.flip(-1), out)
        flipped_cx = torch.where(valid, w - cand[..., 1], cand[..., 1])
        flipped = torch.cat([cand[..., :1], flipped_cx[..., None],
                             cand[..., 2:]], dim=-1)
        cand = torch.where(do_flip[:, None, None], flipped, cand)

    return out, _compact_labels(cand, valid, cfg.max_labels)


def _chw_to_s2d(x: torch.Tensor) -> torch.Tensor:
    """[B,3,H,W] -> the Focus stem's space_to_depth layout [B,H/2,W/2,12],
    channel q = px*2c + py*c + ch (column parity before row parity)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)     # (b, ch, i, py, j, px)
    x = x.permute(0, 2, 4, 5, 3, 1)               # (b, i, j, px, py, ch)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def device_augment(draws: AugmentDraws, images: torch.Tensor,
                   labels: torch.Tensor, cfg: AugmentConfig, enable=True,
                   out_s2d: bool = False):
    """Augment a batch: images [B,H,W,3] (uint8 or float 0..255), labels
    [B,M,5] (cls, cx, cy, w, h in pixels), `draws` from `sample_draws`.
    Returns (NHWC fp32 images, [B,max_labels,5] labels), or with `out_s2d`
    the stem's [B,H/2,W/2,12] layout in the pixel dtype, for a model under
    `layers.blocks.stem_input_s2d()`. `enable` (bool or 0/1 tensor) gates
    mosaic and mixup (the no-aug epochs keep HSV and flip). Runs on the
    images' device; two `mosaic_warp` calls (mosaic, mixup partner)."""
    check_config(cfg)
    b, h, w = images.shape[:3]
    dev = images.device
    draws = draws.to(dev)
    images = images.to(_pixel_dtype(cfg))
    labels = labels.to(dev)
    enable = torch.as_tensor(enable, device=dev).to(torch.bool)
    perm = draws.perm
    idx4 = torch.stack([torch.roll(perm, -i) for i in (1, 2, 3)], dim=1)
    pool = to_chw(images)

    mosaic = mixup = None
    if cfg.mosaic_prob > 0:
        labels4 = torch.cat([labels[:, None], labels[idx4]], dim=1)
        oxw, oyw, xs_raw, ys_raw, mo_cand, mo_valid = _mosaic_geometry(
            draws, labels4, h, w)
        tidx = torch.cat([torch.arange(b, device=dev)[:, None], idx4], dim=1)
        mosaic = (mosaic_sample_idx(pool, tidx, oxw, oyw, xs_raw, ys_raw),
                  mo_cand, mo_valid)
        if cfg.mixup_prob > 0:
            mxs, mys, mix_cand, mix_v = _mixup_geometry(
                draws, labels[draws.mix_idx], h, w)
            mixup = (warp_sample_idx(pool, draws.mix_idx, mxs, mys, fill=0.0),
                     mix_cand, mix_v)

    out, out_labels = _augment_batch(draws, pool, labels, cfg, enable,
                                     mosaic, mixup)
    if out_s2d:
        return _chw_to_s2d(out), out_labels
    nhwc = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    nhwc.copy_(from_chw(out))
    return nhwc, out_labels


def make_augment_fn(cfg: AugmentConfig, out_s2d: bool = False):
    """The train step's `augment_fn(generator, images, labels, enable=True)`
    (JAX `DataModule.make_augment_fn`): draws from `generator` (torch's
    default one on the images' device when None), then `device_augment`."""
    check_config(cfg)

    def augment(generator, images, labels, enable=True):
        draws = sample_draws(generator, images.shape[0],
                             tuple(images.shape[1:3]), cfg,
                             device=images.device)
        return device_augment(draws, images, labels, cfg, enable=enable,
                              out_s2d=out_s2d)

    return augment
