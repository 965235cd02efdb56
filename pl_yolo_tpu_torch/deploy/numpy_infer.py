"""Runtime-independent YOLOX inference: pure numpy, zero jax/XLA imports.

One of the two deployment-interchange artifacts (reference
tools/export_onnx.py:20 + tools/onnx_inference.py:22-71 ship an ONNX graph
plus an onnxruntime demo; here tools/export_onnx.py emits real ONNX via
deploy/onnx_writer.py, and weights-as-npz + THIS file is the
runtime-independent fallback): any Python with numpy can load the exported
.npz and reproduce the device eval outputs —
decoded [B, A, 5+C] predictions and NMS'ed detections — bit-for-bit up to
fp32 rounding. Parity vs the jax forward is asserted by
tests/test_numpy_deploy.py.

Scope: the YOLOX family graph (CSPDarkNet + CSPPAFPN + DecoupledHead,
optionally depthwise) — the flagship deploy target. BatchNorm is folded
into conv weights at load time (same math as utils/fuse.py::fuse_conv_bn).
The Focus stem runs as space_to_depth + 3x3 (identical math to the fused
6x6 inference path, layers/blocks.py:229-263).

This module intentionally has NO imports from the rest of the package: it
must stand alone when copied next to a model.npz on a machine without jax.
"""

from __future__ import annotations

import json

import numpy as np

BN_EPS = 1e-3


# --------------------------------------------------------------- primitives

def sigmoid(x):
    # tanh form: overflow-free for large |x| (exp(-x) would warn)
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def silu(x):
    return x * sigmoid(x)


def _pad_hw(x, pad):
    if pad == 0:
        return x
    return np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))


def _patches(x, kh, kw, stride):
    """Extract conv patches from NHWC input (already padded) as a strided
    view [B, Ho, Wo, kh, kw, C] — no copy until the caller reshapes."""
    b, h, w, c = x.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    sb, sh, sw, sc = x.strides
    view = np.lib.stride_tricks.as_strided(
        x, (b, ho, wo, kh, kw, c),
        (sb, sh * stride, sw * stride, sh, sw, sc), writeable=False)
    return view, ho, wo


def conv2d(x, kernel, bias=None, stride=1, pad=None, groups=1):
    """NHWC conv, kernel HWIO [kh, kw, cin/groups, cout] (flax layout),
    im2col + matmul. Matches nn.Conv with symmetric padding."""
    kh, kw, cin_g, cout = kernel.shape
    if pad is None:
        pad = (kh - 1) // 2
    x = _pad_hw(np.ascontiguousarray(x, np.float32), pad)
    view, ho, wo = _patches(x, kh, kw, stride)
    b = x.shape[0]
    if groups == 1:
        cols = view.reshape(b * ho * wo, kh * kw * cin_g)
        y = cols @ kernel.reshape(kh * kw * cin_g, cout)
        y = y.reshape(b, ho, wo, cout)
    else:
        cin = groups * cin_g
        assert x.shape[-1] == cin and cout % groups == 0
        og = cout // groups
        y = np.empty((b, ho, wo, cout), np.float32)
        vg = view.reshape(b, ho, wo, kh, kw, groups, cin_g)
        for g in range(groups):
            cols = np.ascontiguousarray(vg[..., g, :]).reshape(
                b * ho * wo, kh * kw * cin_g)
            kg = kernel[..., g * og:(g + 1) * og]
            y[..., g * og:(g + 1) * og] = (
                cols @ kg.reshape(kh * kw * cin_g, og)
            ).reshape(b, ho, wo, og)
    if bias is not None:
        y = y + bias
    return y


def max_pool_same(x, ksize):
    pad = ksize // 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                constant_values=-np.inf)
    view, ho, wo = _patches(xp, ksize, ksize, 1)
    return view.max(axis=(3, 4))


def upsample_nearest_2x(x):
    return x.repeat(2, axis=1).repeat(2, axis=2)


def space_to_depth(x):
    """2x2 s2d, column-parity-major channel order (layers/blocks.py:203)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.transpose(0, 1, 3, 4, 2, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


# ----------------------------------------------------------- fused weights

def fuse_conv_bn(kernel, scale, bias, mean, var, eps=BN_EPS):
    """Fold eval-mode BN into (kernel, bias) — utils/fuse.py in numpy."""
    factor = scale / np.sqrt(var + eps)
    return kernel * factor[None, None, None, :], bias - mean * factor


class _Tree(dict):
    """Nested param dict with attribute-ish access helpers."""


def load_npz(path):
    """Load an export_npz artifact: returns (params, batch_stats, meta)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    params, stats = _Tree(), _Tree()
    for key in data.files:
        if key == "__meta__":
            continue
        coll, _, rest = key.partition("/")
        tree = params if coll == "params" else stats
        node = tree
        parts = rest.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, _Tree())
        node[parts[-1]] = np.asarray(data[key], np.float32)
    return params, stats, meta


def _conv_block(p, s, act="silu"):
    """ConvBlock subtree -> fn(x, stride) with BN folded. Handles the
    norm=None case (SPP conv2) and optional conv bias."""
    kernel = p["conv"]["kernel"]
    bias = p["conv"].get("bias")
    if "bn" in p:
        assert bias is None, "conv bias + BN is never emitted by ConvBlock"
        kernel, bias = fuse_conv_bn(
            kernel, p["bn"]["scale"], p["bn"]["bias"],
            s["bn"]["mean"], s["bn"]["var"])
    a = silu if act == "silu" else (lambda v: v)
    if act not in ("silu", None, "none", "identity"):
        raise ValueError(f"numpy runtime supports silu only, got {act}")

    def fn(x, stride=1, groups=1):
        return a(conv2d(x, kernel, bias, stride=stride, groups=groups))
    return fn


def _sub(p, s, name):
    return p[name], s.get(name, {})


# ------------------------------------------------------------- model graph

def _bottleneck(p, s, x, shortcut=True, depthwise=False):
    y = _conv_block(*_sub(p, s, "conv1"))(x)
    y = _dw_or_conv(p, s, "conv2", y, stride=1, depthwise=depthwise)
    if shortcut and x.shape[-1] == y.shape[-1]:
        y = y + x
    return y


def _dw_or_conv(p, s, name, x, stride, depthwise):
    if depthwise:
        pd, sd = _sub(p, s, name)
        y = _conv_block(*_sub(pd, sd, "dconv"))(x, stride=stride,
                                                groups=x.shape[-1])
        return _conv_block(*_sub(pd, sd, "pconv"))(y)
    return _conv_block(*_sub(p, s, name))(x, stride=stride)


def _csp_layer(p, s, x, num_bottle, shortcut=True, depthwise=False):
    x1 = _conv_block(*_sub(p, s, "conv1"))(x)
    x2 = _conv_block(*_sub(p, s, "conv2"))(x)
    for i in range(num_bottle):
        x1 = _bottleneck(*_sub(p, s, f"m{i}"), x1, shortcut=shortcut,
                         depthwise=depthwise)
    return _conv_block(*_sub(p, s, "conv3"))(
        np.concatenate([x1, x2], axis=-1))


def _spp(p, s, x, kernel_sizes=(5, 9, 13)):
    x = _conv_block(*_sub(p, s, "conv1"))(x)
    pools = [max_pool_same(x, k) for k in kernel_sizes]
    return _conv_block(*_sub(p, s, "conv2"))(
        np.concatenate([x] + pools, axis=-1))


def backbone_forward(p, s, x, depths, outputs, depthwise=False):
    """CSPDarkNet (models/backbones/cspdarknet.py) in numpy."""
    feats = {}
    x = _conv_block(*_sub(p["stem"], s["stem"], "conv"))(space_to_depth(x))
    feats["stem"] = x
    for i in range(4):
        x = _dw_or_conv(p, s, f"stage{i + 1}_down", x, stride=2,
                        depthwise=depthwise)
        if i == 3:
            x = _spp(*_sub(p, s, "stage4_spp"), x)
        x = _csp_layer(*_sub(p, s, f"stage{i + 1}_csp"), x,
                       num_bottle=depths[i], shortcut=(i != 3),
                       depthwise=depthwise)
        feats[f"stage{i + 1}"] = x
    return [feats[k] for k in outputs]


def neck_forward(p, s, inputs, depths, depthwise=False):
    """CSPPAFPN (models/necks/csppafpn.py) in numpy."""
    c3, c4, c5 = inputs
    kw = dict(num_bottle=depths[0], shortcut=False, depthwise=depthwise)
    p5_expand = _conv_block(*_sub(p, s, "shrink_conv1"))(c5)
    p4 = np.concatenate([upsample_nearest_2x(p5_expand), c4], axis=-1)
    p4 = _csp_layer(*_sub(p, s, "p5_p4"), p4, **kw)
    p4_expand = _conv_block(*_sub(p, s, "shrink_conv2"))(p4)
    p3 = np.concatenate([upsample_nearest_2x(p4_expand), c3], axis=-1)
    p3 = _csp_layer(*_sub(p, s, "p4_p3"), p3, **kw)
    n3 = p3
    n3_down = _dw_or_conv(p, s, "downsample_conv1", n3, 2, depthwise)
    n4 = np.concatenate([n3_down, p4_expand], axis=-1)
    n4 = _csp_layer(*_sub(p, s, "n3_n4"), n4, **kw)
    n4_down = _dw_or_conv(p, s, "downsample_conv2", n4, 2, depthwise)
    n5 = np.concatenate([n4_down, p5_expand], axis=-1)
    n5 = _csp_layer(*_sub(p, s, "n4_n5"), n5, **kw)
    return n3, n4, n5


def head_forward(p, s, inputs, depthwise=False):
    """DecoupledHead (models/heads/decoupled_head.py) in numpy."""
    outs = []
    for k, x in enumerate(inputs):
        x = _conv_block(*_sub(p, s, f"stem{k}"))(x)
        cf = _dw_or_conv(p, s, f"cls_conv{k}_0", x, 1, depthwise)
        cf = _dw_or_conv(p, s, f"cls_conv{k}_1", cf, 1, depthwise)
        cls_out = conv2d(cf, p[f"cls_pred{k}"]["kernel"],
                         p[f"cls_pred{k}"]["bias"])
        rf = _dw_or_conv(p, s, f"reg_conv{k}_0", x, 1, depthwise)
        rf = _dw_or_conv(p, s, f"reg_conv{k}_1", rf, 1, depthwise)
        reg_out = conv2d(rf, p[f"reg_pred{k}"]["kernel"],
                         p[f"reg_pred{k}"]["bias"])
        obj_out = conv2d(rf, p[f"obj_pred{k}"]["kernel"],
                         p[f"obj_pred{k}"]["bias"])
        outs.append(np.concatenate([reg_out, obj_out, cls_out], axis=-1))
    return outs


def eval_decode(outputs, strides):
    """yolox_eval_decode (models/losses/yolox.py:87-93) in numpy:
    [B, A, 5+C] with xyxy boxes and sigmoid'ed obj/cls."""
    preds = []
    for level, stride in zip(outputs, strides):
        b, h, w, c = level.shape
        flat = level.reshape(b, h * w, c).astype(np.float32)
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        shift = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)[None]
        xy = (flat[..., :2] + shift) * stride
        wh = np.exp(flat[..., 2:4]) * stride
        preds.append(np.concatenate([xy, wh, flat[..., 4:]], axis=-1))
    p = np.concatenate(preds, axis=1)
    boxes = np.concatenate([p[..., :2] - p[..., 2:4] / 2,
                            p[..., :2] + p[..., 2:4] / 2], axis=-1)
    return np.concatenate([boxes, sigmoid(p[..., 4:])], axis=-1)


# ------------------------------------------------- yolov7 family (anchor)

def max_pool2(x):
    """2x2 stride-2 VALID pool (backbones/eelan.py max_pool_stride2)."""
    b, h, w, c = x.shape
    return x[:, :h - h % 2, :w - w % 2, :].reshape(
        b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))


def _elan_block(p, s, x, num_bottle):
    """ELANBlock (models/backbones/eelan.py): 4-branch aggregation."""
    num_conv = num_bottle // 2 if num_bottle > 2 else 1
    x1 = _conv_block(*_sub(p, s, "conv1"))(x)
    x2 = _conv_block(*_sub(p, s, "conv2"))(x)
    x3 = x2
    for i in range(num_conv):
        x3 = _conv_block(*_sub(p, s, f"conv3_{i}"))(x3)
    x4 = x3
    for i in range(num_conv):
        x4 = _conv_block(*_sub(p, s, f"conv4_{i}"))(x4)
    return _conv_block(*_sub(p, s, "conv5"))(
        np.concatenate([x1, x2, x3, x4], axis=-1))


def _transition(p, s, x):
    """Transition / V7Transition: maxpool+1x1 || 1x1+3x3s2, concat [x2, x1]."""
    x1 = _conv_block(*_sub(p, s, "conv1"))(max_pool2(x))
    x2 = _conv_block(*_sub(p, s, "conv2"))(x)
    x2 = _conv_block(*_sub(p, s, "conv3"))(x2, stride=2)
    return np.concatenate([x2, x1], axis=-1)


def _sppcspc(p, s, x, kernel_sizes=(5, 9, 13)):
    """SPPCSPC (layers/blocks.py:425-446)."""
    x1 = _conv_block(*_sub(p, s, "cv1"))(x)
    x1 = _conv_block(*_sub(p, s, "cv3"))(x1)
    x1 = _conv_block(*_sub(p, s, "cv4"))(x1)
    pools = [max_pool_same(x1, k) for k in kernel_sizes]
    y1 = _conv_block(*_sub(p, s, "cv5"))(
        np.concatenate([x1] + pools, axis=-1))
    y1 = _conv_block(*_sub(p, s, "cv6"))(y1)
    y2 = _conv_block(*_sub(p, s, "cv2"))(x)
    return _conv_block(*_sub(p, s, "cv7"))(
        np.concatenate([y1, y2], axis=-1))


def _v7_csp_layer(p, s, x, num_bottle):
    """V7CSPLayer (models/necks/yolov7_neck.py)."""
    x1 = _conv_block(*_sub(p, s, "conv1"))(x)
    x2 = _conv_block(*_sub(p, s, "conv2"))(x)
    x3 = _conv_block(*_sub(p, s, "conv3"))(x2)
    parts = [x1, x2, x3]
    for i in range(num_bottle):
        x3 = _conv_block(*_sub(p, s, f"conv4_{i}"))(x3)
        parts.append(x3)
    return _conv_block(*_sub(p, s, "conv5"))(
        np.concatenate(parts, axis=-1))


def repconv_kernel_bias(pn, sn):
    """Collapse a RepConv subtree into one biased 3x3 HWIO kernel
    (utils/fuse.py::fuse_repconv in numpy)."""
    k3, b3 = fuse_conv_bn(
        pn["rbr_dense_conv"]["kernel"],
        pn["rbr_dense_bn"]["scale"], pn["rbr_dense_bn"]["bias"],
        sn["rbr_dense_bn"]["mean"], sn["rbr_dense_bn"]["var"])
    k1, b1 = fuse_conv_bn(
        pn["rbr_1x1_conv"]["kernel"],
        pn["rbr_1x1_bn"]["scale"], pn["rbr_1x1_bn"]["bias"],
        sn["rbr_1x1_bn"]["mean"], sn["rbr_1x1_bn"]["var"])
    kernel = k3 + np.pad(k1, ((1, 1), (1, 1), (0, 0), (0, 0)))
    bias = b3 + b1
    if "rbr_identity" in pn:
        cin = kernel.shape[2]
        ident = np.zeros_like(k3)
        ident[1, 1, np.arange(cin), np.arange(cin)] = 1.0
        ki, bi = fuse_conv_bn(
            ident, pn["rbr_identity"]["scale"], pn["rbr_identity"]["bias"],
            sn["rbr_identity"]["mean"], sn["rbr_identity"]["var"])
        kernel = kernel + ki
        bias = bias + bi
    return kernel, bias


def _out_conv(p, s, name, x):
    """Neck output conv: plain ConvBlock, or a RepConv collapsed to one
    biased 3x3 + silu."""
    pn, sn = _sub(p, s, name)
    if "rbr_dense_conv" not in pn:
        return _conv_block(pn, sn)(x)
    kernel, bias = repconv_kernel_bias(pn, sn)
    return silu(conv2d(x, kernel, bias))


def v7_backbone_forward(p, s, x, depths, outputs):
    """EELAN (models/backbones/eelan.py) in numpy."""
    feats = {}
    x = _conv_block(*_sub(p, s, "stem0"))(x)
    x = _conv_block(*_sub(p, s, "stem1"))(x, stride=2)
    x = _conv_block(*_sub(p, s, "stem2"))(x)
    feats["stem"] = x
    x = _conv_block(*_sub(p, s, "stage1_down"))(x, stride=2)
    x = _elan_block(*_sub(p, s, "stage1_elan"), x, depths[0])
    feats["stage1"] = x
    for i in (2, 3, 4):
        x = _transition(*_sub(p, s, f"stage{i}_trans"), x)
        if i == 4:
            x = _spp(*_sub(p, s, "stage4_spp"), x)
        x = _elan_block(*_sub(p, s, f"stage{i}_elan"), x, depths[i - 1])
        feats[f"stage{i}"] = x
    return [feats[k] for k in outputs]


def v7_neck_forward(p, s, inputs, depths):
    """YOLOv7NECK (models/necks/yolov7_neck.py) in numpy."""
    c3, c4, c5 = inputs
    d = depths[0]
    p5 = _sppcspc(*_sub(p, s, "spp"), c5)
    p5_shrink = _conv_block(*_sub(p, s, "conv_for_P5"))(p5)
    c4p = _conv_block(*_sub(p, s, "conv_for_C4"))(c4)
    p4 = np.concatenate([upsample_nearest_2x(p5_shrink), c4p], axis=-1)
    p4 = _v7_csp_layer(*_sub(p, s, "p5_p4"), p4, d)
    p4_shrink = _conv_block(*_sub(p, s, "conv_for_P4"))(p4)
    c3p = _conv_block(*_sub(p, s, "conv_for_C3"))(c3)
    p3 = np.concatenate([upsample_nearest_2x(p4_shrink), c3p], axis=-1)
    p3 = _v7_csp_layer(*_sub(p, s, "p4_p3"), p3, d)
    n3 = p3
    n3_down = _transition(*_sub(p, s, "downsample_conv1"), n3)
    n4 = _v7_csp_layer(*_sub(p, s, "n3_n4"),
                       np.concatenate([n3_down, p4], axis=-1), d)
    n4_down = _transition(*_sub(p, s, "downsample_conv2"), n4)
    n5 = _v7_csp_layer(*_sub(p, s, "n4_n5"),
                       np.concatenate([n4_down, p5], axis=-1), d)
    return (_out_conv(p, s, "n3_out", n3),
            _out_conv(p, s, "n4_out", n4),
            _out_conv(p, s, "n5_out", n5))


def v7_head_forward(p, s, inputs):
    """ImplicitHead (models/heads/implicit_head.py) in numpy."""
    outs = []
    for k, x in enumerate(inputs):
        x = x + p[f"ia{k}"]
        x = conv2d(x, p[f"conv{k}"]["kernel"], p[f"conv{k}"]["bias"])
        outs.append(x * p[f"im{k}"])
    return outs


def v7_eval_decode(outputs, strides, anchors):
    """yolov7_eval_decode (models/losses/yolov7.py) in numpy: per-level
    [B,H,W,na*(5+C)] -> [B, A, 5+C] xyxy + sigmoid probs, rows level-major
    then anchor-major then row-major."""
    na = len(anchors[0])
    preds = []
    for level, stride, anc in zip(outputs, strides, anchors):
        b, h, w, c = level.shape
        ch = c // na
        flat = sigmoid(level.reshape(b, h, w, na, ch).transpose(0, 3, 1, 2, 4)
                       .reshape(b, na * h * w, ch).astype(np.float32))
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        cell = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        grid = np.tile(cell, (na, 1))[None]
        anc_px = np.repeat(np.asarray(anc, np.float32), h * w, axis=0)[None]
        xy = (flat[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = (flat[..., 2:4] * 2.0) ** 2 * anc_px
        preds.append(np.concatenate([xy, wh, flat[..., 4:]], axis=-1))
    p = np.concatenate(preds, axis=1)
    boxes = np.concatenate([p[..., :2] - p[..., 2:4] / 2,
                            p[..., :2] + p[..., 2:4] / 2], axis=-1)
    return np.concatenate([boxes, p[..., 4:]], axis=-1)


def forward(params, stats, images, meta):
    """Full eval forward: images NHWC float32 (0-255 pixel scale, matching
    the jax eval path) -> decoded [B, A, 5+C]. Dispatches on meta family
    ('yolox' anchor-free | 'yolov7'/'yolov5' anchor-based)."""
    x = np.asarray(images, np.float32)
    family = meta.get("family", "yolox")
    if family == "yolov5":
        feats = backbone_forward(
            params["backbone"], stats.get("backbone", {}), x,
            depths=meta["backbone_depths"],
            outputs=meta["backbone_outputs"],
            depthwise=meta.get("backbone_depthwise", False))
        feats = neck_forward(params["neck"], stats.get("neck", {}), feats,
                             depths=meta["neck_depths"],
                             depthwise=meta.get("neck_depthwise", False))
        ph = params["head"]
        outs = [conv2d(f, ph[f"conv{k}"]["kernel"], ph[f"conv{k}"]["bias"])
                for k, f in enumerate(feats)]
        return v7_eval_decode(outs, meta["strides"], meta["anchors"])
    if family == "yolov7":
        feats = v7_backbone_forward(
            params["backbone"], stats.get("backbone", {}), x,
            depths=meta["backbone_depths"],
            outputs=meta["backbone_outputs"])
        feats = v7_neck_forward(params["neck"], stats.get("neck", {}),
                                feats, depths=meta["neck_depths"])
        outs = v7_head_forward(params["head"], stats.get("head", {}), feats)
        return v7_eval_decode(outs, meta["strides"], meta["anchors"])
    feats = backbone_forward(params["backbone"], stats.get("backbone", {}),
                             x,
                             depths=meta["backbone_depths"],
                             outputs=meta["backbone_outputs"],
                             depthwise=meta.get("backbone_depthwise", False))
    feats = neck_forward(params["neck"], stats.get("neck", {}), feats,
                         depths=meta["neck_depths"],
                         depthwise=meta.get("neck_depthwise", False))
    outs = head_forward(params["head"], stats.get("head", {}), feats,
                        depthwise=meta.get("head_depthwise", False))
    return eval_decode(outs, meta["strides"])


# -------------------------------------------------------------------- NMS

def nms_numpy(boxes, scores, iou_threshold):
    """Greedy NMS, xyxy. Returns kept indices (score-descending)."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = ((boxes[rest, 2] - boxes[rest, 0])
                  * (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def postprocess(preds, conf_threshold=0.01, iou_threshold=0.65, max_det=300):
    """Reference postprocess semantics (ops/nms.py:164-196) in numpy:
    per image, confidence = obj * max cls prob, per-class greedy NMS.
    Returns a list of [N, 6] arrays (x1 y1 x2 y2 score class)."""
    results = []
    for img in preds:
        cls_probs = img[:, 5:]
        cls_id = cls_probs.argmax(axis=-1)
        conf = img[:, 4] * cls_probs.max(axis=-1)
        m = conf >= conf_threshold
        boxes, conf, cls_id = img[m, :4], conf[m], cls_id[m]
        # class-offset trick: per-class NMS in one call
        offs = cls_id.astype(np.float32) * 4096.0
        keep = nms_numpy(boxes + offs[:, None], conf, iou_threshold)
        keep = keep[:max_det]
        results.append(np.concatenate(
            [boxes[keep], conf[keep, None],
             cls_id[keep, None].astype(np.float32)], axis=-1))
    return results
