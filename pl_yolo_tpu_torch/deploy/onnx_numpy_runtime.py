"""Pure-numpy executor for the exported ONNX graphs (no onnx package).

The in-environment verifier AND portable fallback runtime for artifacts
produced by deploy/onnx_export.py: parses the ModelProto wire format back
(onnx_writer.parse_message) and executes the op subset those graphs use —
Conv / MaxPool / Resize / Concat / Slice / Reshape / Transpose / Sigmoid /
Exp / Add / Sub / Mul / Identity — with standard ONNX semantics (NCHW,
OIHW weights, pads [t,l,b,r]). tests/test_onnx_export.py asserts this
executor reproduces the jax eval forward through the .onnx FILE, which
pins both the serializer and the graph builder; an external onnxruntime
sees exactly the same bytes. Mirrors what the reference's onnxruntime
demo consumes (reference tools/onnx_inference.py:22-71).

Round 5: the op set grew to cover graphs produced by an INDEPENDENT
exporter — torch's ONNX symbolic trace of the deploy/torch_infer.py
rebuild (tests/test_onnx_cross.py) — which emits dynamic-shape machinery
(Constant / Shape / Gather / Unsqueeze / Squeeze / Cast / Ceil /
ConstantOfShape / NonZero / Expand / Div / Range / Where / Equal) plus
opset-13 forms (Slice with steps, Unsqueeze axes-as-input, 2-input
Resize with half_pixel nearest). Executing torch's graph and matching
torch's own output cross-validates this executor's op semantics against
a second implementation of the spec.
"""

from __future__ import annotations

import numpy as np

from . import onnx_writer as ow
from .numpy_infer import conv2d, max_pool_same, sigmoid


def _attr_value(msg: dict):
    # NB: a conformant proto3 serializer (e.g. the official protobuf
    # runtime) OMITS default-valued scalar fields entirely — an INT
    # attribute of 0 arrives with no field 3 — so every branch must
    # fall back to the proto3 default rather than index blindly.
    atype = msg.get(20, [0])[0]
    if atype == 1:
        return np.frombuffer(msg[2][0], "<f4")[0].item() if 2 in msg else 0.0
    if atype == 2:
        v = msg.get(3, [0])[0]
        return v - (1 << 64) if v >= (1 << 63) else v
    if atype == 3:
        return msg.get(4, [b""])[0].decode()
    if atype == 4:
        return ow.parse_tensor(msg[5][0])[1]
    if atype == 6:
        floats = []
        for blob in msg.get(7, []):
            floats.extend(np.frombuffer(blob, "<f4").tolist())
        return floats
    if atype == 7:
        vals = []
        for blob in msg.get(8, []):
            vals.extend(ow.parse_packed_varints(blob))
        return [v - (1 << 64) if v >= (1 << 63) else v for v in vals]
    raise ValueError(f"unsupported attribute type {atype}")


class OnnxModel:
    """Parsed model: .nodes [(op, inputs, outputs, attrs)], .initializers,
    .input_names / .output_names, run(feeds) -> dict of outputs."""

    def __init__(self, model_bytes: bytes):
        mp = ow.parse_message(model_bytes)
        gp = ow.parse_message(mp[7][0])
        self.name = gp.get(2, [b""])[0].decode()
        self.initializers = {}
        for t in gp.get(5, []):
            name, arr = ow.parse_tensor(t)
            self.initializers[name] = arr
        self.nodes = []
        for nb in gp.get(1, []):
            nm = ow.parse_message(nb)
            op = nm[4][0].decode()
            inputs = [v.decode() for v in nm.get(1, [])]
            outputs = [v.decode() for v in nm.get(2, [])]
            attrs = {}
            for ab in nm.get(5, []):
                am = ow.parse_message(ab)
                attrs[am[1][0].decode()] = _attr_value(am)
            self.nodes.append((op, inputs, outputs, attrs))
        self.input_names = [self._vi_name(v) for v in gp.get(11, [])]
        self.output_names = [self._vi_name(v) for v in gp.get(12, [])]

    @staticmethod
    def _vi_name(vi_bytes: bytes) -> str:
        return ow.parse_message(vi_bytes)[1][0].decode()

    # ------------------------------------------------------------ execution

    def run(self, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        vals: dict[str, np.ndarray] = dict(self.initializers)
        for k, v in feeds.items():
            v = np.asarray(v)
            vals[k] = v.astype(np.float32) if v.dtype.kind == "f" else v
        for op, inputs, outputs, attrs in self.nodes:
            args = [vals[i] for i in inputs]
            out = _OPS[op](args, attrs)
            if isinstance(out, tuple):
                for name, o in zip(outputs, out):
                    vals[name] = o
            else:
                vals[outputs[0]] = out
        return {n: vals[n] for n in self.output_names}


def _op_conv(args, attrs):
    x, w = args[0], args[1]
    bias = args[2] if len(args) > 2 else None
    pads = attrs.get("pads", [0, 0, 0, 0])
    assert pads[0] == pads[1] == pads[2] == pads[3], "symmetric pads only"
    strides = attrs.get("strides", [1, 1])
    groups = int(attrs.get("group", 1))
    # NCHW/OIHW -> NHWC/HWIO, reuse the numpy_infer conv
    y = conv2d(np.ascontiguousarray(x.transpose(0, 2, 3, 1)),
               np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
               bias=bias, stride=int(strides[0]), pad=int(pads[0]),
               groups=groups)
    return np.ascontiguousarray(y.transpose(0, 3, 1, 2))


def _op_maxpool(args, attrs):
    k = int(attrs["kernel_shape"][0])
    stride = int(attrs.get("strides", [1, 1])[0])
    pad = int(attrs.get("pads", [0] * 4)[0])
    assert all(int(d) == 1 for d in attrs.get("dilations", [1, 1]))
    assert int(attrs.get("ceil_mode", 0)) == 0
    x = args[0].transpose(0, 2, 3, 1)
    if stride == 1 and pad == k // 2:          # SAME s1 (SPP pyramids)
        y = max_pool_same(x, k)
    elif stride == 2 and pad == 0 and k == 2:  # VALID 2x2 s2 (v7 Transition)
        from .numpy_infer import max_pool2
        y = max_pool2(x)
    else:
        raise AssertionError(
            f"unsupported MaxPool k={k} s={stride} pad={pad}")
    return np.ascontiguousarray(y.transpose(0, 3, 1, 2))


def _op_resize(args, attrs):
    # two accepted forms: opset-13 (X, roi, scales[, sizes]) as our builder
    # emits, and torch's legacy 2-input (X, scales). For nearest + integer
    # scale the ctm variants in play (asymmetric+floor, half_pixel+
    # round_prefer_floor = the spec defaults) all reduce to index//scale.
    x, scales = args[0], args[-1]
    assert attrs.get("mode") == "nearest" and list(scales) == [1, 1, 2, 2]
    assert attrs.get("coordinate_transformation_mode",
                     "half_pixel") in ("asymmetric", "half_pixel")
    assert attrs.get("nearest_mode", "round_prefer_floor") in (
        "floor", "round_prefer_floor")
    return x.repeat(2, axis=2).repeat(2, axis=3)


def _op_slice(args, attrs):
    x, starts, ends, axes = args[0], args[1], args[2], args[3]
    steps = args[4] if len(args) > 4 else [1] * len(np.atleast_1d(starts))
    idx = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(np.atleast_1d(starts), np.atleast_1d(ends),
                              np.atleast_1d(axes), np.atleast_1d(steps)):
        # clamp the INT64_MAX "to the end" sentinel so python slices accept it
        en = min(int(en), x.shape[int(ax)])
        idx[int(ax)] = slice(int(st), en, int(sp))
    return x[tuple(idx)]


# --------------------------------------------- dynamic-shape / misc ops
# (emitted by torch's exporter; standard ONNX semantics, numpy analogues)

_CAST_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
                6: np.int32, 7: np.int64, 9: np.bool_, 11: np.float64}


def _op_gather(args, attrs):
    axis = int(attrs.get("axis", 0))
    return np.take(args[0], np.asarray(args[1], np.int64), axis=axis)


def _op_unsqueeze(args, attrs):
    axes = (np.atleast_1d(args[1]).tolist() if len(args) > 1
            else attrs["axes"])  # opset>=13: input; <13: attribute
    out = args[0]
    for ax in sorted(int(a) for a in axes):
        out = np.expand_dims(out, ax)
    return out


def _op_squeeze(args, attrs):
    axes = (np.atleast_1d(args[1]).tolist() if len(args) > 1
            else attrs.get("axes"))
    if axes is None:
        return np.squeeze(args[0])
    return np.squeeze(args[0], axis=tuple(int(a) for a in axes))


def _op_expand(args, attrs):
    # ONNX Expand is bidirectional broadcast (shape entries may be 1)
    shape = np.broadcast_shapes(args[0].shape,
                                tuple(int(d) for d in args[1]))
    return np.broadcast_to(args[0], shape)


def _op_constant_of_shape(args, attrs):
    val = attrs.get("value")
    fill = (np.asarray(val).reshape(-1)[0] if val is not None
            else np.float32(0))
    shape = [int(d) for d in np.atleast_1d(np.asarray(args[0]))]
    return np.full(shape, fill, dtype=fill.dtype)


def _op_div(args, attrs):
    a, b = args
    if np.issubdtype(np.asarray(a).dtype, np.integer) and \
            np.issubdtype(np.asarray(b).dtype, np.integer):
        # ONNX integer Div truncates toward zero
        return (np.sign(a) * np.sign(b) *
                (np.abs(a) // np.abs(b))).astype(np.asarray(a).dtype)
    return a / b


_OPS = {
    "Conv": _op_conv,
    "MaxPool": _op_maxpool,
    "Resize": _op_resize,
    "Slice": _op_slice,
    "Reshape": lambda a, at: a[0].reshape([int(d) for d in a[1]]),
    "Transpose": lambda a, at: a[0].transpose(at["perm"]),
    "Concat": lambda a, at: np.concatenate(
        [np.atleast_1d(x) for x in a], axis=int(at["axis"])),
    "Sigmoid": lambda a, at: sigmoid(a[0]),
    "Exp": lambda a, at: np.exp(a[0]),
    "Add": lambda a, at: a[0] + a[1],
    "Sub": lambda a, at: a[0] - a[1],
    "Mul": lambda a, at: a[0] * a[1],
    "Div": _op_div,
    "Identity": lambda a, at: a[0],
    "Constant": lambda a, at: at["value"],
    "Shape": lambda a, at: np.asarray(a[0].shape, np.int64),
    "Gather": _op_gather,
    "Unsqueeze": _op_unsqueeze,
    "Squeeze": _op_squeeze,
    "Cast": lambda a, at: np.asarray(a[0]).astype(_CAST_DTYPES[int(at["to"])]),
    "Ceil": lambda a, at: np.ceil(a[0]),
    "Floor": lambda a, at: np.floor(a[0]),
    "Neg": lambda a, at: -a[0],
    "Sqrt": lambda a, at: np.sqrt(a[0]),
    "ConstantOfShape": _op_constant_of_shape,
    "NonZero": lambda a, at: np.asarray(np.nonzero(a[0]), np.int64),
    "Expand": _op_expand,
    "Range": lambda a, at: np.arange(
        np.asarray(a[0]).item(), np.asarray(a[1]).item(),
        np.asarray(a[2]).item(), dtype=np.asarray(a[0]).dtype),
    "Where": lambda a, at: np.where(a[0], a[1], a[2]),
    "Equal": lambda a, at: a[0] == a[1],
    "Relu": lambda a, at: np.maximum(a[0], 0),
    "Softmax": lambda a, at: _softmax(a[0], int(at.get("axis", -1))),
}


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


# ---------------------------------------------------------------------------
# Ops added for the graphs torch's tracer makes of the port's modules
# (pl_yolo_tpu_torch.deploy.export), with standard ONNX semantics; the ops
# above are the JAX package's, unchanged.

def _op_split(args, attrs):
    """Split (opset 13: the sizes are the optional second input; before,
    the `split` attribute). Without sizes the number of outputs is not
    known here, so they are required."""
    x = args[0]
    sizes = (np.atleast_1d(args[1]).tolist() if len(args) > 1
             else attrs.get("split"))
    if sizes is None:
        raise ValueError("Split without sizes is not supported")
    axis = int(attrs.get("axis", 0))
    bounds = np.cumsum([int(n) for n in sizes])[:-1]
    return tuple(np.split(x, bounds, axis=axis))


def _op_one_hot(args, attrs):
    """OneHot(indices, depth, values=[off, on]): a new axis `axis` of size
    depth; negative indices count from the end, others outside [0, depth)
    give an all-off row."""
    indices = np.asarray(args[0]).astype(np.int64)
    depth = int(np.asarray(args[1]).reshape(-1)[0])
    off, on = np.asarray(args[2]).reshape(-1)[:2]
    indices = np.where(indices < 0, indices + depth, indices)
    axis = int(attrs.get("axis", -1))
    if axis < 0:
        axis += indices.ndim + 1
    hot = np.expand_dims(indices, axis) == np.arange(depth).reshape(
        [depth if i == axis else 1 for i in range(indices.ndim + 1)])
    return np.where(hot, on, off)


def _op_flatten(args, attrs):
    """Flatten: [d0..d(axis-1)] x [d(axis)..] as a 2-D array."""
    x = args[0]
    axis = int(attrs.get("axis", 1))
    if axis < 0:
        axis += x.ndim
    return x.reshape(int(np.prod(x.shape[:axis])), -1)


_OPS["Split"] = _op_split
_OPS["OneHot"] = _op_one_hot
_OPS["Flatten"] = _op_flatten
_OPS["Pow"] = lambda a, at: np.power(a[0], a[1]).astype(np.asarray(a[0]).dtype)
_OPS["Tile"] = lambda a, at: np.tile(a[0], [int(r) for r in a[1]])
