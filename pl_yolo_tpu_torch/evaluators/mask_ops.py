"""RLE mask operations — pycocotools.mask-compatible API over the native
C++ core (native/rle.cpp).

Capability parity with the reference's vendored pycocotools mask layer
(models/data/datasets/pycocotools/mask.py:1-103 + _mask.pyx:1-308): encode /
decode / area / merge / iou / toBbox / frPyObjects, with RLE dicts of the
form {"size": [h, w], "counts": <compressed ascii str>}.

The shared library builds on first use with g++ (no pybind11 dependency —
plain C ABI via ctypes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "rle.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "build" / "librle.so"
_lib = None


def _build() -> None:
    # into the package's build directory, under a name of this process's
    # own and then renamed: parallel first uses never load a half-written
    # library
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
         str(_SRC), "-o", str(tmp)],
        check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime):
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p]
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
    lib.rle_area.restype = ctypes.c_uint64
    lib.rle_area.argtypes = [u32p, ctypes.c_int]
    lib.rle_merge.restype = ctypes.c_int
    lib.rle_merge.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int,
                              ctypes.c_int64, ctypes.c_int, u32p]
    lib.rle_iou_single.restype = ctypes.c_double
    lib.rle_iou_single.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int,
                                   ctypes.c_int64, ctypes.c_int]
    lib.rle_to_bbox.restype = None
    lib.rle_to_bbox.argtypes = [u32p, ctypes.c_int, ctypes.c_int, f64p]
    lib.rle_from_bbox.restype = ctypes.c_int
    lib.rle_from_bbox.argtypes = [f64p, ctypes.c_int, ctypes.c_int, u32p]
    lib.rle_from_poly.restype = ctypes.c_int
    lib.rle_from_poly.argtypes = [f64p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, u32p, u8p]
    lib.rle_to_string.restype = ctypes.c_int
    lib.rle_to_string.argtypes = [u32p, ctypes.c_int, ctypes.c_char_p]
    lib.rle_from_string.restype = ctypes.c_int
    lib.rle_from_string.argtypes = [ctypes.c_char_p, ctypes.c_int, u32p]
    _lib = lib
    return lib


def _u32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.uint32)


def _counts_to_str(counts: np.ndarray) -> str:
    lib = _get_lib()
    buf = ctypes.create_string_buffer(len(counts) * 8 + 16)
    n = lib.rle_to_string(
        _u32(counts).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(counts), buf)
    return buf.raw[:n].decode("ascii")


def _str_to_counts(s: str) -> np.ndarray:
    lib = _get_lib()
    raw = s.encode("ascii")
    out = np.zeros(len(raw) + 2, np.uint32)
    m = lib.rle_from_string(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out[:m]


def _rle_counts(rle: dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        if isinstance(c, bytes):
            c = c.decode("ascii")
        return _str_to_counts(c)
    return _u32(c)


def encode(mask: np.ndarray) -> dict:
    """Binary mask [h, w] (or [h, w, n] -> list) to compressed RLE dict."""
    if mask.ndim == 3:
        return [encode(mask[..., i]) for i in range(mask.shape[-1])]
    lib = _get_lib()
    h, w = mask.shape
    fm = np.asfortranarray(mask, dtype=np.uint8)
    flat = np.ascontiguousarray(fm.reshape(-1, order="F"))
    out = np.zeros(h * w + 1, np.uint32)
    m = lib.rle_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return {"size": [h, w], "counts": _counts_to_str(out[:m])}


def decode(rle: dict) -> np.ndarray:
    """Compressed RLE dict -> binary mask [h, w]."""
    if isinstance(rle, (list, tuple)):
        return np.stack([decode(r) for r in rle], axis=-1)
    lib = _get_lib()
    h, w = rle["size"]
    counts = _rle_counts(rle)
    out = np.zeros(h * w, np.uint8)
    rc = lib.rle_decode(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(counts),
        h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError("invalid RLE")
    return out.reshape(w, h).T  # column-major -> [h, w]


def area(rle: dict):
    if isinstance(rle, (list, tuple)):
        return np.asarray([area(r) for r in rle], np.uint64)
    lib = _get_lib()
    counts = _rle_counts(rle)
    return int(lib.rle_area(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(counts)))


def merge(rles: list[dict], intersect: bool = False) -> dict:
    lib = _get_lib()
    h, w = rles[0]["size"]
    acc = _rle_counts(rles[0])
    for r in rles[1:]:
        b = _rle_counts(r)
        out = np.zeros(h * w + 2, np.uint32)
        m = lib.rle_merge(
            acc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(acc),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(b),
            h * w, int(intersect),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        acc = out[:m]
    return {"size": [h, w], "counts": _counts_to_str(acc)}


def iou(dets, gts, iscrowd=None) -> np.ndarray:
    """IoU matrix [n_det, n_gt]. dets/gts: RLE dicts or [x,y,w,h] box arrays.
    iscrowd: per-gt flags (COCO crowd semantics)."""
    lib = _get_lib()
    if iscrowd is None:
        iscrowd = [0] * len(gts)

    def as_rle_list(items):
        if len(items) and isinstance(items[0], dict):
            return items, None
        return None, np.asarray(items, np.float64).reshape(len(items), 4)

    d_rle, d_box = as_rle_list(dets)
    g_rle, g_box = as_rle_list(gts)
    out = np.zeros((len(dets), len(gts)))
    if d_box is not None and g_box is not None:
        # bbox iou (maskApi bbIou semantics, incl. crowd)
        for i, db in enumerate(d_box):
            for j, gb in enumerate(g_box):
                ix = max(0.0, min(db[0] + db[2], gb[0] + gb[2]) - max(db[0], gb[0]))
                iy = max(0.0, min(db[1] + db[3], gb[1] + gb[3]) - max(db[1], gb[1]))
                inter = ix * iy
                den = (db[2] * db[3] if iscrowd[j]
                       else db[2] * db[3] + gb[2] * gb[3] - inter)
                out[i, j] = inter / den if den > 0 else 0.0
        return out
    # mask iou: convert boxes to RLEs if mixed
    h, w = (d_rle or g_rle)[0]["size"]
    if d_rle is None:
        d_rle = [frBbox(b, h, w) for b in d_box]
    if g_rle is None:
        g_rle = [frBbox(b, h, w) for b in g_box]
    for i, dr in enumerate(d_rle):
        dc = _rle_counts(dr)
        for j, gr in enumerate(g_rle):
            gc = _rle_counts(gr)
            out[i, j] = lib.rle_iou_single(
                dc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(dc),
                gc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(gc),
                h * w, int(bool(iscrowd[j])))
    return out


def toBbox(rle: dict) -> np.ndarray:
    if isinstance(rle, (list, tuple)):
        return np.stack([toBbox(r) for r in rle])
    lib = _get_lib()
    h, _ = rle["size"]
    counts = _rle_counts(rle)
    out = np.zeros(4, np.float64)
    lib.rle_to_bbox(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(counts),
        h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def frBbox(box, h: int, w: int) -> dict:
    lib = _get_lib()
    b = np.asarray(box, np.float64)
    out = np.zeros(2 * w + 4, np.uint32)
    m = lib.rle_from_bbox(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return {"size": [h, w], "counts": _counts_to_str(out[:m])}


def frPoly(poly, h: int, w: int) -> dict:
    """Polygon [x0, y0, x1, y1, ...] -> RLE."""
    lib = _get_lib()
    xy = np.asarray(poly, np.float64).reshape(-1)
    npts = len(xy) // 2
    out = np.zeros(h * w + 1, np.uint32)
    scratch = np.zeros(h * w, np.uint8)
    m = lib.rle_from_poly(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), npts, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return {"size": [h, w], "counts": _counts_to_str(out[:m])}


def frPyObjects(objs, h: int, w: int):
    """pycocotools.mask.frPyObjects semantics: polygons (list of lists),
    uncompressed RLE dicts, or boxes."""
    if isinstance(objs, dict):
        return {"size": objs["size"],
                "counts": _counts_to_str(_u32(objs["counts"]))}
    if isinstance(objs, np.ndarray):
        objs = objs.tolist()
    if isinstance(objs, (list, tuple)):
        if len(objs) and isinstance(objs[0], (list, tuple, np.ndarray)):
            first = np.asarray(objs[0]).reshape(-1)
            if len(first) == 4 and len(np.asarray(objs).shape) == 2:
                return [frBbox(o, h, w) for o in objs]
            return [frPoly(o, h, w) for o in objs]
        return frPoly(objs, h, w)
    raise TypeError(f"unsupported object: {type(objs)}")
