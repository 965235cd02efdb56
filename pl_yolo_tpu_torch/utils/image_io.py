"""Image IO shims: imread / imwrite / imfrombytes.

Capability parity with the reference's mmcv utility shims
(utils/mmcv_utils.py:139-267, cv2/PIL/turbojpeg backend dispatch) — here a
single PIL backend (cv2 is not in the TPU image) with the same flag
semantics: 'color' -> 3-channel, 'grayscale' -> 1-channel, 'unchanged' ->
as stored. Arrays are RGB uint8 (note: the reference's cv2 path is BGR)."""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
from PIL import Image


def _convert(img: "Image.Image", flag: str) -> np.ndarray:
    if flag == "color":
        return np.asarray(img.convert("RGB"))
    if flag == "grayscale":
        return np.asarray(img.convert("L"))
    if flag == "unchanged":
        return np.asarray(img)
    raise ValueError(f"unknown flag {flag!r} (color|grayscale|unchanged)")


def imread(path: str | Path, flag: str = "color") -> np.ndarray:
    with Image.open(path) as img:
        return _convert(img, flag)


def imfrombytes(content: bytes, flag: str = "color") -> np.ndarray:
    with Image.open(io.BytesIO(content)) as img:
        return _convert(img, flag)


def imwrite(img: np.ndarray, path: str | Path, quality: int = 95) -> bool:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.asarray(img, np.uint8)).save(path, quality=quality)
    return True
