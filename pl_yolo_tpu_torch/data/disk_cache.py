"""Pre-letterboxed uint8 disk cache: decode every image ONCE, then serve
training from a memmap.

The reference keeps decoded images in RAM behind a ThreadPool preload
(models/data/datasets/cocoDataset.py:137-158), which caps the dataset at
host-RAM size — COCO-train (118k x 640x640x3 = ~140 GB) does not fit. Here
the decoded letterboxed images live in ONE flat binary file next to a
meta.json, mapped read-only at train time, so:

  * decode cost (PIL JPEG + resize) is paid once per dataset, not per epoch;
  * the OS page cache does the RAM caching adaptively — hot shards stay
    resident, cold ones are a sequential read away;
  * batch assembly is a memcpy per image, which a 1-core host can sustain at
    the device step rate (the JPEG path cannot).

The cache is validated by a fingerprint of the dataset (size, image size,
file list digest), so a stale cache for a different split/size is rebuilt,
never silently served.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

_META = "meta.json"
_DATA = "images.u8"
_VERSION = 1


def dataset_fingerprint(dataset) -> str:
    """Identity of (file list, letterbox size): any change invalidates."""
    h = hashlib.sha1()
    h.update(f"v{_VERSION}:{len(dataset)}:{dataset.img_size}".encode())
    for i in range(len(dataset)):
        h.update(str(dataset._img_path(i)).encode())
    return h.hexdigest()


class DiskImageCache:
    """Read-only view over a built cache directory."""

    def __init__(self, cache_dir: str | Path):
        self.dir = Path(cache_dir)
        with open(self.dir / _META) as f:
            self.meta = json.load(f)
        n = self.meta["n"]
        h, w = self.meta["img_size"]
        self._mm = np.memmap(self.dir / _DATA, dtype=np.uint8, mode="r",
                             shape=(n, h, w, 3))

    def __len__(self) -> int:
        return self.meta["n"]

    def __getitem__(self, index: int) -> np.ndarray:
        return np.asarray(self._mm[index])  # copy out of the map

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        """Batch fetch: one C-level fancy-index copy for the whole batch."""
        return self._mm[idxs]

    def matches(self, dataset) -> bool:
        return (self.meta["n"] == len(dataset)
                and tuple(self.meta["img_size"]) == tuple(dataset.img_size)
                and self.meta["fingerprint"] == dataset_fingerprint(dataset))


def build_disk_cache(dataset, cache_dir: str | Path, workers: int = 4,
                     force: bool = False, verbose: bool = True) -> DiskImageCache:
    """Decode every dataset image into `cache_dir` (reused when the
    fingerprint matches; pass force=True to rebuild)."""
    cache_dir = Path(cache_dir)
    if not force and (cache_dir / _META).exists():
        try:
            cache = DiskImageCache(cache_dir)
            if cache.matches(dataset):
                return cache
            if verbose:
                print(f"[disk_cache] stale cache at {cache_dir}; rebuilding")
        except Exception:
            pass

    cache_dir.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    h, w = dataset.img_size
    tmp = cache_dir / (_DATA + ".tmp")
    mm = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=(n, h, w, 3))

    # decode_image bypasses every cache layer — this IS the cache build
    def fill(i):
        mm[i] = dataset.decode_image(i)

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for done, _ in enumerate(ex.map(fill, range(n))):
                if verbose and done % 1000 == 999:
                    print(f"[disk_cache] {done + 1}/{n}")
    else:
        for i in range(n):
            fill(i)
    mm.flush()
    del mm
    with open(cache_dir / _META, "w") as f:
        json.dump({"n": n, "img_size": [h, w],
                   "fingerprint": dataset_fingerprint(dataset)}, f)
    os.replace(tmp, cache_dir / _DATA)
    if verbose:
        gb = n * h * w * 3 / 2**30
        print(f"[disk_cache] built {n} images ({gb:.2f} GiB) at {cache_dir}")
    return DiskImageCache(cache_dir)
