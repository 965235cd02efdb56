#!/usr/bin/env python3
"""Hold builds of the NMS suppression kernel to its plain version and time
them against each other, in turns, on one CUDA card.

    python3 chip_nms_ab.py [OTHER.cu ...]

Builds `pl_yolo_tpu_torch/csrc/nms_suppress.cu` and every other source
given (each exporting the same C function `nms_suppress`) with the port's
`nvcc` flags and prints ptxas's report for each. Each build runs every
case of `chip_smoke.nms_cases` (random boxes of 80 and 4 classes, a chain,
identical boxes, all invalid, and boxes with infinite and NaN coordinates)
and is compared with `suppress_plain`, bit for bit: the tree's kernel must
equal it on every case, another build's matches are reported. Then each
build is timed by CUDA events, 50 launches a reading, in turns (the tree's
kernel, the others, then back in reverse order, three times) on [16,1024]
random boxes of 80 classes at IoU 0.65 (taken as sorted), with 90% of them
valid and with all valid, as the serving path's candidates are. The timed
call is the bare C function; the wrapper's host cost is `chip_smoke.py`'s
to measure. Exits non-zero without a result where no CUDA card is
available.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

READINGS = 3


def build_other(build, src: Path, tag: str) -> tuple[ctypes.CDLL, str]:
    """`src` built with the port's flags into the build directory."""
    out = build.BUILD_DIR / f"nms_suppress_{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS,
                           *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def bare_call(torch, lib: ctypes.CDLL):
    """The library's `nms_suppress` as fn(boxes, valid, thr) -> alive."""
    fn = lib.nms_suppress
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(boxes, valid, thr):
        b, k = valid.shape
        alive = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64,
                           device=boxes.device)
        err = fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                 alive.data_ptr(), b, k, float(thr),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"nms_suppress launch failed: cudaError {err}")
        return alive
    return call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_nms_ab: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT))
    from pl_yolo_tpu_torch.ops.cuda import build
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import suppress_plain

    dev = torch.device("cuda", 0)
    build.build(["nms_suppress"])
    calls = {"tree": bare_call(torch, build.load("nms_suppress"))}
    print(f"[ptxas] tree: {cs.ptxas_summary(build.LOGS['nms_suppress'])}")
    for i, src in enumerate(sys.argv[1:]):
        tag = f"{i}:{Path(src).name}"
        lib, log = build_other(build, Path(src), str(i))
        calls[tag] = bare_call(torch, lib)
        print(f"[ptxas] {tag}: {cs.ptxas_summary(log)}")

    cases = cs.nms_cases(torch, dev)
    for name, boxes, valid, thr in cases:
        want = suppress_plain(boxes, valid, thr)
        equal = {tag: bool(torch.equal(call(boxes, valid, thr), want))
                 for tag, call in calls.items()}
        print(f"[kernel] == plain on {name} ({tuple(valid.shape)}): {equal}")
        if not equal["tree"]:
            raise AssertionError(f"the tree's kernel != plain on {name}")

    card = cs.card_line()
    _, boxes, valid, _ = cases[0]  # random, 80 classes, K=1024, 90% valid
    order = list(calls) + list(reversed(calls))
    for label, v in (("90% valid", valid), ("all valid",
                                            torch.ones_like(valid))):
        us = {tag: [] for tag in calls}
        for _ in range(READINGS):
            for tag in order:
                us[tag].append(1e3 * cs.cuda_ms(
                    torch, lambda: calls[tag](boxes, v, cs.IOU), iters=50))
        print(f"[time] [16,1024] random boxes of 80 classes, {label}, IoU "
              f"{cs.IOU}, us a call (best, median of {2 * READINGS}): "
              + ", ".join(f"{tag} {min(t):.2f}, {sorted(t)[len(t) // 2]:.2f}"
                          for tag, t in us.items()) + f" on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
