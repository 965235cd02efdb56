#!/usr/bin/env python3
"""Hold builds of the NMS suppression kernel to its plain version and time
them against each other, in turns, on one CUDA card.

    python3 chip_nms_ab.py [OTHER.cu ...]

Builds `pl_yolo_tpu_torch/csrc/nms_suppress.cu`, its copy cut after the IoU
pass (`-DNMS_CUT_AFTER_IOU`), and every other source given (each exporting
the same C function `nms_suppress`) with the port's `nvcc` flags, all
started together, and prints ptxas's report for each. Each whole build runs
every case of `chip_smoke.nms_cases` (random boxes of 80 and 4 classes, a
chain, identical boxes, all invalid, boxes with infinite and NaN
coordinates, and the shapes a cluster of CTAs can get wrong: K of 1, 65 and
525, B=1, the cluster kernel's capacity and one K above it) and is compared
with `suppress_plain`, bit for bit: the tree's kernel must equal it on every
case, another build's matches are reported. Then, on [16,1024] random boxes
of 80 classes at IoU 0.65 (taken as sorted), with 90% of them valid and
with all valid, as the serving path's candidates are, each build is timed
in turns (the tree's kernel, the others, then back in reverse order, three
times): by device time (the sum of its kernels a call in a profiler trace
of 20 calls) and by CUDA events over 50 back-to-back calls of the bare C
function. The tree's cut copy against its whole kernel splits the device
time into the IoU pass and the sweep; the wrapper `nms_suppress` is timed
by CUDA events beside the bare call. Exits non-zero without a result where
no CUDA card is available.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

READINGS = 3
CUT_FLAG = "-DNMS_CUT_AFTER_IOU"


def start_build(build, src: Path, tag: str, flags=()):
    """Start `nvcc` on `src` with the port's flags (and `flags`) into the
    build directory; returns finish() -> (library, nvcc's output)."""
    out = build.BUILD_DIR / f"nms_suppress_{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([build.nvcc_path(), *build.ARCH_FLAGS,
                             *build.NVCC_FLAGS, *flags, "-o", str(out),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def finish() -> tuple[ctypes.CDLL, str]:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} {flags}:\n{log}")
        return ctypes.CDLL(str(out)), log
    return finish


def start_cut_build(build):
    """The tree's source cut after its IoU pass, its build started."""
    return start_build(build, build.CSRC_DIR / "nms_suppress.cu", "cut",
                       (CUT_FLAG,))


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


def device_us(torch, fn, iters: int = 20) -> float:
    """Device µs a call of `fn`: its kernels' time in a profiler trace."""
    return 1e3 * cs.device_profile(torch, fn, iters, None)[0]


def phase_split(torch, whole, cut, boxes, valid, thr) -> dict:
    """Device µs a call of the whole kernel and of its copy cut after the
    IoU pass, in turns (whole, cut, cut, whole); the sweep is the rest."""
    us = {"whole": [], "cut": []}
    for tag in ("whole", "cut", "cut", "whole"):
        fn = whole if tag == "whole" else cut
        us[tag].append(device_us(torch, lambda: fn(boxes, valid, thr)))
    w, c = (sum(us[t]) / len(us[t]) for t in ("whole", "cut"))
    return {"whole_us": w, "iou_us": c, "sweep_us": w - c}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_nms_ab: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT))
    from pl_yolo_tpu_torch.ops.cuda import build
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import (CLUSTER_MAX_K,
                                                         cluster_fit,
                                                         nms_suppress,
                                                         suppress_plain)

    dev = torch.device("cuda", 0)
    pending = {"cut": start_cut_build(build)}
    for i, src in enumerate(sys.argv[1:]):
        pending[f"{i}:{Path(src).name}"] = start_build(build, Path(src),
                                                       str(i))
    build.build(["nms_suppress"])
    calls = {"tree": bare_call(torch, build.load("nms_suppress"))}
    print(f"[ptxas] tree: {cs.ptxas_summary(build.LOGS['nms_suppress'])}")
    for tag, finish in pending.items():
        lib, log = finish()
        calls[tag] = bare_call(torch, lib)
        print(f"[ptxas] {tag}: {cs.ptxas_summary(log)}")
    cut = calls.pop("cut")
    print(f"[cluster] 8-CTA clusters resident at once: "
          f"{cluster_fit(cs.PRE_NMS_TOPK)} at K={cs.PRE_NMS_TOPK}, "
          f"{cluster_fit(CLUSTER_MAX_K)} at K={CLUSTER_MAX_K}")

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
        dev_us = {tag: [] for tag in calls}
        ev_us = {tag: [] for tag in calls}
        for _ in range(READINGS):
            for tag in order:
                fn = calls[tag]
                dev_us[tag].append(device_us(
                    torch, lambda: fn(boxes, v, cs.IOU)))
                ev_us[tag].append(1e3 * cs.cuda_ms(
                    torch, lambda: fn(boxes, v, cs.IOU), iters=50))
        for what, us in (("device time", dev_us), ("CUDA events, bare C "
                                                   "call", ev_us)):
            print(f"[time] [16,1024] random boxes of 80 classes, {label}, "
                  f"IoU {cs.IOU}, {what}, us a call (best, median of "
                  f"{2 * READINGS}): " + ", ".join(
                      f"{tag} {min(t):.2f}, {sorted(t)[len(t) // 2]:.2f}"
                      for tag, t in us.items()) + f" on {card}")
        split = phase_split(torch, calls["tree"], cut, boxes, v, cs.IOU)
        wrapper = [1e3 * cs.cuda_ms(torch, lambda: nms_suppress(
            boxes, v, cs.IOU), iters=50) for _ in range(READINGS)]
        print(f"[split] tree, {label}: device us a call: whole "
              f"{split['whole_us']:.2f}, IoU pass (the cut copy) "
              f"{split['iou_us']:.2f}, sweep (the rest) "
              f"{split['sweep_us']:.2f}; the wrapper by CUDA events "
              f"{min(wrapper):.2f} (best of {READINGS}) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
