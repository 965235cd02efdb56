#!/usr/bin/env python3
"""Time builds of the row top-k kernel against each other, in turns, on one
CUDA card, on the inputs the YOLOX-s training path hands it.

    python3 chip_topk_ab.py [OTHER.cu ...] [--json PATH]

Builds `pl_yolo_tpu_torch/csrc/topk_rows.cu` and every other source given
(each exporting the same C function `topk_rows`) with the port's `nvcc`
flags and prints ptxas's report for each. The inputs: SimOTA's pair IoU and
negated cost from YOLOX-s (full width and depth, 80 classes, seeded random
init, fp32, train mode) at B=16, 640^2: [16,50,8400] from uniform 0-255
images with 8 boxes in 50 label slots, as `chip_smoke.py` phase 6 captures
them, and [16,100,8400] from the batch that `device_augment` makes of
uint8 images with 100 label slots, as phase 7 does; then probes of the
cost of waves (the first 792 and 1584 rows of those inputs) and of
selection passes (800 rows of exact zeros, 800 of distinct values). Every
build is held bit-equal to `topk_plain` and `torch.topk` on every input and
on `chip_smoke.topk_cases`, then timed in turns (the given sources first,
the tree's kernel, the tree's kernel, the given sources again): device us
with the L2 cold (128 MB written before each launch), warm (launches back
to back) and with the input just written by a copy (as the step's own
producer leaves it), all by kernel name from the profiler, and us a call
by CUDA events; beside them
`torch.amax(x, dim=-1)` L2 cold, a pass of torch's own over the same
bytes. The timed call is the bare C function on an fp32 contiguous input;
the wrapper's own host cost is `chip_smoke.py`'s to measure. The times go
to `--json` as well. Exits non-zero without a result where no CUDA card is
available.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
KERNEL = "topk_rows_kernel"


def build_other(build, src: Path, tag: str) -> tuple[ctypes.CDLL, str]:
    """`src` built with the port's flags into the build directory."""
    out = build.BUILD_DIR / f"topk_rows_{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS,
                           *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def bare_call(torch, lib: ctypes.CDLL):
    """fn(x [rows, A] fp32 contiguous, k) -> [rows, k] through `lib`."""
    fn = lib.topk_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, k):
        out = torch.empty((x.shape[0], k), dtype=torch.float32,
                          device=x.device)
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], k,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"topk_rows launch failed: cudaError {err}")
        return out
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", nargs="*", type=Path,
                        help="other sources of topk_rows to time beside")
    parser.add_argument("--json", type=Path,
                        default=ROOT / "chiprun_out" / "topk_ab.json")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_topk_ab: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.ops.cuda import build
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_plain
    from pl_yolo_tpu_torch.utils.config import load_config, validate_model_config

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    build.build(["topk_rows"])
    builds = {"tree": (ctypes.CDLL(str(build.library_path("topk_rows"))),
                       build.LOGS.get("topk_rows", "(built before)"))}
    for i, src in enumerate(args.others):
        builds[src.stem] = build_other(build, src, f"other{i}")
    print(f"[build] {len(builds)} builds in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, (_, log) in builds.items():
        print(f"[ptxas] {name}: {cs.ptxas_summary(log)}", flush=True)
    calls = {name: bare_call(torch, lib) for name, (lib, _) in builds.items()}

    # the training path's inputs, captured as chip_smoke.py phases 6 and 7 do
    cfg = validate_model_config(load_config(cs.CONFIG), str(cs.CONFIG))
    cfg["dtype"] = None
    model = build_model(cfg, cs.NUM_CLASSES, seed=0)
    module, strides = model.module.train(), model.loss.strides
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.rand((cs.BATCH, cs.SIZE, cs.SIZE, 3), generator=gen,
                        device=dev) * 255.0
    labels = cs.train_labels(torch, dev, cs.BATCH)
    with torch.no_grad():
        maps = [m.float() for m in module(images)]
    iou50, cost50 = cs.simota_inputs(torch, maps, labels, strides)
    aug_cfg = augment.AugmentConfig(max_labels=cs.AUG_MAX_LABELS)
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = augment.sample_draws(gen, cs.BATCH, (cs.SIZE, cs.SIZE), aug_cfg)
    img_s2d, lab100 = augment.device_augment(
        draws, cs.bench_images(torch, dev, cs.BATCH), labels, aug_cfg,
        out_s2d=True)
    iou100, cost100 = cs.augmented_simota_inputs(torch, module, img_s2d,
                                                 lab100, strides)
    del maps, images, img_s2d, model, module
    a = iou50.shape[-1]
    main_inputs = {"pair_iou M=50": iou50, "-cost M=50": -cost50,
                   "pair_iou M=100": iou100, "-cost M=100": -cost100}
    main_inputs = {n: x.reshape(-1, a).contiguous()
                   for n, x in main_inputs.items()}
    g = torch.Generator(device=dev).manual_seed(3)
    probes = {"pair_iou M=50, first 792 rows":
              main_inputs["pair_iou M=50"][:792].contiguous(),
              "pair_iou M=100, first 1584 rows":
              main_inputs["pair_iou M=100"][:1584].contiguous(),
              "800 rows of zeros": torch.zeros((800, a), device=dev),
              "800 rows of distinct values": torch.randn(
                  (800, a), device=dev, generator=g)}
    for name, x in main_inputs.items():
        valid = int(((x != x[:, :1]).any(-1)).sum())
        print(f"[input] {name} {tuple(x.shape)}: {valid} rows not constant",
              flush=True)

    # every build bit-equal to the plain version and torch.topk
    checks = [(n, x.reshape(-1, x.shape[-1]).float().contiguous(), k)
              for n, x, k in cs.topk_cases(torch, dev)]
    checks += [(n, x, cs.TOPK_K) for n, x in {**main_inputs, **probes}.items()]
    for n, x, k in checks:
        plain = topk_plain(x, k)
        library = torch.topk(x, k, dim=-1).values
        if not torch.equal(plain, library):
            raise AssertionError(f"topk_plain != torch.topk on '{n}'")
        for b, call in calls.items():
            got = call(x, k)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(
                    f"build {b} != plain on '{n}' (k={k}): "
                    f"{int((got != plain).any(-1).sum())} rows differ")
    print(f"[check] {len(calls)} builds == topk_plain == torch.topk on "
          f"{len(checks)} inputs", flush=True)

    # in turns: the others, the tree, the tree, the others
    names = [n for n in calls if n != "tree"]
    order = names + ["tree", "tree"] + names[::-1] if names else ["tree"] * 2
    results = {}
    for what, x in {**main_inputs, **probes}.items():
        rows = x.shape[0]
        bound_ms = (rows * a + rows * cs.TOPK_K) * 4 / cs.PEAK_BYTES * 1e3
        runs = {n: {"cold": [], "warm": [], "written": [], "events": []}
                for n in calls}
        fresh = torch.empty_like(x)
        for n in order:
            fn = (lambda c=calls[n]: c(x, cs.TOPK_K))
            runs[n]["cold"].append(cs.kernel_device_ms(
                torch, cs.l2_cold(torch, fn), (KERNEL,))[KERNEL])
            runs[n]["warm"].append(cs.kernel_device_ms(
                torch, fn, (KERNEL,))[KERNEL])
            runs[n]["written"].append(cs.kernel_device_ms(
                torch, lambda c=calls[n]: c(fresh.copy_(x), cs.TOPK_K),
                (KERNEL,))[KERNEL])
            runs[n]["events"].append(cs.cuda_ms(torch, fn, iters=50))
        # a floor for a pass over the same bytes: torch's own row reduction
        amax = cs.kernel_device_ms(torch, cs.l2_cold(
            torch, lambda: torch.amax(x, dim=-1)), ("reduce_kernel",))[
                "reduce_kernel"]
        rec = {"rows": rows, "A": a, "bound_us": bound_ms * 1e3,
               "amax_cold_us": None if amax is None else amax * 1e3}
        print(f"[time] torch.amax(x, -1) on {what}: device us L2 cold "
              f"{rec['amax_cold_us']} on {card}", flush=True)
        for n, r in runs.items():
            rec[n] = {key: [None if v is None else v * 1e3 for v in vals]
                      for key, vals in r.items()}
            cold = [v for v in rec[n]["cold"] if v is not None]
            share = (f", {bound_ms * 1e3 / (sum(cold) / len(cold)):.3f} of "
                     f"the bound" if cold else "")
            print(f"[time] {n} on {what} {tuple(x.shape)}: device us L2 "
                  f"cold {rec[n]['cold']}, warm {rec[n]['warm']}, just "
                  f"written {rec[n]['written']}; CUDA "
                  f"events us a call {rec[n]['events']}; bound "
                  f"{bound_ms * 1e3:.3f} us{share} on {card}", flush=True)
        results[what] = rec
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps({"card": card, "order": order,
                                     "inputs": results}, indent=1))
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
