#!/usr/bin/env python3
"""Drive the PyTorch port's YOLOX-s inference path on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. device: the card's name and power limit from nvidia-smi;
  2. build: compile every CUDA kernel of the path from `pl_yolo_tpu_torch/csrc`;
  3. kernels: each kernel against its plain PyTorch version on the card;
  4. the slice: `build_model(yolox_s.yaml, 80 classes)` from a seeded random
     init, 4 requests of [16,640,640,3] images through eval forward,
     `eval_decode` and `postprocess`, in the config's bf16 and in fp32 (TF32
     off); shapes, finiteness, kernel launch counts, card postprocess equal
     to the CPU postprocess on the same decoded predictions, and the card's
     fp32 head maps against the CPU's at B=1;
  5. times: infer+NMS images/s at B=16 and each kernel's time beside its
     bound and its plain version's time, with the card's name and power limit.

The line before the last is the `kernels` JSON record, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result where no CUDA card is available.
"""

from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "pl_yolo_tpu" / "configs" / "model" / "yolox_s.yaml"
BATCH, SIZE, NUM_CLASSES, REQUESTS = 16, 640, 80, 4
CONF, IOU, PRE_NMS_TOPK, MAX_DET = 0.01, 0.65, 1024, 300
# H100 SXM published peaks (NVIDIA data sheet, dense): non-tensor fp32 and HBM3
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# fp32 ops per box pair in the NMS IoU pass (csrc/nms_suppress.cu note)
NMS_OPS_PER_PAIR = 14
# card fp32 (cuDNN, TF32 off) vs CPU fp32 head maps: the sums run in another
# order, and cuDNN may pick Winograd/FFT algorithms, through ~70 convs
MAPS_TOL = 1e-3  # on max |card - cpu| / max(1, max |cpu|)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of `fn` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, iters: int, top: int = 14):
    """Device time per call of `fn` from a torch.profiler trace: the busy
    ms (sum of kernel self times) and the `top` kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their device time is their kernels'
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3 / iters))
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows[:top]


def nms_cases(torch, dev):
    """(name, boxes [B,K,4], valid [B,K], threshold) on the card."""
    g = torch.Generator(device="cpu").manual_seed(7)

    def rand_boxes(b, k, n_classes):
        cxy = torch.rand((b, k, 2), generator=g) * SIZE
        wh = 8 + torch.rand((b, k, 2), generator=g) * 200
        boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1)
        cls = torch.randint(0, n_classes, (b, k), generator=g)
        boxes = boxes + (cls.to(torch.float32) * 4096.0)[..., None]
        valid = torch.rand((b, k), generator=g) < 0.9
        return boxes.contiguous(), valid

    cases = []
    for n_classes in (NUM_CLASSES, 4):
        boxes, valid = rand_boxes(BATCH, PRE_NMS_TOPK, n_classes)
        for thr in (0.65, 0.5):
            cases.append((f"random {n_classes} classes K=1024 thr={thr}",
                          boxes, valid, thr))
    boxes, valid = rand_boxes(BATCH, 300, 4)
    cases.append(("random K=300", boxes, valid, IOU))
    cases.append(("all invalid", boxes, torch.zeros_like(valid), IOU))
    # chain: IoU(i, i+1) = 0.82, IoU(i, i+2) = 0.67, IoU(i, i+3) = 0.54
    x0 = torch.arange(PRE_NMS_TOPK, dtype=torch.float32) * 10
    chain = torch.stack([x0, torch.zeros_like(x0), x0 + 100,
                         torch.full_like(x0, 100)], -1)
    chain = chain[None].repeat(2, 1, 1).contiguous()
    ones = torch.ones(chain.shape[:2], dtype=torch.bool)
    cases.append(("chain", chain, ones, IOU))
    same = torch.tensor([10.0, 20.0, 110.0, 220.0]).repeat(2, PRE_NMS_TOPK, 1)
    cases.append(("identical", same.contiguous(), ones, IOU))
    return [(n, b.to(dev), v.to(dev), t) for n, b, v, t in cases]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.ops.cuda import build
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import (nms_suppress,
                                                         suppress_plain)
    from pl_yolo_tpu_torch.ops.nms import postprocess, nms_candidates
    from pl_yolo_tpu_torch.utils.config import load_config, validate_model_config

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    log(card_line())
    log(f"[device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.build(["nms_suppress"])
    log(f"[build] nms_suppress built in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    max_err = 0
    for name, boxes, valid, thr in nms_cases(torch, dev):
        got = nms_suppress(boxes, valid, thr)
        want = suppress_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"nms_suppress != plain on '{name}': "
                f"{int((got != want).sum())} rows differ")
        log(f"[kernel] nms_suppress == plain on {name} "
            f"({tuple(valid.shape)}, {int(got.sum())} kept)")

    # 4. the slice
    cfg = validate_model_config(load_config(CONFIG), str(CONFIG))
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
                * 255.0 for _ in range(REQUESTS)]
    models = {}
    for precision in ("bfloat16", "float32"):
        c = copy.deepcopy(cfg)
        c["dtype"] = None if precision == "float32" else precision
        models[precision] = build_model(c, NUM_CLASSES, seed=0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def infer(model, x):
        preds = model.loss.eval_decode(model.module(x))
        return preds, postprocess(preds, conf_threshold=CONF,
                                  iou_threshold=IOU, max_det=MAX_DET,
                                  pre_nms_topk=PRE_NMS_TOPK)

    outputs = []
    nms_suppress.launches = 0
    with torch.inference_mode():
        for precision, model in models.items():
            for x in requests:
                before = nms_suppress.launches
                preds, det = infer(model, x)
                if nms_suppress.launches != before + 1:
                    raise AssertionError("postprocess did not launch the "
                                         "NMS kernel exactly once")
                outputs.append((precision, preds, det))
    torch.cuda.synchronize()
    launches = nms_suppress.launches
    n_anchors = sum((SIZE // s) ** 2 for s in (8, 16, 32))
    for precision, preds, det in outputs:
        shapes = [tuple(preds.shape), tuple(det.boxes.shape),
                  tuple(det.scores.shape), tuple(det.classes.shape),
                  tuple(det.valid.shape)]
        expect = [(BATCH, n_anchors, 5 + NUM_CLASSES), (BATCH, MAX_DET, 4),
                  (BATCH, MAX_DET), (BATCH, MAX_DET), (BATCH, MAX_DET)]
        if shapes != expect:
            raise AssertionError(f"{precision}: shapes {shapes} != {expect}")
        for name, t in (("preds", preds), ("boxes", det.boxes),
                        ("scores", det.scores)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{precision}: non-finite {name}")
        ref = postprocess(preds.cpu(), conf_threshold=CONF, iou_threshold=IOU,
                          max_det=MAX_DET, pre_nms_topk=PRE_NMS_TOPK,
                          device="cpu")
        for field in ("valid", "classes", "scores", "boxes"):
            if not torch.equal(getattr(det, field).cpu(), getattr(ref, field)):
                raise AssertionError(
                    f"{precision}: card postprocess != CPU postprocess "
                    f"({field})")
    kept = [int(det.valid.sum()) for _, _, det in outputs]
    log(f"[slice] {len(outputs)} requests of {BATCH}x{SIZE}x{SIZE}: shapes, "
        f"finiteness and card == CPU postprocess ok; detections kept "
        f"{kept}; nms launches {launches}")

    with torch.inference_mode():
        x1 = requests[0][:1]
        maps_card = [m.float().cpu() for m in models["float32"].module(x1)]
        cpu_cfg = copy.deepcopy(cfg)
        cpu_cfg["dtype"] = None
        cpu_model = build_model(cpu_cfg, NUM_CLASSES, device="cpu", seed=0)
        maps_cpu = cpu_model.module(x1.cpu())
        maps_bf16 = [m.float().cpu() for m in models["bfloat16"].module(x1)]
    scale = max(1.0, max(float(m.abs().max()) for m in maps_cpu))
    err = max(float((a - b).abs().max()) for a, b in zip(maps_card, maps_cpu))
    err_bf16 = max(float((a - b).abs().max())
                   for a, b in zip(maps_bf16, maps_cpu))
    log(f"[slice] fp32 head maps card vs CPU at B=1: max abs err {err:.3e} "
        f"(max |map| {scale:.3f}, tolerance {MAPS_TOL} x scale); bf16 vs CPU "
        f"fp32: {err_bf16:.3e}")
    if not err <= MAPS_TOL * scale:
        raise AssertionError(f"fp32 head maps differ: {err} > {MAPS_TOL * scale}")

    # the NMS kernel on the main path's own input (the last bf16 request)
    preds = outputs[REQUESTS - 1][1]
    cls_conf, cls_pred = preds[..., 5:].max(-1)
    cand = nms_candidates(preds[..., :4], preds[..., 4] * cls_conf,
                          cls_pred.to(torch.int32), CONF, PRE_NMS_TOPK)
    got = nms_suppress(cand.nms_boxes, cand.valid, IOU)
    want = suppress_plain(cand.nms_boxes, cand.valid, IOU)
    if not torch.equal(got, want):
        raise AssertionError("nms_suppress != plain on the main path's input")
    max_err = max(max_err, int((got.int() - want.int()).abs().max()))

    # 5. times
    torch.backends.cudnn.benchmark = True
    with torch.inference_mode():
        model, x = models["bfloat16"], requests[0]
        infer_ms = cuda_ms(torch, lambda: infer(model, x), iters=20)
        fwd_ms = cuda_ms(torch, lambda: model.module(x), iters=20)
        maps = model.module(x)
        dec_ms = cuda_ms(torch, lambda: model.loss.eval_decode(maps), iters=20)
        pp_ms = cuda_ms(torch, lambda: postprocess(
            preds, conf_threshold=CONF, iou_threshold=IOU, max_det=MAX_DET,
            pre_nms_topk=PRE_NMS_TOPK), iters=20)
        busy_ms, top = device_profile(torch, lambda: infer(model, x), 5)
    card = card_line()
    log(f"[profile] device busy {busy_ms:.3f} ms of {infer_ms:.3f} ms per "
        f"infer+NMS batch (idle share {1.0 - busy_ms / infer_ms:.3f}); "
        f"top kernels, ms per batch:")
    for name, ms in top:
        log(f"[profile]   {ms:9.4f}  {name[:110]}")
    log(f"[time] infer+NMS bf16 B={BATCH}: {infer_ms:.3f} ms/batch, "
        f"{BATCH * 1000.0 / infer_ms:.1f} images/s (forward {fwd_ms:.3f} ms, "
        f"decode {dec_ms:.3f} ms, postprocess {pp_ms:.3f} ms) on {card}")

    def nms_record(boxes, valid):
        b, k = valid.shape
        n_valid = valid.sum(1).double()
        ops = NMS_OPS_PER_PAIR * float((n_valid * (n_valid - 1) / 2).sum())
        nbytes = boxes.numel() * 4 + valid.numel() + b * k
        bound = {"operations": ops / PEAK_FP32_FLOPS * 1e3,
                 "bytes": nbytes / PEAK_BYTES * 1e3}
        bound_by = max(bound, key=bound.get)
        ms = cuda_ms(torch, lambda: nms_suppress(boxes, valid, IOU), iters=50)
        plain = cuda_ms(torch, lambda: suppress_plain(boxes, valid, IOU),
                        iters=10)
        return dict(ms=ms, plain_ms=plain, bound_ms=bound[bound_by],
                    bound_by=bound_by, n_valid=int(n_valid.sum()))

    main_rec = nms_record(cand.nms_boxes, cand.valid)
    _, stages = device_profile(
        torch, lambda: nms_suppress(cand.nms_boxes, cand.valid, IOU), 20, 2)
    log("[profile] nms_suppress stages on the main-path input, us per call: "
        + ", ".join(f"{re.search(r'nms_[a-z]+_kernel', name).group(0)} "
                    f"{ms * 1e3:.2f}" for name, ms in stages))
    syn_boxes, syn_valid = nms_cases(torch, dev)[0][1:3]
    syn_rec = nms_record(syn_boxes, syn_valid)
    for label, r in (("main-path input", main_rec),
                     ("random [16,1024], 80 classes", syn_rec)):
        log(f"[time] nms_suppress on {label}: {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us "
            f"({r['bound_by']}, {r['n_valid']} valid rows) on {card}")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "nms_suppress", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/nms_pallas.py:29",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
