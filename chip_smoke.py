#!/usr/bin/env python3
"""Drive the PyTorch port's YOLOX-s serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. device: the card's name and power limit from nvidia-smi;
  2. build: compile every CUDA kernel of the paths from `pl_yolo_tpu_torch/csrc`;
  3. kernels: each kernel against its plain PyTorch version on the card (the
     row top-k also against `torch.topk`);
  4. serving: `build_model(yolox_s.yaml, 80 classes)` from a seeded random
     init, 4 requests of [16,640,640,3] images through eval forward,
     `eval_decode` and `postprocess`, in the config's bf16 and in fp32 (TF32
     off); shapes, finiteness, kernel launch counts, card postprocess equal
     to the CPU postprocess on the same decoded predictions, and the card's
     fp32 head maps against the CPU's at B=1;
  5. training: `build_optimizer`, `TrainState.create`, `make_train_step`
     without augmentation; 4 steps at B=16, 640^2 in bf16 and 4 in fp32;
     finite losses, anchors assigned, two top-k launches a step, weights, BN
     statistics and the EMA copy moved, biases moved by the gradient step
     alone, then one request through `make_eval_step` on the EMA weights and
     `postprocess`;
  6. the loss on the card against the CPU on the training path's own fp32
     head maps (assignment equal, losses and gradients to LOSS_TOL), and the
     top-k kernel against `torch.topk` on that step's pair-IoU and cost;
  7. times: infer+NMS and train images/s, the train step's split and device
     profile, and each kernel's time beside its bound, its plain version's
     time and the PyTorch library call's, with the card's name and power
     limit.

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
CONFIG = ROOT / "pl_yolo_tpu_torch" / "configs" / "model" / "yolox_s.yaml"
BATCH, SIZE, NUM_CLASSES, REQUESTS = 16, 640, 80, 4
TRAIN_STEPS, MAX_LABELS, BOXES_PER_IMAGE, TOTAL_STEPS = 4, 50, 8, 1000
TOPK_K = 10  # SimOTA's k, for both of a step's launches
CONF, IOU, PRE_NMS_TOPK, MAX_DET = 0.01, 0.65, 1024, 300
CONF_TRAINED = 1e-6  # for the one request served after the train steps
# H100 SXM published peaks (NVIDIA data sheet, dense): non-tensor fp32 and HBM3
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# fp32 ops per box pair in the NMS IoU pass (csrc/nms_suppress.cu note)
NMS_OPS_PER_PAIR = 14
# card fp32 (cuDNN, TF32 off) vs CPU fp32 head maps: the sums run in another
# order, and cuDNN may pick Winograd/FFT algorithms, through ~70 convs
MAPS_TOL = 1e-3  # on max |card - cpu| / max(1, max |cpu|)
# the loss on the card vs the CPU from the same fp32 head maps: the same
# formulas, sums over 8400 anchors in another order, exp/log of two libraries
LOSS_TOL = 1e-5  # relative, on each loss entry and on max |grad| per map
# a bias after 4 SGD steps vs the same steps redone by hand from its
# recorded gradients: fp32 rounding of a few multiply-adds
UPDATE_TOL = 1e-5  # on max |change - by hand| / max |change|


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def note(msg: str) -> None:
    """Progress on stderr, with the seconds since the start: says which
    measurement a run was in, should one ever stall."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


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
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue  # host ops and annotated ranges (the optimizer's step):
            # their device time is their kernels'
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


def cuda_ms_each(torch, setup, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of `fn(setup())` on the current stream, `setup` untimed."""
    pairs = []
    for i in range(warmup + iters):
        ctx = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(ctx)
        end.record()
        if i >= warmup:
            pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def topk_cases(torch, dev):
    """(name, x [..., A], k) on the card: the shapes and the kinds of row
    that SimOTA sends, and the wrapper's cast and copy paths."""
    g = torch.Generator(device="cpu").manual_seed(11)
    rows, a = BATCH * MAX_LABELS, sum((SIZE // s) ** 2 for s in (8, 16, 32))
    x = torch.randn((rows, a), generator=g)
    cases = [("random", x, TOPK_K), ("random k=1", x, 1),
             ("random k=16", x, 16), ("7 rows", x[:7], TOPK_K),
             ("1 row", x[:1], TOPK_K),
             ("A=2100 (320 px)", x[:, :2100], TOPK_K),
             ("A=65", x[:, :65], TOPK_K)]
    sparse = torch.zeros((rows, a))
    sparse[:, 5], sparse[:, 77], sparse[:, a - 1] = 0.5, 0.25, 0.5
    cases.append(("all zeros but three entries", sparse, TOPK_K))
    ties = -1e9 - 1e5 - torch.rand((rows, a), generator=g) * 30.0
    ties[::2, 100:106] = -torch.rand((rows // 2, 6), generator=g) * 30.0
    cases.append(("exact ties near -1e9", ties, TOPK_K))
    inf = torch.full((rows, a), -float("inf"))
    inf[:, :4] = torch.tensor([3.0, -1.0, 3.0, 7.5])
    inf[5] = -float("inf")
    cases.append(("-inf rows, fewer than k finite", inf, TOPK_K))
    cases.append(("3-D [16,50,8400]", x.reshape(BATCH, MAX_LABELS, a), TOPK_K))
    cases.append(("non-contiguous", torch.randn((a, 40), generator=g).t(),
                  TOPK_K))
    cases.append(("bf16 (cast path)", x.to(torch.bfloat16), TOPK_K))
    return [(n, v.to(dev), k) for n, v, k in cases]


def train_labels(torch, dev, batch):
    """[batch, 50, 5] labels with 8 boxes an image, as `bench.py` draws
    them: class in [0, 80), cx, cy, w, h uniform in [50, 550)."""
    import numpy as np
    rng = np.random.default_rng(0)
    labels = np.zeros((batch, MAX_LABELS, 5), np.float32)
    labels[:, :BOXES_PER_IMAGE, 0] = rng.integers(
        0, NUM_CLASSES, (batch, BOXES_PER_IMAGE))
    labels[:, :BOXES_PER_IMAGE, 1:] = rng.uniform(
        50, 550, (batch, BOXES_PER_IMAGE, 4))
    return torch.from_numpy(labels).to(dev)


def sgd_by_hand(p0, grads, lrs, momentum):
    """SGD with momentum and no weight decay, step by step, as the optimizer
    should have moved a bias from `p0` given its recorded gradients."""
    p, buf = p0.clone(), None
    for g, lr in zip(grads, lrs):
        buf = g.clone() if buf is None else buf * momentum + g
        p = p - lr * buf
    return p


def simota_inputs(torch, maps, labels, strides):
    """The pair IoU and the cost [B,M,A] that `yolox_loss` hands to the
    top-k kernel for these head maps and labels."""
    from pl_yolo_tpu_torch.models.losses import yolox
    from pl_yolo_tpu_torch.ops.boxes import cxcywh2xyxy
    with torch.no_grad():
        d = yolox.yolox_decode(maps, strides)
        gt_boxes, gt_valid = labels[..., 1:5], labels.sum(dim=2) > 0
        xc = (d.x_shifts + 0.5) * d.strides
        yc = (d.y_shifts + 0.5) * d.strides
        in_box, in_center = yolox._gates(gt_boxes, gt_valid, xc, yc,
                                         d.strides, 2.5)
        pair_iou, cost, _, _ = yolox._cost_and_claims(
            gt_boxes, labels[..., 0].long(), gt_valid, in_box & in_center,
            (in_box | in_center).any(dim=1), cxcywh2xyxy(d.preds[..., :4]),
            *yolox._cls_cost_terms(d.preds[..., 4], d.preds[..., 5:]))
    return pair_iou, cost


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.models.losses.yolox import (simota_assign,
                                                       yolox_decode)
    from pl_yolo_tpu_torch.ops.cuda import build
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import (nms_suppress,
                                                         suppress_plain)
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_plain, topk_rows
    from pl_yolo_tpu_torch.ops.nms import postprocess, nms_candidates
    from pl_yolo_tpu_torch.ops.topk import topk_lastdim
    from pl_yolo_tpu_torch.train.ema import ema_update
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import (TrainState, make_eval_step,
                                               make_train_step)
    from pl_yolo_tpu_torch.utils.config import load_config, validate_model_config

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    n_anchors = sum((SIZE // s) ** 2 for s in (8, 16, 32))

    # 1. device
    log(card_line())
    log(f"[device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.build(["nms_suppress", "topk_rows"])
    log(f"[build] nms_suppress and topk_rows built in "
        f"{time.perf_counter() - t0:.2f} s")

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

    def check_topk(name, x, k):
        """The kernel (through `topk_lastdim`) against its plain version and
        against `torch.topk`; returns max |kernel - plain|."""
        before = topk_rows.launches
        got = topk_lastdim(x, k)
        torch.cuda.synchronize()
        if topk_rows.launches != before + 1:
            raise AssertionError(f"topk_lastdim did not launch the kernel "
                                 f"on '{name}'")
        plain = topk_plain(x, k)
        library = torch.topk(x, k, dim=-1).values
        if got.shape != library.shape or got.dtype != x.dtype:
            raise AssertionError(f"topk_rows on '{name}': {got.dtype} "
                                 f"{tuple(got.shape)}")
        for other, what in ((plain, "plain"), (library, "torch.topk")):
            if not torch.equal(got, other):
                raise AssertionError(
                    f"topk_rows != {what} on '{name}': "
                    f"{int((got != other).any(-1).sum())} rows differ")
        finite = torch.isfinite(got) & torch.isfinite(plain)
        return float((got.float() - plain.float())[finite].abs().max()
                     ) if bool(finite.any()) else 0.0

    topk_err = 0.0
    for name, x, k in topk_cases(torch, dev):
        topk_err = max(topk_err, check_topk(name, x, k))
        log(f"[kernel] topk_rows == plain == torch.topk on {name} "
            f"({tuple(x.shape)}, k={k})")

    # NaN is outside the kernel's contract, but it must come back from it
    nan_rows = torch.full((BATCH * MAX_LABELS, n_anchors), float("nan"),
                          device=dev)
    nan_rows[1::2, :3] = 1.0
    got = topk_lastdim(nan_rows, TOPK_K)
    torch.cuda.synchronize()
    if not (bool(torch.isnan(got[0::2]).all())
            and bool((got[1::2, :3] == 1.0).all())
            and bool(torch.isnan(got[1::2, 3:]).all())):
        raise AssertionError("topk_rows on rows of NaN: unexpected result")
    log("[kernel] topk_rows ends on rows of NaN (outside its contract)")

    # 4. the serving path
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

    def check_detections(what, preds, det, conf=CONF):
        shapes = [tuple(preds.shape), tuple(det.boxes.shape),
                  tuple(det.scores.shape), tuple(det.classes.shape),
                  tuple(det.valid.shape)]
        expect = [(BATCH, n_anchors, 5 + NUM_CLASSES), (BATCH, MAX_DET, 4),
                  (BATCH, MAX_DET), (BATCH, MAX_DET), (BATCH, MAX_DET)]
        if shapes != expect:
            raise AssertionError(f"{what}: shapes {shapes} != {expect}")
        for name, t in (("preds", preds), ("boxes", det.boxes),
                        ("scores", det.scores)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what}: non-finite {name}")
        ref = postprocess(preds.cpu(), conf_threshold=conf, iou_threshold=IOU,
                          max_det=MAX_DET, pre_nms_topk=PRE_NMS_TOPK,
                          device="cpu")
        for field in ("valid", "classes", "scores", "boxes"):
            if not torch.equal(getattr(det, field).cpu(), getattr(ref, field)):
                raise AssertionError(
                    f"{what}: card postprocess != CPU postprocess ({field})")

    outputs = []
    nms_suppress.launches = topk_rows.launches = 0
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
    nms_launches = nms_suppress.launches
    for precision, preds, det in outputs:
        check_detections(precision, preds, det)
    kept = [int(det.valid.sum()) for _, _, det in outputs]
    log(f"[serving] {len(outputs)} requests of {BATCH}x{SIZE}x{SIZE}: shapes, "
        f"finiteness and card == CPU postprocess ok; detections kept "
        f"{kept}; nms launches {nms_launches}")

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
    log(f"[serving] fp32 head maps card vs CPU at B=1: max abs err {err:.3e} "
        f"(max |map| {scale:.3f}, tolerance {MAPS_TOL} x scale); bf16 vs CPU "
        f"fp32: {err_bf16:.3e}")
    if not err <= MAPS_TOL * scale:
        raise AssertionError(f"fp32 head maps differ: {err} > {MAPS_TOL * scale}")

    # the NMS kernel on the serving path's own input (the last bf16 request)
    preds = outputs[REQUESTS - 1][1]
    cls_conf, cls_pred = preds[..., 5:].max(-1)
    cand = nms_candidates(preds[..., :4], preds[..., 4] * cls_conf,
                          cls_pred.to(torch.int32), CONF, PRE_NMS_TOPK)
    got = nms_suppress(cand.nms_boxes, cand.valid, IOU)
    want = suppress_plain(cand.nms_boxes, cand.valid, IOU)
    if not torch.equal(got, want):
        raise AssertionError("nms_suppress != plain on the main path's input")
    max_err = max(max_err, int((got.int() - want.int()).abs().max()))

    # 5. the training path: the models built above go on to train
    note("training")
    images = requests[0]
    labels = train_labels(torch, dev, BATCH)
    momentum = float(cfg["optimizer"]["momentum"])
    states = {}
    nms_suppress.launches = topk_rows.launches = 0
    for precision, model in models.items():
        module = model.module
        optimizer, schedule = build_optimizer(module, cfg["optimizer"],
                                              total_steps=TOTAL_STEPS)
        state = TrainState.create(module, optimizer)
        step = make_train_step(model.loss.train_loss)
        initial = {k: v.clone() for k, v in module.state_dict().items()}
        names = dict(module.named_parameters())
        watched = {k: [] for k in ("backbone.stem.conv.bn.bias",
                                   "head.reg_pred0.bias")}
        history = []
        for n in range(TRAIN_STEPS):
            before = topk_rows.launches
            history.append(step(state, images, labels))
            if topk_rows.launches != before + 2:
                raise AssertionError(
                    f"{precision}: a train step launched the top-k kernel "
                    f"{topk_rows.launches - before} times, not twice")
            for k in watched:
                watched[k].append(names[k].grad.clone())
        torch.cuda.synchronize()
        for n, losses in enumerate(history):
            for k, v in losses.items():
                if v.requires_grad or not bool(torch.isfinite(v)):
                    raise AssertionError(f"{precision} step {n}: bad {k} {v}")
            if not float(losses["proportion"]) > 0:
                raise AssertionError(f"{precision} step {n}: no anchor assigned")
        if state.step != TRAIN_STEPS or optimizer.updates != TRAIN_STEPS:
            raise AssertionError(f"{precision}: step count {state.step}")
        final = module.state_dict()
        ema = state.eval_module.state_dict()
        if state.eval_module is module or state.eval_module.training:
            raise AssertionError(f"{precision}: no EMA copy in eval mode")
        for k, v in final.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{precision}: non-finite {k}")
            moved = not torch.equal(v, initial[k])
            ema_moved = not torch.equal(ema[k], initial[k])
            if k.endswith(("conv.weight", "running_mean", "running_var")) \
                    and not (moved and ema_moved):
                raise AssertionError(f"{precision}: {k} did not change "
                                     f"(trained {moved}, EMA {ema_moved})")
        decayed, plain_group = optimizer.param_groups
        wd = float(cfg["optimizer"]["weight_decay"])
        if decayed["weight_decay"] != wd or plain_group["weight_decay"] != 0.0 \
                or not all(p.dim() == 4 for p in decayed["params"]) \
                or not all(p.dim() == 1 for p in plain_group["params"]):
            raise AssertionError(f"{precision}: weight decay reaches more "
                                 f"than the conv weights")
        lrs = [schedule(n) for n in range(TRAIN_STEPS)]
        for k, grads in watched.items():
            change = final[k] - initial[k]
            by_hand = sgd_by_hand(initial[k], grads, lrs, momentum) - initial[k]
            rel = float((change - by_hand).abs().max() / change.abs().max())
            if not rel <= UPDATE_TOL:
                raise AssertionError(f"{precision}: {k} moved by more than "
                                     f"its gradient steps: {rel}")
        states[precision] = state
        log(f"[training] {precision}: {TRAIN_STEPS} steps of {BATCH}x{SIZE}x"
            f"{SIZE}, lr {lrs[0]:.1e}..{lrs[-1]:.1e}: loss "
            + " ".join(f"{float(h['loss']):.4f}" for h in history)
            + f"; proportion {float(history[-1]['proportion']):.2f}; 2 top-k "
            f"launches a step; weights, BN stats and EMA moved; biases moved "
            f"by their gradient steps alone (tolerance {UPDATE_TOL})")
    topk_launches = topk_rows.launches

    # training hands over to serving: one request on the EMA weights. Their
    # BatchNorm statistics have begun to move off (0, 1), so the scores of
    # this random model fall back to the head's prior (obj x cls ~ 1e-4):
    # the request asks for a confidence below that, so that NMS has work.
    model, state = models["bfloat16"], states["bfloat16"]
    eval_step = make_eval_step(model.loss.eval_decode)
    before = nms_suppress.launches
    preds = eval_step(state.eval_module, requests[1])
    det = postprocess(preds, conf_threshold=CONF_TRAINED, iou_threshold=IOU,
                      max_det=MAX_DET, pre_nms_topk=PRE_NMS_TOPK)
    if nms_suppress.launches != before + 1:
        raise AssertionError("postprocess after training did not launch the "
                             "NMS kernel once")
    check_detections("after training", preds, det, CONF_TRAINED)
    if not int(det.valid.sum()) > 0:
        raise AssertionError("the trained model's request kept no detection")
    log(f"[training] eval step on the EMA weights + postprocess (conf "
        f"{CONF_TRAINED}): {int(det.valid.sum())} detections kept; top-k "
        f"launches on the training path {topk_launches}")

    note("loss on the card against the CPU")
    # 6. the loss on the card against the CPU, on the training path's own
    # fp32 head maps (B=2), and the kernel on that step's real inputs
    model = models["float32"]
    strides = model.loss.strides
    with torch.no_grad():
        maps = [m.float() for m in model.module.train()(images[:2])]
    sides = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        outs = [m.detach().to(device).requires_grad_() for m in maps]
        lab = labels[:2].to(device)
        before = topk_rows.launches
        losses = model.loss.train_loss(outs, lab, use_l1=True)
        if topk_rows.launches != before + (2 if side == "card" else 0):
            raise AssertionError(f"the loss on the {side} launched the top-k "
                                 f"kernel {topk_rows.launches - before} times")
        losses["loss"].backward()
        d = yolox_decode([o.detach() for o in outs], strides)
        assign = simota_assign(
            lab[..., 1:5], lab[..., 0].long(), lab.sum(dim=2) > 0,
            d.preds[..., :4], d.preds[..., 4], d.preds[..., 5:], d.x_shifts,
            d.y_shifts, d.strides)
        sides[side] = (losses, [o.grad.cpu() for o in outs], assign)
    (l_card, g_card, a_card), (l_cpu, g_cpu, a_cpu) = sides["card"], sides["cpu"]
    if not (torch.equal(a_card.fg_mask.cpu(), a_cpu.fg_mask)
            and torch.equal(a_card.matched_gt.cpu(), a_cpu.matched_gt)):
        flips = int((a_card.fg_mask.cpu() != a_cpu.fg_mask).sum())
        raise AssertionError(f"SimOTA on the card != CPU: {flips} anchors "
                             f"change side")
    l_card = {k: float(v.detach()) for k, v in l_card.items()}
    l_cpu = {k: float(v.detach()) for k, v in l_cpu.items()}
    loss_err = max(abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                   for k in l_cpu)
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g_card, g_cpu))
    log(f"[loss] card vs CPU on the training path's fp32 maps at B=2: "
        f"assignment equal ({int(a_cpu.fg_mask.sum())} foreground anchors), "
        f"loss {l_card['loss']:.6f} vs {l_cpu['loss']:.6f}, max "
        f"relative error of a loss entry {loss_err:.3e}, of a map's gradient "
        f"{grad_err:.3e} (tolerance {LOSS_TOL})")
    if not (loss_err <= LOSS_TOL and grad_err <= LOSS_TOL):
        raise AssertionError(f"loss on the card != CPU: {loss_err}, {grad_err}")

    with torch.no_grad():
        maps16 = [m.float() for m in model.module(images)]
    pair_iou, cost = simota_inputs(torch, maps16, labels, strides)
    topk_inputs = (("pair_iou", pair_iou), ("-cost", -cost))
    for name, x in topk_inputs:
        topk_err = max(topk_err, check_topk(f"the training path's {name}",
                                            x, TOPK_K))
    log(f"[kernel] topk_rows == plain == torch.topk on the training path's "
        f"pair_iou and -cost {tuple(cost.shape)}")

    # 7. times
    note("times: serving")
    torch.backends.cudnn.benchmark = True
    with torch.inference_mode():
        model, x = models["bfloat16"], requests[0]
        model.module.eval()
        infer_ms = cuda_ms(torch, lambda: infer(model, x), iters=20)
        fwd_ms = cuda_ms(torch, lambda: model.module(x), iters=20)
        maps = model.module(x)
        dec_ms = cuda_ms(torch, lambda: model.loss.eval_decode(maps), iters=20)
        preds = model.loss.eval_decode(maps)
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

    note("times: nms_suppress")
    main_rec = nms_record(cand.nms_boxes, cand.valid)
    _, stages = device_profile(
        torch, lambda: nms_suppress(cand.nms_boxes, cand.valid, IOU), 20, 2)
    def short(name):
        found = re.search(r"[a-z_]+_kernel", name)
        return found.group(0) if found else name[:40]

    log("[profile] nms_suppress stages on the main-path input, us per call: "
        + ", ".join(f"{short(name)} {ms * 1e3:.2f}" for name, ms in stages))
    syn_boxes, syn_valid = nms_cases(torch, dev)[0][1:3]
    syn_rec = nms_record(syn_boxes, syn_valid)
    for label, r in (("main-path input", main_rec),
                     ("random [16,1024], 80 classes", syn_rec)):
        log(f"[time] nms_suppress on {label}: {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us "
            f"({r['bound_by']}, {r['n_valid']} valid rows) on {card}")

    # the train step, bf16: whole, then forward / loss / backward / update.
    # The timed steps run on a horizon so long that the warm-up keeps the
    # learning rate near 0: some hundred steps on one batch of noise at the
    # real rates could drive this random model to non-finite values, and
    # the times would then be of another computation.
    model = models["bfloat16"]
    module, loss_fn = model.module.train(), model.loss.train_loss
    optimizer, _ = build_optimizer(module, cfg["optimizer"],
                                   total_steps=10 ** 9)
    state = TrainState.create(module, optimizer)
    step = make_train_step(loss_fn)
    note("times: train step")
    step_ms = cuda_ms(torch, lambda: step(state, images, labels), iters=10)
    t0 = time.perf_counter()
    for _ in range(10):
        step(state, images, labels)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 10
    note("times: train step's parts")
    fwd_ms = cuda_ms(torch, lambda: module(images), iters=10)
    outs = [m.detach().requires_grad_() for m in module(images)]
    loss_ms = cuda_ms(torch, lambda: loss_fn(outs, labels), iters=10)
    with torch.no_grad():
        d = yolox_decode(outs, strides)
        assign_args = (
            labels[..., 1:5], labels[..., 0].long(), labels.sum(dim=2) > 0,
            d.preds[..., :4], d.preds[..., 4], d.preds[..., 5:], d.x_shifts,
            d.y_shifts, d.strides)
        assign_ms = cuda_ms(torch, lambda: simota_assign(*assign_args),
                            iters=10)
    bwd_ms = cuda_ms_each(
        torch, lambda: loss_fn(module(images), labels)["loss"],
        lambda loss: loss.backward(), iters=10)

    def update():
        state.optimizer.step()
        ema_update(state.ema_module, module, state.step)

    upd_ms = cuda_ms(torch, update, iters=10)
    note("times: train step's profile")
    busy_ms, top = device_profile(torch, lambda: step(state, images, labels), 3)
    log(f"[profile] device busy {busy_ms:.3f} ms of {step_ms:.3f} ms per "
        f"train step (idle share {1.0 - busy_ms / step_ms:.3f}); top "
        f"kernels, ms per step:")
    for name, ms in top:
        log(f"[profile]   {ms:9.4f}  {name[:110]}")
    log(f"[time] train step bf16 B={BATCH}: {step_ms:.3f} ms/step, "
        f"{BATCH * 1000.0 / step_ms:.1f} images/s by CUDA events "
        f"({wall_ms:.3f} ms/step by the host clock); timed alone: forward "
        f"{fwd_ms:.3f} ms, loss {loss_ms:.3f} ms (of which the SimOTA "
        f"assignment {assign_ms:.3f} ms), backward "
        f"{bwd_ms:.3f} ms, optimizer + EMA {upd_ms:.3f} ms on {card}")
    note("times: train step at B=64")
    torch.cuda.reset_peak_memory_stats()
    images64 = torch.cat(requests, 0)
    labels64 = train_labels(torch, dev, images64.shape[0])
    step64_ms = cuda_ms(torch, lambda: step(state, images64, labels64),
                        iters=5, warmup=2)
    log(f"[time] train step bf16 B={images64.shape[0]}: {step64_ms:.3f} "
        f"ms/step, {images64.shape[0] * 1000.0 / step64_ms:.1f} images/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB on {card}")
    del images64, labels64
    last = step(state, images, labels)
    if not all(bool(torch.isfinite(v)) for v in last.values()):
        raise AssertionError(f"non-finite losses after the timed steps: {last}")

    def topk_record(x):
        rows, a = x.shape[0] * x.shape[1], x.shape[2]
        # a row needs one scan (a compare and a max per entry) for each
        # distinct value among its top k, and the load's max: what this
        # input needs, not the k scans a row of distinct values would
        top = torch.topk(x, TOPK_K, dim=-1).values
        scans = int((top[..., 1:] != top[..., :-1]).sum()) + 2 * rows
        bound = {"operations": 2.0 * a * scans / PEAK_FP32_FLOPS * 1e3,
                 "bytes": (rows * a + rows * TOPK_K) * 4 / PEAK_BYTES * 1e3}
        bound_by = max(bound, key=bound.get)
        _, kernels = device_profile(torch, lambda: topk_rows(x, TOPK_K), 20, 5)
        return dict(
            ms=cuda_ms(torch, lambda: topk_rows(x, TOPK_K), iters=50),
            # the trace may miss a kernel: then its device time is unknown
            device_ms=next((ms for name, ms in kernels
                            if "topk_rows_kernel" in name), None),
            plain_ms=cuda_ms(torch, lambda: topk_plain(x, TOPK_K), iters=10),
            library_ms=cuda_ms(
                torch, lambda: torch.topk(x, TOPK_K, dim=-1).values, iters=50),
            bound_ms=bound[bound_by], bound_by=bound_by)

    note("times: topk_rows")
    topk_recs = {name: topk_record(x) for name, x in topk_inputs}
    topk_recs["random"] = topk_record(torch.randn(
        cost.shape, device=dev, generator=torch.Generator(dev).manual_seed(3)))
    for name, r in topk_recs.items():
        device_us = ("not measured" if r["device_ms"] is None
                     else f"{r['device_ms'] * 1e3:.2f} us")
        log(f"[time] topk_rows on {name} {tuple(cost.shape)} k={TOPK_K}: "
            f"{r['ms'] * 1e3:.2f} us a call ({device_us} of "
            f"device time in the profiler), plain {r['plain_ms'] * 1e3:.2f} "
            f"us, torch.topk {r['library_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) on {card}")

    def mean(key):
        return sum(topk_recs[name][key] for name, _ in topk_inputs) / 2

    log(card)
    log(json.dumps({"kernels": [{
        "name": "nms_suppress", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/nms_pallas.py:29",
        "launches": nms_launches, "max_abs_err": max_err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None}, {
        "name": "topk_rows", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/topk_rows.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/topk_pallas.py:26",
        "launches": topk_launches, "max_abs_err": topk_err,
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": topk_recs["-cost"]["bound_ms"],
        "bound_by": topk_recs["-cost"]["bound_by"],
        "library_ms": mean("library_ms")}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
