#!/usr/bin/env python3
"""Drive the PyTorch port's YOLOX-s serving and training paths, its anchor
families (YOLOv7, YOLOv5-s, YOLOv3), its transformer backbones (Swin,
SwinV2, ViT, ViT-MoE, ResTv2, MCTformer), its mobile backbones (e-YOLOX,
CSPMobileNext, MobileNetV3-S/L, ShuffleNetV2), its deploy path (a
trained checkpoint exported and served), its several-rank paths, its extra
backbones (ConvNeXt-T, EfficientRep, ResNet-18, GhostNet, VGG, MobileNeXt)
and its attention registry, on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. device: the card's name and power limit from nvidia-smi;
  2. build: compile every CUDA kernel of the paths from `pl_yolo_tpu_torch/csrc`
     (four: NMS suppression, row top-k, mosaic warp, fused SimOTA
     assignment), and the NMS kernel cut after its IoU pass for step 9's
     phase split, all `nvcc`s at once, with ptxas's registers and spills;
  3. kernels: each kernel against its plain PyTorch version on the card (the
     NMS also on boxes with infinite and NaN coordinates, as an overflowing
     decode gives them, and on the shapes its clusters of CTAs can get
     wrong: K = 1, 65 and 525, B = 1, its capacity K = 3584, and K = 4096,
     which takes the two-launch path, the only call that may; the
     row top-k also against `torch.topk`, on the rows SimOTA sends and on
     rows a lane-split pass can get wrong: ascending, descending, all
     equal, the top k in one lane's share, odd A, k = 1..16; the mosaic
     warp in bf16 and fp32 pools, through both entries, at B=16 640^2 and
     at 2x3x72x88, with K=4 and 1 as the path calls it and K=5 and 8
     overlapping tiles; the SimOTA assignment on 11 synthetic cases, NaN
     logits and images with no or 9 candidates among them); both warp
     entries captured in a CUDA graph at B=16 640^2 and replayed, equal to
     an eager call (a host read-back in the wrapper would make the capture
     fail); and a tile index outside the pool, in a child process, ending it
     with a device-side assert;
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
  7. training with augmentation: `make_train_step` with
     `make_augment_fn(AugmentConfig(max_labels=100), out_s2d=True)` and the
     model under `stem_input_s2d()`, from uint8 images, bf16, B=16, 640^2:
     4 steps and one with `aug_enable=False`; finite losses, anchors
     assigned, two mosaic-warp and two top-k launches a step; the card's
     augmented batch against the CPU's on the same draws; the top-k kernel
     against `torch.topk` on this batch's own pair-IoU and cost (M=100);
  8. training with `loss: {pallas_assign: true}` (the fused assignment
     kernel): 4 bf16 steps as in phase 5 and 4+1 augmented steps as in phase
     7; finite losses, anchors assigned, one fused-assignment launch and no
     top-k launch a step; the kernel against its plain version and against
     the dense SimOTA on those steps' own inputs (M=50 and M=100), and the
     loss through it against the dense loss on phase 6's fp32 maps;
  9. times: infer+NMS and train images/s (with and without augmentation, at
     B=16 and B=64), the augmented step with the fused against the dense
     assignment (interleaved, with each variant's device busy time), the
     assignment alone (fused, dense, chunked), the augmentation alone, the
     train steps' split and device profiles, and each kernel's time beside
     its bound, its plain version's time and the PyTorch library call's
     (the top-k on the M=50 and M=100 inputs with the L2 cold and warm, with
     its host time a call, and inside both train steps' profiler windows),
     the phase split of the redesigned kernels (the NMS cluster kernel's
     IoU pass from its copy cut after it, the warp with every tile out of
     reach, the SimOTA passes with each image's candidates) and the
     augmentation's pool build, beside the first kernel versions' numbers,
     with the card's name and power limit;
 10. the trainer: a synthetic COCO set of 64 JPEGs (480x640, drawn
     rectangles, 80 classes) in a temporary directory, and YOLOX-s at full
     width and depth with `schedule: {no_aug_epochs: 1}`, B=16, 640^2:
     `Trainer.fit` in this process for 3 epochs of 4 steps (validation after
     the 2nd and 3rd) with the loader in its thread, the kernels' launches
     counted (2 warps and 2 top-k a step, 1 NMS a validation batch) and
     checked again in a profiler window over one augmented step and one
     validation batch, finite losses, mAP and mAP50, at most 2 checkpoints,
     and the restored step, optimizer state, EMA and BN statistics equal to
     the trained ones; beside all that, in child processes started first,
     `python -m pl_yolo_tpu_torch` with 4 loader
     workers: SIGTERM in its 2nd epoch (exit 75, a checkpoint marked
     `preempted`), `--resume` to step 12, and `--test --ckpt`, which prints
     mAP; the epoch images/s through the loader with 0 and 4 workers, the
     epoch's images/s without the loader's wait, the loader alone, the
     bare step alone and beside a decoding loader, and the validation's
     time a batch (forward + decode, postprocess, COCO evaluation);
 11. the anchor families: `yolov7.yaml` at full width and depth (E-ELAN,
     the YOLOv7 neck, the implicit head, the OTA loss), 80 classes, bf16,
     B=16, 640^2, its kernel launches counted from 0: 4 requests through
     `postprocess` (one NMS launch each; card == CPU postprocess), 4 steps
     with 50 label slots and 4+1 steps through
     `make_augment_fn(AugmentConfig(max_labels=100), out_s2d=False)` (the
     NHWC route: E-ELAN has no Focus stem), 2 top-k launches a step and 2
     warps an augmented one, finite losses with labels assigned; the top-k
     kernel bit-equal to its plain version and `torch.topk` on both steps'
     own OTA rows ([16,50,1350] and [16,100,2700]); the fp32 head maps at
     B=1, the loss and its gradients at B=2 and the NHWC augmented batch
     against the CPU's; the times (infer+NMS, both train steps with idle
     share and peak memory, the OTA assignment alone, the top-k on its rows
     cold and back to back beside its bound, plain version and
     `torch.topk`); `python -m pl_yolo_tpu_torch -c yolov7.yaml` on 32
     JPEGs for one epoch and a validation that prints mAP, in a child
     process beside the rest of the phase: `yolov5_s.yaml`: 2 augmented
     steps on the s2d route and a request; the YOLOv3 loss and gradients
     on the card against the CPU;
 12. the accuracy gate and the YOLOX trainer's options: (a) the port's
     `yolox_tiny` accuracy gate at its full recipe
     (`pl_yolo_tpu_torch.tools.accuracy_gate`: 100 epochs on 400 generated
     hard-shapes images at 160^2, B=32), its held-out mAP asserted against
     the floor 0.25 and printed beside the JAX package's line, with its wall
     time and the launches of the warp, top-k and NMS kernels over the fit;
     the fit's own calls of the three kernels, recorded at each shape they
     met (a step's pair-IoU and -cost rows [32,M,525], its mosaic and mixup
     warps of 160^2 tiles, a validation batch's NMS), run again against
     their plain versions, bit for bit;
     (b) `yolox_s_dropblock.yaml` at full width, bf16, B=16, through
     `Trainer.fit` on 128 synthetic JPEGs with `accumulate_steps: 2`,
     `remat: true` and multi-scale buckets [576^2, 704^2] every 2 steps:
     finite losses, the params unchanged after each odd micro-step and
     changed after each even one, the buckets visited at their sizes, and
     the fit's kernel calls held to their plain versions as in (a) (top-k
     rows of A = 8400, 6804 and 10164); the peak memory of the augmented
     step at 640^2 with and without `remat`;
     (c) 3 augmented steps with degrees 10, shear 2 and perspective 5e-4
     (the general-gather route, NHWC, no warp launch): finite losses, labels
     inside the canvas, the card's batch against the CPU's on the same
     draws; (d) `utils.profiler.trace` around 3 steps of (a)'s model, its
     top device ops printed, and `StepTimer`'s mean step.

 13. the transformer backbones: `swin_tiny.yaml` at full width and depth
     (Swin-T, `neck: none`, the 4-level decoupled head, strides 4-32:
     34,000 anchors an image), 80 classes, the config's bf16 (an fp32
     backbone, a bf16 head), B=16, 640^2, its kernel launches counted from
     0: 4 requests through `postprocess` at conf 1e-6 (the random head
     scores ~1e-4: the NMS takes 1024 candidates of 34,000 rows; one
     launch each; card == CPU postprocess), 4 steps with 50 label slots
     and 4+1 steps through the NHWC augmentation with 100, 2 top-k
     launches a step on [16,50,34000] / [16,100,34000] rows and 2 warps an
     augmented one, finite losses with labels assigned; the path's own kernel calls recorded and run again
     against the plain versions, bit for bit, and its top-k rows against
     `torch.topk`; the fp32 head maps at B=1 of `swin_tiny` and
     `vit_tiny_moe` and the Swin loss and its gradients at B=2, card
     against CPU; the times (infer+NMS, both train steps with idle share
     and peak memory, the top-k on its rows cold and back to back beside
     its bound, plain version and `torch.topk`, the cold time also by CUDA
     events less the flush's own); `python -m
     pl_yolo_tpu_torch -c swin_tiny.yaml` on 32 JPEGs for one epoch and a
     validation that prints mAP, in a child process while the phase goes
     on (its epoch images/s are those of a shared card); a request each,
     and 2 augmented
     steps for `vit_tiny`, `vit_tiny_moe` (its peak memory), `restv2_tiny`
     and `mctformer_small` (AdamW), of `swin_small`, `swin_base`,
     `swin_large` and SwinV2 (`swin_tiny.yaml`, backbone renamed), with
     images/s;
 14. the mobile backbones: `e-yolox_s.yaml` at full width and depth
     (ECMNet with its Focus stem, the AL-PAFPN neck with its bicubic
     upsampling, the decoupled head), 80 classes, bf16, B=16, 640^2, its
     kernel launches counted from 0: 4 requests through `postprocess` at
     conf 1e-6 (the NMS takes its full 1024 candidates; one launch each;
     card == CPU postprocess), 4 steps with 50 label slots and 4+1 steps
     through `make_augment_fn(..., out_s2d=True)` with the model under
     `stem_input_s2d()` (the s2d route) with 100, 2 top-k launches a step
     on [16,50,8400] / [16,100,8400] rows and 2 warps an augmented one,
     finite losses with labels assigned; the path's own kernel calls
     recorded and run again against the plain versions, bit for bit, and
     its top-k rows against `torch.topk`; the fp32 head maps at B=1, card
     against CPU; the times (infer+NMS, both train steps with idle share
     and peak memory; cuDNN autotuning off, as in the whole phase);
     `python -m pl_yolo_tpu_torch -c e-yolox_s.yaml` on
     32 JPEGs for one epoch and a validation that prints mAP, in a child
     process while the phase goes on; a
     request and 2 augmented steps, with images/s, of `e-yolox_tiny`,
     `_m`, `_l`, `_x` and a CSPMobileNext detector (s2d route), and of
     MobileNetV3-S, MobileNetV3-L and ShuffleNetV2 with its SE, each with
     a CSP-PAFPN neck and decoupled head as wide as its maps (NHWC route).
 15. deploy: a trained checkpoint (4 bf16 steps of `yolox_s.yaml` at full
     width, 640^2, B=16, through the trainer's step on 4 batches of scene
     images, the rectangles phase 10 draws, with their labels; saved in
     the trainer's layout: EMA weights, BN statistics) through every
     exporter of `pl_yolo_tpu_torch.deploy.export`: TorchScript (`.pt`,
     fp32, BN folded, traced on the card), the served program (`.pt2`:
     `torch.export` of forward, decode and `postprocess` in bf16 with the
     NMS as the registered operator) exported on the card, and through
     `python -m pl_yolo_tpu_torch.tools.export --device cpu` on the host
     and moved to the card; 4 requests of [16,640,640,3] scene images at
     conf 0 (all 1024 candidates valid) through each on the card, the NMS
     launches counted from 0 for each (1 a request, no other kernel); the
     `.pt2`'s own NMS calls, recorded where the operator makes them, run again
     against `suppress_plain`, bit for bit; the `.pt` against the eager
     fp32 predictions and both `.pt2` against the eager bf16 served
     function (valid and classes equal, boxes and scores within MAPS_TOL
     of their scale); the npz (numpy runtime) and ONNX (numpy ONNX
     runtime) artifacts on the host at one 256^2 image against the card's
     fp32 forward (MAPS_TOL); infer+NMS images/s of the `.pt` +
     `postprocess`, both `.pt2`, the eager fp32 and bf16 models, in turns;
     the operator's cost a call over the wrapper's; the NMS kernel's time
     on the `.pt2`'s input; each step's seconds and the phase's time.
 16. several ranks on the card (`pl_yolo_tpu_torch.parallel`): (a) two
     ranks, spawned once as children of this script (`--rank parallel`),
     over gloo by the backend rule (two ranks share the one card; what
     gloo takes through host memory is printed), train `yolox_s_zero.yaml`
     (ZeRO-1, `accumulate_steps: 2`, clip 35, the s2d augmentation of the
     global batch, 8 rows a rank) and `vit_tiny_pp2.yaml` (GPipe, 2
     stages, 2 microbatches of 8) at full width, 640^2, global batch 16:
     4 fp32 steps (TF32 off), each rank's losses and rank 0's gathered
     state and EMA against one process here from the same init on the
     same batch (PARALLEL_TOL, printed with its reason), then 2 steps in
     the YAMLs' bf16 with finite losses, images/s as two ranks sharing one
     card beside one process's (the ranks start their steps once the
     one-process references here are done, so nothing else runs on the
     card meanwhile); each rank's bytes of ZeRO state against one
     process's; one eval batch of each rank's rows through the gathered
     EMA, its predictions against one process's EMA's on those rows
     (PARALLEL_PRED_TOL), and `postprocess`; each
     rank's own calls of the warp, top-k and NMS kernels recorded and held
     to the plain versions bit for bit; (b) one rank over NCCL: a ZeRO-3
     step; (c) `torchrun --nproc-per-node 2 -m pl_yolo_tpu_torch -c
     yolox_s_zero.yaml` for one epoch and a validation on 32 JPEGs at
     320^2, beside (b) and a one-process `Trainer.fit` of the same
     configs here, whose
     checkpoint the rank-0 checkpoint's weights and EMA are held to
     (PARALLEL_CLI_TOL of the change from the init), then the rank-0
     checkpoint validated by that `Trainer` to the mAP the two ranks
     printed; the phase's time.
 17. tensor, spatial and expert parallelism on the card: four ranks,
     spawned once as children of this script (`--rank tpsp`), over gloo
     on the one card, train (a) `yolox_s_tp2sp2.yaml` (model 2 x spatial
     2, data 1: each rank its cout slices of the convs and its band of
     rows of every map, with the halo exchanges) and (b) `vit_tiny_moe`
     with `parallel: {expert: 2}` set in its dict (data 2 x expert 2, the
     capacity as shipped) at 640^2 on a global batch of 8: 3 (a) and 2
     (b) fp32 steps (TF32 off), each rank's losses and rank 0's gathered
     state and EMA against one process here from the same init on the
     same batch (phase 16's bounds), then 2 bf16 steps of (a), timed, as
     four ranks sharing one card beside one process; one validation batch
     of (a) through the gathered EMA on every rank, its predictions
     against one process's EMA's (PARALLEL_PRED_TOL); the two phases
     share their spawn, runs table (`RANK_RUNS`) and checks; each rank's
     held parameter, moment and EMA bytes
     against one process's; each rank's own calls of the warp, top-k and
     NMS kernels recorded and held to the plain versions bit for bit; a
     rank's staged collective counts; the phase's time.
 18. the extra backbones and the attention registry, cuDNN autotuning
     off, TF32 off: (a) ConvNeXt-T (the JAX defaults, depths 3,3,9,3,
     widths 96-768, fp32 whatever the config's dtype) in
     `yolox_m.yaml`'s place of CSPDarknet (its neck and head as wide as
     ConvNeXt-T's stage2-4 maps, bf16), 80 classes, B=16, 640^2, its
     kernel launches counted from 0: 4 requests through `postprocess` at
     conf 1e-6 (card == CPU postprocess), 4 steps with 50 label slots and
     4+1 steps through the NHWC augmentation with 100, 2 top-k launches a
     step on [16,50,8400] / [16,100,8400] rows and 2 warps an augmented
     one; the path's own kernel calls held to the plain versions bit for
     bit and its top-k rows to `torch.topk`; the fp32 head maps at B=1,
     card against CPU; infer+NMS and both train steps' images/s with idle
     share and peak memory; `python -m pl_yolo_tpu_torch -c` on that
     config (written to a temporary file) for one epoch on 32 JPEGs and a
     validation, in a child process beside (b) and (c); (b) EfficientRep,
     ResNet-18, GhostNet-1.0, VGG and
     MobileNeXt at the JAX defaults in `yolox_s.yaml`'s place of
     CSPDarknet (a CSP-PAFPN neck of depths 1,1,1,1 and a decoupled head
     at their stage widths): their BN statistics from one batch
     (`calibrate_bn_`), a request and 2 augmented steps each, their
     kernel calls held to the plain versions bit for bit; (c) every
     `ATTENTION` entry on a seeded [4,20,20,256] map with seeded weights,
     card against CPU in fp32: the output, the input's and every
     parameter's gradient within ATTN_TOL of their scale (EPSA's conv1
     weight gradient within ATTN_TOL_CUDNN, with its readings in float64,
     with the deterministic algorithms and without cuDNN), the worst
     printed with its module; the phase's time.
 19. the combinations of the parallel axes of ROADMAP item 12c, parts 1-3,
     on the card: four ranks, spawned once as children of this script
     (`--rank combos`), over gloo on the one card, at 640^2 on a global
     batch of 8, with `parallel:` (and, for (c), `remat: true`) set in
     each config's dict: (a) `yolox_s_zero.yaml` with {zero: 3, model: 2}
     (data 2 x model 2: each rank its data part of its cout slice of
     every sharded kernel, accumulate 2, clip 35), 3 fp32 steps, then 2
     bf16 steps timed; (b) `yolox_s_zero.yaml` with {zero: true, spatial:
     2} (data 2 x spatial 2), (c) `yolox_s_dropblock.yaml` with remat and
     {model: 2, spatial: 2} (DropBlock drawn on the whole map, kept on
     the band), (d) `yolox_nano.yaml` (depthwise) with {model: 2} (data 2
     x model 2, each rank its cout slice of whole groups), (e)
     `vit_tiny_moe.yaml` with {expert: 2, zero: true} (data 2 x expert
     2), 2 fp32 steps each; each run's losses and rank 0's gathered state
     and EMA against one process here from the same init on the same
     batch (phase 16's bounds), a validation batch of each YOLOX run
     through the gathered EMA on every rank (PARALLEL_PRED_TOL); each
     rank's held parameter, moment and EMA bytes against one process's,
     (a)'s at most COMBO_BYTES_SHARE of it; each rank's own calls of the
     warp, top-k and NMS kernels recorded and held to the plain versions
     bit for bit; the phase's time. In the same spawn, item 12c.4 part 1:
     (f) `yolov7_tiny.yaml` (E-ELAN, the YOLOv7 neck, the implicit head
     with its priors sliced on C, the OTA loss on the top-k kernel), 3
     fp32 steps and a validation batch through the gathered EMA with NMS,
     (g) `e-yolox_s.yaml` (ECMNet's depthwise convs, AL-PAFPN's bicubic
     upsampling on bands) and (h) `yolov5_s.yaml` (the simple head), 2
     fp32 steps each, all three at their published widths with {model:
     2, spatial: 2}, held as (a)-(e) are; each run's own launches on
     every rank (the warp in each, the top-k and NMS in (f)), and the
     runs' seconds on the ranks and here.

The anchor-family gates (`--model yolov7_tiny|yolov5_s --autoanchor`, 200
epochs each) run through the gate's own command, not here: with them the
script would take ~15 minutes. The script's total wall time is printed
before the card's line. The line
before the last is the `kernels` JSON record (the top-k kernel three
times: on the YOLOX path's rows, on the YOLOv7 OTA's and on the Swin
path's; the four kernels' `launches` add the e-YOLOX path's to the
YOLOX path's, which `launches_e_yolox_s` gives alone, and the deploy
path's, which `launches_deploy` gives alone, with the kernel's times on
the `.pt2`'s input as `ms_deploy`, `plain_ms_deploy`, `bound_ms_deploy`,
and phase 16's, which `launches_parallel` gives alone, and phase 17's,
which `launches_tpsp` gives alone, and the ConvNeXt path's of phase 18,
which `launches_extras` gives alone, and phase 19's, which
`launches_combos` gives alone, of which its runs (f)-(h)'s
`launches_families` gives alone),
and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result where no CUDA card is available.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "pl_yolo_tpu_torch" / "configs" / "model" / "yolox_s.yaml"
BATCH, SIZE, NUM_CLASSES, REQUESTS = 16, 640, 80, 4
TRAIN_STEPS, MAX_LABELS, BOXES_PER_IMAGE, TOTAL_STEPS = 4, 50, 8, 1000
TOPK_K = 10  # SimOTA's k, for both of a step's launches
MAX_K = 16  # the top-k kernel's largest k
# a buffer this large (2.5x the H100's 50 MB L2) is written before each
# launch timed "L2 cold", so that the launch finds none of its input there
L2_FLUSH_BYTES = 128 << 20
AUG_STEPS, AUG_MAX_LABELS = 4, 100  # the augmented steps, as bench.py's
# the card's augmented batch vs the CPU's from the same draws and inputs:
# the label math (3x3 products, divisions) may round differently by an ulp,
# so a coordinate may move by ~1e-4 px; a pixel then moves by at most one
# bf16 step (2 grey levels at 128..255) before HSV, which can double it
AUG_LABEL_TOL = 1e-3  # px, on every label entry, with the same valid rows
AUG_PIXEL_TOL = (8.0, 0.05)  # grey levels: max and mean |card - cpu|
CONF, IOU, PRE_NMS_TOPK, MAX_DET = 0.01, 0.65, 1024, 300
CONF_TRAINED = 1e-6  # the request after the train steps; the Swin path
# H100 SXM published peaks (NVIDIA data sheet, dense): non-tensor fp32 and HBM3
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# fp32 ops per box pair in the NMS IoU pass (csrc/nms_suppress.cu note)
NMS_OPS_PER_PAIR = 14
# card fp32 (cuDNN, TF32 off) vs CPU fp32 head maps: the sums run in another
# order, and cuDNN may pick Winograd/FFT algorithms, through ~70 convs
# (YOLOX-s) or ~110 (YOLOv7, whose implicit head then runs in fp32 in both
# precisions)
MAPS_TOL = 1e-3  # on max |card - cpu| / max(1, max |cpu|)
# the loss on the card vs the CPU from the same fp32 head maps: the same
# formulas, sums over 8400 anchors in another order, exp/log of two libraries
LOSS_TOL = 1e-5  # relative, on each loss entry and on max |grad| per map
# the fused SimOTA kernel vs the dense path on the same inputs: S and the
# top-10 IoU sum are added in another order, which can flip an exact tie
# (the JAX package's own bound for its fused kernel, tests/test_simota_pallas)
SIMOTA_FG_AGREE = 0.999
# fp32 operations the assignment needs, counted from the formulas with a
# transcendental as one: per (anchor, class) term of S (sigmoid 4, product,
# sqrt, clip 2, log1p and its negation, sum: 11); per (valid label, anchor)
# pair (gates 20, IoU 13, cls cost 13, IoU cost 5, penalties 2, ranking 2)
SIMOTA_OPS_PER_CLASS_TERM, SIMOTA_OPS_PER_PAIR = 11, 55
# the first versions of the two redesigned kernels (one thread a pixel; three
# SimOTA passes over all anchors) on the main path's inputs, measured by
# this script on an NVIDIA H100 80GB HBM3 at 700 W and printed beside this
# run's: device us and CUDA-event us a call
FIRST_WARP_US = {"mosaic (K=4)": (113.34, 262.01),
                 "mixup (K=1)": (69.05, 129.68)}
FIRST_GRID_SAMPLE_US = 82.23
FIRST_SIMOTA_US = {"M=50 un-augmented step": (122.52, 140.97,
                                            "anchor 51.00, label 51.51, "
                                            "assign 20.01"),
                 "M=100 augmented step": (197.93, 222.57,
                                          "anchor 54.64, label 97.26, "
                                          "assign 46.04")}
SIMOTA_PASSES = ("anchor", "label", "label_merge", "assign")
# a bias after 4 SGD steps vs the same steps redone by hand from its
# recorded gradients: fp32 rounding of a few multiply-adds
UPDATE_TOL = 1e-5  # on max |change - by hand| / max |change|
# phase 10: the trainer on JPEGs through the loader, 4 steps an epoch
TRAINER_IMAGES, TRAINER_EPOCHS, JPEG_HW = 64, 3, (480, 640)
TRAINER_STEPS = TRAINER_EPOCHS * TRAINER_IMAGES // BATCH
STEP_SPLIT_STEPS = 4  # a timing of the bare step beside a busy loader
# phase 11: the anchor families, YOLOv7 at full width and depth
V7_CONFIG = ROOT / "pl_yolo_tpu_torch" / "configs" / "model" / "yolov7.yaml"
V5_CONFIG = ROOT / "pl_yolo_tpu_torch" / "configs" / "model" / "yolov5_s.yaml"
ANCHOR_CLI_IMAGES = 32  # 2 steps at B=16, then a validation
# phase 12: the port's accuracy gate and the YOLOX trainer's options
GATE_MODEL = "yolox_tiny"
# the JAX package's gate lines (GATE_RESULTS.jsonl lines 3, 14 and 13:
# 100 epochs; 200 with autoanchor), mAP and mAP50, printed beside the port's
JAX_GATE = {"yolox_tiny": (0.3368, 0.5438), "yolov7_tiny": (0.141, 0.2701),
            "yolov5_s": (0.2899, 0.4564)}
GATE_KERNELS = ("mosaic_warp", "topk_rows", "nms_suppress")
# where the YOLOX path calls each of them (the module and the name it calls
# the wrapper by), and how many calls of one shape phase 12 records there:
# a step's pair-IoU and -cost rows share one
PATH_CALL_SITES = {"topk_rows": ("pl_yolo_tpu_torch.ops.topk", 2),
                   "mosaic_warp": ("pl_yolo_tpu_torch.ops.mosaic", 1),
                   "nms_suppress": ("pl_yolo_tpu_torch.ops.nms", 1)}
OPTIONS_CONFIG = (ROOT / "pl_yolo_tpu_torch" / "configs" / "model"
                  / "yolox_s_dropblock.yaml")
OPTIONS_IMAGES = 128  # 8 micro-steps at B=16: 4 updates of accumulate_steps 2
MULTISCALE_SIZES, MULTISCALE_INTERVAL = [[576, 576], [704, 704]], 2
# the trainer's seed there: its bucket draws, every 2 steps from
# default_rng(seed + 7), visit all three buckets in 8 steps (base, 704, 576)
OPTIONS_SEED = 4
GENERAL_AUG = dict(degrees=10.0, shear=2.0, perspective=0.0005)
GENERAL_STEPS, GENERAL_CHECK_BATCH = 3, 4
PROFILE_STEPS, MEMORY_STEPS = 3, 2
# phase 13: the transformer backbones, Swin-T on the YOLOX path at full size
MODEL_DIR = ROOT / "pl_yolo_tpu_torch" / "configs" / "model"
OTHER_AUG_STEPS = 2  # the ViT, ViT-MoE, ResTv2 and MCTformer detectors
# phase 14: the mobile backbones, e-YOLOX-s on the YOLOX path at full size
E_YOLOX_CONFIG = MODEL_DIR / "e-yolox_s.yaml"
# (name, backbone section, stage2-4 widths) of the NHWC-route detectors
MOBILE_NHWC = (("mobilenetv3s", {"name": "mobilenetv3s"}, (24, 48, 96)),
               ("mobilenetv3l", {"name": "mobilenetv3l"}, (40, 80, 160)),
               ("shufflenetv2 with its SE",
                {"name": "shufflenetv2", "use_se": True}, (104, 208, 416)))
# phase 15: deploy, from a checkpoint of DEPLOY_STEPS steps, one on each of
# DEPLOY_BATCHES batches of scene images. Phase 10's fit checkpoint (12
# steps at its horizon of 12) is degenerate: its eval maps are so large
# that its decode overflows exp and fp32 rounding alone moves its scores;
# after more steps in the warm-up the running BN statistics also trail
# the weights until the eval maps overflow. At conf 0 every candidate is
# valid: the NMS takes its full 1024
DEPLOY_STEPS = DEPLOY_BATCHES = 4
DEPLOY_CONF = 0.0
DEPLOY_HOST_SIZE = 256  # the npz and ONNX runtimes' image, on the host
DEPLOY_ROUNDS = 3  # the serving routes timed in turns
# phase 16: several ranks on the one card. Two ranks, spawned once, train
# yolox_s_zero (ZeRO-1, accumulate 2, clip 35, augmented, 8 rows a rank)
# and vit_tiny_pp2 (GPipe, 2 stages of 6 blocks, M = 2 microbatches of 8)
# at 640^2 on a global batch of 16, in fp32 (TF32 off) against one process
# here from the same init on the same batch, then in their bf16
PARALLEL_RANKS, PARALLEL_STEPS, PARALLEL_BF16_STEPS = 2, 4, 2
# fp32, two ranks against one process: the same function, but the convs
# and matmuls see 8 rows (or 8-row microbatches) where one process sees
# 16, so cuDNN and cuBLAS may pick other algorithms and sum in another
# order, and BatchNorm's statistics are all-reduced partial sums: ~1e-6 of
# a map's scale a layer, which 4 steps through ~70 BN layers carry into
# the parameters. So each parameter's change since the init is held to
# PARALLEL_TOL of that change (at least 1e-3 of the largest change), and
# each logged loss to PARALLEL_LOSS_TOL relative; a wrong normaliser, a
# wrong sum or mean of the gradients or a wrong augmentation partner moves
# them by O(1) of the change
PARALLEL_TOL, PARALLEL_LOSS_TOL = 2e-2, 1e-3
PARALLEL_CLI_IMAGES, PARALLEL_CLI_SIZE = 32, 320  # torchrun: 2 steps of 16
# the torchrun fit's rank-0 checkpoint against a one-process fit, both in
# the YAML's bf16: |got - want| / |want - init| over the whole module (or
# EMA) tree. bf16 convs on 8 rows and on 16 sum apart (~1e-2 of the
# change); a stale or untrained checkpoint is 1, averaged instead of
# summed gradients 0.5
PARALLEL_CLI_TOL = 0.1
# phase 17: tensor, spatial and expert parallelism on the one card. Four
# ranks, spawned once, train (a) yolox_s_tp2sp2 (model 2 x spatial 2, data
# 1: each rank its cout slices and its band of rows of the 8 images) and
# (b) vit_tiny_moe with `parallel: {expert: 2}` set in its dict (data 2 x
# expert 2, its experts' capacity as shipped) at 640^2 on a global batch
# of 8, in fp32 (TF32 off) against one process here from the same init on
# the same batch, to phase 16's bounds; then (a) in its bf16, timed, and a
# validation batch through the gathered EMA
TPSP_RANKS, TPSP_BATCH, TPSP_STEPS, TPSP_BF16_STEPS, EP_STEPS = 4, 8, 3, 2, 2
# the multi-rank runs of phases 16, 17 and 19, {tag: (phase, ranks,
# global batch, [(config or run label, `parallel:` set in its dict or
# None, fp32 steps, bf16 steps)])}; each run's layout comes from its
# `parallel:`
# phase 19: the combinations of the parallel axes of ROADMAP item 12c,
# parts 1-3, on four ranks sharing the card, global batch 8, 640^2, each
# against one process from the same init on the same batch to phase 16's
# bounds: (a) ZeRO-3 over model slices, (b) ZeRO-1 over bands, (c) remat
# and DropBlock on bands of cout-sharded convs, (d) depthwise convs under
# the model axis (yolox_nano at its published widths), (e) ZeRO-1 over
# expert slices; (a) then in its bf16, timed; and item 12c.4 part 1, the
# conv families beyond YOLOX at their published widths under model 2 x
# spatial 2: (f) yolov7_tiny (E-ELAN, the YOLOv7 neck, the implicit head,
# the OTA loss on the top-k kernel), 3 steps and a validation batch
# through the gathered EMA with NMS, (g) e-yolox_s (ECMNet, AL-PAFPN's
# bicubic upsampling on bands) and (h) yolov5_s (the simple head), 2
# steps each
COMBO_STEPS = 2
FAMILY_RUNS = ("yolov7_tiny", "e-yolox_s", "yolov5_s")
# the runs other than YOLOX's whose eval predictions are held too
EVAL_RUNS = ("yolov7_tiny",)
# a run's label -> (its model YAML, top-level keys set in its dict); a
# label that is no key is its YAML's name
RUN_CONFIGS = {"yolox_s_zero3_model2": ("yolox_s_zero", {}),
               "yolox_s_zero1_spatial2": ("yolox_s_zero", {}),
               "yolox_s_dropblock_remat": ("yolox_s_dropblock",
                                           {"remat": True}),
               "vit_tiny_moe_zero1": ("vit_tiny_moe", {})}
# (a) holds at most this share of one process's params, moments and EMA
# on each rank: ZeRO's half of a model slice's half, and half of the
# tensors no slice takes
COMBO_BYTES_SHARE = 0.35
RANK_RUNS = {
    "parallel": (16, PARALLEL_RANKS, BATCH, [
        ("yolox_s_zero", None, PARALLEL_STEPS, PARALLEL_BF16_STEPS),
        ("vit_tiny_pp2", None, PARALLEL_STEPS, PARALLEL_BF16_STEPS)]),
    "tpsp": (17, TPSP_RANKS, TPSP_BATCH, [
        ("yolox_s_tp2sp2", None, TPSP_STEPS, TPSP_BF16_STEPS),
        ("vit_tiny_moe", {"expert": 2}, EP_STEPS, 0)]),
    "combos": (19, TPSP_RANKS, TPSP_BATCH, [
        ("yolox_s_zero3_model2", {"zero": 3, "model": 2}, TPSP_STEPS,
         TPSP_BF16_STEPS),
        ("yolox_s_zero1_spatial2", {"zero": True, "spatial": 2},
         COMBO_STEPS, 0),
        ("yolox_s_dropblock_remat", {"model": 2, "spatial": 2},
         COMBO_STEPS, 0),
        ("yolox_nano", {"model": 2}, COMBO_STEPS, 0),
        ("vit_tiny_moe_zero1", {"expert": 2, "zero": True}, COMBO_STEPS,
         0),
        ("yolov7_tiny", {"model": 2, "spatial": 2}, TPSP_STEPS, 0),
        ("e-yolox_s", {"model": 2, "spatial": 2}, COMBO_STEPS, 0),
        ("yolov5_s", {"model": 2, "spatial": 2}, COMBO_STEPS, 0)]),
}
# the eval predictions of a YOLOX run's rows through the ranks' gathered
# EMA against one process's EMA's, fp32: |got - want| over the largest
# |want|, the boxes and the scores each. The weights agree to
# PARALLEL_TOL of a few small steps' change, which moves the predictions
# by far less; a gather that puts a slice or a shard in the wrong place
# moves them by O(1)
PARALLEL_PRED_TOL = 1e-3
# phase 18: the extra backbones, ConvNeXt-T on the YOLOX path at full width
# (yolox_m.yaml's neck and head, as wide as ConvNeXt-T's stage2-4 maps,
# 192/384/768), the other five at the JAX defaults with a CSP-PAFPN neck
# and a decoupled head at their stage widths, and the attention registry
CONVNEXT_BACKBONE = {"name": "convnext",
                     "outputs": ["stage2", "stage3", "stage4"]}
EXTRAS_OTHER = (("efficientrep", (64, 128, 256)), ("resnet", (128, 256, 512)),
                ("ghostnet", (40, 112, 160)), ("vgg", (256, 512, 512)),
                ("mobilenext", (128, 256, 512)))
# every ATTENTION entry on a stride-32 map of a 640 px image, fp32, card
# (TF32 off) against CPU: forward, input gradient, parameter gradients.
# Matmuls, convs, softmaxes and FFTs sum in another order on each side:
# every tensor sat within 7.1e-5 of its scale but one (on an NVIDIA H100
# 80GB HBM3 at 700 W, `chip_attn_bound.py`). That one is EPSA's 5x5 conv1
# weight gradient, 3.01e-3 from the CPU's fp32 and from the float64 value
# alike, with cuDNN's deterministic algorithm too, where the card's
# float64 is within 1e-15 of the CPU's: the fp32 arithmetic of cuDNN's
# weight gradient on that shape, not the module (`epsa_conv1_readings`,
# printed in each run, also gives it without cuDNN). It alone is held to
# ATTN_TOL_CUDNN. A gradient's scale has a floor of 1e-2 of its module's
# largest gradient (one zero in exact arithmetic is rounding noise:
# tests/test_torch_attention.py). A fault on one device moves a tensor
# O(1) of its scale.
ATTN_SHAPE = (4, 20, 20, 256)
ATTN_TOL = 1e-3  # on max |card - cpu| / scale, each tensor
ATTN_TOL_CUDNN = {("epsa", "conv1.weight gradient"): 1e-2}
# ACmix's shift path reads C/heads of its 3·heads mixed maps: at C = 256 it
# needs 16 heads (the JAX module fails at the default 4 there too)
ATTN_KWARGS = {"acmix": {"heads": 16}}
EPOCH_LINE = re.compile(r"^epoch (\d+): ([\d.]+)s \(([\d.]+) img/s\) "
                        r"loss=(\S+); ([\d.]+) img/s without the ([\d.]+)s")


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


def ptxas_summary(log: str) -> str:
    """ptxas's `-v` report of one source (`build.LOGS`) in a line."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    stack = [int(b) for b in re.findall(r"(\d+) bytes stack frame", log)]
    spill = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers a "
            f"thread, stack frames up to {max(stack, default=0)} B, spill "
            f"stores + loads up to {max(spill, default=0)} B")


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


def device_profile(torch, fn, iters: int, top: int | None = 14):
    """Device time per call of `fn` from a torch.profiler trace: the busy
    ms (sum of kernel self times) and the `top` kernels by time (None:
    all)."""
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


def kernel_device_ms(torch, fn, names, iters: int = 20, traces: int = 3):
    """{name: device ms a call} of the kernels whose names contain `names`,
    the mean over `traces` profiler traces of `iters` calls each; the trace
    on the chip machine sometimes drops a kernel, so a name counts only the
    traces that hold it, and is None if none does."""
    found = {n: [] for n in names}
    for _ in range(traces):
        _, kernels = device_profile(torch, fn, iters, None)
        for n in names:
            ms = next((ms for k, ms in kernels if n in k), None)
            if ms is not None:
                found[n].append(ms)
    return {n: sum(v) / len(v) if v else None for n, v in found.items()}


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
    # a decode whose exp overflowed: boxes of infinite width or height,
    # and NaN coordinates; an inf - inf union must suppress nothing
    boxes, valid = rand_boxes(2, 256, 4)
    boxes[:, ::4, 0], boxes[:, ::4, 2] = -math.inf, math.inf
    boxes[:, 1::8, 3] = math.inf
    boxes[:, 2::16, 1] = math.nan
    cases.append(("non-finite coordinates", boxes, valid, IOU))
    # the shapes a cluster of CTAs can get wrong: one box; a ragged block
    # and a block count that is not a multiple of 8 (K=65: two blocks, six
    # CTAs own none); the 160 px gate's candidates; one image; the cluster
    # kernel's capacity; and one K above it, which takes the two launches
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import CLUSTER_MAX_K
    for name, b, k in (("K=1", BATCH, 1), ("K=65", BATCH, 65),
                       ("K=525, the 160 px gate's candidates", BATCH, 525),
                       ("B=1", 1, PRE_NMS_TOPK),
                       (f"K={CLUSTER_MAX_K}, the cluster kernel's capacity",
                        2, CLUSTER_MAX_K),
                       ("K=4096, the two-launch path", 2, 4096)):
        boxes, valid = rand_boxes(b, k, 4)
        cases.append((name, boxes, valid, IOU))
    return [(n, b.to(dev), v.to(dev), t) for n, b, v, t in cases]


def nms_record(torch, boxes, valid) -> dict:
    """The NMS kernel on one input at IOU: its time and its plain version's
    by CUDA events, and its bound (14 fp32 operations a valid pair, or the
    bytes of boxes and valid in and alive out)."""
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import (nms_suppress,
                                                         suppress_plain)
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
    # rows that a pass split over lanes, with a running list each, can get
    # wrong: every value inserting, none after the first, k copies spread
    # over every lane, the whole top k in one lane's share (16-byte chunks
    # 1536 entries apart fall to thread 0 at 32, 64, 96 or 128 threads a
    # row) and row starts off 16-byte alignment
    up = (torch.arange(a, dtype=torch.float32)[None, :]
          + torch.arange(rows, dtype=torch.float32)[:, None])
    cases.append(("ascending rows", up, TOPK_K))
    cases.append(("descending rows", up.flip(-1), TOPK_K))
    same = torch.randn((rows, 1), generator=g).expand(rows, a)
    cases.append(("all-equal rows", same.contiguous(), MAX_K))
    one = torch.randn((rows, a), generator=g)
    lane0 = (1536 * torch.arange(4)[:, None] + torch.arange(4)).flatten()
    one[:, lane0] = 10.0 + torch.rand((rows, MAX_K), generator=g)
    cases.append(("top 16 in one lane's share", one, MAX_K))
    cases.append(("top 10 of 16 in one lane's share", one, TOPK_K))
    for odd in (a - 1, 2101):
        cases.append((f"A={odd} (misaligned row starts)",
                      torch.randn((rows, odd), generator=g), TOPK_K))
    cases.extend((f"random k={k}", x, k) for k in range(2, MAX_K)
                 if k != TOPK_K)
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


def bench_images(torch, dev, batch, seed=0):
    """[batch, 640, 640, 3] uint8 images drawn as `bench.py` draws them
    (uniform 0..255), cast to uint8 as a decoded image would be."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 255, (batch, SIZE, SIZE, 3)
                                        ).astype(np.uint8)).to(dev)


def mosaic_geometry_case(torch, g, kind, b, h, w):
    """(tidx, ox, oy, xs, ys) of a K=4 mosaic warp in window coordinates,
    drawn as the augmentation draws them, then bent to `kind`."""
    perm = torch.randperm(b, generator=g)
    tidx = torch.stack([torch.arange(b)] + [torch.roll(perm, -i)
                                            for i in (1, 2, 3)], 1)
    cx = torch.randint(w // 2, 3 * w // 2 + 1, (b,), generator=g)
    cy = torch.randint(h // 2, 3 * h // 2 + 1, (b,), generator=g)
    if kind == "centres at the window's edges":   # tiles half outside
        cx = torch.where(torch.arange(b) % 2 == 0, w // 2, 3 * w // 2)
        cy = torch.where(torch.arange(b) % 3 == 0, h // 2, 3 * h // 2)
    ox = torch.stack([cx - w, cx, cx - w, cx], 1)
    oy = torch.stack([cy - h, cy - h, cy, cy], 1)
    scale = {"scale 0.1": 0.1, "scale 2.0": 2.0}.get(kind)
    s = (torch.full((b, 1), scale) if scale
         else torch.rand((b, 1), generator=g) + 0.5)
    tx = (torch.rand((b, 1), generator=g) * 0.2 + 0.4) * w
    ty = (torch.rand((b, 1), generator=g) * 0.2 + 0.4) * h
    xs = (torch.arange(w)[None] - tx) / s + w
    ys = (torch.arange(h)[None] - ty) / s + h
    if kind == "flipped":
        xs = xs.flip(-1)
    if kind == "outside the window":  # left, right, inside; no row at all
        xs = xs + torch.tensor([-2.5 * w, 0.6 * w, 0.0]).repeat(b)[:b, None]
        ys = ys - torch.tensor([0.0, 0.0, 4.0 * h]).repeat(b)[:b, None]
    return tidx, ox, oy, xs, ys


def mixup_geometry_case(torch, g, kind, b, h, w):
    """(idx, xs, ys) of a K=1 mixup warp: scale f, crop, flip."""
    f = {"scale 0.5": 0.5, "scale 1.5": 1.5}.get(kind)
    f = torch.full((b, 1), f) if f else torch.rand((b, 1), generator=g) + 0.5
    xo = torch.rand((b, 1), generator=g) * torch.clamp(w * f - w, min=0)
    yo = torch.rand((b, 1), generator=g) * torch.clamp(h * f - h, min=0)
    xs = (torch.arange(w)[None] + xo + 0.5) / f - 0.5
    ys = (torch.arange(h)[None] + yo + 0.5) / f - 0.5
    if kind == "flipped":
        xs = torch.where(torch.arange(b)[:, None] % 2 == 0, xs.flip(-1), xs)
    if kind == "outside the window":
        xs = xs + torch.tensor([-0.5 * w, 0.5 * w, 2.0 * w]).repeat(b)[:b, None]
    return torch.randperm(b, generator=g), xs, ys


def many_tiles_case(torch, g, k, b, h, w):
    """(tidx, ox, oy, xs, ys) of a warp of k > 4 overlapping tiles (the
    kernel stages the taps of 4 tiles at a time): a K=4 mosaic plus tiles
    shifted by thirds of a tile."""
    tidx, ox, oy, xs, ys = mosaic_geometry_case(torch, g, "overlapping", b,
                                                h, w)
    more = range(1, (k + 3) // 4)
    tidx = torch.cat([tidx, *(torch.roll(tidx, i, 1) for i in more)], 1)
    ox = torch.cat([ox, *(ox + i * w // 3 for i in more)], 1)
    oy = torch.cat([oy, *(oy + i * h // 3 for i in more)], 1)
    return tidx[:, :k], ox[:, :k], oy[:, :k], xs, ys


MOSAIC_KINDS = ("scale 0.1", "scale 2.0", "centres at the window's edges",
                "flipped", "outside the window")
MIXUP_KINDS = ("scale 0.5", "scale 1.5", "flipped", "outside the window")


def warp_cases(torch, dev):
    """(name, entry, args, plain args) of the mosaic-warp checks on the card:
    both entries, bf16 and fp32 pools, the main path's B=16 640^2 and an odd
    small 2x3x72x88; K=4 and 1 as the path calls them, and K=5 and 8."""
    from pl_yolo_tpu_torch.ops.mosaic import FILL
    g = torch.Generator().manual_seed(13)
    cases = []
    for b, h, w in ((BATCH, SIZE, SIZE), (2, 72, 88)):
        pool32 = torch.rand((b, 3, h, w), generator=g) * 255
        for dtype in (torch.bfloat16, torch.float32):
            pool = pool32.to(dtype).to(dev)
            what = f"{str(dtype)[6:]} {b}x3x{h}x{w}"
            for kind in MOSAIC_KINDS:
                tidx, ox, oy, xs, ys = (t.to(dev) for t in mosaic_geometry_case(
                    torch, g, kind, b, h, w))
                cases.append((f"mosaic K=4, {kind}, {what}", "mosaic",
                              (pool, tidx, ox, oy, xs, ys),
                              (pool, tidx, ox, oy, xs, ys, 2 * w, 2 * h,
                               FILL)))
            for k in (5, 8):  # more than one group of staged taps
                tidx, ox, oy, xs, ys = (t.to(dev) for t in many_tiles_case(
                    torch, g, k, b, h, w))
                cases.append((f"mosaic K={k}, overlapping tiles, {what}",
                              "mosaic", (pool, tidx, ox, oy, xs, ys),
                              (pool, tidx, ox, oy, xs, ys, 2 * w, 2 * h,
                               FILL)))
            for kind in MIXUP_KINDS:
                idx, xs, ys = (t.to(dev) for t in mixup_geometry_case(
                    torch, g, kind, b, h, w))
                zeros = torch.zeros((b, 1), dtype=torch.int32, device=dev)
                cases.append((f"mixup K=1, {kind}, {what}", "mixup",
                              (pool, idx, xs, ys),
                              (pool, idx[:, None], zeros, zeros, xs, ys, w, h,
                               0.0)))
    return cases


def warp_bound(torch, pool, tidx, ox, oy, xs, ys, hix, hiy):
    """The least ms the card could take for one warp, and what bounds it:
    the output written once plus every distinct source texel that carries a
    non-zero weight read once, over the memory rate; ~9 fp32 operations per
    channel per (pixel, covering tile), over the fp32 rate."""
    from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import _taps
    n, _, h, w = pool.shape
    b, nk = tidx.shape
    y0, y1, wy0, wy1, _ = _taps(ys.float(), oy, h, hiy)
    x0, x1, wx0, wx1, _ = _taps(xs.float(), ox, w, hix)

    def used(i0, i1, w0, w1, size):
        m = torch.zeros((b, nk, size), dtype=torch.int32, device=pool.device)
        m.scatter_add_(2, i0, (w0 != 0).int())
        m.scatter_add_(2, i1, (w1 != 0).int())
        return m > 0

    rows, cols = used(y0, y1, wy0, wy1, h), used(x0, x1, wx0, wx1, w)
    touched = (rows[..., :, None] & cols[..., None, :]).reshape(-1, h, w)
    per_image = torch.zeros((n, h, w), device=pool.device).index_add_(
        0, tidx.reshape(-1).long(), touched.float())
    texels = int((per_image > 0).sum())
    pairs = float((((wy0 != 0) | (wy1 != 0)).sum(-1).double()
                   * ((wx0 != 0) | (wx1 != 0)).sum(-1).double()).sum())
    esize = pool.element_size()
    bound = {"bytes": (b * 3 * h * w + texels * 3) * esize / PEAK_BYTES * 1e3,
             "operations": 9.0 * 3 * pairs / PEAK_FP32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    return bound[bound_by], bound_by, texels


# the warp's phase split, by its inputs: the same call with every tile's
# origin moved out of reach computes all the taps and writes the fill but
# reads no texel (every tile weighs 0 on every block and is skipped); the
# call as made adds the loads and their sums
WARP_SPLIT = ("taps + stores", "full kernel")


def warp_step_calls(torch, aug_fn, gen, images, labels):
    """The (args, kwargs) of the two `mosaic_warp` calls (mosaic K=4, mixup
    K=1) that one run of the augmentation makes, recorded as it makes them."""
    from pl_yolo_tpu_torch.ops import mosaic as mosaic_module
    warp = mosaic_module.mosaic_warp
    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return warp(*args, **kw)

    mosaic_module.mosaic_warp = recording
    try:
        aug_fn(gen, images, labels)
    finally:
        mosaic_module.mosaic_warp = warp
    return calls


def warp_split(torch, calls, iters=20):
    """{call index: {split name: device ms a call}} of the warp kernel on
    the recorded calls (WARP_SPLIT), from the profiler."""
    from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp
    out = {}
    for i, (args, kw) in enumerate(calls):
        pool, tidx, *_, xs, ys = args
        away = (torch.full(tidx.shape, kw["hix"] + 1, dtype=torch.int32,
                           device=tidx.device),
                torch.full(tidx.shape, kw["hiy"] + 1, dtype=torch.int32,
                           device=tidx.device))
        variants = {"taps + stores": (pool, tidx, *away, xs, ys),
                    "full kernel": args}
        out[i] = {name: kernel_device_ms(
            torch, lambda a=variants[name]: mosaic_warp(*a, **kw),
            ("mosaic_warp_kernel",), iters)["mosaic_warp_kernel"]
            for name in WARP_SPLIT}
    return out


def with_origins(torch, args):
    """A warp call's positional args with zero origins where the call has
    none (the K=1 entry), as `warp_plain` and the bound take them."""
    pool, tidx, ox, oy, *rest = args
    if ox is None:
        ox = oy = torch.zeros(tidx.shape, dtype=torch.int32,
                              device=tidx.device)
    return (pool, tidx, ox, oy, *rest)


def graph_replay_equal(torch, entry, args):
    """Capture one call of `entry(*args)` in a CUDA graph, replay it, and
    compare the replay's output with an eager call's, bit for bit."""
    eager = entry(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        entry(*args)  # the warm-up that torch.cuda.graph asks for
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = entry(*args)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


# a mosaic warp whose second image draws tile 2 of a 2-image pool
BAD_INDEX_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from pl_yolo_tpu_torch.ops.mosaic import mosaic_sample_idx
pool = torch.zeros((2, 3, 64, 64), dtype=torch.bfloat16, device="cuda")
tidx = torch.tensor([[0, 1, 0, 1], [1, 0, 2, 0]], device="cuda")
ox = torch.tensor([[0, 64, 0, 64]] * 2, dtype=torch.int32, device="cuda")
oy = torch.tensor([[0, 0, 64, 64]] * 2, dtype=torch.int32, device="cuda")
xs = torch.arange(64, dtype=torch.float32, device="cuda")[None].repeat(2, 1) * 2
out = mosaic_sample_idx(pool, tidx, ox, oy, xs, xs.clone())
torch.cuda.synchronize()
print("the bad tile index went through")
"""


def bad_index_ends_the_run():
    """Run BAD_INDEX_CHILD in a child process (a device-side assert spoils
    the CUDA context); returns (exit code, the stderr line naming it)."""
    child = subprocess.run([sys.executable, "-c", BAD_INDEX_CHILD, str(ROOT)],
                           capture_output=True, text=True, timeout=600)
    named = [line for line in child.stderr.splitlines()
             if "device-side assert" in line]
    if child.returncode == 0 or not named:
        raise AssertionError(
            f"a tile index outside the pool did not end the run with a "
            f"device-side assert: exit {child.returncode}, stdout "
            f"{child.stdout[-500:]!r}, stderr {child.stderr[-2000:]!r}")
    return child.returncode, named[0].strip()


def anchor_grid(torch, size, strides):
    """x_shifts, y_shifts, strides [A] of a `size`^2 input, as the YOLOX
    decode lays them out (level-major, 'ij' within a level)."""
    xs, ys, ss = [], [], []
    for s in strides:
        g = size // s
        gy, gx = torch.meshgrid(torch.arange(g), torch.arange(g),
                                indexing="ij")
        xs.append(gx.reshape(-1))
        ys.append(gy.reshape(-1))
        ss.append(torch.full((g * g,), s))
    return tuple(torch.cat(t).float() for t in (xs, ys, ss))


def simota_case(torch, g, dev, b, m, c, size, strides=(8, 16, 32),
                n_valid=None, kind="random"):
    """One synthetic SimOTA input: labels [B,M,4] (the first n valid slots
    an image, n random in [1, M) unless `n_valid`), classes, validity, and
    predictions as the loss hands them over: slices of one [B,A,5+C]
    tensor, predicted boxes near their anchors."""
    xs, ys, st = anchor_grid(torch, size, strides)
    a = xs.shape[0]
    n = (torch.randint(1, m, (b,), generator=g) if n_valid is None
         else torch.full((b,), n_valid))
    valid = torch.arange(m)[None, :] < n[:, None]
    boxes = torch.cat([torch.rand((b, m, 2), generator=g) * (size - 20) + 10,
                       torch.rand((b, m, 2), generator=g) * 0.4 * size + 8],
                      -1)
    classes = torch.randint(0, c, (b, m), generator=g)
    preds = torch.empty((b, a, 5 + c))
    preds[..., 0] = (xs + torch.rand((b, a), generator=g) * 2 - 1) * st
    preds[..., 1] = (ys + torch.rand((b, a), generator=g) * 2 - 1) * st
    preds[..., 2:4] = torch.rand((b, a, 2), generator=g) * 10 * st[:, None] + 4
    preds[..., 4:] = torch.randn((b, a, 1 + c), generator=g) * 2 - 2
    if kind == "no valid label in one image":
        valid[1] = False
    elif kind == "labels at the image edge":
        boxes[..., 0] = torch.where(torch.rand((b, m), generator=g) < 0.5,
                                    0.0, float(size))
        boxes[..., 1] = torch.rand((b, m), generator=g) * size
    elif kind == "class index out of range":
        classes[:, ::3] = -3
        classes[:, 1::3] = c + 5
    elif kind == "ties: repeated identical predictions":
        preds[...] = preds[:1, :1]           # one box and one logit row
        boxes[:, 1::2] = boxes[:, ::2][:, :boxes[:, 1::2].shape[1]]
    elif kind == "an image with no candidate":   # its labels lie far outside
        boxes[1, :, :2] = -5000.0
    elif kind == "an image with 9 candidates":    # 4x4 px labels at (-15, -15):
        boxes[0, :, :2] = -15.0                   # 1 + 4 + 4 centre-gate anchors
        boxes[0, :, 2:] = 4.0
    elif kind == "NaN logits":
        preds[:, ::7, 5] = float("nan")      # a class logit of every 7th
        preds[0, 100:130, 4] = float("nan")  # anchor; obj of 30 anchors
    boxes, classes, valid, preds, xs, ys, st = (
        t.to(dev) for t in (boxes * valid[..., None], classes, valid, preds,
                            xs, ys, st))
    return (boxes, classes, valid, preds[..., :4], preds[..., 4],
            preds[..., 5:], xs, ys, st)


def simota_cases(torch, dev):
    """(name, args) of the fused-assignment checks on the card."""
    g = torch.Generator().manual_seed(17)
    cases = []
    for b, m, c, size, strides, kind in (
            (BATCH, AUG_MAX_LABELS, NUM_CLASSES, SIZE, (8, 16, 32), "random"),
            (BATCH, MAX_LABELS, NUM_CLASSES, SIZE, (8, 16, 32), "random"),
            (2, 13, 7, 128, (8, 16), "random"),
            (4, 13, NUM_CLASSES, SIZE, (8, 16, 32), "random"),
            (3, 50, 7, 128, (8, 16), "no valid label in one image"),
            (4, AUG_MAX_LABELS, NUM_CLASSES, SIZE, (8, 16, 32),
             "labels at the image edge"),
            (2, 13, 7, 128, (8, 16), "class index out of range"),
            (4, MAX_LABELS, NUM_CLASSES, SIZE, (8, 16, 32),
             "ties: repeated identical predictions"),
            (4, 13, NUM_CLASSES, SIZE, (8, 16, 32), "NaN logits"),
            (3, AUG_MAX_LABELS, NUM_CLASSES, SIZE, (8, 16, 32),
             "an image with no candidate"),
            (3, MAX_LABELS, NUM_CLASSES, SIZE, (8, 16, 32),
             "an image with 9 candidates")):
        args = simota_case(torch, g, dev, b, m, c, size, strides, kind=kind)
        cases.append((f"{kind}, B={b} M={m} A={args[6].shape[0]} C={c}",
                      args))
    return cases


def simota_candidates(torch, args, radius=2.5):
    """Each image's number of candidate anchors (inside either gate of one
    of its valid labels), and the number of valid label rows with fewer
    than 10 anchors inside both their gates (the rows whose every cost the
    kernel's label pass computes)."""
    gt, _, valid, _, _, _, xs, ys, st = args
    xc, yc, rad = (xs + 0.5) * st, (ys + 0.5) * st, radius * st
    gx, gy, gw, gh = (t[..., None] for t in gt.unbind(-1))
    in_box = torch.minimum(
        torch.minimum(xc - (gx - gw * 0.5), (gx + gw * 0.5) - xc),
        torch.minimum(yc - (gy - gh * 0.5), (gy + gh * 0.5) - yc)) > 0.0
    in_center = torch.minimum(
        torch.minimum(xc - (gx - rad), (gx + rad) - xc),
        torch.minimum(yc - (gy - rad), (gy + rad) - yc)) > 0.0
    small = ((in_box & in_center).sum(-1) < 10) & valid
    return (((in_box | in_center) & valid[..., None]).any(1).sum(1).tolist(),
            int(small.sum()))


def simota_bound(args):
    """The least ms the card could take for one fused assignment, and what
    bounds it: every input read once and the outputs (bool, int64, fp32)
    written once, over the memory rate; the operations these inputs need
    (the C class terms of every anchor, and every pair of a valid label and
    an anchor once), over the fp32 rate."""
    gt, _, valid, _, _, cls, _, _, _ = args
    b, m = valid.shape
    a, c = cls.shape[1:]
    nbytes = (b * m * (4 * 4 + 8 + 1) + b * a * (4 * 4 + 4 + c * 4)
              + 3 * a * 4 + b * a * (1 + 8 + 4))
    ops = (SIMOTA_OPS_PER_CLASS_TERM * b * a * c
           + SIMOTA_OPS_PER_PAIR * int(valid.sum()) * a)
    bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
             "operations": ops / PEAK_FP32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    return bound[bound_by], bound_by


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


def augmented_simota_inputs(torch, module, img_s2d, labels, strides):
    """`simota_inputs` of an augmented batch: the model under
    `stem_input_s2d()` on its s2d images, the maps widened to fp32."""
    from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d
    with torch.no_grad(), stem_input_s2d():
        maps = [m.float() for m in module(img_s2d)]
    return simota_inputs(torch, maps, labels, strides)


def l2_cold(torch, fn):
    """`fn` preceded by a write of L2_FLUSH_BYTES to a scratch buffer: the
    L2 cache then holds none of `fn`'s inputs when its launch starts."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def run():
        scratch.zero_()
        return fn()
    return run


def draw_scene(rng, num_classes: int):
    """An image of 480x640 on a plain ground with 1-5 filled rectangles of
    random classes: (PIL image, [(x, y, w, h, class id from 1)])."""
    from PIL import Image, ImageDraw
    h, w = JPEG_HW
    img = Image.new("RGB", (w, h), tuple(rng.integers(0, 256, 3).tolist()))
    draw = ImageDraw.Draw(img)
    boxes = []
    for _ in range(int(rng.integers(1, 6))):
        bw, bh = int(rng.integers(24, w // 2)), int(rng.integers(24, h // 2))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        draw.rectangle([x, y, x + bw, y + bh],
                       fill=tuple(rng.integers(0, 256, 3).tolist()))
        boxes.append((x, y, bw, bh, int(rng.integers(1, num_classes + 1))))
    return img, boxes


def scene_batch(torch, dev, n: int, size: int, seed: int):
    """n images of `draw_scene`, letterboxed as the serving tools letterbox
    an image, and their labels, on `dev`: ([n, size, size, 3] float 0-255,
    [n, MAX_LABELS, 5] class, cx, cy, w, h in pixels)."""
    import numpy as np
    from pl_yolo_tpu_torch.data.datasets import letterbox_image
    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.float32)
    labels = np.zeros((n, MAX_LABELS, 5), np.float32)
    for i in range(n):
        img, boxes = draw_scene(rng, NUM_CLASSES)
        images[i], r = letterbox_image(img, (size, size))
        for j, (x, y, w, h, cat) in enumerate(boxes):
            labels[i, j] = (cat - 1, (x + w / 2) * r, (y + h / 2) * r,
                            w * r, h * r)
    return (torch.from_numpy(images).to(dev),
            torch.from_numpy(labels).to(dev))


def write_coco(root: Path, n: int, num_classes: int, seed: int = 0) -> None:
    """A COCO set under `root`: `n` JPEGs of `draw_scene` and their
    annotations."""
    import numpy as np
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "annotations").mkdir()
    h, w = JPEG_HW
    images, anns = [], []
    for i in range(n):
        img, boxes = draw_scene(rng, num_classes)
        for x, y, bw, bh, cat in boxes:
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cat, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0})
        img.save(root / "images" / f"{i:04d}.jpg", quality=90)
        images.append({"id": i + 1, "file_name": f"{i:04d}.jpg",
                       "height": h, "width": w})
    (root / "annotations" / "instances.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c + 1, "name": f"class{c}"}
                       for c in range(num_classes)]}))


def trainer_configs(load_config, root: Path, workers: int):
    """(model cfg, data cfg): yolox_s.yaml with the no-aug schedule cut to
    the last epoch, and coco2017.yaml pointed at `root`, B=16, 640^2."""
    model = load_config(CONFIG)
    model["schedule"]["no_aug_epochs"] = 1
    data = load_config(ROOT / "pl_yolo_tpu_torch/configs/data/coco2017.yaml")
    data["dataset"].update(
        dir=str(root), train="images", val="images", test="images",
        train_json="annotations/instances.json",
        val_json="annotations/instances.json",
        test_json="annotations/instances.json", train_size=[SIZE, SIZE],
        val_size=[SIZE, SIZE], train_batch_size=BATCH, val_batch_size=BATCH,
        num_workers=workers)
    return model, data


def kernel_wrappers() -> dict:
    """The kernels' wrappers by name; each counts its launches."""
    from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import nms_suppress
    from pl_yolo_tpu_torch.ops.cuda.simota import simota_fused
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_rows
    return {"mosaic_warp": mosaic_warp, "topk_rows": topk_rows,
            "nms_suppress": nms_suppress, "simota_assign": simota_fused}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def start_cli(args, sigterm_after: str | None = None):
    """Start `python -m pl_yolo_tpu_torch args` from the repo root; returns
    `finish(timeout)`, which (with `sigterm_after`, once a line of its
    output starts with it, sends SIGTERM and) waits for the child and
    returns (exit code, output lines); the child is killed on a timeout."""
    cmd = [sys.executable, "-m", "pl_yolo_tpu_torch", *args]
    child = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    lines, seen = [], threading.Event()

    def read():
        for line in child.stdout:
            lines.append(line.rstrip("\n"))
            if sigterm_after and line.startswith(sigterm_after):
                seen.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def finish(timeout: float):
        try:
            if sigterm_after is not None:
                if not seen.wait(timeout):
                    raise AssertionError(f"no line '{sigterm_after}' within "
                                         f"{timeout} s: "
                                         + "\n".join(lines[-20:]))
                child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout)
            reader.join(10)
        except BaseException:
            child.kill()
            child.wait()
            raise
        return rc, lines
    return finish


def run_cli(args, timeout: float, sigterm_after: str | None = None):
    """Run `python -m pl_yolo_tpu_torch args` to its end (`start_cli`).
    Returns (exit code, output lines)."""
    return start_cli(args, sigterm_after)(timeout)


def epoch_lines(lines) -> dict:
    """{epoch: (s, img/s, loss, img/s without the loader's wait)} from the
    trainer's epoch lines."""
    out = {}
    for line in lines:
        m = EPOCH_LINE.match(line)
        if m:
            out[int(m[1])] = (float(m[2]), float(m[3]), float(m[4]),
                              float(m[5]))
    return out


def phase_trainer(torch, card: str, device) -> None:
    """Phase 10 (see the module docstring), on `device`."""
    import csv
    import itertools
    from torch.profiler import ProfilerActivity, profile
    from pl_yolo_tpu_torch.train.checkpoint import CheckpointManager
    from pl_yolo_tpu_torch.train.trainer import Trainer
    from pl_yolo_tpu_torch.utils.config import load_config

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    finish_cli = None
    try:
        write_coco(tmp / "coco", TRAINER_IMAGES, NUM_CLASSES)

        def cli_chain() -> None:
            """The CLI on the same JPEGs, in child processes, beside the
            in-process work below: SIGTERM in the second epoch, --resume,
            --test."""
            # the CLI, with 4 loader workers
            model_cfg, data_cfg = trainer_configs(load_config, tmp / "coco",
                                                  4)
            import yaml
            (tmp / "model.yaml").write_text(yaml.safe_dump(model_cfg))
            (tmp / "data.yaml").write_text(yaml.safe_dump(data_cfg))
            args = ["-c", str(tmp / "model.yaml"), "-d",
                    str(tmp / "data.yaml"), "--max_epochs",
                    str(TRAINER_EPOCHS), "--logger", "csv", "--output_dir",
                    str(tmp / "runs"), "-n", "cli"]
            if device.type != "cuda":  # the CLI's default is the card
                args += ["--device", str(device)]
            ckpts = tmp / "runs" / "cli" / "checkpoints"
            note("trainer: CLI, SIGTERM in the second epoch")
            rc, first = run_cli(args, 300, sigterm_after="epoch 0:")
            steps = sorted(int(d.name) for d in ckpts.iterdir()
                           if d.name.isdigit())
            spe = TRAINER_STEPS // TRAINER_EPOCHS
            if rc != 75 or len(steps) != 1 or not spe < steps[0] < 2 * spe:
                raise AssertionError(f"preempted CLI: exit {rc}, "
                                     f"checkpoints {steps}:\n"
                                     + "\n".join(first[-30:]))
            marked = json.loads((ckpts / str(steps[0]) / "metrics.json")
                                .read_text())
            if marked.get("preempted") != 1.0:
                raise AssertionError(
                    f"the preemption checkpoint says {marked}")
            note("trainer: CLI --resume")
            rc, resumed = run_cli([*args, "--resume"], 300)
            mgr = CheckpointManager(ckpts)
            kept = sorted(int(d.name) for d in ckpts.iterdir()
                          if d.name.isdigit())
            if rc != 0 or mgr.latest_step != TRAINER_STEPS or len(kept) > 2:
                raise AssertionError(f"resumed CLI: exit {rc}, "
                                     f"checkpoints {kept}:\n"
                                     + "\n".join(resumed[-30:]))
            if mgr.restore()["step"] != TRAINER_STEPS:
                raise AssertionError("the resumed run's last checkpoint is "
                                     f"not at step {TRAINER_STEPS}")
            note("trainer: CLI --test")
            rc, tested = run_cli([*args, "--test", "--ckpt", str(ckpts)],
                                 300)
            test_map = [line for line in tested
                        if line.startswith("mAP = ")]
            if rc != 0 or not test_map:
                raise AssertionError(f"--test: exit {rc}:\n"
                                     + "\n".join(tested[-30:]))
            log(f"[trainer] CLI: SIGTERM in epoch 1 -> exit 75 with a "
                f"preemption checkpoint at step {steps[0]}; --resume -> exit "
                f"0 at step "
                f"{mgr.latest_step}, checkpoints kept {kept}; --test -> "
                f"'{test_map[-1]}'")
            for what, lines in (("first run", first),
                                ("resumed run", resumed)):
                for i, (dt, ips, _, step_ips) in epoch_lines(lines).items():
                    aug = "mosaic/mixup on" if i < 2 else "no-aug"
                    log(f"[time] trainer epoch {i} of the CLI's {what} "
                        f"({aug}, 4 loader workers, beside the in-process "
                        f"work): {ips:.1f} images/s from JPEG decode through "
                        f"the loader to the step ({dt:.1f} s); {step_ips:.1f} "
                        f"images/s without the loader's wait, on {card}")

        # (the CLI's epochs share the card with the in-process fit, loader
        # and profiler runs below)
        finish_cli = in_background(cli_chain)
        model_cfg, data_cfg = trainer_configs(load_config, tmp / "coco", 0)
        note(f"trainer: fit in process ({TRAINER_EPOCHS} epochs)")
        trainer = Trainer(copy.deepcopy(model_cfg), copy.deepcopy(data_cfg),
                          max_epochs=TRAINER_EPOCHS, check_val_every_n_epoch=2,
                          output_dir=str(tmp / "runs"), experiment_name="fit",
                          logger="csv", seed=0, device=device,
                          # the losses at each epoch's last step, where the
                          # epoch's own sync is: no sync of its own a step
                          log_every_n_steps=TRAINER_STEPS // TRAINER_EPOCHS)
        reset_launch_counts()
        trainer.fit()
        sync()
        counts = launch_counts()
        val_batches = math.ceil(TRAINER_IMAGES / BATCH)
        want = {"mosaic_warp": 2 * TRAINER_STEPS,
                "topk_rows": 2 * TRAINER_STEPS,
                "nms_suppress": 2 * val_batches, "simota_assign": 0}
        if counts != want:
            raise AssertionError(f"Trainer.fit launched {counts}, not {want}")
        if trainer.state.step != TRAINER_STEPS:
            raise AssertionError(f"fit ended at step {trainer.state.step}")
        rows = list(csv.DictReader(open(trainer.out_dir / "logs/metrics.csv")))
        losses = [float(r["loss"]) for r in rows if r.get("loss")]
        maps = [(float(r["mAP"]), float(r["mAP50"])) for r in rows
                if r.get("mAP")]
        epochs = {i: r for i, r in enumerate(r for r in rows
                                             if r.get("loss_epoch"))}
        if len(losses) != TRAINER_EPOCHS or not all(map(math.isfinite,
                                                        losses)):
            raise AssertionError(f"fit's losses: {losses}")
        if len(maps) != 2 or not all(math.isfinite(v) and v >= 0
                                     for m in maps for v in m):
            raise AssertionError(f"fit's mAP, mAP50: {maps}")
        kept = sorted(int(d.name) for d in (trainer.out_dir / "checkpoints")
                      .iterdir() if d.name.isdigit())
        if not 1 <= len(kept) <= 2 or kept[-1] != TRAINER_STEPS:
            raise AssertionError(f"checkpoints kept: {kept}")
        et = trainer.eval_times
        log(f"[trainer] fit: {TRAINER_EPOCHS} epochs x "
            f"{TRAINER_STEPS // TRAINER_EPOCHS} steps of YOLOX-s at B={BATCH} "
            f"{SIZE}^2 from {TRAINER_IMAGES} JPEGs of {JPEG_HW[0]}x"
            f"{JPEG_HW[1]}; losses at the epochs' ends "
            + ", ".join(f"{v:.3f}" for v in losses)
            + "; mAP, mAP50 " + "; ".join(f"{a:.5f}, {b:.5f}" for a, b in maps)
            + f"; launches {counts}; checkpoints kept {kept}")
        for i, r in epochs.items():
            log(f"[time] trainer epoch {i} ({'mosaic/mixup on' if i < 2 else 'no-aug'}"
                f", loader thread, 0 workers): {float(r['epoch_img_s']):.1f} "
                f"images/s from JPEG decode through the loader to the step; "
                f"{float(r['step_img_s']):.1f} images/s without the "
                f"{float(r['loader_wait_s']):.3f} s the loop waited for the "
                f"loader, on {card}")
        log(f"[time] trainer validation in fit ({et['detections']} "
            f"detections), a batch of {BATCH} (mean of "
            f"{et['batches'] - 1} after the first): forward + decode "
            f"{et['infer_s'] * 1e3:.2f} ms, postprocess {et['nms_s'] * 1e3:.2f} "
            f"ms, formatting {et['format_s'] / et['batches'] * 1e3:.2f} ms, "
            f"COCO evaluation {et['coco_eval_s'] / et['batches'] * 1e3:.2f} "
            f"ms ({et['coco_eval_s']:.3f} s for {TRAINER_IMAGES} images) on "
            f"{card}")

        note("trainer: restore")
        again = Trainer(copy.deepcopy(model_cfg), copy.deepcopy(data_cfg),
                        max_epochs=TRAINER_EPOCHS,
                        output_dir=str(tmp / "runs"), experiment_name="fit",
                        logger="csv", seed=1, device=device)
        again.state = again._build_state(TRAINER_STEPS)
        again._steps_per_epoch = TRAINER_STEPS // TRAINER_EPOCHS
        # validation at the NMS's full load: at conf 1e-6 the random init
        # (heads at their prior, 1e-4) passes every candidate, so 300
        # detections an image reach the COCO evaluation (the model trained
        # 12 steps from it scores nothing above 1e-6)
        note("trainer: validation of the random init")
        ap, ap50 = again.validate(conf=CONF_TRAINED)
        et = again.eval_times
        if not (math.isfinite(ap) and math.isfinite(ap50) and ap >= 0
                and ap50 >= 0 and et["detections"] > 0):
            raise AssertionError(f"validate on the random init: mAP {ap}, "
                                 f"mAP50 {ap50}, {et['detections']} "
                                 f"detections")
        log(f"[time] trainer validation of the random init at conf "
            f"{CONF_TRAINED} ({et['detections']} detections, mAP {ap:.6f}, mAP50 "
            f"{ap50:.6f}), a batch of {BATCH} (mean of {et['batches'] - 1} "
            f"after the first): forward + decode {et['infer_s'] * 1e3:.2f} "
            f"ms, postprocess {et['nms_s'] * 1e3:.2f} ms, formatting "
            f"{et['format_s'] / et['batches'] * 1e3:.2f} ms, COCO evaluation "
            f"{et['coco_eval_s'] / et['batches'] * 1e3:.2f} ms "
            f"({et['coco_eval_s']:.3f} s for {TRAINER_IMAGES} images) on "
            f"{card}")
        if again._restore(None, resume=True) != TRAINER_EPOCHS:
            raise AssertionError("restore gave the wrong epoch to go on from")
        got, ref = again.state, trainer.state
        if not got.step == got.optimizer.updates == ref.step:
            raise AssertionError(f"restored step {got.step}, updates "
                                 f"{got.optimizer.updates}, saved {ref.step}")
        pairs = [(got.module.state_dict(), ref.module.state_dict()),
                 (got.ema_module.state_dict(), ref.ema_module.state_dict())]
        a, b = got.optimizer.state_dict(), ref.optimizer.state_dict()
        pairs.append(({i: v["momentum_buffer"] for i, v in a["state"].items()},
                      {i: v["momentum_buffer"] for i, v in b["state"].items()}))
        for x, y in pairs:
            if x.keys() != y.keys() or not all(torch.equal(x[k], y[k])
                                               for k in x):
                raise AssertionError("a restored tensor differs from the "
                                     "trained one")
        if a["param_groups"] != b["param_groups"] or not a["state"]:
            raise AssertionError("restored optimizer groups differ")
        log(f"[trainer] restore: step {got.step}, the optimizer's "
            f"{len(a['state'])} momentum buffers, the module's and the EMA's "
            f"{len(pairs[0][0])} tensors (BN statistics among them) equal to "
            f"the trained ones")
        del again, got, pairs, a, b

        # the loader alone: JPEG decode and letterbox, once the prefetch
        # buffers are drained (the epochs above are too short to show it)
        note("trainer: the loader alone")
        for workers in (0, 4):
            trainer.datamodule.num_workers = workers
            loader = trainer.datamodule.train_loader()
            try:
                for _ in range(4):
                    next(loader)
                t0 = time.perf_counter()
                for _ in range(8):
                    next(loader)
                dt = time.perf_counter() - t0
            finally:
                loader.close()
            log(f"[time] the train loader alone, {workers} workers: "
                f"{8 * BATCH / dt:.1f} images/s of JPEG decode, letterbox "
                f"and collation ({JPEG_HW[0]}x{JPEG_HW[1]} to {SIZE}^2; 8 "
                f"batches after 4) on the host of {card}")
        trainer.datamodule.num_workers = 0

        # one augmented step and one validation batch in a profiler window
        note("trainer: profiler window")
        loader = trainer.datamodule.train_loader()
        batch = next(loader)
        loader.close()
        images = torch.from_numpy(batch["images"]).to(device)
        labels = torch.from_numpy(batch["labels"]).to(device)
        step_fn = trainer.make_step()
        gen = torch.Generator(device=device).manual_seed(7)
        step_fn(trainer.state, images, labels, generator=gen,
                aug_enable=True, use_l1=False)  # warm
        sync()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(trainer.state, images, labels, generator=gen,
                    aug_enable=True, use_l1=False)
            trainer._run_eval(itertools.islice(
                trainer.datamodule.val_batches(), 1),
                trainer.state.eval_module, 0.01, 0.65,
                dataset=trainer.datamodule.dataset_val)
            sync()
        after = launch_counts()
        window = {k: after[k] - before[k] for k in after}
        want = {"mosaic_warp": 2, "topk_rows": 2, "nms_suppress": 1,
                "simota_assign": 0}
        if window != want:
            raise AssertionError(f"profiler window launched {window}, "
                                 f"not {want}")
        traced = {}
        for name, kernel in (("mosaic_warp", "mosaic_warp_kernel"),
                             ("topk_rows", "topk_rows_kernel"),
                             ("nms_suppress", "nms_cluster_kernel")):
            traced[name] = sum(e.count for e in prof.key_averages()
                               if e.device_type == torch.autograd.DeviceType
                               .CUDA and kernel in e.key)
            if traced[name] > window[name] or (
                    0 < traced[name] < window[name]):
                raise AssertionError(f"the trace holds {traced[name]} "
                                     f"{kernel} launches, the wrapper "
                                     f"counted {window[name]}")
        log(f"[trainer] profiler window (one augmented step, one validation "
            f"batch): launches counted by the wrappers {window}; kernels in "
            f"the trace {traced} (0: dropped from this trace)")

        # the fit loop's step rate against the bare step's, one device
        # batch over and over, alone and with a train loader decoding
        # beside it (a thread of this process, or 4 worker processes,
        # drained by a thread that drops its batches): how much of the
        # epoch's time the host's decoding takes from the dispatch
        note("trainer: the step beside a decoding loader")
        rates = {}
        for what, workers in (("alone", None), ("0 workers", 0),
                              ("4 workers", 4), ("alone again", None)):
            stop, loader, drain = threading.Event(), None, None
            if workers is not None:
                trainer.datamodule.num_workers = workers
                loader = trainer.datamodule.train_loader()

                def drop(loader=loader, stop=stop):
                    while not stop.is_set():
                        next(loader)
                drain = threading.Thread(target=drop, daemon=True)
                drain.start()
                time.sleep(0.5)  # the loader under way
            try:
                sync()
                t0 = time.perf_counter()
                for _ in range(STEP_SPLIT_STEPS):
                    step_fn(trainer.state, images, labels, generator=gen,
                            aug_enable=True, use_l1=False)
                sync()
                rates[what] = STEP_SPLIT_STEPS * BATCH / (
                    time.perf_counter() - t0)
            finally:
                stop.set()
                if loader is not None:
                    drain.join(10)
                    loader.close()
        trainer.datamodule.num_workers = 0
        log(f"[time] the fit loop's augmented step on one device batch, "
            f"{STEP_SPLIT_STEPS} steps each: "
            + ", ".join(f"{what} {ips:.1f} images/s"
                        for what, ips in rates.items())
            + f" (a train loader decoding beside it) on {card}")
        del trainer, images, labels, step_fn
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        if finish_cli is not None:
            finish_cli()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[trainer] phase 10 took {time.perf_counter() - t_phase:.1f} s")


def assert_launched(before: dict, want: dict, what: str) -> None:
    """Fail unless each kernel launched `want[name]` times (0 if absent)
    since the counts `before`."""
    got = {n: c - before[n] for n, c in launch_counts().items()}
    want = {n: want.get(n, 0) for n in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, not {want}")


def assert_finite_losses(torch, what: str, losses: dict) -> None:
    for k, v in losses.items():
        if v.requires_grad or not bool(torch.isfinite(v)):
            raise AssertionError(f"{what}: bad {k} {v}")


def trained_ok(torch, what: str, losses: dict) -> None:
    """A train step's losses: finite, and some anchor assigned."""
    assert_finite_losses(torch, what, losses)
    if not float(losses["proportion"]) > 0:
        raise AssertionError(f"{what}: no anchor assigned")


def served_ok(torch, what: str, preds, det, n_anchors: int,
              conf: float) -> None:
    """A request's decoded predictions and detections: their shapes,
    finite values, and the card's postprocess equal to the CPU's on the
    same predictions."""
    from pl_yolo_tpu_torch.ops.nms import postprocess
    if tuple(preds.shape) != (BATCH, n_anchors, 5 + NUM_CLASSES) \
            or tuple(det.boxes.shape) != (BATCH, MAX_DET, 4):
        raise AssertionError(f"{what}: shapes {tuple(preds.shape)}, "
                             f"{tuple(det.boxes.shape)}")
    for name, t in (("preds", preds), ("boxes", det.boxes),
                    ("scores", det.scores)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    ref = postprocess(preds.cpu(), conf_threshold=conf, iou_threshold=IOU,
                      max_det=MAX_DET, pre_nms_topk=PRE_NMS_TOPK,
                      device="cpu")
    for field in ("valid", "classes", "scores", "boxes"):
        if not torch.equal(getattr(det, field).cpu(), getattr(ref, field)):
            raise AssertionError(f"{what}: card postprocess != CPU "
                                 f"postprocess ({field})")


def start_cli_epoch(config: Path, tag: str, seed: int):
    """Start `python -m pl_yolo_tpu_torch -c config` on ANCHOR_CLI_IMAGES
    synthetic JPEGs (B=16, 640^2) for one epoch and a validation; returns
    `finish()`, which waits for it and fails unless it exited 0 with a
    finite loss and printed mAP. A phase starts it and goes on with its
    own work on the card (the child's epoch images/s are then those of a
    card it shares), then finishes it."""
    import yaml
    from pl_yolo_tpu_torch.utils.config import load_config
    note(f"{tag}: CLI")
    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"))
    try:
        write_coco(tmp / "coco", ANCHOR_CLI_IMAGES, NUM_CLASSES, seed=seed)
        _, data_cfg = trainer_configs(load_config, tmp / "coco", 0)
        (tmp / "data.yaml").write_text(yaml.safe_dump(data_cfg))
        wait = start_cli(["-c", str(config), "-d", str(tmp / "data.yaml"),
                          "--max_epochs", "1", "--logger", "csv",
                          "--output_dir", str(tmp / "runs"), "-n",
                          f"{tag}_cli"])
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    def finish() -> None:
        try:
            rc, lines = wait(300)
            maps_line = [line for line in lines if line.startswith("mAP = ")]
            epochs = epoch_lines(lines)
            if rc != 0 or not maps_line or 0 not in epochs \
                    or not math.isfinite(epochs[0][2]):
                raise AssertionError(f"{tag} CLI: exit {rc}:\n"
                                     + "\n".join(lines[-30:]))
            shown = (config.relative_to(ROOT) if config.is_relative_to(ROOT)
                     else config.name)
            log(f"[{tag}] CLI `python -m pl_yolo_tpu_torch -c "
                f"{shown}` on {ANCHOR_CLI_IMAGES} JPEGs: exit "
                f"0, epoch 0 {epochs[0][1]:.1f} images/s, loss "
                f"{epochs[0][2]:.3f}; '{maps_line[-1]}'")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return finish


def in_background(fn):
    """Run fn() in a thread; returns `finish()`, which waits for it and
    returns its result, or raises what it raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as err:   # handed to finish()
            out["error"] = err
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def finish():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out.get("value")
    return finish


def cli_epoch(config: Path, tag: str, seed: int) -> None:
    """`start_cli_epoch` run to its end before the phase goes on."""
    start_cli_epoch(config, tag, seed)()


def ota_recorder(torch):
    """A context that records the inputs of the YOLOv7 loss's top-k calls
    (the OTA's IoU and -cost rows) and of its assignment, as the loss hands
    them over, while the calls themselves run unchanged."""
    import contextlib
    from pl_yolo_tpu_torch.models.losses import yolov7

    @contextlib.contextmanager
    def record():
        rows, assigns = [], []
        topk, assign = yolov7.topk_lastdim, yolov7.ota_assign

        def topk_recording(x, k, *args, **kw):
            rows.append((x.detach().clone(), k))
            return topk(x, k, *args, **kw)

        def assign_recording(*args):
            assigns.append(args)
            return assign(*args)
        yolov7.topk_lastdim, yolov7.ota_assign = topk_recording, assign_recording
        try:
            yield rows, assigns
        finally:
            yolov7.topk_lastdim, yolov7.ota_assign = topk, assign
    return record


def phase_anchor(torch, card: str, dev) -> dict:
    """Phase 11 (see the module docstring), on the card `dev`. Returns the
    top-k kernel's record on the YOLOv7 path for the `kernels` line."""
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.models.losses import yolov3, yolov7
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_plain, topk_rows
    from pl_yolo_tpu_torch.ops.nms import postprocess
    from pl_yolo_tpu_torch.ops.topk import topk_lastdim
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.utils.config import (load_config,
                                                validate_model_config)
    t_phase = time.perf_counter()
    record = ota_recorder(torch)

    def config(path, dtype="keep"):
        cfg = validate_model_config(load_config(path), str(path))
        if dtype != "keep":
            cfg["dtype"] = dtype
        return cfg

    cfg = config(V7_CONFIG)
    model = build_model(cfg, NUM_CLASSES, device=dev, seed=0)
    fp32 = build_model(config(V7_CONFIG, None), NUM_CLASSES, device=dev,
                       seed=0)
    loss_kw = model.loss.train_loss.keywords
    strides, anchors = loss_kw["strides"], loss_kw["anchors"]
    n_anchors = 3 * sum((SIZE // s) ** 2 for s in strides)
    gen = torch.Generator(device=dev).manual_seed(21)
    requests = [torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
                * 255.0 for _ in range(REQUESTS)]
    labels = train_labels(torch, dev, BATCH)
    aug_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS)
    aug_images = bench_images(torch, dev, BATCH, seed=2)

    def infer(m, x):
        preds = m.loss.eval_decode(m.module(x))
        return preds, postprocess(preds, conf_threshold=CONF,
                                  iou_threshold=IOU, max_det=MAX_DET,
                                  pre_nms_topk=PRE_NMS_TOPK, device=dev)

    # the YOLOv7 path: serving, then training without and with augmentation,
    # its kernel launches counted from 0
    note("yolov7: serving")
    reset_launch_counts()
    served = []
    with torch.inference_mode():
        for x in requests:
            before = launch_counts()
            served.append(infer(model, x))
            assert_launched(before, {"nms_suppress": 1}, "yolov7 request")
    note("yolov7: training")
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    state = TrainState.create(model.module, optimizer)
    step = make_train_step(model.loss.train_loss)
    aug_fn = augment.make_augment_fn(aug_cfg, out_s2d=False)
    aug_step = make_train_step(model.loss.train_loss, augment_fn=aug_fn)
    history, aug_history = [], []
    for n in range(TRAIN_STEPS):
        before = launch_counts()
        with record() as (rows, assigns):
            history.append(step(state, requests[0], labels))
        assert_launched(before, {"topk_rows": 2}, f"yolov7 step {n}")
        if n == 0:
            rows50, assign50 = rows, assigns[0]
    for n in range(AUG_STEPS + 1):
        before = launch_counts()
        with record() as (rows, assigns):
            aug_history.append(aug_step(state, aug_images, labels,
                                        generator=gen,
                                        aug_enable=n < AUG_STEPS))
        assert_launched(before, {"topk_rows": 2, "mosaic_warp": 2},
                 f"yolov7 augmented step {n}")
        if n == 0:
            rows100, assign100 = rows, assigns[0]
    torch.cuda.synchronize()
    path_launches = launch_counts()
    if not all(path_launches[n] > 0 for n in
               ("nms_suppress", "topk_rows", "mosaic_warp")):
        raise AssertionError(f"the yolov7 path skipped a kernel: "
                             f"{path_launches}")

    # what it served and how it trained
    for preds, det in served:
        served_ok(torch, "yolov7 serving", preds, det, n_anchors, CONF)
    for what, hist in (("step", history), ("augmented step", aug_history)):
        for n, losses in enumerate(hist):
            trained_ok(torch, f"yolov7 {what} {n}", losses)
    if [tuple(x.shape) for x, _ in rows50] != [(BATCH, MAX_LABELS, MAX_LABELS * 27)] * 2 \
            or [tuple(x.shape) for x, _ in rows100] != [(BATCH, AUG_MAX_LABELS, AUG_MAX_LABELS * 27)] * 2:
        raise AssertionError("the OTA's top-k rows: "
                             f"{[tuple(x.shape) for x, _ in rows50 + rows100]}")
    log(f"[yolov7] {cfg['backbone']['name']} {cfg['backbone']['channels']} "
        f"depths {cfg['backbone']['depths']}, {cfg['neck']['name']}, "
        f"{cfg['head']['name']}, bf16: {REQUESTS} requests of {BATCH}x{SIZE}x"
        f"{SIZE} through eval_decode and postprocess (shapes, finiteness, "
        f"card == CPU postprocess; kept "
        f"{[int(det.valid.sum()) for _, det in served]}); {TRAIN_STEPS} "
        f"steps (M={MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in history)
        + f"; {AUG_STEPS}+1 augmented steps (NHWC, M={AUG_MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in aug_history)
        + f"; proportion {float(history[-1]['proportion']):.2f} / "
        f"{float(aug_history[-2]['proportion']):.2f}; launches on the path "
        f"{path_launches}")

    # the top-k kernel on the steps' own rows, bit for bit
    topk_err = 0.0
    for what, rows in ((f"M={MAX_LABELS} step", rows50),
                       (f"M={AUG_MAX_LABELS} augmented step", rows100)):
        for (x, k), name in zip(rows, ("IoU", "-cost")):
            before = launch_counts()
            got = topk_lastdim(x, k)
            torch.cuda.synchronize()
            assert_launched(before, {"topk_rows": 1},
                            f"top-k on the {what}'s {name}")
            plain = topk_plain(x, k)
            library = torch.topk(x, k, dim=-1).values
            for other, against in ((plain, "plain"), (library, "torch.topk")):
                if not torch.equal(got, other):
                    raise AssertionError(
                        f"topk_rows != {against} on the yolov7 {what}'s "
                        f"{name} {tuple(x.shape)}: "
                        f"{int((got != other).any(-1).sum())} rows differ")
            fin = torch.isfinite(plain)
            topk_err = max(topk_err, float((got - plain)[fin].abs().max())
                           if bool(fin.any()) else 0.0)
            log(f"[kernel] topk_rows == plain == torch.topk on the yolov7 "
                f"{what}'s OTA {name} rows {tuple(x.shape)}, k={k}")

    # the fp32 head maps at B=1, card against CPU (TF32 off, as phase 4)
    note("yolov7: card against CPU")
    x1 = requests[0][:1]
    with torch.inference_mode():
        maps_card = [m.cpu() for m in fp32.module.eval()(x1)]
        cpu_model = build_model(config(V7_CONFIG, None), NUM_CLASSES,
                                device="cpu", seed=0)
        maps_cpu = cpu_model.module(x1.cpu())
    scale = max(1.0, max(float(m.abs().max()) for m in maps_cpu))
    err = max(float((a - b).abs().max()) for a, b in zip(maps_card, maps_cpu))
    log(f"[yolov7] fp32 head maps card vs CPU at B=1: max abs err {err:.3e} "
        f"(max |map| {scale:.3f}, tolerance {MAPS_TOL} x scale)")
    if not err <= MAPS_TOL * scale:
        raise AssertionError(f"yolov7 fp32 head maps differ: {err}")

    # the loss and its gradients, card against CPU, on fp32 maps at B=2
    with torch.no_grad():
        maps = [m.float() for m in fp32.module.train()(requests[0][:2])]
    fp32.module.eval()
    sides = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        outs = [m.detach().to(device).requires_grad_() for m in maps]
        lab = labels[:2].to(device)
        losses = fp32.loss.train_loss(outs, lab)
        losses["loss"].backward()
        with torch.no_grad():
            d = yolov7.flatten_v7_outputs([o.detach() for o in outs],
                                          strides, anchors, NUM_CLASSES)
            a = yolov7.ota_assign(lab[..., 1:5], lab[..., 0].long(),
                                  lab.sum(2) > 0, d,
                                  tuple(o.shape[1:3] for o in outs), strides,
                                  anchors, NUM_CLASSES)
        sides[side] = ({k: float(v.detach()) for k, v in losses.items()},
                       [o.grad.cpu() for o in outs], a)
    (l_card, g_card, a_card), (l_cpu, g_cpu, a_cpu) = sides["card"], sides["cpu"]
    same = all(torch.equal(getattr(a_card, f).cpu(), getattr(a_cpu, f))
               for f in ("flat_idx", "matched_gt", "fg"))
    loss_err = max(abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                   for k in l_cpu)
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g_card, g_cpu))
    log(f"[yolov7] loss card vs CPU on fp32 maps at B=2: assignment equal "
        f"{same} ({int(a_cpu.fg.sum())} positives), loss {l_card['loss']:.6f} "
        f"vs {l_cpu['loss']:.6f}, max relative error of a loss entry "
        f"{loss_err:.3e}, of a map's gradient {grad_err:.3e} (tolerance "
        f"{LOSS_TOL})")
    if not (same and loss_err <= LOSS_TOL and grad_err <= LOSS_TOL):
        raise AssertionError(f"yolov7 loss on the card != CPU: {same}, "
                             f"{loss_err}, {grad_err}")

    # the NHWC augmentation, card against CPU on the same draws
    draws = augment.sample_draws(gen, BATCH, (SIZE, SIZE), aug_cfg)
    card_img, card_lab = augment.device_augment(draws, aug_images, labels,
                                                aug_cfg)
    cpu_img, cpu_lab = augment.device_augment(
        draws.to("cpu"), aug_images.cpu(), labels.cpu(), aug_cfg)
    if (tuple(card_img.shape) != (BATCH, SIZE, SIZE, 3)
            or card_img.dtype != torch.float32):
        raise AssertionError(f"NHWC augmented batch: {card_img.dtype} "
                             f"{tuple(card_img.shape)}")
    lab_err = float((card_lab.cpu() - cpu_lab).abs().max())
    same_rows = torch.equal(card_lab.cpu().abs().sum(-1) > 0,
                            cpu_lab.abs().sum(-1) > 0)
    pix = (card_img.cpu() - cpu_img).abs()
    log(f"[augment] NHWC (out_s2d=False) card vs CPU on the same draws, "
        f"B={BATCH} {SIZE}^2 uint8 in, fp32 out: labels max abs err "
        f"{lab_err:.3e} px (tolerance {AUG_LABEL_TOL}), valid rows equal "
        f"{same_rows}; pixels max {float(pix.max()):.3f}, mean "
        f"{float(pix.mean()):.3e} grey levels (tolerance {AUG_PIXEL_TOL})")
    if not (lab_err <= AUG_LABEL_TOL and same_rows
            and float(pix.max()) <= AUG_PIXEL_TOL[0]
            and float(pix.mean()) <= AUG_PIXEL_TOL[1]):
        raise AssertionError("the card's NHWC augmentation != the CPU's")
    del cpu_img, pix, card_img, maps_cpu, cpu_model

    # times, on a state whose learning rate stays near 0 (see phase 9)
    note("yolov7: times")
    rec = {}
    torch.cuda.empty_cache()
    with torch.inference_mode():
        model.module.eval()
        infer_ms = cuda_ms(torch, lambda: infer(model, requests[0]), 10)
        infer_busy, _ = device_profile(torch, lambda: infer(
            model, requests[0]), 3)
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                   total_steps=10 ** 9)
    state = TrainState.create(model.module, optimizer)
    timed = {}
    for what, fn in (("un-augmented", lambda: step(state, requests[0],
                                                   labels)),
                     ("augmented", lambda: aug_step(
                         state, aug_images, labels, generator=gen))):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, fn, iters=6, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, top = device_profile(torch, fn, 2)
        timed[what] = (ms, busy, peak, top)
    ota_ms = {what: cuda_ms(torch, lambda: yolov7.ota_assign(*args), 10)
              for what, args in (("M=50", assign50), ("M=100", assign100))}
    log(f"[time] yolov7 infer+NMS bf16 B={BATCH}: {infer_ms:.3f} "
        f"ms/batch, {BATCH * 1000.0 / infer_ms:.1f} images/s, device "
        f"busy {infer_busy:.3f} ms (idle share "
        f"{1.0 - infer_busy / infer_ms:.3f}) on {card}")
    for what, (ms, busy, peak, top) in timed.items():
        log(f"[time] yolov7 {what} train step bf16 B={BATCH}: {ms:.3f} "
            f"ms/step, {BATCH * 1000.0 / ms:.1f} images/s, device busy "
            f"{busy:.3f} ms (idle share {1.0 - busy / ms:.3f}), peak "
            f"device memory {peak:.2f} GiB on {card}; top kernels, ms "
            f"a step: " + "; ".join(f"{t:.4f} {name[:48]}"
                                    for name, t in top[:6]))
    log(f"[time] yolov7 OTA assignment alone (candidates, cost, 2 top-k, "
        f"claims) on the steps' own inputs: "
        + ", ".join(f"{w} {ms:.3f} ms" for w, ms in ota_ms.items())
        + f" on {card}")
    for what, rows in (("M=50", rows50), ("M=100", rows100)):
        for (x, k), name in zip(rows, ("IoU", "-cost")):
            n_rows, a = x.shape[0] * x.shape[1], x.shape[2]
            bound = {"operations": n_rows * a / PEAK_FP32_FLOPS * 1e3,
                     "bytes": (n_rows * a + n_rows * k) * 4
                     / PEAK_BYTES * 1e3}
            bound_by = max(bound, key=bound.get)

            def call(x=x, k=k):
                return topk_rows(x, k)

            def device(fn):
                return kernel_device_ms(torch, fn, ("topk_rows_kernel",))[
                    "topk_rows_kernel"]
            r = dict(ms=cuda_ms(torch, call, iters=50),
                     device_ms=device(call),
                     cold_ms=device(l2_cold(torch, call)),
                     plain_ms=cuda_ms(torch, lambda: topk_plain(x, k),
                                      iters=10),
                     library_ms=cuda_ms(torch, lambda: torch.topk(
                         x, k, dim=-1).values, iters=50),
                     bound_ms=bound[bound_by], bound_by=bound_by)
            rec[what, name] = r
            fmt = lambda ms: ("not measured" if ms is None
                              else f"{ms * 1e3:.2f} us")
            log(f"[time] topk_rows on the yolov7 {what} OTA {name} rows "
                f"{tuple(x.shape)} k={k}: device time "
                f"{fmt(r['cold_ms'])} with the L2 cold, "
                f"{fmt(r['device_ms'])} back to back; "
                f"{r['ms'] * 1e3:.2f} us a call by CUDA events; plain "
                f"{r['plain_ms'] * 1e3:.2f} us, torch.topk "
                f"{r['library_ms'] * 1e3:.2f} us, bound "
                f"{r['bound_ms'] * 1e3:.3f} us ({bound_by}) on {card}")

    # the CLI on a few JPEGs: one short epoch and a validation with mAP,
    # beside the YOLOv5-s and YOLOv3 checks
    finish_cli = start_cli_epoch(V7_CONFIG, "yolov7", seed=3)
    try:
        # YOLOv5-s: the Focus stem's s2d route, and one request
        note("yolov5-s")
        v5_cfg = config(V5_CONFIG)
        v5 = build_model(v5_cfg, NUM_CLASSES, device=dev, seed=0)
        optimizer, _ = build_optimizer(v5.module, v5_cfg["optimizer"],
                                       total_steps=TOTAL_STEPS)
        state = TrainState.create(v5.module, optimizer)

        def s2d_apply(module, x):
            with stem_input_s2d():
                return module(x)
        v5_step = make_train_step(v5.loss.train_loss, apply_fn=s2d_apply,
                                  augment_fn=augment.make_augment_fn(
                                      aug_cfg, out_s2d=True))
        v5_losses = []
        for n in range(2):
            before = launch_counts()
            v5_losses.append(v5_step(state, aug_images, labels, generator=gen))
            assert_launched(before, {"mosaic_warp": 2},
                            f"yolov5-s augmented step {n}")
            assert_finite_losses(torch, f"yolov5-s augmented step {n}",
                                 v5_losses[-1])
        before = launch_counts()
        v5.module.eval()
        with torch.inference_mode():
            preds, det = infer(v5, requests[1])
        assert_launched(before, {"nms_suppress": 1}, "yolov5-s request")
        if not (bool(torch.isfinite(preds).all())
                and bool(torch.isfinite(det.boxes).all())):
            raise AssertionError("yolov5-s request: non-finite outputs")
        log(f"[yolov5] yolov5_s.yaml bf16: 2 augmented steps of "
            f"{BATCH}x{SIZE}x{SIZE} through the s2d stem, loss "
            + " ".join(f"{float(h['loss']):.4f}" for h in v5_losses)
            + f", proportion {float(v5_losses[-1]['proportion']):.2f}; 1 "
            f"request: {int(det.valid.sum())} detections kept")
        del v5, state

        # YOLOv3: the loss and its gradients on the card against the CPU
        g3 = torch.Generator(device="cpu").manual_seed(9)
        v3_maps = [torch.randn((2, SIZE // s, SIZE // s,
                                3 * (5 + NUM_CLASSES)), generator=g3)
                   for s in (32, 16, 8)]
        sides = {}
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            outs = [m.to(device).requires_grad_() for m in v3_maps]
            loss = yolov3.yolov3_loss(outs, labels[:2].to(device),
                                      NUM_CLASSES,
                                      img_size=(SIZE, SIZE))["loss"]
            loss.backward()
            sides[side] = (float(loss.detach()),
                           [o.grad.cpu() for o in outs])
        (l3_card, g3_card), (l3_cpu, g3_cpu) = sides["card"], sides["cpu"]
        l3_err = abs(l3_card - l3_cpu) / abs(l3_cpu)
        g3_err = max(float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(g3_card, g3_cpu))
        log(f"[yolov3] loss card vs CPU on random maps at B=2, {SIZE}^2: "
            f"{l3_card:.6f} vs {l3_cpu:.6f}, relative error {l3_err:.3e}, "
            f"of a map's gradient {g3_err:.3e} (tolerance {LOSS_TOL})")
        if not (l3_err <= LOSS_TOL and g3_err <= LOSS_TOL):
            raise AssertionError(f"yolov3 loss on the card != CPU: {l3_err}, "
                                 f"{g3_err}")
    finally:
        finish_cli()
    log(f"[anchor] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": path_launches["topk_rows"], "max_abs_err": topk_err,
            "records": rec}


def path_call_recorder(torch, sites=None):
    """A context that records copies of the inputs of the calls the path
    makes to `topk_rows`, `mosaic_warp` and `nms_suppress` (or to those of
    `sites`, shaped like PATH_CALL_SITES), the first ones at each shape
    (PATH_CALL_SITES says how many), while the calls run unchanged; it
    yields {kernel name: {shape: [(args, kwargs), ...]}}."""
    sites = PATH_CALL_SITES if sites is None else sites
    import contextlib
    import importlib

    def shape_of(a):
        return (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a

    def copy_of(a):
        return a.detach().clone() if isinstance(a, torch.Tensor) else a

    @contextlib.contextmanager
    def record():
        records = {name: {} for name in sites}
        saved = {}
        for name, (where, per_shape) in sites.items():
            module = importlib.import_module(where)
            fn = getattr(module, name)
            saved[name] = module, fn

            def recording(*args, _name=name, _fn=fn, _n=per_shape, **kw):
                key = (tuple(shape_of(a) for a in args)
                       + tuple(sorted(kw.items())))
                calls = records[_name].setdefault(key, [])
                if len(calls) < _n:
                    calls.append((tuple(copy_of(a) for a in args), kw))
                return _fn(*args, **kw)
            setattr(module, name, recording)
        try:
            yield records
        finally:
            for name, (module, fn) in saved.items():
                setattr(module, name, fn)
    return record


def path_calls_equal_plain(torch, records, what: str) -> dict:
    """Run each call `path_call_recorder` recorded again through its kernel
    and through its plain version, and fail unless the two agree bit for
    bit. Returns {kernel name: (max |kernel - plain|, [the shapes])}."""
    from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp, warp_plain
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import (nms_suppress,
                                                         suppress_plain)
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_plain, topk_rows

    def warp_plain_of(*args, **kw):
        return warp_plain(*with_origins(torch, args), **kw)

    def shape(name, args):
        if name == "topk_rows":
            return f"{list(args[0].shape)} k={args[1]}"
        if name == "mosaic_warp":
            b, k = args[1].shape
            return f"[{b},3,{args[0].shape[2]},{args[0].shape[3]}] K={k}"
        return f"{list(args[1].shape)} ({int(args[1].sum())} valid)"

    pairs = {"topk_rows": (topk_rows, topk_plain),
             "mosaic_warp": (mosaic_warp, warp_plain_of),
             "nms_suppress": (nms_suppress, suppress_plain)}
    out = {}
    for name, by_shape in records.items():
        if not by_shape:
            raise AssertionError(f"{what}: no call of {name} recorded")
        kernel, plain = pairs[name]
        err, shapes = 0.0, []
        for calls in by_shape.values():
            for args, kw in calls:
                got, want = kernel(*args, **kw), plain(*args, **kw)
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{name} != plain on {what}'s call "
                                         f"at {shape(name, args)}")
                got, want = got.float(), want.float()
                finite = torch.isfinite(got) & torch.isfinite(want)
                if bool(finite.any()):
                    err = max(err, float((got - want)[finite].abs().max()))
            shapes.append(f"{shape(name, calls[0][0])} x{len(calls)}")
        out[name] = (err, shapes)
    return out


def describe_path_checks(checks: dict) -> str:
    return "; ".join(f"{name} on " + ", ".join(shapes)
                     + f" (max abs err {err})"
                     for name, (err, shapes) in checks.items())


def phase_options(torch, card: str, dev) -> dict:
    """Phase 12 (see the module docstring), on the card `dev`. Returns the
    gate's result, its kernels' launch counts, and each kernel's max |kernel
    - plain| on the calls of (a) and (b)."""
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d
    from pl_yolo_tpu_torch.layers.drops import DropBlock2d
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.tools import accuracy_gate as gate
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.train.trainer import Trainer
    from pl_yolo_tpu_torch.utils import profiler
    from pl_yolo_tpu_torch.utils.config import load_config

    def finite(what, losses):
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"{what}: non-finite {bad}")

    def s2d_apply(module, x):
        with stem_input_s2d():
            return module(x)

    t_phase = time.perf_counter()
    record = path_call_recorder(torch)
    errs = dict.fromkeys(GATE_KERNELS, 0.0)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_options_"))
    try:
        # (a) the accuracy gate, its full recipe and its own floor, whatever
        # the environment says
        note("accuracy gate")
        floor = gate.DEFAULT_FLOORS[GATE_MODEL][0]
        args = gate.argument_parser().parse_args(
            ["--model", GATE_MODEL, "--root", str(tmp / "shapes"), "--out",
             str(tmp / "gate"), "--results", str(tmp / "gate.jsonl"),
             "--device", str(dev), "--floor", str(floor)])
        t0 = time.perf_counter()
        device, model_cfg, data_cfg = gate.prepare(args)
        log(f"[gate] data set written in {time.perf_counter() - t0:.1f} s: "
            f"400 train and 100 val hard-shapes images at {gate.GATE_SIZE}^2")
        reset_launch_counts()
        with record() as calls:
            result, trainer = gate.run(args, device, model_cfg, data_cfg)
        counts = {k: v for k, v in launch_counts().items()
                  if k in GATE_KERNELS}
        steps = int(trainer.state.step)
        jax_map, jax_map50 = JAX_GATE[GATE_MODEL]
        log(f"[gate] {json.dumps(result)}")
        log(f"[gate] {GATE_MODEL}, {result['epochs']} epochs ({steps} steps "
            f"of B={trainer.datamodule.train_batch_size}) at "
            f"{gate.GATE_SIZE}^2: held-out mAP {result['mAP']:.4f}, mAP50 "
            f"{result['mAP50']:.4f} (the JAX package's gate: {jax_map} / "
            f"{jax_map50}; floor {result['floor']}), wall {result['wall_s']}"
            f" s; launches over the fit: "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f" on {card}")
        if not (trainer.best_map >= floor and result["pass"]):
            raise AssertionError(f"accuracy gate failed: mAP "
                                 f"{trainer.best_map} < floor {floor}")
        if min(counts.values()) == 0:
            raise AssertionError(f"the gate's fit launched a kernel of its "
                                 f"path no time: {counts}")
        # the kernels on the fit's own inputs, at the shapes it gave them
        checks = path_calls_equal_plain(torch, calls, "the gate's fit")
        a_gate = sum((gate.GATE_SIZE // s) ** 2 for s in (8, 16, 32))
        warp_k = {key[1][0][1] for key in calls["mosaic_warp"]}
        if not ({key[0][0][-1] for key in calls["topk_rows"]} == {a_gate}
                and warp_k == {4, 1}):
            raise AssertionError(f"the gate's fit: top-k rows "
                                 f"{list(calls['topk_rows'])}, warps "
                                 f"{list(calls['mosaic_warp'])}")
        for name, (err, _) in checks.items():
            errs[name] = max(errs[name], err)
        log(f"[gate] kernel == plain (bit for bit) on the fit's own calls: "
            f"{describe_path_checks(checks)} on {card}")
        del calls

        # (d) the profiler around 3 steps of the gate's model
        note("profiler")
        g = torch.Generator(device=dev).manual_seed(0)
        b, hw = trainer.datamodule.train_batch_size, gate.GATE_SIZE
        images = (torch.rand((b, hw, hw, 3), generator=g, device=dev)
                  * 255).to(torch.uint8)
        labels = torch.zeros((b, 50, 5), device=dev)
        labels[:, :4, 0] = torch.randint(0, 6, (b, 4), generator=g,
                                         device=dev).float()
        labels[:, :4, 1:] = 16 + torch.rand((b, 4, 4), generator=g,
                                            device=dev) * 96
        step = trainer.make_step()
        step(trainer.state, images, labels, generator=g)
        torch.cuda.synchronize(dev)
        timer = profiler.StepTimer()
        with profiler.trace(str(tmp / "trace")) as prof:
            for _ in range(PROFILE_STEPS):
                timer.start()
                with profiler.annotate("train_step"):
                    losses = step(trainer.state, images, labels, generator=g)
                timer.stop(losses["loss"])
        finite("profiled step", losses)
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA \
                    or getattr(e, "is_user_annotation", False):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((us / PROFILE_STEPS, e.key))
        rows.sort(reverse=True)
        trace_file = tmp / "trace" / "trace.json"
        if not trace_file.stat().st_size or not rows:
            raise AssertionError("profiler.trace: no trace file or no "
                                 "device time")
        log(f"[profiler] trace of {PROFILE_STEPS} steps of {GATE_MODEL} at "
            f"B={b}, {hw}^2 ({trace_file.stat().st_size / 1e6:.1f} MB): "
            f"StepTimer mean {timer.mean * 1e3:.2f} ms a step (first "
            f"dropped), device busy {sum(r[0] for r in rows) / 1e3:.2f} ms "
            f"a step; top device ops, us a step: "
            + "; ".join(f"{k[:48]} {us:.1f}" for us, k in rows[:8])
            + f" on {card}")
        del trainer, step

        # (b) yolox_s_dropblock: accumulate_steps, remat, multi-scale
        note("yolox_s_dropblock: accumulate, remat, buckets")
        write_coco(tmp / "coco", OPTIONS_IMAGES, NUM_CLASSES, seed=3)
        model_cfg = load_config(OPTIONS_CONFIG)
        model_cfg["remat"] = True
        model_cfg["optimizer"]["accumulate_steps"] = 2
        model_cfg["schedule"]["no_aug_epochs"] = 0
        _, data_cfg = trainer_configs(load_config, tmp / "coco", 0)
        data_cfg["transform"].update(
            multiscale_sizes=MULTISCALE_SIZES,
            multiscale_interval=MULTISCALE_INTERVAL)
        trainer = Trainer(model_cfg, data_cfg, max_epochs=1,
                          check_val_every_n_epoch=1,
                          output_dir=str(tmp / "runs"), logger="csv",
                          seed=OPTIONS_SEED, device=dev)
        module = trainer.model.module
        drops = [m for m in module.modules() if isinstance(m, DropBlock2d)]
        if not (module.backbone.remat and module.neck.remat
                and len(drops) == 4):
            raise AssertionError("yolox_s_dropblock: remat or DropBlock off")
        weight = module.head.cls_pred0.weight
        micro = []
        make_step = trainer.make_step

        def recording_make_step(out_hw=None):
            step_fn = make_step(out_hw)

            def step(state, images, labels, **kw):
                before = weight.detach().clone()
                losses = step_fn(state, images, labels, **kw)
                micro.append((out_hw, torch.equal(before, weight),
                              {k: float(v) for k, v in losses.items()}))
                return losses
            return step
        trainer.make_step = recording_make_step
        reset_launch_counts()
        t0 = time.perf_counter()
        with record() as calls:
            trainer.fit()
        fit_s = time.perf_counter() - t0
        fit_counts = launch_counts()
        for n, (hw, unchanged, losses) in enumerate(micro):
            finite(f"yolox_s_dropblock micro-step {n}", losses)
            if unchanged != (n % 2 == 0):
                raise AssertionError(
                    f"accumulate_steps 2: params "
                    f"{'unchanged' if unchanged else 'changed'} after "
                    f"micro-step {n + 1}")
        sizes = [tuple(hw) if hw else (SIZE, SIZE) for hw, _, _ in micro]
        visited = sorted(set(sizes))
        if len(micro) != OPTIONS_IMAGES // BATCH or len(visited) != 3 \
                or trainer.state.optimizer.updates != len(micro) // 2:
            raise AssertionError(f"buckets {sizes}, micro-steps {len(micro)}")
        log(f"[options] yolox_s_dropblock.yaml (DropBlock 0.1/7 after each "
            f"stage), bf16, B={BATCH}, remat: true, accumulate_steps: 2, "
            f"buckets {[[SIZE, SIZE]] + MULTISCALE_SIZES} every "
            f"{MULTISCALE_INTERVAL} steps: Trainer.fit {len(micro)} "
            f"micro-steps in {fit_s:.1f} s (validation included), sizes "
            + " ".join(f"{hw[0]}" for hw in sizes)
            + "; params unchanged after micro-steps "
            + ",".join(str(n + 1) for n, m in enumerate(micro) if m[1])
            + ", changed after "
            + ",".join(str(n + 1) for n, m in enumerate(micro) if not m[1])
            + "; loss " + " ".join(f"{m[2]['loss']:.3f}" for m in micro)
            + f"; best mAP {trainer.best_map:.4f}; launches "
            + ", ".join(f"{k} {v}" for k, v in fit_counts.items())
            + f" on {card}")
        if min(fit_counts[k] for k in GATE_KERNELS) == 0:
            raise AssertionError(f"the yolox_s_dropblock fit launched a "
                                 f"kernel of its path no time: {fit_counts}")
        checks = path_calls_equal_plain(torch, calls,
                                        "the yolox_s_dropblock fit")
        row_lengths = {key[0][0][-1] for key in calls["topk_rows"]}
        want = {sum((hw[0] // s) ** 2 for s in (8, 16, 32))
                for hw in [[SIZE, SIZE]] + MULTISCALE_SIZES}
        if row_lengths != want:
            raise AssertionError(f"yolox_s_dropblock: top-k rows of A "
                                 f"{sorted(row_lengths)}, not {sorted(want)}")
        for name, (err, _) in checks.items():
            errs[name] = max(errs[name], err)
        log(f"[options] kernel == plain (bit for bit) on the "
            f"yolox_s_dropblock fit's own calls, every bucket: "
            f"{describe_path_checks(checks)} on {card}")
        del trainer, module, weight, calls

        # the augmented step's peak memory at 640^2 with and without remat
        note("remat peak memory")
        images = bench_images(torch, dev, BATCH)
        labels = train_labels(torch, dev, BATCH)
        aug_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS)
        peaks = {}
        for remat in (False, True):
            cfg = load_config(OPTIONS_CONFIG)
            cfg["remat"] = remat
            model = build_model(cfg, NUM_CLASSES, device=dev, seed=0)
            optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                           total_steps=TOTAL_STEPS)
            state = TrainState.create(model.module, optimizer)
            step = make_train_step(
                model.loss.train_loss, apply_fn=s2d_apply,
                augment_fn=augment.make_augment_fn(aug_cfg, out_s2d=True))
            g = torch.Generator(device=dev).manual_seed(1)
            finite(f"remat {remat} warm-up step",
                   step(state, images, labels, generator=g))
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            for _ in range(MEMORY_STEPS):
                losses = step(state, images, labels, generator=g)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / MEMORY_STEPS * 1e3
            finite(f"remat {remat} step", losses)
            peaks[remat] = (torch.cuda.max_memory_allocated(dev), resident,
                            ms)
            del model, optimizer, state, step, losses
            torch.cuda.empty_cache()
        (p0, r0, ms0), (p1, r1, ms1) = peaks[False], peaks[True]
        gib = 1024 ** 3
        log(f"[options] remat peak memory of the augmented step, "
            f"yolox_s_dropblock bf16 B={BATCH} {SIZE}^2: without "
            f"{p0 / gib:.2f} GiB ({(p0 - r0) / gib:.2f} above the "
            f"{r0 / gib:.2f} resident), with {p1 / gib:.2f} GiB "
            f"({(p1 - r1) / gib:.2f} above), {1 - p1 / p0:.3f} lower; step "
            f"{ms0:.1f} / {ms1:.1f} ms (host clock, {MEMORY_STEPS} steps) "
            f"on {card}")
        if not p1 < p0:
            raise AssertionError(f"remat did not lower the peak: {peaks}")

        # (c) the general-gather augmentation on the NHWC route
        note("general-gather augmentation")
        gen_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS,
                                        **GENERAL_AUG)
        cfg = load_config(CONFIG)
        model = build_model(cfg, NUM_CLASSES, device=dev, seed=0)
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                       total_steps=TOTAL_STEPS)
        state = TrainState.create(model.module, optimizer)
        step = make_train_step(model.loss.train_loss,
                               augment_fn=augment.make_augment_fn(
                                   gen_cfg, out_s2d=False))
        g = torch.Generator(device=dev).manual_seed(2)
        before = launch_counts()
        gen_losses = []
        for n in range(GENERAL_STEPS):
            gen_losses.append({k: float(v) for k, v in step(
                state, images, labels, generator=g).items()})
            finite(f"general-gather step {n}", gen_losses[-1])
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        if launched["mosaic_warp"] != 0 \
                or launched["topk_rows"] != 2 * GENERAL_STEPS:
            raise AssertionError(f"general-gather steps launched {launched}")
        draws = augment.sample_draws(g, BATCH, (SIZE, SIZE), gen_cfg)
        img, lab = augment.device_augment(draws, images, labels, gen_cfg)
        kept = lab[lab.abs().sum(-1) > 0]
        cx, cy, w, h = kept[:, 1:].unbind(-1)
        inside = bool(((cx - w / 2 >= -1e-3) & (cx + w / 2 <= SIZE + 1e-3)
                       & (cy - h / 2 >= -1e-3) & (cy + h / 2 <= SIZE + 1e-3)
                       & (w > 2) & (h > 2)).all())
        if not (inside and len(kept) and bool(torch.isfinite(img).all())):
            raise AssertionError("general-gather batch: labels outside the "
                                 "canvas or non-finite pixels")
        n = GENERAL_CHECK_BATCH
        sub = augment.AugmentDraws(*(t[:n] for t in draws))
        sub = sub._replace(perm=torch.randperm(n, generator=g, device=dev),
                           mix_idx=torch.randperm(n, generator=g,
                                                  device=dev))
        card_img, card_lab = augment.device_augment(sub, images[:n],
                                                    labels[:n], gen_cfg)
        cpu_img, cpu_lab = augment.device_augment(
            sub.to("cpu"), images[:n].cpu(), labels[:n].cpu(), gen_cfg)
        lab_err = float((card_lab.cpu() - cpu_lab).abs().max())
        same_rows = torch.equal(card_lab.cpu().abs().sum(-1) > 0,
                                cpu_lab.abs().sum(-1) > 0)
        pix = (card_img.cpu() - cpu_img).abs()
        log(f"[options] general-gather augmentation (degrees 10, shear 2, "
            f"perspective 5e-4), NHWC, yolox_s.yaml bf16 B={BATCH} {SIZE}^2:"
            f" {GENERAL_STEPS} steps, loss "
            + " ".join(f"{ls['loss']:.4f}" for ls in gen_losses)
            + f", launches {launched}; {len(kept)} labels kept, all inside "
            f"the canvas; card vs CPU on the same draws (B={n}): labels max "
            f"abs err {lab_err:.3e} px (tolerance {AUG_LABEL_TOL}), valid "
            f"rows equal {same_rows}; pixels max {float(pix.max()):.3f}, "
            f"mean {float(pix.mean()):.3e} (tolerance {AUG_PIXEL_TOL}) on "
            f"{card}")
        if not (lab_err <= AUG_LABEL_TOL and same_rows
                and float(pix.max()) <= AUG_PIXEL_TOL[0]
                and float(pix.mean()) <= AUG_PIXEL_TOL[1]):
            raise AssertionError("the card's general-gather augmentation "
                                 "!= the CPU's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[options] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {"gate": result, "launches": counts, "max_abs_err": errs}


def phase_transformers(torch, card: str, dev) -> dict:
    """Phase 13 (see the module docstring), on the card `dev`. Returns the
    top-k kernel's record on the Swin path's rows for the `kernels` line,
    its launches there, and each kernel's max |kernel - plain| on the
    path's own calls."""
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_plain, topk_rows
    from pl_yolo_tpu_torch.ops.nms import postprocess
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.utils.config import (load_config,
                                                validate_model_config)
    t_phase = time.perf_counter()
    record = path_call_recorder(torch)
    torch.backends.cudnn.allow_tf32 = False  # as phase 4 left them
    torch.backends.cuda.matmul.allow_tf32 = False

    def config(name, dtype="keep"):
        path = MODEL_DIR / f"{name}.yaml"
        cfg = validate_model_config(load_config(path), str(path))
        if dtype != "keep":
            cfg["dtype"] = dtype
        return cfg

    def infer(m, x, conf=CONF):
        preds = m.loss.eval_decode(m.module(x))
        return preds, postprocess(preds, conf_threshold=conf,
                                  iou_threshold=IOU, max_det=MAX_DET,
                                  pre_nms_topk=PRE_NMS_TOPK, device=dev)

    def steps_of(model, cfg):
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                       total_steps=TOTAL_STEPS)
        state = TrainState.create(model.module, optimizer)
        return state, make_train_step(model.loss.train_loss), \
            make_train_step(model.loss.train_loss, augment_fn=aug_fn)

    cfg = config("swin_tiny")
    strides = tuple(cfg["loss"]["stride"])
    n_anchors = sum((SIZE // s) ** 2 for s in strides)
    model = build_model(cfg, NUM_CLASSES, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(31)
    requests = [torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
                * 255.0 for _ in range(REQUESTS)]
    labels = train_labels(torch, dev, BATCH)
    aug_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS)
    aug_fn = augment.make_augment_fn(aug_cfg, out_s2d=False)
    aug_images = bench_images(torch, dev, BATCH, seed=4)

    # the Swin path: serving, then training without and with augmentation,
    # its kernel launches counted from 0 and its kernel calls recorded. The
    # random Swin scores every anchor near its head's priors (~1e-4), below
    # CONF: served at CONF_TRAINED, the NMS takes its full 1024 candidates
    # of the 34,000 rows
    note("swin: serving")
    reset_launch_counts()
    served, history, aug_history = [], [], []
    with record() as calls:
        with torch.inference_mode():
            for x in requests:
                before = launch_counts()
                served.append(infer(model, x, CONF_TRAINED))
                assert_launched(before, {"nms_suppress": 1}, "swin request")
        note("swin: training")
        state, step, aug_step = steps_of(model, cfg)
        for n in range(TRAIN_STEPS):
            before = launch_counts()
            history.append(step(state, requests[0], labels))
            assert_launched(before, {"topk_rows": 2}, f"swin step {n}")
        for n in range(AUG_STEPS + 1):
            before = launch_counts()
            aug_history.append(aug_step(state, aug_images, labels,
                                        generator=gen,
                                        aug_enable=n < AUG_STEPS))
            assert_launched(before, {"topk_rows": 2, "mosaic_warp": 2},
                            f"swin augmented step {n}")
    torch.cuda.synchronize()
    path_launches = launch_counts()
    if not all(path_launches[n] > 0 for n in GATE_KERNELS):
        raise AssertionError(f"the swin path skipped a kernel: "
                             f"{path_launches}")
    for preds, det in served:
        served_ok(torch, "swin serving", preds, det, n_anchors, CONF_TRAINED)
    for what, hist in (("step", history), ("augmented step", aug_history)):
        for n, losses in enumerate(hist):
            trained_ok(torch, f"swin {what} {n}", losses)
    rows = {key[0][0]: by for key, by in calls["topk_rows"].items()}
    if set(rows) != {(BATCH, MAX_LABELS, n_anchors),
                     (BATCH, AUG_MAX_LABELS, n_anchors)}:
        raise AssertionError(f"the swin path's top-k rows: {list(rows)}")
    log(f"[swin] swin_tiny.yaml {cfg['backbone']['name']} embed "
        f"{cfg['backbone']['embed_dim']} depths {cfg['backbone']['depths']}"
        f", neck {cfg['neck']['name']}, head {cfg['head']['channels']}, "
        f"strides {list(strides)}, bf16 head (fp32 backbone): {REQUESTS} "
        f"requests of {BATCH}x{SIZE}x{SIZE} ({n_anchors} anchors an image) "
        f"through eval_decode and postprocess at conf {CONF_TRAINED} "
        f"(shapes, finiteness, card == "
        f"CPU postprocess; kept {[int(d.valid.sum()) for _, d in served]}); "
        f"{TRAIN_STEPS} steps (M={MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in history)
        + f"; {AUG_STEPS}+1 augmented steps (NHWC, M={AUG_MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in aug_history)
        + f"; proportion {float(history[-1]['proportion']):.3f} / "
        f"{float(aug_history[-2]['proportion']):.3f}; launches on the path "
        f"{path_launches}")

    # the kernels on the path's own calls, bit for bit; the top-k also
    # against torch.topk
    checks = path_calls_equal_plain(torch, calls, "the swin path")
    for shape, by in rows.items():
        for args, _ in by:
            got = topk_rows(*args)
            if not torch.equal(got, torch.topk(args[0], args[1],
                                               dim=-1).values):
                raise AssertionError(f"topk_rows != torch.topk on the swin "
                                     f"path's rows {shape}")
    log(f"[swin] kernel == plain (bit for bit) on the path's own calls: "
        f"{describe_path_checks(checks)}; topk_rows == torch.topk on each "
        f"recorded row set, on {card}")
    del calls

    # card against CPU: the fp32 head maps at B=1 (TF32 off) of swin_tiny
    # and vit_tiny_moe, and the swin loss and its gradients at B=2
    note("swin: card against CPU")
    x1 = requests[0][:1]
    for name in ("swin_tiny", "vit_tiny_moe"):
        fp32 = build_model(config(name, None), NUM_CLASSES, device=dev,
                           seed=0)
        with torch.inference_mode():
            maps_card = [m.cpu() for m in fp32.module(x1)]
            cpu_model = build_model(config(name, None), NUM_CLASSES,
                                    device="cpu", seed=0)
            maps_cpu = cpu_model.module(x1.cpu())
        scale = max(1.0, max(float(m.abs().max()) for m in maps_cpu))
        err = max(float((a - b).abs().max())
                  for a, b in zip(maps_card, maps_cpu))
        log(f"[swin] {name} fp32 head maps card vs CPU at B=1: max abs err "
            f"{err:.3e} (max |map| {scale:.3f}, tolerance {MAPS_TOL} x "
            f"scale)")
        if not err <= MAPS_TOL * scale:
            raise AssertionError(f"{name} fp32 head maps differ: {err}")
        if name == "swin_tiny":
            with torch.no_grad():
                maps = [m.float() for m in
                        fp32.module.train()(requests[0][:2])]
        del fp32, cpu_model
    sides = {}
    loss_fn = model.loss.train_loss
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        outs = [m.detach().to(device).requires_grad_() for m in maps]
        losses = loss_fn(outs, labels[:2].to(device))
        losses["loss"].backward()
        sides[side] = ({k: float(v.detach()) for k, v in losses.items()},
                       [o.grad.cpu() for o in outs])
    (l_card, g_card), (l_cpu, g_cpu) = sides["card"], sides["cpu"]
    loss_err = max(abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                   for k in l_cpu)
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g_card, g_cpu))
    log(f"[swin] loss card vs CPU on fp32 maps at B=2 ({n_anchors} "
        f"anchors): loss {l_card['loss']:.6f} vs {l_cpu['loss']:.6f}, "
        f"proportion {l_card['proportion']:.4f} vs {l_cpu['proportion']:.4f}"
        f", max relative error of a loss entry {loss_err:.3e}, of a map's "
        f"gradient {grad_err:.3e} (tolerance {LOSS_TOL})")
    if not (loss_err <= LOSS_TOL and grad_err <= LOSS_TOL):
        raise AssertionError(f"swin loss on the card != CPU: {loss_err}, "
                             f"{grad_err}")
    del maps, sides

    # times, on a state whose learning rate stays near 0 (see phase 9)
    note("swin: times")
    torch.cuda.empty_cache()
    model.module.eval()
    with torch.inference_mode():
        infer_ms = cuda_ms(torch, lambda: infer(model, requests[0],
                                                CONF_TRAINED), 10)
        infer_busy, _ = device_profile(torch, lambda: infer(
            model, requests[0], CONF_TRAINED), 3)
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                   total_steps=10 ** 9)
    state = TrainState.create(model.module, optimizer)
    timed = {}
    for what, fn in (("un-augmented", lambda: step(state, requests[0],
                                                   labels)),
                     ("augmented", lambda: aug_step(
                         state, aug_images, labels, generator=gen))):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, fn, iters=6, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, top = device_profile(torch, fn, 2)
        timed[what] = (ms, busy, peak, top)
    log(f"[time] swin_tiny infer+NMS (conf {CONF_TRAINED}) bf16 head "
        f"B={BATCH}: {infer_ms:.3f} "
        f"ms/batch, {BATCH * 1000.0 / infer_ms:.1f} images/s, device "
        f"busy {infer_busy:.3f} ms (idle share "
        f"{1.0 - infer_busy / infer_ms:.3f}) on {card}")
    for what, (ms, busy, peak, top) in timed.items():
        log(f"[time] swin_tiny {what} train step B={BATCH}: {ms:.3f} "
            f"ms/step, {BATCH * 1000.0 / ms:.1f} images/s, device busy "
            f"{busy:.3f} ms (idle share {1.0 - busy / ms:.3f}), peak "
            f"device memory {peak:.2f} GiB on {card}; top kernels, ms "
            f"a step: " + "; ".join(f"{t:.4f} {name[:48]}"
                                    for name, t in top[:6]))
    rec = {}
    # the profiler's per-kernel times sometimes miss events (a "cold" time
    # under the bound); the cold time by CUDA events, the flush's own time
    # taken off, is read beside it
    flush_ms = cuda_ms(torch, l2_cold(torch, lambda: None), iters=20)
    for shape, by in sorted(rows.items()):
        for (args, _), name in zip(by, ("IoU", "-cost")):
            x, k = args
            n_rows, a = x.shape[0] * x.shape[1], x.shape[2]
            bound = {"operations": n_rows * a / PEAK_FP32_FLOPS * 1e3,
                     "bytes": (n_rows * a + n_rows * k) * 4
                     / PEAK_BYTES * 1e3}
            bound_by = max(bound, key=bound.get)

            def call(x=x, k=k):
                return topk_rows(x, k)

            def device(fn):
                return kernel_device_ms(torch, fn, ("topk_rows_kernel",))[
                    "topk_rows_kernel"]
            r = dict(ms=cuda_ms(torch, call, iters=50),
                     device_ms=device(call),
                     cold_ms=device(l2_cold(torch, call)),
                     cold_events_ms=cuda_ms(torch, l2_cold(torch, call),
                                            iters=20) - flush_ms,
                     plain_ms=cuda_ms(torch, lambda: topk_plain(x, k),
                                      iters=5, warmup=1),
                     library_ms=cuda_ms(torch, lambda: torch.topk(
                         x, k, dim=-1).values, iters=50),
                     bound_ms=bound[bound_by], bound_by=bound_by)
            rec[f"M={shape[1]}", name] = r
            fmt = lambda ms: ("not measured" if ms is None
                              else f"{ms * 1e3:.2f} us")
            share = ("not measured" if r["cold_ms"] is None
                     else f"{r['bound_ms'] / r['cold_ms']:.2f}")
            log(f"[time] topk_rows on the swin M={shape[1]} step's {name} "
                f"rows {tuple(x.shape)} k={k}: device time "
                f"{fmt(r['cold_ms'])} with the L2 cold ({share} of the "
                f"bound) in the profiler, {fmt(r['cold_events_ms'])} by CUDA "
                f"events less the flush's {flush_ms * 1e3:.2f} us "
                f"({r['bound_ms'] / r['cold_events_ms']:.2f} of the bound), "
                f"{fmt(r['device_ms'])} back to back; "
                f"{r['ms'] * 1e3:.2f} us a call by CUDA events; plain "
                f"{r['plain_ms'] * 1e3:.2f} us, torch.topk "
                f"{r['library_ms'] * 1e3:.2f} us, bound "
                f"{r['bound_ms'] * 1e3:.3f} us ({bound_by}) on {card}")
    del state, optimizer, step, aug_step, model
    torch.cuda.empty_cache()

    # the CLI on a few JPEGs: one short epoch and a validation with mAP,
    # in a child process beside the other configs' checks
    finish_cli = start_cli_epoch(MODEL_DIR / "swin_tiny.yaml", "swin",
                                 seed=5)
    try:
        # the other configs: a request each, and 2 augmented steps for the
        # ViT, ViT-MoE, ResTv2 and MCTformer detectors (MCTformer under AdamW)
        others = [(name, config(name), OTHER_AUG_STEPS)
                  for name in ("vit_tiny", "vit_tiny_moe", "restv2_tiny",
                               "mctformer_small")]
        others += [(name, config(name), 0)
                   for name in ("swin_small", "swin_base", "swin_large")]
        v2 = config("swin_tiny")
        v2["backbone"]["name"] = "swin_transformerv2"
        others.append(("swin_tiny as SwinV2", v2, 0))
        for name, c, n_steps in others:
            note(f"{name}")
            m = build_model(c, NUM_CLASSES, device=dev, seed=0)
            n_a = sum((SIZE // s) ** 2 for s in c["loss"].get("stride",
                                                             (8, 16, 32)))
            before = launch_counts()
            with torch.inference_mode():
                preds, det = infer(m, requests[1])
            assert_launched(before, {"nms_suppress": 1},
                            f"{name} request")
            served_ok(torch, f"{name} request", preds, det, n_a, CONF)
            with torch.inference_mode():
                ms = cuda_ms(torch, lambda: infer(m, requests[1]), 3,
                             warmup=1)
            line = (f"[time] {name}: infer+NMS B={BATCH} {ms:.3f} ms, "
                    f"{BATCH * 1000.0 / ms:.1f} images/s")
            if n_steps:
                optimizer, _ = build_optimizer(m.module, c["optimizer"],
                                               total_steps=TOTAL_STEPS)
                state = TrainState.create(m.module, optimizer)
                step = make_train_step(m.loss.train_loss, augment_fn=aug_fn)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                losses = []
                for n in range(n_steps):
                    before = launch_counts()
                    losses.append(step(state, aug_images, labels,
                                       generator=gen))
                    assert_launched(before, {"topk_rows": 2,
                                             "mosaic_warp": 2},
                                    f"{name} augmented step {n}")
                    trained_ok(torch, f"{name} augmented step {n}",
                               losses[-1])
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                step_ms = cuda_ms(torch, lambda: step(
                    state, aug_images, labels, generator=gen), 3, warmup=0)
                line += (f"; {n_steps} augmented steps "
                         f"({type(optimizer).__name__}), loss "
                         + " ".join(f"{float(h['loss']):.4f}"
                                    for h in losses)
                         + f", peak device memory {peak:.2f} GiB; then "
                         f"{step_ms:.1f} ms a step, "
                         f"{BATCH * 1000.0 / step_ms:.1f} images/s")
                del state, optimizer, step
            log(line + f" on {card}")
            del m, preds, det
            torch.cuda.empty_cache()
    finally:
        finish_cli()
    log(f"[swin] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": path_launches["topk_rows"],
            "max_abs_err": {name: err for name, (err, _) in checks.items()},
            "records": rec}


def mobile_configs(load_config, validate_model_config) -> list:
    """The other mobile detectors of phase 14: (name, cfg, s2d route).
    e-yolox_{tiny,m,l,x} as copied; `cspmobilenext` in e-yolox_s.yaml's
    place of ECMNet (its stages as wide); MobileNetV3-S/L and ShuffleNetV2
    (with its SE) in yolox_s.yaml's place of CSPDarknet, with a CSP-PAFPN
    neck and decoupled head as wide as their stage2-4 maps."""
    def config(name):
        path = MODEL_DIR / f"{name}.yaml"
        return validate_model_config(load_config(path), str(path))
    out = [(name, config(name), True)
           for name in ("e-yolox_tiny", "e-yolox_m", "e-yolox_l",
                        "e-yolox_x")]
    csp = config("e-yolox_s")
    csp["backbone"]["name"] = "cspmobilenext"
    out.append(("cspmobilenext (e-yolox_s widths)", csp, True))
    for name, backbone, widths in MOBILE_NHWC:
        cfg = config("yolox_s")
        cfg["backbone"] = dict(backbone)
        cfg["neck"]["channels"] = list(widths)
        cfg["head"]["channels"] = list(widths)
        out.append((name, cfg, False))
    return out


def phase_mobile(torch, card: str, dev) -> dict:
    """Phase 14 (see the module docstring), on the card `dev`. Returns the
    e-YOLOX path's launches of each kernel and each kernel's max |kernel -
    plain| on the path's own calls, for the `kernels` line."""
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_rows
    from pl_yolo_tpu_torch.ops.nms import postprocess
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.utils.config import (load_config,
                                                validate_model_config)
    t_phase = time.perf_counter()
    record = path_call_recorder(torch)
    torch.backends.cudnn.allow_tf32 = False  # as phase 4 left them
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's autotuning (on since phase 9) times every algorithm for each
    # new conv shape: the depthwise convs of eight new models made it most
    # of this phase's time (294 s, against 108 s without, on an NVIDIA
    # H100 80GB HBM3 at 700 W); the phase runs without it and leaves it as
    # it found it
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False

    def config(dtype="keep"):
        cfg = validate_model_config(load_config(E_YOLOX_CONFIG),
                                    str(E_YOLOX_CONFIG))
        if dtype != "keep":
            cfg["dtype"] = dtype
        return cfg

    def infer(m, x):
        preds = m.loss.eval_decode(m.module(x))
        return preds, postprocess(preds, conf_threshold=CONF_TRAINED,
                                  iou_threshold=IOU, max_det=MAX_DET,
                                  pre_nms_topk=PRE_NMS_TOPK, device=dev)

    def s2d_apply(module, x):
        with stem_input_s2d():
            return module(x)

    def aug_step_of(model, s2d):
        return make_train_step(
            model.loss.train_loss, apply_fn=s2d_apply if s2d else None,
            augment_fn=augment.make_augment_fn(aug_cfg, out_s2d=s2d))

    cfg = config()
    n_anchors = sum((SIZE // s) ** 2 for s in cfg["loss"]["stride"])
    model = build_model(cfg, NUM_CLASSES, device=dev, seed=0)
    if not getattr(type(model.module.backbone), "STEM_S2D", False):
        raise AssertionError("ECMNet lost its Focus stem's s2d route")
    gen = torch.Generator(device=dev).manual_seed(41)
    requests = [torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
                * 255.0 for _ in range(REQUESTS)]
    labels = train_labels(torch, dev, BATCH)
    aug_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS)
    aug_images = bench_images(torch, dev, BATCH, seed=5)

    # the e-YOLOX path: serving at conf 1e-6 (the NMS takes its full 1024
    # candidates whatever the random head scores), then training without
    # and with augmentation on the s2d route, its kernel launches counted
    # from 0 and its kernel calls recorded
    note("e-yolox: serving")
    reset_launch_counts()
    served, history, aug_history = [], [], []
    with record() as calls:
        with torch.inference_mode():
            for x in requests:
                before = launch_counts()
                served.append(infer(model, x))
                assert_launched(before, {"nms_suppress": 1},
                                "e-yolox request")
        note("e-yolox: training")
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                       total_steps=TOTAL_STEPS)
        state = TrainState.create(model.module, optimizer)
        step = make_train_step(model.loss.train_loss)
        aug_step = aug_step_of(model, True)
        for n in range(TRAIN_STEPS):
            before = launch_counts()
            history.append(step(state, requests[0], labels))
            assert_launched(before, {"topk_rows": 2}, f"e-yolox step {n}")
        for n in range(AUG_STEPS + 1):
            before = launch_counts()
            aug_history.append(aug_step(state, aug_images, labels,
                                        generator=gen,
                                        aug_enable=n < AUG_STEPS))
            assert_launched(before, {"topk_rows": 2, "mosaic_warp": 2},
                            f"e-yolox augmented step {n}")
    torch.cuda.synchronize()
    path_launches = launch_counts()
    if not all(path_launches[n] > 0 for n in GATE_KERNELS):
        raise AssertionError(f"the e-yolox path skipped a kernel: "
                             f"{path_launches}")
    for preds, det in served:
        served_ok(torch, "e-yolox serving", preds, det, n_anchors,
                  CONF_TRAINED)
    for what, hist in (("step", history), ("augmented step", aug_history)):
        for n, losses in enumerate(hist):
            trained_ok(torch, f"e-yolox {what} {n}", losses)
    rows = {key[0][0]: by for key, by in calls["topk_rows"].items()}
    if set(rows) != {(BATCH, MAX_LABELS, n_anchors),
                     (BATCH, AUG_MAX_LABELS, n_anchors)}:
        raise AssertionError(f"the e-yolox path's top-k rows: {list(rows)}")
    b = cfg["backbone"]
    log(f"[mobile] e-yolox_s.yaml {b['name']} channels {b['channels']} "
        f"depths {b['depths']}, neck {cfg['neck']['name']} "
        f"{cfg['neck']['channels']}, head {cfg['head']['channels']}, "
        f"{cfg['dtype']}: {REQUESTS} requests of {BATCH}x{SIZE}x{SIZE} "
        f"through eval_decode and postprocess at conf {CONF_TRAINED} "
        f"(shapes, finiteness, card == CPU postprocess; kept "
        f"{[int(d.valid.sum()) for _, d in served]}); {TRAIN_STEPS} steps "
        f"(M={MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in history)
        + f"; {AUG_STEPS}+1 augmented steps (s2d, M={AUG_MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in aug_history)
        + f"; proportion {float(history[-1]['proportion']):.3f} / "
        f"{float(aug_history[-2]['proportion']):.3f}; launches on the path "
        f"{path_launches}")

    # the kernels on the path's own calls, bit for bit; the top-k also
    # against torch.topk
    checks = path_calls_equal_plain(torch, calls, "the e-yolox path")
    for shape, by in rows.items():
        for args, _ in by:
            got = topk_rows(*args)
            if not torch.equal(got, torch.topk(args[0], args[1],
                                               dim=-1).values):
                raise AssertionError(f"topk_rows != torch.topk on the "
                                     f"e-yolox path's rows {shape}")
    log(f"[mobile] kernel == plain (bit for bit) on the path's own calls: "
        f"{describe_path_checks(checks)}; topk_rows == torch.topk on each "
        f"recorded row set, on {card}")
    del calls, rows

    # card against CPU: the fp32 head maps at B=1 (TF32 off)
    note("e-yolox: card against CPU")
    x1 = requests[0][:1]
    fp32 = build_model(config(None), NUM_CLASSES, device=dev, seed=0)
    with torch.inference_mode():
        maps_card = [m.cpu() for m in fp32.module(x1)]
        cpu_model = build_model(config(None), NUM_CLASSES, device="cpu",
                                seed=0)
        maps_cpu = cpu_model.module(x1.cpu())
    scale = max(1.0, max(float(m.abs().max()) for m in maps_cpu))
    err = max(float((a - b).abs().max()) for a, b in zip(maps_card, maps_cpu))
    log(f"[mobile] e-yolox_s fp32 head maps card vs CPU at B=1: max abs err "
        f"{err:.3e} (max |map| {scale:.3f}, tolerance {MAPS_TOL} x scale)")
    if not err <= MAPS_TOL * scale:
        raise AssertionError(f"e-yolox_s fp32 head maps differ: {err}")
    del fp32, cpu_model

    # times, on a state whose learning rate stays near 0 (see phase 9)
    note("e-yolox: times")
    torch.cuda.empty_cache()
    model.module.eval()
    with torch.inference_mode():
        infer_ms = cuda_ms(torch, lambda: infer(model, requests[0]), 10)
        infer_busy, _ = device_profile(torch, lambda: infer(
            model, requests[0]), 3)
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                   total_steps=10 ** 9)
    state = TrainState.create(model.module, optimizer)
    timed = {}
    for what, fn in (("un-augmented", lambda: step(state, requests[0],
                                                   labels)),
                     ("augmented (s2d)", lambda: aug_step(
                         state, aug_images, labels, generator=gen))):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, fn, iters=6, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, top = device_profile(torch, fn, 2)
        timed[what] = (ms, busy, peak, top)
    log(f"[time] e-yolox_s infer+NMS (conf {CONF_TRAINED}) bf16 B={BATCH}: "
        f"{infer_ms:.3f} ms/batch, {BATCH * 1000.0 / infer_ms:.1f} images/s,"
        f" device busy {infer_busy:.3f} ms (idle share "
        f"{1.0 - infer_busy / infer_ms:.3f}) on {card}")
    for what, (ms, busy, peak, top) in timed.items():
        log(f"[time] e-yolox_s {what} train step B={BATCH}: {ms:.3f} "
            f"ms/step, {BATCH * 1000.0 / ms:.1f} images/s, device busy "
            f"{busy:.3f} ms (idle share {1.0 - busy / ms:.3f}), peak "
            f"device memory {peak:.2f} GiB on {card}; top kernels, ms "
            f"a step: " + "; ".join(f"{t:.4f} {name[:48]}"
                                    for name, t in top[:6]))
    del state, optimizer, step, aug_step, model
    torch.cuda.empty_cache()

    # the CLI on a few JPEGs: one short epoch and a validation with mAP,
    # in a child process beside the other detectors' checks
    finish_cli = start_cli_epoch(E_YOLOX_CONFIG, "mobile", seed=6)

    # the other mobile detectors: a request and 2 augmented steps each, on
    # the route the trainer would take (s2d behind a Focus stem, else NHWC)
    try:
        for name, c, s2d in mobile_configs(load_config,
                                           validate_model_config):
            note(name)
            m = build_model(c, NUM_CLASSES, device=dev, seed=0)
            if bool(getattr(type(m.module.backbone), "STEM_S2D",
                            False)) != s2d:
                raise AssertionError(f"{name}: the stem route is not {s2d}")
            before = launch_counts()
            with torch.inference_mode():
                preds, det = infer(m, requests[1])
            assert_launched(before, {"nms_suppress": 1}, f"{name} request")
            served_ok(torch, f"{name} request", preds, det, n_anchors,
                      CONF_TRAINED)
            with torch.inference_mode():
                ms = cuda_ms(torch, lambda: infer(m, requests[1]), 3,
                             warmup=1)
            optimizer, _ = build_optimizer(m.module, c["optimizer"],
                                           total_steps=TOTAL_STEPS)
            state = TrainState.create(m.module, optimizer)
            step = aug_step_of(m, s2d)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for n in range(OTHER_AUG_STEPS):
                before = launch_counts()
                losses.append(step(state, aug_images, labels,
                                   generator=gen))
                assert_launched(before, {"topk_rows": 2, "mosaic_warp": 2},
                                f"{name} augmented step {n}")
                trained_ok(torch, f"{name} augmented step {n}", losses[-1])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            step_ms = cuda_ms(torch, lambda: step(state, aug_images, labels,
                                                  generator=gen), 3, warmup=0)
            log(f"[time] {name} ({'s2d' if s2d else 'NHWC'} route): "
                f"infer+NMS B={BATCH} {ms:.3f} ms, "
                f"{BATCH * 1000.0 / ms:.1f} images/s; {OTHER_AUG_STEPS} "
                f"augmented steps, loss "
                + " ".join(f"{float(h['loss']):.4f}" for h in losses)
                + f", peak device memory {peak:.2f} GiB; then "
                f"{step_ms:.1f} ms a step, "
                f"{BATCH * 1000.0 / step_ms:.1f} images/s on {card}")
            del m, preds, det, state, optimizer, step
            torch.cuda.empty_cache()
    finally:
        finish_cli()
    torch.backends.cudnn.benchmark = autotune
    log(f"[mobile] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {n: path_launches[n] for n in kernel_wrappers()},
            "max_abs_err": {name: err for name, (err, _) in checks.items()}}


def deploy_checkpoint(torch, dev, directory: Path) -> None:
    """Train `yolox_s.yaml` (bf16) a step on each of DEPLOY_BATCHES batches
    of scene images and their labels with the trainer's step (SGD, EMA,
    BatchNorm statistics) and save the state, in the trainer's checkpoint
    layout, to `directory`. The schedule's horizon is TOTAL_STEPS, as phase 5's, so
    the steps run in its warm-up."""
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.train.checkpoint import CheckpointManager
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG)
    model = build_model(cfg, NUM_CLASSES, device=dev)
    module = model.module.train()
    optimizer, _ = build_optimizer(module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    state = TrainState.create(module, optimizer)
    step = make_train_step(model.loss.train_loss)
    batches = [scene_batch(torch, dev, BATCH, SIZE, seed)
               for seed in range(DEPLOY_BATCHES)]
    for images, labels in batches:
        losses = step(state, images, labels)
    if not math.isfinite(float(losses["loss"])):
        raise AssertionError(f"deploy checkpoint: loss {losses}")
    CheckpointManager(directory).save(state.step, {
        "step": state.step, "module": state.module.state_dict(),
        "ema_module": state.ema_module.state_dict(),
        "optimizer": state.optimizer.state_dict()}, {"mAP": 0.0})


def phase_deploy(torch, card: str, dev) -> dict:
    """Phase 15 (see the module docstring), on the card `dev`. Returns the
    deploy path's NMS launches, the kernel's max |kernel - plain| on the
    `.pt2`'s own calls and its times there."""
    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.deploy import numpy_infer as ni
    from pl_yolo_tpu_torch.deploy.onnx_numpy_runtime import OnnxModel
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import nms_suppress
    from pl_yolo_tpu_torch.ops.nms import nms_candidates, postprocess
    from pl_yolo_tpu_torch.tools import deploy_cli as cli
    from pl_yolo_tpu_torch.tools import export as export_tool

    def rel_err(got, want):
        return export.max_abs_err(got, want, relative=True)
    from pl_yolo_tpu_torch.train.checkpoint import CheckpointManager
    t_phase = time.perf_counter()
    autotune = torch.backends.cudnn.benchmark  # new conv shapes: see 14
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_deploy_"))
    times = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[what] = time.perf_counter() - t0
        return out

    ckpt = tmp / "checkpoints"
    try:
        # the trained checkpoint: its EMA weights and BN statistics, in an
        # fp32 model (the .pt, ONNX and npz artifacts and the reference
        # forward; TF32 off since phase 4) and in the config's bf16 (the
        # .pt2, as tools.export makes it)
        timed("checkpoint", lambda: deploy_checkpoint(torch, dev, ckpt))
        mgr = CheckpointManager(ckpt)
        tree = mgr.restore()
        ema = tree["ema_module"]
        if ema is None or tree["step"] <= 0:
            raise AssertionError("the checkpoint holds no trained EMA state")
        moved = max(float(t.abs().max()) for k, t in ema.items()
                    if k.endswith("running_mean"))
        if not moved > 0:
            raise AssertionError("the checkpoint's BN statistics are the "
                                 "init's")
        del tree, ema
        fp32, step = timed("load", lambda: export.load_model(
            CONFIG, NUM_CLASSES, dev, ckpt))
        bf16, _ = export.load_model(CONFIG, NUM_CLASSES, dev, ckpt,
                                    fp32=False)
        requests = [scene_batch(torch, dev, BATCH, SIZE, 100 + i)[0]
                    for i in range(REQUESTS)]
        kw = dict(conf=DEPLOY_CONF, nms=IOU)
        serve = {p: export.ServeModule(m.module, m.loss.eval_decode, **kw)
                 for p, m in (("fp32", fp32), ("bf16", bf16))}

        # the artifacts: .pt traced on the card; .pt2 exported on the card
        # and, through the CLI, on the host, then moved to the card
        note("deploy: export")
        timed("torchscript", lambda: export.export_torchscript(
            fp32, tmp / "m.pt", SIZE, BATCH))
        pt = timed("torchscript load", lambda: torch.jit.load(
            str(tmp / "m.pt"), map_location=dev))
        timed("program", lambda: export.export_program(
            bf16, tmp / "card.pt2", BATCH, SIZE, **kw))
        card_pt2 = timed("program load", lambda: export.load_program(
            tmp / "card.pt2", dev))
        rc = timed("program on the host (CLI)", lambda: export_tool.main([
            "-c", str(CONFIG), "--ckpt", str(ckpt), "-o",
            str(tmp / "host.pt2"), "--device", "cpu", "--num-classes",
            str(NUM_CLASSES), "--batch", str(BATCH), "--size", str(SIZE),
            "--conf", str(DEPLOY_CONF), "--nms", str(IOU)]))
        if rc != 0:
            raise AssertionError(f"tools.export --device cpu: exit {rc}")
        host_pt2 = timed("program load and move", lambda: export.load_program(
            tmp / "host.pt2", dev))

        # 4 requests through each, the NMS launches counted from 0 for each;
        # the card .pt2's NMS calls recorded where the operator makes them
        note("deploy: serve")
        record = path_call_recorder(torch, {"nms_suppress": (
            "pl_yolo_tpu_torch.ops.nms", REQUESTS)})

        def pt_serve(x):
            preds = pt(x.permute(0, 3, 1, 2).contiguous())
            return preds, postprocess(preds, conf_threshold=DEPLOY_CONF,
                                      iou_threshold=IOU, device=dev)

        artifacts = {".pt + postprocess": pt_serve, ".pt2": card_pt2,
                     ".pt2 from the host": host_pt2}
        outs, launches = {}, 0
        with torch.no_grad():
            for name, fn in artifacts.items():
                reset_launch_counts()
                if name == ".pt2":
                    with record() as records:
                        outs[name] = [fn(x) for x in requests]
                else:
                    outs[name] = [fn(x) for x in requests]
                torch.cuda.synchronize()
                counts = launch_counts()
                want = {n: REQUESTS if n == "nms_suppress" else 0
                        for n in counts}
                if counts != want:
                    raise AssertionError(f"{name}: launches {counts}, not "
                                         f"{want}")
                launches += counts["nms_suppress"]
            eager = {p: [fn(x) for x in requests] for p, fn in serve.items()}
            ref_maps = [fp32.module(x) for x in requests]
            ref_preds = [fp32.loss.eval_decode(m) for m in ref_maps]
            maps_max = max(float(m.abs().max()) for ms in ref_maps
                           for m in ms)
            del ref_maps
        checks = path_calls_equal_plain(torch, records, "the .pt2 on the card")
        (nms_err, nms_shapes) = checks["nms_suppress"]

        # every artifact against the eager forward on the card
        ts_err = max(rel_err(p.cpu().numpy(), r.cpu().numpy())
                     for (p, _), r in zip(outs[".pt + postprocess"],
                                          ref_preds))
        if not ts_err <= MAPS_TOL:
            raise AssertionError(f".pt vs eager fp32: {ts_err}")
        for name in (".pt2", ".pt2 from the host"):
            for got, want in zip(outs[name], eager["bf16"]):
                err = export.detections_err(got, want)
                if not (err["same_valid"] and err["max_rel"] <= MAPS_TOL):
                    raise AssertionError(f"{name} vs eager bf16: {err}")
        pt2_err = [export.detections_err(g, w) for g, w in
                   zip(outs[".pt2"], eager["bf16"])]
        vs_fp32 = [export.detections_err(g, w) for g, w in
                   zip(outs[".pt2"], eager["fp32"])]
        # a decode of the trained weights may overflow (boxes of infinite
        # width): the comparisons above hold such entries equal only where
        # both sides have the same one; count them
        nonfinite = sum(int((~torch.isfinite(p)).sum()) for p in ref_preds)
        nonfinite_det = sum(int((~torch.isfinite(d[0][d[3]])).any(-1).sum())
                            for d in outs[".pt2"])
        log(f"[deploy] checkpoint: {DEPLOY_STEPS} train steps of "
            f"{CONFIG.name} (bf16, B={BATCH}) on scene images, saved at step "
            f"{step}, EMA BN means up to {moved:.4f}, its eval head maps up "
            f"to {maps_max:.3f}; "
            f"{REQUESTS} requests of {BATCH}x{SIZE}x{SIZE} through each "
            f"artifact on the card, conf {DEPLOY_CONF}, NMS {IOU}: "
            f"nms_suppress launches {REQUESTS} each ({launches} in all), "
            f"none of the other kernels; non-finite entries: {nonfinite} of "
            f"the eager fp32 predictions, {nonfinite_det} valid .pt2 "
            f"detections with a non-finite box")
        log(f"[deploy] .pt (fp32, BN folded) vs eager fp32 predictions: max "
            f"rel err {ts_err:.3e} (tolerance {MAPS_TOL}); .pt2 (bf16) vs "
            f"eager bf16 served: {pt2_err[0]} .. valid "
            f"{[e['n_valid'] for e in pt2_err]} (tolerance: valid and "
            f"classes equal, boxes and scores {MAPS_TOL} of their scale); "
            f"the host-exported .pt2 moved to the card: the same; .pt2 (bf16)"
            f" vs eager fp32 served: valid equal "
            f"{[e['same_valid'] for e in vs_fp32]}")
        log(f"[deploy] the .pt2's own NMS calls == plain bit for bit: "
            f"{', '.join(nms_shapes)} (max abs err {nms_err})")

        # the host artifacts at one image of 256^2 against the card
        note("deploy: host artifacts")
        img = scene_batch(torch, "cpu", 1, DEPLOY_HOST_SIZE, 200)[0].numpy()
        want = cli.eager_predictions(fp32, img)
        meta = timed("npz", lambda: export.export_npz(
            fp32.cfg, fp32, tmp / "m.npz"))
        params, stats, meta = ni.load_npz(tmp / "m.npz")
        npz_err = rel_err(timed("npz run", lambda: ni.forward(
            params, stats, img, meta)), want)
        blob = timed("onnx", lambda: export.export_onnx(
            fp32, 1, DEPLOY_HOST_SIZE))
        onnx_err = rel_err(timed("onnx run", lambda: OnnxModel(
            blob).run({"images": cli.nchw(img)})["predictions"]), want)
        log(f"[deploy] host runtimes vs eager fp32 on the card, 1x"
            f"{DEPLOY_HOST_SIZE}x{DEPLOY_HOST_SIZE}: npz (numpy_infer) max "
            f"rel err {npz_err:.3e}, ONNX ({len(blob) / 2 ** 20:.1f} MiB, "
            f"{len(OnnxModel(blob).nodes)} nodes, numpy runtime) "
            f"{onnx_err:.3e} (tolerance {MAPS_TOL})")
        if not (npz_err <= MAPS_TOL and onnx_err <= MAPS_TOL):
            raise AssertionError(f"host artifacts: npz {npz_err}, onnx "
                                 f"{onnx_err}")

        # times: infer+NMS of each route on the same images, in turns,
        # DEPLOY_ROUNDS rounds of 10 requests each after 2
        note("deploy: times")
        x = requests[0]
        with torch.no_grad():
            routes = {".pt + postprocess": lambda: pt_serve(x),
                      ".pt2": lambda: card_pt2(x),
                      ".pt2 from the host": lambda: host_pt2(x),
                      "eager fp32": lambda: serve["fp32"](x),
                      "eager bf16": lambda: serve["bf16"](x)}
            rounds = {name: [] for name in routes}
            for _ in range(DEPLOY_ROUNDS):
                for name, fn in routes.items():
                    rounds[name].append(cuda_ms(torch, fn, iters=10,
                                                warmup=2))
            ms = {name: min(r) for name, r in rounds.items()}
            preds = ref_preds[0]
            cls_conf, cls_pred = preds[..., 5:].max(-1)
            cand = nms_candidates(preds[..., :4], preds[..., 4] * cls_conf,
                                  cls_pred.to(torch.int32), DEPLOY_CONF,
                                  PRE_NMS_TOPK)
            op = torch.ops.pl_yolo_tpu_torch.nms_suppress
            calls = {"wrapper": lambda: nms_suppress(cand.nms_boxes,
                                                     cand.valid, IOU),
                     "operator": lambda: op(cand.nms_boxes, cand.valid, IOU)}
            # by CUDA events, and the host's time to issue 50 calls (the
            # serving path is host-bound), in turns
            call_us = {n: [] for n in calls}
            issue_us = {n: [] for n in calls}
            for _ in range(3):
                for n, fn in calls.items():
                    call_us[n].append(1e3 * cuda_ms(torch, fn, iters=50))
                    t0 = time.perf_counter()
                    for _ in range(50):
                        fn()
                    issue_us[n].append((time.perf_counter() - t0) * 1e6 / 50)
                    torch.cuda.synchronize()
        # the kernel's time on the .pt2's first NMS input
        first_call = next(iter(records["nms_suppress"].values()))[0]
        boxes, valid, _ = first_call[0]
        rec = nms_record(torch, boxes, valid)
        for name, t in ms.items():
            log(f"[time] deploy infer+NMS {name} B={BATCH}: {t:.3f} ms, "
                f"{BATCH * 1000.0 / t:.1f} images/s (best of "
                f"{DEPLOY_ROUNDS} rounds in turns: "
                f"{', '.join(f'{r:.3f}' for r in rounds[name])} ms) on {card}")
        extra_us = min(issue_us["operator"]) - min(issue_us["wrapper"])
        log(f"[time] deploy: the NMS step through the operator "
            f"{min(call_us['operator']):.2f} us a call by CUDA events, "
            f"{min(issue_us['operator']):.2f} us of host time to issue it, "
            f"vs the wrapper {min(call_us['wrapper']):.2f} / "
            f"{min(issue_us['wrapper']):.2f} us (best of 3 x 50 in turns): "
            f"{extra_us:.2f} us of host time, "
            f"{extra_us / 10.0 / ms['eager bf16']:.3f}% of a "
            f"{ms['eager bf16']:.3f} ms request; nms_suppress on the "
            f".pt2's input: {rec['ms'] * 1e3:.2f} us, plain "
            f"{rec['plain_ms'] * 1e3:.2f} us, bound {rec['bound_ms'] * 1e3:.3f}"
            f" us ({rec['bound_by']}, {rec['n_valid']} valid rows) on {card}")
        log("[time] deploy steps, s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in times.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.benchmark = autotune
    log(f"[deploy] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": nms_err, "record": rec}


def parallel_run(torch, name: str, dev, layout, rows, fp32: bool,
                 steps: int, batch: int = BATCH,
                 parallel: dict | None = None) -> dict:
    """`steps` train steps of `name`.yaml (or of a run label's YAML with
    its keys, `RUN_CONFIGS`) at full width, 640^2, on rows
    `rows` of a global batch of `batch` uint8 images (bench.py's) through
    the trainer's route (the s2d augmentation for a Focus stem, else
    NHWC), from seed 0, with a card generator seeded 7: under `layout`
    through the data-parallel engine (ZeRO, and the model, spatial and
    expert slices, as the YAML, or `parallel` in its place, says), else in
    one process. fp32 (TF32 off since phase 4) or the YAML's dtype.
    Returns the global losses of each step, its seconds, the state and the
    EMA as one process keeps them (fp32; the EMA as validation takes it,
    gathered from the ranks' parts where they hold parts), the engine's
    state bytes and, for the YOLOX configs and `EVAL_RUNS`, the eval
    predictions of the rows through that EMA and their count of detections
    after `postprocess`."""
    from pl_yolo_tpu_torch.data.augment import AugmentConfig, make_augment_fn
    from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.ops.nms import postprocess
    from pl_yolo_tpu_torch.parallel.zero import DataParallel
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import (TrainState, make_eval_step,
                                               make_train_step)
    from pl_yolo_tpu_torch.utils.config import load_config
    config, extra = RUN_CONFIGS.get(name, (name, {}))
    cfg = load_config(MODEL_DIR / f"{config}.yaml")
    cfg.update(extra)
    if fp32:
        cfg["dtype"] = None
    if parallel is not None:
        cfg["parallel"] = parallel
    par = cfg.get("parallel") or {}
    zero = 3 if par.get("zero") == 3 else int(bool(par.get("zero")))
    model = build_model(cfg, NUM_CLASSES, device=dev, seed=0,
                        input_size=(SIZE, SIZE))
    init = {k: v.detach().clone() for k, v in
            model.module.state_dict().items()} if fp32 else None
    engine = (DataParallel(model.module, layout, zero=zero)
              if layout is not None else None)
    optimizer, _ = build_optimizer(
        model.module, cfg["optimizer"], TOTAL_STEPS,
        **(engine.optimizer_views() if engine is not None else {}))
    state = TrainState.create(model.module, optimizer, parallel=engine)
    s2d = getattr(type(model.module.backbone), "STEM_S2D", False)

    def s2d_apply(module, x):
        with stem_input_s2d():
            return module(x)
    step = make_train_step(
        model.loss.train_loss,
        augment_fn=make_augment_fn(AugmentConfig(max_labels=AUG_MAX_LABELS),
                                   out_s2d=s2d),
        apply_fn=s2d_apply if s2d else None)
    images = bench_images(torch, dev, batch, seed=16)[rows]
    labels = train_labels(torch, dev, batch)[rows]
    generator = torch.Generator(device=dev)
    generator.manual_seed(7)
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step(state, images, labels, generator=generator)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in out.items()})
    res = {"losses": losses, "seconds": seconds,
           "rows": (rows.start, rows.stop)}
    eval_module = state.eval_module   # gathered from the ranks' parts
    if fp32:
        if engine is not None and engine.sliced:
            res["state"] = engine.module_state_dict()
            res["bytes"] = engine.state_bytes()
        else:
            res["state"] = {k: v.detach().clone() for k, v in
                            state.module.state_dict().items()}
        res["ema"] = {k: v.detach().clone() for k, v in
                      eval_module.state_dict().items()}
        res["init"] = init
    if name.startswith("yolox_") or name in EVAL_RUNS:
        preds = make_eval_step(model.loss.eval_decode)(
            eval_module, images.float())
        det = postprocess(preds, conf_threshold=CONF_TRAINED,
                          iou_threshold=IOU, device=dev)
        res["preds"] = preds.float().cpu()
        res["detections"] = int(det.valid.sum())
    return res


def rank_child(tag: str, rank: int, port: int, out_dir: str,
               device: str = "cuda:0") -> None:
    """One rank of phase 16, 17 or 19 on the card (this script, run as
    `chip_smoke.py --rank TAG RANK PORT OUT_DIR` by `run_ranks`): the
    phase's runs in turn (`RANK_RUNS[TAG]`), each in fp32 then in its
    bf16, its kernel calls recorded and held to the plain versions; writes
    what it found to OUT_DIR/rank{RANK}.pt."""
    import torch
    sys.path.insert(0, str(ROOT))
    from pl_yolo_tpu_torch.parallel import collectives, distributed
    from pl_yolo_tpu_torch.parallel.mesh import Layout
    from pl_yolo_tpu_torch.utils.config import load_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    phase, n, batch, runs = RANK_RUNS[tag]
    dev = torch.device(device)
    distributed.initialize(device=dev, init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=n, local_world_size=n)
    res = {"backend": torch.distributed.get_backend()}
    layouts = {}
    for name, parallel, _, _ in runs:
        par = parallel if parallel is not None else (load_config(
            MODEL_DIR / f"{RUN_CONFIGS.get(name, (name,))[0]}.yaml").get(
                "parallel") or {})
        axes = {"pipe": int(par.get("pipeline", 1)),
                **{a: int(par.get(a, 1))
                   for a in ("model", "spatial", "expert")}}
        layouts[name] = Layout(n // math.prod(axes.values()), **axes)
    # the timed steps wait for the parent's one-process references
    while not (Path(out_dir) / "refs_done").exists():
        time.sleep(0.05)
    reset_launch_counts()
    collectives.STAGED.clear()
    with path_call_recorder(torch)() as records:
        for name, parallel, steps, bf16_steps in runs:
            layout = layouts[name]
            per = batch // layout.data
            rows = slice(layout.data_index * per,
                         (layout.data_index + 1) * per)
            before, t0 = launch_counts(), time.perf_counter()
            res[name] = parallel_run(torch, name, dev, layout, rows,
                                     fp32=True, steps=steps, batch=batch,
                                     parallel=parallel)
            res[name]["index"] = layout.index
            res[name]["widths"] = {a: getattr(layout, a) for a in (
                "data", "model", "spatial", "pipe", "expert")}
            if rank:  # rank 0's gathered state is the one compared
                for k in ("state", "ema", "init"):
                    res[name].pop(k, None)
            if bf16_steps:
                res[name + " bf16"] = parallel_run(
                    torch, name, dev, layout, rows, fp32=False,
                    steps=bf16_steps, batch=batch, parallel=parallel)
            # the run's own launches (the fp32 and bf16 steps, its eval
            # batch) and its wall seconds on this rank
            res[name]["launches"] = {k: v - before[k] for k, v in
                                     launch_counts().items()}
            res[name]["wall_s"] = time.perf_counter() - t0
    res["launches"] = launch_counts()
    res["nms_large_k"] = kernel_wrappers()["nms_suppress"].large_k_launches
    res["checks"] = path_calls_equal_plain(torch, records,
                                           f"rank {rank} of phase {phase}")
    res["staged"] = dict(collectives.STAGED)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    distributed.shutdown()


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def state_change_err(torch, got: dict, want: dict, init: dict) -> float:
    """max over the float tensors of |got - want| / (its change since
    `init`, at least 1e-3 of the largest change)."""
    changes = {k: float((want[k].double() - init[k].double()).abs().max())
               for k in want if want[k].is_floating_point()
               and want[k].numel()}
    floor = 1e-3 * max(changes.values())
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(change, floor) for k, change in changes.items())


def tree_change_err(got: dict, want: dict, init: dict) -> float:
    """|got - want| / |want - init| over the float tensors of a state
    dict, each norm over the whole tree."""
    err = change = 0.0
    for k, w in want.items():
        if w.is_floating_point():
            w = w.double()
            err += float((got[k].double().to(w.device) - w).square().sum())
            change += float((w - init[k].double().to(w.device))
                            .square().sum())
    return math.sqrt(err / change)


def run_ranks(torch, tag: str, dev, tmp: Path) -> tuple[list, dict, str]:
    """The ranks of phase 16, 17 or 19 on the one card, spawned once as
    children of this script (`rank_child`), while the one-process
    references of the same runs (fp32, and bf16 for the images/s) are
    computed here; the ranks start their steps once those are done, so
    nothing else runs on the card meanwhile. Returns (each rank's results,
    the references, rank 0's output)."""
    phase, n, batch, runs = RANK_RUNS[tag]
    children = []
    try:
        port = free_port()
        children = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", tag,
             str(r), str(port), str(tmp)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        refs = {}
        for name, _, steps, bf16_steps in runs:
            t0 = time.perf_counter()
            refs[name] = parallel_run(torch, name, dev, None,
                                      slice(0, batch), fp32=True,
                                      steps=steps, batch=batch)
            refs[name]["wall_s"] = time.perf_counter() - t0
            if bf16_steps:
                refs[name + " bf16"] = parallel_run(
                    torch, name, dev, None, slice(0, batch), fp32=False,
                    steps=bf16_steps, batch=batch)
        torch.cuda.empty_cache()
        (tmp / "refs_done").touch()
        logs = [c.communicate(timeout=600)[0] for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    for r, (c, out) in enumerate(zip(children, logs)):
        if c.returncode != 0:
            raise AssertionError(f"phase {phase} rank {r}: exit "
                                 f"{c.returncode}:\n{out[-4000:]}")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(n)]
    return ranks, refs, logs[0]


def preds_err(got, want) -> float:
    """|got - want| over the largest |want| of eval predictions [B, A,
    5 + C], the boxes (the first 4 columns) and the scores each; the
    larger."""
    return max(float((got[..., c] - want[..., c]).abs().max())
               / float(want[..., c].abs().max())
               for c in (slice(0, 4), slice(4, None)))


def hold_ranks(torch, tag: str, ranks: list, refs: dict) -> dict:
    """Phase 16's, 17's or 19's ranks against one process: each rank's fp32
    losses (PARALLEL_LOSS_TOL relative), rank 0's gathered state and EMA
    (PARALLEL_TOL of the change), each rank's eval predictions of its rows
    through the gathered EMA (PARALLEL_PRED_TOL), finite losses in fp32 and
    bf16. Returns {run: {"state", "ema", "preds": the worst errors}}."""
    phase, _, _, runs = RANK_RUNS[tag]
    held = {}
    for name, _, _, bf16_steps in runs:
        ref = refs[name]
        for r, got in enumerate(ranks):
            for i, (g, w) in enumerate(zip(got[name]["losses"],
                                           ref["losses"])):
                for k in w:
                    err = abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
                    if not err <= PARALLEL_LOSS_TOL:
                        raise AssertionError(
                            f"{name}: rank {r} step {i} {k} {g[k]} != "
                            f"one process's {w[k]}")
            for what in ("", " bf16") if bf16_steps else ("",):
                for i, losses in enumerate(got[name + what]["losses"]):
                    if not all(math.isfinite(v) for v in losses.values()):
                        raise AssertionError(f"{name}{what}: rank {r} step "
                                             f"{i}: {losses}")
        err = {part: state_change_err(torch, ranks[0][name][part],
                                      ref[part], ref["init"])
               for part in ("state", "ema")}
        if not max(err.values()) <= PARALLEL_TOL:
            raise AssertionError(f"{name}: the {len(ranks)}-rank state and "
                                 f"EMA are {err} of their change from one "
                                 f"process's (phase {phase})")
        if "preds" in ref:
            err["preds"] = max(
                preds_err(got[name]["preds"],
                          ref["preds"][slice(*got[name]["rows"])])
                for got in ranks)
            if not err["preds"] <= PARALLEL_PRED_TOL:
                raise AssertionError(
                    f"{name}: the eval predictions through the gathered EMA "
                    f"are {err['preds']:.3e} of their scale from one "
                    f"process's (phase {phase})")
        held[name] = err
    return held


def rank_kernels(ranks: list, tag: str) -> tuple[dict, dict]:
    """The kernels' launches summed over the ranks, and the max |kernel -
    plain| of their recorded calls; each rank must have launched each."""
    launches = {k: 0 for k in GATE_KERNELS}
    errs = {k: 0.0 for k in GATE_KERNELS}
    for r, got in enumerate(ranks):
        for k in GATE_KERNELS:
            launches[k] += got["launches"][k]
            errs[k] = max(errs[k], got["checks"][k][0])
        log(f"[{tag}] rank {r} kernel calls == plain, bit for bit: "
            + describe_path_checks(got["checks"]))
        if not all(got["launches"][k] for k in GATE_KERNELS):
            raise AssertionError(f"rank {r} launches {got['launches']}")
        if got["nms_large_k"]:
            raise AssertionError(f"rank {r}: {got['nms_large_k']} NMS calls "
                                 f"took the two-launch path")
    return launches, errs


def phase_parallel(torch, card: str, dev) -> dict:
    """Phase 16 (see the module docstring), on the card `dev`. Returns the
    kernels' launches on the two ranks' paths of step 1 (the torchrun
    ranks' are not counted) and their max |kernel - plain| on the ranks'
    own calls."""
    import yaml
    from pl_yolo_tpu_torch.parallel import distributed
    from pl_yolo_tpu_torch.parallel.mesh import Layout
    from pl_yolo_tpu_torch.parallel.zero import DataParallel
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.train.trainer import Trainer
    from pl_yolo_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    child = None   # torchrun
    try:
        # 1. two ranks on the one card, spawned once; the one-process
        # references meanwhile, here, before the ranks' steps start
        note("parallel: two ranks")
        ranks, refs, log0 = run_ranks(torch, "parallel", dev, tmp)
        for line in log0.splitlines():
            if line.startswith("[parallel]"):
                log(line)
        log(f"[parallel] backend by rule: {ranks[0]['backend']} (2 ranks, "
            f"{torch.cuda.device_count()} card); staged through host "
            f"memory: {ranks[0]['staged'] or 'nothing'}")
        log(f"[parallel] tolerance: each parameter's and EMA tensor's "
            f"change after {PARALLEL_STEPS} fp32 steps within "
            f"{PARALLEL_TOL} of the one-process change, each loss within "
            f"{PARALLEL_LOSS_TOL} (relative): the convs and matmuls see 8 "
            f"rows where one process sees 16, cuDNN may sum in another "
            f"order, BN's statistics are all-reduced partial sums; the eval "
            f"predictions through the gathered EMA within "
            f"{PARALLEL_PRED_TOL} of their scale")
        held = hold_ranks(torch, "parallel", ranks, refs)
        for name, _, steps, _ in RANK_RUNS["parallel"][3]:
            ref, err = refs[name], held[name]
            bf16 = ranks[0][name + " bf16"]["seconds"][1:]
            one_bf16 = refs[name + " bf16"]["seconds"][1:]
            step_s = ranks[0][name]["seconds"][1:]
            log(f"[parallel] {name} fp32, {steps} steps at "
                f"640^2, global batch {BATCH}: 2 ranks == 1 process "
                f"(losses of the last step {ranks[0][name]['losses'][-1]['loss']:.6f} "
                f"vs {ref['losses'][-1]['loss']:.6f}; worst parameter "
                f"{err['state']:.3e}, EMA tensor {err['ema']:.3e} of its "
                f"change); bf16 losses finite; "
                f"{BATCH / (sum(bf16) / len(bf16)):.1f} images/s bf16, "
                f"{BATCH / (sum(step_s) / len(step_s)):.1f} fp32, as 2 ranks "
                f"sharing one card over gloo (no scaling figure; one "
                f"process bf16 {BATCH / (sum(one_bf16) / len(one_bf16)):.1f}"
                f", fp32 "
                f"{BATCH / (sum(ref['seconds'][1:]) / (steps - 1)):.1f})"
                f" on {card}")
        for r, got in enumerate(ranks):
            b = got["yolox_s_zero"]["bytes"]
            log(f"[parallel] yolox_s_zero ZeRO-1, rank {r}: moments + "
                f"accumulation {b['opt_state'] / 2**20:.1f} MiB of one "
                f"process's {b['opt_state_one_process'] / 2**20:.1f}, EMA "
                f"{b['ema'] / 2**20:.1f} of {b['ema_one_process'] / 2**20:.1f}"
                f", params {b['params'] / 2**20:.1f} of "
                f"{b['params_one_process'] / 2**20:.1f} (replicated at "
                f"level 1); {got['yolox_s_zero']['detections']} detections "
                f"on its eval rows through the gathered EMA, its "
                f"predictions within {held['yolox_s_zero']['preds']:.3e} "
                f"(worst rank) of one process's")
            if not b["opt_state"] < 0.55 * b["opt_state_one_process"]:
                raise AssertionError(f"rank {r}: moments not sharded: {b}")
        launches, errs = rank_kernels(ranks, "parallel")

        # 2. torchrun: one epoch and a validation of yolox_s_zero at 320^2,
        # started here and run beside the NCCL step and the one-process fit
        # below; then its rank-0 checkpoint validated by one process
        note("parallel: torchrun")
        write_coco(tmp / "coco", PARALLEL_CLI_IMAGES, NUM_CLASSES, seed=16)
        model_cfg, data_cfg = trainer_configs(load_config, tmp / "coco", 0)
        data_cfg["dataset"].update(
            train_size=[PARALLEL_CLI_SIZE] * 2,
            val_size=[PARALLEL_CLI_SIZE] * 2)
        (tmp / "data.yaml").write_text(yaml.safe_dump(data_cfg))
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(PARALLEL_RANKS), "--master-port",
             str(free_port()), "-m", "pl_yolo_tpu_torch", "-c",
             str(MODEL_DIR / "yolox_s_zero.yaml"), "-d",
             str(tmp / "data.yaml"), "--max_epochs", "1", "--logger", "csv",
             "--output_dir", str(tmp / "runs"), "-n", "zero_cli"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        outputs: list = []
        cli_out = threading.Thread(
            target=lambda: outputs.append(child.communicate()), daemon=True)
        cli_out.start()

        # 3. one rank over NCCL: a ZeRO-3 step puts its all-gathers,
        # reduce-scatters, all-reduces and broadcasts on the card
        note("parallel: NCCL")
        distributed.initialize(device=dev, init_method=f"tcp://127.0.0.1:"
                               f"{free_port()}", rank=0, world_size=1,
                               local_world_size=1)
        try:
            backend = torch.distributed.get_backend()
            cfg = load_config(MODEL_DIR / "yolox_s_zero.yaml")
            model = build_model(cfg, NUM_CLASSES, device=dev, seed=0,
                                input_size=(SIZE, SIZE))
            engine = DataParallel(model.module, Layout(1, 1), zero=3)
            optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                           TOTAL_STEPS,
                                           **engine.optimizer_views())
            state = TrainState.create(model.module, optimizer,
                                      parallel=engine)
            step = make_train_step(model.loss.train_loss)
            z3 = step(state, bench_images(torch, dev, 4).float(),
                      train_labels(torch, dev, 4))
            trained_ok(torch, "ZeRO-3 over NCCL", z3)
            zb = engine.state_bytes()
        finally:
            distributed.shutdown()
        if backend != "nccl":
            raise AssertionError(f"world 1 on the card took {backend}")
        log(f"[parallel] one rank over NCCL: a ZeRO-3 step of yolox_s_zero "
            f"at B=4 (all-gather and reduce-scatter into tensors, "
            f"all-reduce, broadcast on the card), loss "
            f"{float(z3['loss']):.4f}; params held as shards "
            f"{zb['params'] / 2**20:.1f} MiB")

        # one process fits the same configs, beside torchrun; the rank-0
        # checkpoint's weights and EMA against its checkpoint's
        note("parallel: one-process fit beside torchrun")
        model_cfg = load_config(MODEL_DIR / "yolox_s_zero.yaml")
        trainer = Trainer(model_cfg, data_cfg, max_epochs=1, logger="csv",
                          output_dir=str(tmp / "one"), device=dev,
                          experiment_name="zero_one")
        init = {k: v.detach().clone() for k, v in
                trainer.model.module.state_dict().items()}
        trainer.fit()
        cli_out.join(600)
        if not outputs:
            raise AssertionError("torchrun did not end within 600 s")
        cli_s = time.perf_counter() - t0
        stdout, stderr = outputs[0]
        lines = stdout.splitlines()
        maps_line = [line for line in lines if line.startswith("mAP = ")]
        if child.returncode != 0 or not maps_line:
            raise AssertionError(f"torchrun: exit {child.returncode}:\n"
                                 + "\n".join((stdout + stderr)
                                             .splitlines()[-40:]))
        ckpt = tmp / "runs" / "zero_cli" / "checkpoints"

        def last_state(root):
            steps = sorted(root.glob("*/state.pt"),
                           key=lambda p: int(p.parent.name))
            return torch.load(steps[-1], map_location=dev, weights_only=True)
        two = last_state(ckpt)
        one = last_state(tmp / "one" / "zero_one" / "checkpoints")
        if two["step"] != one["step"]:
            raise AssertionError(f"the rank-0 checkpoint is at step "
                                 f"{two['step']}, one process's at "
                                 f"{one['step']}")
        ckpt_err = {part: tree_change_err(two[part], one[part], init)
                    for part in ("module", "ema_module")}
        if not max(ckpt_err.values()) <= PARALLEL_CLI_TOL:
            raise AssertionError(f"the rank-0 checkpoint differs from one "
                                 f"process's fit: {ckpt_err} of the change")
        trainer.load_weights(str(ckpt))
        ap, ap50 = trainer.validate()
        want = float(maps_line[-1].split(",")[0].split("=")[1])
        if round(ap, 4) != want:
            raise AssertionError(f"the rank-0 checkpoint validates to mAP "
                                 f"{ap:.4f} in one process, {want} in two")
        log(f"[parallel] `torchrun --nproc-per-node 2 -m pl_yolo_tpu_torch "
            f"-c yolox_s_zero.yaml` on {PARALLEL_CLI_IMAGES} JPEGs at "
            f"{PARALLEL_CLI_SIZE}^2, beside the NCCL step and the "
            f"one-process fit: exit 0 in {cli_s:.1f} s, "
            f"'{maps_line[-1]}'; its rank-0 checkpoint (step {two['step']}) "
            f"against a one-process fit of the same configs, bf16: weights "
            f"{ckpt_err['module']:.3e}, EMA {ckpt_err['ema_module']:.3e} of "
            f"the change from the init (tolerance {PARALLEL_CLI_TOL}); "
            f"validated in one process: mAP = {ap:.4f}, mAP50 = {ap50:.4f}")
        for line in lines:
            if line.startswith(("[parallel]", "epoch ")):
                log(f"[parallel]   torchrun: {line}")
    finally:
        if child is not None and child.poll() is None:
            child.terminate()   # torchrun passes it on to its ranks
            try:
                child.wait(30)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        torch.backends.cudnn.benchmark = autotune
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[parallel] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": errs}


def phase_tpsp(torch, card: str, dev) -> dict:
    """Phase 17 (see the module docstring), on the card `dev`. Returns the
    kernels' launches on the four ranks' paths and their max |kernel -
    plain| on the ranks' own calls."""
    t_phase = time.perf_counter()
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tpsp_"))
    try:
        note("tpsp: four ranks")
        ranks, refs, _ = run_ranks(torch, "tpsp", dev, tmp)
        log(f"[tpsp] backend by rule: {ranks[0]['backend']} ({TPSP_RANKS} "
            f"ranks, {torch.cuda.device_count()} card); rank 0's calls "
            f"staged through host memory: {ranks[0]['staged'] or 'nothing'}")
        log(f"[tpsp] tolerance: phase 16's, each parameter's and EMA "
            f"tensor's change after the fp32 steps within {PARALLEL_TOL} of "
            f"the one-process change, each loss within {PARALLEL_LOSS_TOL} "
            f"(relative), the eval predictions through the gathered EMA "
            f"within {PARALLEL_PRED_TOL} of their scale: the convs see half "
            f"the couts and half the rows, the MoE's matmuls half the "
            f"tokens, BN's statistics are all-reduced partial sums")
        held = hold_ranks(torch, "tpsp", ranks, refs)
        for name, parallel, steps, _ in RANK_RUNS["tpsp"][3]:
            ref, err = refs[name], held[name]
            step_s = ranks[0][name]["seconds"][1:]
            log(f"[tpsp] {name} {ranks[0][name]['widths']}"
                f"{' (set in the dict)' if parallel else ''}"
                f", {steps} fp32 steps at 640^2, global batch {TPSP_BATCH}: "
                f"4 ranks == 1 process (last losses "
                f"{ranks[0][name]['losses'][-1]['loss']:.6f} vs "
                f"{ref['losses'][-1]['loss']:.6f}; worst parameter "
                f"{err['state']:.3e}, EMA tensor {err['ema']:.3e} of its "
                f"change); "
                f"{TPSP_BATCH / (sum(step_s) / len(step_s)):.2f} images/s "
                f"fp32 as 4 ranks sharing one card over gloo, one process "
                f"{TPSP_BATCH / (sum(ref['seconds'][1:]) / (steps - 1)):.2f}"
                f" (no scaling figure) on {card}")
            for r, got in enumerate(ranks):
                b = got[name]["bytes"]
                log(f"[tpsp] {name} rank {r} {got[name]['index']}: holds "
                    f"params {b['params'] / 2**20:.2f} MiB of one process's "
                    f"{b['params_one_process'] / 2**20:.2f}, moments "
                    f"{b['opt_state'] / 2**20:.2f} of "
                    f"{b['opt_state_one_process'] / 2**20:.2f}, EMA "
                    f"{b['ema'] / 2**20:.2f} of "
                    f"{b['ema_one_process'] / 2**20:.2f}")
                if not b["params"] < 0.6 * b["params_one_process"] and \
                        name == "yolox_s_tp2sp2":
                    raise AssertionError(f"rank {r}: convs not sliced: {b}")
        name = "yolox_s_tp2sp2"
        bf16 = ranks[0][name + " bf16"]["seconds"][1:]
        one_bf16 = refs[name + " bf16"]["seconds"][1:]
        log(f"[tpsp] {name} bf16: losses finite, "
            f"{TPSP_BATCH / (sum(bf16) / len(bf16)):.2f} images/s as 4 ranks "
            f"sharing one card over gloo, one process "
            f"{TPSP_BATCH / (sum(one_bf16) / len(one_bf16)):.2f}"
            f" (no scaling figure); a validation batch of the 8 images "
            f"through the gathered EMA on every rank: predictions within "
            f"{held[name]['preds']:.3e} of their scale (worst rank) of one "
            f"process's EMA's, {ranks[0][name]['detections']} detections "
            f"(one process {refs[name]['detections']}); peak memory a rank "
            f"{max(g['peak_gib'] for g in ranks):.1f} GiB on {card}")
        launches, errs = rank_kernels(ranks, "tpsp")
        log(f"[tpsp] the kernels' launches on the 4 ranks: {launches}")
    finally:
        torch.backends.cudnn.benchmark = autotune
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[tpsp] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": errs}


def phase_combos(torch, card: str, dev) -> dict:
    """Phase 19 (see the module docstring), on the card `dev`. Returns the
    kernels' launches on the four ranks' paths and their max |kernel -
    plain| on the ranks' own calls."""
    t_phase = time.perf_counter()
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_combos_"))
    try:
        note("combos: four ranks")
        ranks, refs, _ = run_ranks(torch, "combos", dev, tmp)
        log(f"[combos] backend by rule: {ranks[0]['backend']} ({TPSP_RANKS} "
            f"ranks, {torch.cuda.device_count()} card); rank 0's calls "
            f"staged through host memory: {ranks[0]['staged'] or 'nothing'}")
        log(f"[combos] tolerance: phase 16's, each parameter's and EMA "
            f"tensor's change after the fp32 steps within {PARALLEL_TOL} of "
            f"the one-process change, each loss within {PARALLEL_LOSS_TOL} "
            f"(relative), the eval predictions through the gathered EMA "
            f"within {PARALLEL_PRED_TOL} of their scale: the convs see half "
            f"the rows, the couts or the groups, the MoE's matmuls half the "
            f"tokens, BN's statistics are all-reduced partial sums")
        held = hold_ranks(torch, "combos", ranks, refs)
        for name, parallel, steps, _ in RANK_RUNS["combos"][3]:
            ref, err = refs[name], held[name]
            step_s = ranks[0][name]["seconds"][1:]
            rows = ranks[0][name]["rows"]
            preds = (f"; a validation batch through the gathered EMA on "
                     f"every rank: predictions within {err['preds']:.3e} of "
                     f"their scale (worst rank), "
                     f"{ranks[0][name]['detections']} detections on rank "
                     f"0's rows {rows[0]}-{rows[1] - 1} (one process "
                     f"{ref['detections']} on the {TPSP_BATCH})"
                     if "preds" in err else "")
            extra = RUN_CONFIGS.get(name, (name, {}))[1]
            log(f"[combos] {name} {ranks[0][name]['widths']} (parallel: "
                f"{parallel}{', ' + str(extra) if extra else ''}"
                f"), {steps} fp32 steps at 640^2, global batch "
                f"{TPSP_BATCH}: 4 ranks == 1 process (last losses "
                f"{ranks[0][name]['losses'][-1]['loss']:.6f} vs "
                f"{ref['losses'][-1]['loss']:.6f}; worst parameter "
                f"{err['state']:.3e}, EMA tensor {err['ema']:.3e} of its "
                f"change){preds}; "
                f"{TPSP_BATCH / (sum(step_s) / len(step_s)):.2f} images/s "
                f"fp32 as 4 ranks sharing one card over gloo, one process "
                f"{TPSP_BATCH / (sum(ref['seconds'][1:]) / (steps - 1)):.2f}"
                f" (no scaling figure) on {card}")
            for r, got in enumerate(ranks):
                b = got[name]["bytes"]
                log(f"[combos] {name} rank {r} {got[name]['index']}: holds "
                    f"params {b['params'] / 2**20:.2f} MiB of one process's "
                    f"{b['params_one_process'] / 2**20:.2f}, moments "
                    f"{b['opt_state'] / 2**20:.2f} of "
                    f"{b['opt_state_one_process'] / 2**20:.2f}, EMA "
                    f"{b['ema'] / 2**20:.2f} of "
                    f"{b['ema_one_process'] / 2**20:.2f}")
                if name == "yolox_s_zero3_model2" and not all(
                        b[k] <= COMBO_BYTES_SHARE * b[k + "_one_process"]
                        for k in ("params", "opt_state", "ema")):
                    raise AssertionError(
                        f"rank {r}: ZeRO-3 over model slices holds more "
                        f"than {COMBO_BYTES_SHARE} of one process's: {b}")
        name = "yolox_s_zero3_model2"
        bf16 = ranks[0][name + " bf16"]["seconds"][1:]
        one_bf16 = refs[name + " bf16"]["seconds"][1:]
        log(f"[combos] {name} bf16: losses finite, "
            f"{TPSP_BATCH / (sum(bf16) / len(bf16)):.2f} images/s as 4 ranks "
            f"sharing one card over gloo, one process "
            f"{TPSP_BATCH / (sum(one_bf16) / len(one_bf16)):.2f}"
            f" (no scaling figure); peak memory a rank "
            f"{max(g['peak_gib'] for g in ranks):.1f} GiB on {card}")
        launches, errs = rank_kernels(ranks, "combos")
        log(f"[combos] the kernels' launches on the 4 ranks: {launches}")
        # (f)-(h): item 12c.4 part 1, each run's own launches
        families = {k: 0 for k in GATE_KERNELS}
        for r, got in enumerate(ranks):
            for name in FAMILY_RUNS:
                run = got[name]["launches"]
                need = (GATE_KERNELS if name in EVAL_RUNS
                        else ("mosaic_warp",))
                if not all(run[k] for k in need):
                    raise AssertionError(f"{name}: rank {r} launched {run}")
                for k in GATE_KERNELS:
                    families[k] += run[k]
        ranks_s = max(sum(g[n]["wall_s"] for n in FAMILY_RUNS)
                      for g in ranks)
        log(f"[families] (f)-(h) {', '.join(FAMILY_RUNS)} under model 2 x "
            f"spatial 2: the kernels' launches on the 4 ranks {families}; "
            f"the runs took {ranks_s:.1f} s on the ranks (worst rank) and "
            f"{sum(refs[n]['wall_s'] for n in FAMILY_RUNS):.1f} s for the "
            f"one-process references here, on {card}")
    finally:
        torch.backends.cudnn.benchmark = autotune
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[combos] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": errs,
            "families": families}


def randomize_(torch, module, gen) -> None:
    """Seeded values for every parameter of `module` (a kernel of
    unit-variance outputs by its first axis, the rest N(0, 0.5²)) and its
    BatchNorm statistics."""
    with torch.no_grad():
        for p in module.parameters():
            std = p[0].numel() ** -0.5 if p.dim() >= 2 else 0.5
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)


def attention_card_vs_cpu(torch, dev, shape=ATTN_SHAPE) -> dict:
    """Every ATTENTION entry on seeded NHWC maps of `shape` with seeded
    weights, on `dev` against the CPU, fp32, eval mode: the output, the
    input's gradient and each parameter's gradient of sum(out · cot).
    Returns {name: (worst error of a tensor / scale, its tensor, the
    module's seconds on the CPU, the output's error / scale, {tensor: its
    error / scale})}."""
    import copy as copy_mod
    from pl_yolo_tpu_torch.layers.attention import ATTENTION, build_attention
    b, h, w, c = shape
    out = {}
    for i, name in enumerate(sorted(ATTENTION)):
        gen = torch.Generator().manual_seed(1800 + i)
        module = build_attention(name, c, size=(h, w),
                                 **ATTN_KWARGS.get(name, {}))
        randomize_(torch, module, gen)
        xs = [torch.randn(shape, generator=gen)
              for _ in range(2 if name == "skff" else 1)]
        runs = {}
        for where in ("cpu", dev):
            t0 = time.perf_counter()
            m = copy_mod.deepcopy(module).to(where).eval()
            x = [t.to(where, copy=True).requires_grad_() for t in xs]
            y = m(x if name == "skff" else x[0])
            if "cot" not in runs:
                runs["cot"] = torch.randn(y.shape, generator=gen)
            (y * runs["cot"].to(where)).sum().backward()
            tensors = {"output": y.detach()}
            tensors.update({f"input {j} gradient": t.grad
                            for j, t in enumerate(x)})
            tensors.update({f"{k} gradient": p.grad
                            for k, p in m.named_parameters()})
            runs[str(where)] = ({k: v.cpu() for k, v in tensors.items()},
                                time.perf_counter() - t0)
        (cpu, cpu_s), (card, _) = runs["cpu"], runs[str(dev)]
        floor = 1e-2 * max(float(v.abs().max()) for k, v in cpu.items()
                           if k != "output")
        worst, errors = (0.0, "output"), {}
        for key, want in cpu.items():
            scale = max(float(want.abs().max()),
                        1e-6 if key == "output" else floor)
            err = float((card[key] - want).abs().max()) / scale
            if not math.isfinite(err):
                raise AssertionError(f"attention {name}: {key} not finite")
            errors[key] = err
            worst = max(worst, (err, key))
        out[name] = (worst[0], worst[1], cpu_s,
                     float((card["output"] - cpu["output"]).abs().max())
                     / max(float(cpu["output"].abs().max()), 1e-6), errors)
    return out


def epsa_conv1_readings(torch, dev, shape=ATTN_SHAPE) -> dict:
    """EPSA's 5x5 `conv1` weight gradient in the case of
    `attention_card_vs_cpu` (its module, input and cotangent drawn as that
    draws them) five ways: on the CPU in fp32 and in float64, and on `dev`
    in fp32 (TF32 off, cuDNN's default algorithm), in fp32 with
    `torch.use_deterministic_algorithms(True, warn_only=True)` and
    `cudnn.deterministic`, in fp32 with cuDNN off (PyTorch's own conv
    kernels), and in float64. Returns {way: (|way - CPU fp32|,
    |way - CPU float64|)}, each the max over the tensor over the scale
    phase 18 (c) gives it."""
    import copy as copy_mod
    from pl_yolo_tpu_torch.layers.attention import ATTENTION, build_attention
    gen = torch.Generator().manual_seed(1800 + sorted(ATTENTION).index("epsa"))
    module = build_attention("epsa", shape[3], size=shape[1:3])
    randomize_(torch, module, gen)
    x = torch.randn(shape, generator=gen)
    cot = torch.randn(shape, generator=gen)   # EPSA keeps x's shape

    def grads(where, dtype, deterministic=False, cudnn=True):
        m = copy_mod.deepcopy(module).to(where, dtype).eval()
        xx = x.to(where, dtype, copy=True).requires_grad_()
        before = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled(),
                  torch.backends.cudnn.deterministic,
                  torch.backends.cudnn.enabled)
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.enabled = cudnn
        try:
            (m(xx) * cot.to(where, dtype)).sum().backward()
        finally:
            torch.use_deterministic_algorithms(before[0], warn_only=before[1])
            torch.backends.cudnn.deterministic = before[2]
            torch.backends.cudnn.enabled = before[3]
        out = {"input": xx.grad.double().cpu()}
        out.update({k: p.grad.double().cpu()
                    for k, p in m.named_parameters()})
        return out

    ways = {"cpu fp32": grads("cpu", torch.float32),
            "cpu float64": grads("cpu", torch.float64),
            "card fp32": grads(dev, torch.float32),
            "card fp32 deterministic": grads(dev, torch.float32, True),
            "card fp32 without cuDNN": grads(dev, torch.float32,
                                             cudnn=False),
            "card float64": grads(dev, torch.float64)}
    cpu32, cpu64 = ways["cpu fp32"], ways["cpu float64"]
    floor = 1e-2 * max(float(v.abs().max()) for v in cpu32.values())
    scale = max(float(cpu32["conv1.weight"].abs().max()), floor)
    return {way: tuple(float((g["conv1.weight"] - ref["conv1.weight"])
                             .abs().max()) / scale for ref in (cpu32, cpu64))
            for way, g in ways.items()}


def calibrate_bn_(torch, module, x) -> None:
    """Set every BatchNorm's running statistics to those of the batch `x`
    (one train-mode forward at momentum 1, no gradient), and leave the
    module in eval mode. From the seeded init (running mean 0, variance
    1) the eval maps of EfficientRep, ResNet and GhostNet grow past what
    the decode's exp can hold (head maps ~100-400 at 128 px on the CPU),
    as a flax init's do; with the statistics of a batch they are those of
    a trained model's scale."""
    bns = [m for m in module.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    module.train()
    with torch.no_grad():
        module(x)
    for m, momentum in zip(bns, saved):
        m.momentum = momentum
    module.eval()


def extras_configs(load_config, validate_model_config) -> list:
    """The other extra detectors of phase 18: (name, cfg) with yolox_s.yaml's
    recipe, the backbone at the JAX defaults, a CSP-PAFPN neck (depths
    1,1,1,1) and a decoupled head as wide as its stage2-4 maps."""
    out = []
    for name, widths in EXTRAS_OTHER:
        cfg = validate_model_config(load_config(CONFIG), str(CONFIG))
        cfg["backbone"] = {"name": name,
                           "outputs": ["stage2", "stage3", "stage4"]}
        cfg["neck"].update(channels=list(widths), depths=[1, 1, 1, 1])
        cfg["head"]["channels"] = list(widths)
        out.append((name, cfg))
    return out


def phase_extras(torch, card: str, dev) -> dict:
    """Phase 18 (see the module docstring), on the card `dev`. Returns the
    ConvNeXt path's launches of each kernel and each kernel's max |kernel
    - plain| on the phase's own calls, for the `kernels` line."""
    import yaml
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_rows
    from pl_yolo_tpu_torch.ops.nms import postprocess
    from pl_yolo_tpu_torch.train.optim import build_optimizer
    from pl_yolo_tpu_torch.train.state import TrainState, make_train_step
    from pl_yolo_tpu_torch.utils.config import (load_config,
                                                validate_model_config)
    t_phase = time.perf_counter()
    record = path_call_recorder(torch)
    torch.backends.cudnn.allow_tf32 = False  # as phase 4 left them
    torch.backends.cuda.matmul.allow_tf32 = False
    autotune = torch.backends.cudnn.benchmark  # off, as in phase 14
    torch.backends.cudnn.benchmark = False

    def config(dtype="keep"):
        path = MODEL_DIR / "yolox_m.yaml"
        cfg = validate_model_config(load_config(path), str(path))
        cfg["backbone"] = dict(CONVNEXT_BACKBONE)
        if dtype != "keep":
            cfg["dtype"] = dtype
        return cfg

    def infer(m, x):
        preds = m.loss.eval_decode(m.module(x))
        return preds, postprocess(preds, conf_threshold=CONF_TRAINED,
                                  iou_threshold=IOU, max_det=MAX_DET,
                                  pre_nms_topk=PRE_NMS_TOPK, device=dev)

    def aug_step_of(model):
        return make_train_step(
            model.loss.train_loss,
            augment_fn=augment.make_augment_fn(aug_cfg, out_s2d=False))

    cfg = config()
    n_anchors = sum((SIZE // s) ** 2 for s in cfg["loss"]["stride"])
    model = build_model(cfg, NUM_CLASSES, device=dev, seed=0)
    backbone = model.module.backbone
    if backbone.out_channels != cfg["neck"]["channels"] or getattr(
            type(backbone), "STEM_S2D", False):
        raise AssertionError(f"ConvNeXt-T: widths {backbone.out_channels}, "
                             f"or a Focus stem's route")
    if any(p.dtype != torch.float32 for p in backbone.parameters()):
        raise AssertionError("ConvNeXt-T holds non-fp32 parameters")
    gen = torch.Generator(device=dev).manual_seed(43)
    requests = [torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device=dev)
                * 255.0 for _ in range(REQUESTS)]
    labels = train_labels(torch, dev, BATCH)
    aug_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS)
    aug_images = bench_images(torch, dev, BATCH, seed=7)

    # (a) the ConvNeXt path: serving at conf 1e-6, then training without
    # and with augmentation on the NHWC route, its launches counted from 0
    # and its kernel calls recorded
    note("convnext: serving")
    reset_launch_counts()
    served, history, aug_history = [], [], []
    with record() as calls:
        with torch.inference_mode():
            for x in requests:
                before = launch_counts()
                served.append(infer(model, x))
                assert_launched(before, {"nms_suppress": 1},
                                "convnext request")
        note("convnext: training")
        optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                       total_steps=TOTAL_STEPS)
        state = TrainState.create(model.module, optimizer)
        step = make_train_step(model.loss.train_loss)
        aug_step = aug_step_of(model)
        for n in range(TRAIN_STEPS):
            before = launch_counts()
            history.append(step(state, requests[0], labels))
            assert_launched(before, {"topk_rows": 2}, f"convnext step {n}")
        note("convnext: augmented training")
        for n in range(AUG_STEPS + 1):
            before = launch_counts()
            aug_history.append(aug_step(state, aug_images, labels,
                                        generator=gen,
                                        aug_enable=n < AUG_STEPS))
            assert_launched(before, {"topk_rows": 2, "mosaic_warp": 2},
                            f"convnext augmented step {n}")
    torch.cuda.synchronize()
    path_launches = launch_counts()
    if not all(path_launches[n] > 0 for n in GATE_KERNELS):
        raise AssertionError(f"the convnext path skipped a kernel: "
                             f"{path_launches}")
    for preds, det in served:
        served_ok(torch, "convnext serving", preds, det, n_anchors,
                  CONF_TRAINED)
    for what, hist in (("step", history), ("augmented step", aug_history)):
        for n, losses in enumerate(hist):
            trained_ok(torch, f"convnext {what} {n}", losses)
    rows = {key[0][0]: by for key, by in calls["topk_rows"].items()}
    if set(rows) != {(BATCH, MAX_LABELS, n_anchors),
                     (BATCH, AUG_MAX_LABELS, n_anchors)}:
        raise AssertionError(f"the convnext path's top-k rows: {list(rows)}")
    log(f"[extras] ConvNeXt-T (depths {list(backbone.depths)}, stage2-4 "
        f"{backbone.out_channels}, fp32) + yolox_m.yaml neck "
        f"{cfg['neck']['name']} {cfg['neck']['channels']} and head "
        f"{cfg['head']['channels']}, {cfg['dtype']}: {REQUESTS} requests of "
        f"{BATCH}x{SIZE}x{SIZE} through eval_decode and postprocess at conf "
        f"{CONF_TRAINED} (shapes, finiteness, card == CPU postprocess; kept "
        f"{[int(d.valid.sum()) for _, d in served]}); {TRAIN_STEPS} steps "
        f"(M={MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in history)
        + f"; {AUG_STEPS}+1 augmented steps (NHWC, M={AUG_MAX_LABELS}), loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in aug_history)
        + f"; proportion {float(history[-1]['proportion']):.3f} / "
        f"{float(aug_history[-2]['proportion']):.3f}; launches on the path "
        f"{path_launches}")

    # the kernels on the path's own calls, bit for bit; the top-k also
    # against torch.topk
    note("convnext: the path's kernel calls")
    checks = path_calls_equal_plain(torch, calls, "the convnext path")
    for shape, by in rows.items():
        for args, _ in by:
            got = topk_rows(*args)
            if not torch.equal(got, torch.topk(args[0], args[1],
                                               dim=-1).values):
                raise AssertionError(f"topk_rows != torch.topk on the "
                                     f"convnext path's rows {shape}")
    log(f"[extras] kernel == plain (bit for bit) on the path's own calls: "
        f"{describe_path_checks(checks)}; topk_rows == torch.topk on each "
        f"recorded row set, on {card}")
    del calls, rows

    # card against CPU: the fp32 head maps at B=1 (TF32 off)
    note("convnext: card against CPU")
    x1 = requests[0][:1]
    fp32 = build_model(config(None), NUM_CLASSES, device=dev, seed=0)
    with torch.inference_mode():
        maps_card = [m.cpu() for m in fp32.module(x1)]
        cpu_model = build_model(config(None), NUM_CLASSES, device="cpu",
                                seed=0)
        maps_cpu = cpu_model.module(x1.cpu())
    scale = max(1.0, max(float(m.abs().max()) for m in maps_cpu))
    err = max(float((a - b).abs().max()) for a, b in zip(maps_card, maps_cpu))
    log(f"[extras] ConvNeXt-T + yolox_m fp32 head maps card vs CPU at B=1: "
        f"max abs err {err:.3e} (max |map| {scale:.3f}, tolerance "
        f"{MAPS_TOL} x scale)")
    if not err <= MAPS_TOL * scale:
        raise AssertionError(f"ConvNeXt-T fp32 head maps differ: {err}")
    del fp32, cpu_model

    # times, on a state whose learning rate stays near 0 (see phase 9)
    note("convnext: times")
    torch.cuda.empty_cache()
    model.module.eval()
    with torch.inference_mode():
        infer_ms = cuda_ms(torch, lambda: infer(model, requests[0]), 5, 1)
        infer_busy, _ = device_profile(torch, lambda: infer(
            model, requests[0]), 2)
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                   total_steps=10 ** 9)
    state = TrainState.create(model.module, optimizer)
    timed = {}
    for what, fn in (("un-augmented", lambda: step(state, requests[0],
                                                   labels)),
                     ("augmented (NHWC)", lambda: aug_step(
                         state, aug_images, labels, generator=gen))):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, fn, iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, top = device_profile(torch, fn, 1)
        timed[what] = (ms, busy, peak, top)
    log(f"[time] convnext_t infer+NMS (conf {CONF_TRAINED}) bf16 head "
        f"B={BATCH}: {infer_ms:.3f} ms/batch, "
        f"{BATCH * 1000.0 / infer_ms:.1f} images/s, device busy "
        f"{infer_busy:.3f} ms (idle share {1.0 - infer_busy / infer_ms:.3f})"
        f" on {card}")
    for what, (ms, busy, peak, top) in timed.items():
        log(f"[time] convnext_t {what} train step B={BATCH}: {ms:.3f} "
            f"ms/step, {BATCH * 1000.0 / ms:.1f} images/s, device busy "
            f"{busy:.3f} ms (idle share {1.0 - busy / ms:.3f}), peak "
            f"device memory {peak:.2f} GiB on {card}; top kernels, ms "
            f"a step: " + "; ".join(f"{t:.4f} {name[:48]}"
                                    for name, t in top[:6]))
    del state, optimizer, step, aug_step, model
    torch.cuda.empty_cache()

    # the CLI on a few JPEGs, from the config written to a temporary file,
    # in a child process beside (b) and (c)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_extras_"))
    try:
        (tmp / "convnext_t.yaml").write_text(yaml.safe_dump(config()))
        finish_cli = start_cli_epoch(tmp / "convnext_t.yaml", "extras",
                                     seed=8)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        # (b) the other extras: a request and 2 augmented steps each on the
        # NHWC route, their kernel calls held to the plain versions
        with record() as calls:
            for name, c in extras_configs(load_config, validate_model_config):
                note(name)
                t0 = time.perf_counter()
                m = build_model(c, NUM_CLASSES, device=dev, seed=0)
                if m.module.backbone.out_channels != c["neck"]["channels"]:
                    raise AssertionError(f"{name}: stage widths "
                                         f"{m.module.backbone.out_channels}")
                calibrate_bn_(torch, m.module, requests[2])
                before = launch_counts()
                with torch.inference_mode():
                    preds, det = infer(m, requests[1])
                assert_launched(before, {"nms_suppress": 1},
                                f"{name} request")
                served_ok(torch, f"{name} request", preds, det, n_anchors,
                          CONF_TRAINED)
                optimizer, _ = build_optimizer(m.module, c["optimizer"],
                                               total_steps=TOTAL_STEPS)
                state = TrainState.create(m.module, optimizer)
                step = aug_step_of(m)
                losses = []
                for n in range(OTHER_AUG_STEPS):
                    before = launch_counts()
                    losses.append(step(state, aug_images, labels,
                                       generator=gen))
                    assert_launched(before, {"topk_rows": 2,
                                             "mosaic_warp": 2},
                                    f"{name} augmented step {n}")
                    trained_ok(torch, f"{name} augmented step {n}",
                               losses[-1])
                torch.cuda.synchronize()
                log(f"[extras] {name} (stage2-4 {c['neck']['channels']}, "
                    f"{c['dtype']}): BN statistics of one batch, a request "
                    f"(kept {int(det.valid.sum())}), "
                    f"{OTHER_AUG_STEPS} augmented steps (NHWC), loss "
                    + " ".join(f"{float(h['loss']):.4f}" for h in losses)
                    + f"; {time.perf_counter() - t0:.1f} s with the build")
                del m, preds, det, state, optimizer, step
                torch.cuda.empty_cache()
        other = path_calls_equal_plain(torch, calls, "the other extras")
        log(f"[extras] kernel == plain (bit for bit) on the other extras' "
            f"own calls: {describe_path_checks(other)}")
        del calls

        # (c) every ATTENTION entry, card against CPU
        note("attention registry")
        t0 = time.perf_counter()
        attn = attention_card_vs_cpu(torch, dev)
        name, (worst, tensor, *_) = max(attn.items(),
                                        key=lambda kv: kv[1][0])
        out_name, out_err = max(((n, v[3]) for n, v in attn.items()),
                                key=lambda kv: kv[1])
        slow = sorted(attn.items(), key=lambda kv: -kv[1][2])[:3]
        log(f"[extras] {len(attn)} ATTENTION entries on "
            f"{list(ATTN_SHAPE)} fp32 (NHWC; {ATTN_KWARGS} set), eval "
            f"forward, input and parameter gradients, card (TF32 off) vs "
            f"CPU: worst {worst:.3e} of its scale ({name}: {tensor}), the "
            f"worst output "
            f"{out_err:.3e} ({out_name}); "
            f"{time.perf_counter() - t0:.1f} s, the CPU's longest "
            + ", ".join(f"{n} {v[2]:.1f} s" for n, v in slow))
        bad = {(n, k): err for n, v in attn.items()
               for k, err in v[4].items()
               if not err <= ATTN_TOL_CUDNN.get((n, k), ATTN_TOL)}
        rest = max((err, n, k) for n, v in attn.items()
                   for k, err in v[4].items() if (n, k) not in ATTN_TOL_CUDNN)
        log(f"[extras] every tensor but {list(ATTN_TOL_CUDNN)} within "
            f"{rest[0]:.3e} of its scale ({rest[1]}: {rest[2]}; tolerance "
            f"{ATTN_TOL}); " + "; ".join(
                f"{n} {k} {attn[n][4][k]:.3e} (tolerance {tol})"
                for (n, k), tol in ATTN_TOL_CUDNN.items()))
        for way, (e32, e64) in epsa_conv1_readings(torch, dev).items():
            log(f"[extras] epsa conv1.weight gradient, {way}: {e32:.3e} of "
                f"its scale from the CPU's fp32, {e64:.3e} from its float64")
        if bad:
            raise AssertionError(f"attention card vs CPU beyond {ATTN_TOL} "
                                 f"(or {ATTN_TOL_CUDNN}): {bad}")
    finally:
        try:
            finish_cli()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    torch.backends.cudnn.benchmark = autotune
    log(f"[extras] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    errs = {n: max(checks[n][0], other[n][0]) for n in checks}
    return {"launches": {n: path_launches[n] for n in kernel_wrappers()},
            "max_abs_err": errs}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F
    from pl_yolo_tpu_torch.data import augment
    from pl_yolo_tpu_torch.layers.blocks import stem_input_s2d
    from pl_yolo_tpu_torch.models.detector import build_model
    from pl_yolo_tpu_torch.models.losses.yolox import (simota_assign,
                                                       yolox_decode)
    from pl_yolo_tpu_torch.ops.cuda import build
    from pl_yolo_tpu_torch.ops.cuda.nms_suppress import (
        CLUSTER_MAX_K as NMS_CLUSTER_MAX_K, cluster_fit as nms_cluster_fit,
        nms_suppress, suppress_plain)
    from pl_yolo_tpu_torch.ops.cuda.mosaic_warp import mosaic_warp, warp_plain
    from pl_yolo_tpu_torch.ops.cuda.simota import (simota_fused,
                                                   simota_fused_plain)
    from pl_yolo_tpu_torch.ops.cuda.topk import topk_plain, topk_rows
    from pl_yolo_tpu_torch.ops.mosaic import mosaic_sample_idx, warp_sample_idx
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
    import chip_nms_ab
    # the NMS kernel cut after its IoU pass, for the phase split of step 9
    finish_cut = chip_nms_ab.start_cut_build(build)
    build.build(["nms_suppress", "topk_rows", "mosaic_warp", "simota_assign"])
    nms_cut, cut_log = finish_cut()
    log(f"[build] nms_suppress, topk_rows, mosaic_warp and simota_assign "
        f"(and nms_suppress cut after its IoU pass) built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in build.LOGS.items():
        log(f"[ptxas] {name}: {ptxas_summary(out)}")
    log(f"[ptxas] nms_suppress cut: {ptxas_summary(cut_log)}")

    # 3. kernels against their plain versions
    max_err = 0
    log(f"[kernel] nms_suppress: 8-CTA clusters resident at once "
        f"{nms_cluster_fit(PRE_NMS_TOPK)} at K={PRE_NMS_TOPK}, "
        f"{nms_cluster_fit(NMS_CLUSTER_MAX_K)} at K={NMS_CLUSTER_MAX_K}")
    for name, boxes, valid, thr in nms_cases(torch, dev):
        large_before = nms_suppress.large_k_launches
        got = nms_suppress(boxes, valid, thr)
        want = suppress_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"nms_suppress != plain on '{name}': "
                f"{int((got != want).sum())} rows differ")
        large = nms_suppress.large_k_launches - large_before
        if large != (valid.shape[1] > NMS_CLUSTER_MAX_K):
            raise AssertionError(f"nms_suppress on '{name}': {large} launches "
                                 f"of the two-launch path at K="
                                 f"{valid.shape[1]}")
        log(f"[kernel] nms_suppress == plain on {name} "
            f"({tuple(valid.shape)}, {int(got.sum())} kept, "
            f"{'two launches' if large else 'cluster kernel'})")
    # from here on every NMS call of this process is on a path, K <= 1024
    nms_suppress.large_k_launches = 0

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

    def check_warp(name, entry, args, plain_args):
        """The kernel, through the entry the augmentation calls, against its
        plain version; returns max |kernel - plain|."""
        before = mosaic_warp.launches
        got = (mosaic_sample_idx if entry == "mosaic" else warp_sample_idx)(
            *args)
        torch.cuda.synchronize()
        if mosaic_warp.launches != before + 1:
            raise AssertionError(f"{entry} did not launch the kernel on "
                                 f"'{name}'")
        want = warp_plain(*plain_args)
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"mosaic_warp != plain on '{name}': max abs "
                                 f"err {err}")
        return err

    warp_err = 0.0
    graph_cases = {}
    for name, entry, args, plain_args in warp_cases(torch, dev):
        warp_err = max(warp_err, check_warp(name, entry, args, plain_args))
        log(f"[kernel] mosaic_warp == plain (bit for bit) on {name}")
        if args[0].shape[0] == BATCH and args[0].dtype == torch.bfloat16:
            graph_cases.setdefault(entry, (name, args))

    # no host read-back: both entries captured in a CUDA graph and replayed
    for entry, (name, args) in graph_cases.items():
        fn = mosaic_sample_idx if entry == "mosaic" else warp_sample_idx
        if not graph_replay_equal(torch, fn, args):
            raise AssertionError(f"{fn.__name__} replayed from a CUDA graph "
                                 f"!= eager on '{name}'")
        log(f"[kernel] {fn.__name__} captured in a CUDA graph and replayed: "
            f"equal to an eager call bit for bit on {name}")
    rc, named = bad_index_ends_the_run()
    log(f"[kernel] mosaic_warp with a tile index outside the pool (child "
        f"process): exit {rc}, stderr: {named[:120]}")

    def check_simota(name, args):
        """The kernel against its plain version: fg and matched equal,
        pred_iou equal bit for bit; returns (outputs, max |kernel - plain|
        over the three outputs)."""
        before = simota_fused.launches
        got = simota_fused(*args)
        torch.cuda.synchronize()  # a run that does not end stops here
        if simota_fused.launches != before + 1:
            raise AssertionError(f"simota_fused did not launch the kernel on "
                                 f"'{name}'")
        want = simota_fused_plain(*args)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        if not all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(
                f"simota_assign != plain on '{name}': fg differs at "
                f"{int((got[0] != want[0]).sum())} anchors, matched at "
                f"{int((got[1] != want[1]).sum())}, max abs err {err}")
        return got, err

    simota_err = 0.0
    synthetic = simota_cases(torch, dev)
    for name, args in synthetic:
        got, err = check_simota(name, args)
        simota_err = max(simota_err, err)
        log(f"[kernel] simota_assign == plain (fg, matched, pred_iou bit for "
            f"bit) on {name}: {int(got[0].sum())} foreground anchors")

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
    nms_suppress.launches = topk_rows.launches = mosaic_warp.launches = 0
    simota_fused.launches = 0
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
    nms_suppress.launches = topk_rows.launches = mosaic_warp.launches = 0
    simota_fused.launches = 0
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
    topk_inputs = {"pair_iou M=50": pair_iou, "-cost M=50": -cost}
    for name, x in topk_inputs.items():
        topk_err = max(topk_err, check_topk(f"the training path's {name}",
                                            x, TOPK_K))
    log(f"[kernel] topk_rows == plain == torch.topk on the training path's "
        f"pair_iou and -cost {tuple(cost.shape)}")
    del pair_iou, cost

    # 7. training with augmentation, wired as bench.py wires it
    note("training with augmentation")
    aug_cfg = augment.AugmentConfig(max_labels=AUG_MAX_LABELS)
    aug_images = bench_images(torch, dev, BATCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = augment.sample_draws(gen, BATCH, (SIZE, SIZE), aug_cfg)
    card_img, card_lab = augment.device_augment(draws, aug_images, labels,
                                                aug_cfg, out_s2d=True)
    cpu_img, cpu_lab = augment.device_augment(
        draws.to("cpu"), aug_images.cpu(), labels.cpu(), aug_cfg,
        out_s2d=True)
    if (tuple(card_img.shape) != (BATCH, SIZE // 2, SIZE // 2, 12)
            or card_img.dtype != torch.bfloat16
            or tuple(card_lab.shape) != (BATCH, AUG_MAX_LABELS, 5)):
        raise AssertionError(f"augmented batch: {card_img.dtype} "
                             f"{tuple(card_img.shape)}, {tuple(card_lab.shape)}")
    card_lab = card_lab.cpu()
    lab_err = float((card_lab - cpu_lab).abs().max())
    same_rows = torch.equal(card_lab.abs().sum(-1) > 0,
                            cpu_lab.abs().sum(-1) > 0)
    pix = (card_img.float().cpu() - cpu_img.float()).abs()
    log(f"[augment] card vs CPU on the same draws, B={BATCH} {SIZE}^2 uint8 "
        f"in, s2d bf16 out: labels max abs err {lab_err:.3e} px (tolerance "
        f"{AUG_LABEL_TOL}), valid rows equal {same_rows} "
        f"({int((cpu_lab.abs().sum(-1) > 0).sum())} boxes); pixels max "
        f"{float(pix.max()):.3f}, mean {float(pix.mean()):.3e} grey levels "
        f"(tolerance {AUG_PIXEL_TOL})")
    if not (lab_err <= AUG_LABEL_TOL and same_rows
            and float(pix.max()) <= AUG_PIXEL_TOL[0]
            and float(pix.mean()) <= AUG_PIXEL_TOL[1]):
        raise AssertionError("the card's augmentation != the CPU's")
    del cpu_img, pix
    # the top-k kernel on the augmented step's own inputs (M=100), from the
    # augmented batch's maps and labels as phase 6 takes the M=50 ones
    pair_iou, cost = augmented_simota_inputs(
        torch, models["float32"].module, card_img, card_lab.to(dev), strides)
    topk_inputs.update({"pair_iou M=100": pair_iou, "-cost M=100": -cost})
    for name in ("pair_iou M=100", "-cost M=100"):
        topk_err = max(topk_err, check_topk(
            f"the augmented step's {name}", topk_inputs[name], TOPK_K))
    log(f"[kernel] topk_rows == plain == torch.topk on the augmented step's "
        f"pair_iou and -cost {tuple(cost.shape)}")
    del pair_iou, cost

    def s2d_apply(module, x):
        with stem_input_s2d():
            return module(x)

    model = models["bfloat16"]
    optimizer, _ = build_optimizer(model.module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    state = TrainState.create(model.module, optimizer)
    aug_step = make_train_step(
        model.loss.train_loss, apply_fn=s2d_apply,
        augment_fn=augment.make_augment_fn(aug_cfg, out_s2d=True))
    history = []
    nms_suppress.launches = topk_rows.launches = mosaic_warp.launches = 0
    simota_fused.launches = 0
    for n in range(AUG_STEPS + 1):
        before = (mosaic_warp.launches, topk_rows.launches)
        history.append(aug_step(state, aug_images, labels, generator=gen,
                                aug_enable=n < AUG_STEPS))
        per_step = (mosaic_warp.launches - before[0],
                    topk_rows.launches - before[1])
        if per_step != (2, 2):
            raise AssertionError(f"augmented step {n}: {per_step} mosaic-warp "
                                 f"and top-k launches, not (2, 2)")
    torch.cuda.synchronize()
    warp_launches = mosaic_warp.launches
    if warp_launches == 0 or topk_rows.launches == 0:
        raise AssertionError("the augmented path launched no kernel")
    for n, losses in enumerate(history):
        for k, v in losses.items():
            if v.requires_grad or not bool(torch.isfinite(v)):
                raise AssertionError(f"augmented step {n}: bad {k} {v}")
        if not float(losses["proportion"]) > 0:
            raise AssertionError(f"augmented step {n}: no anchor assigned")
    log(f"[training] bf16 with augmentation: {AUG_STEPS} steps of {BATCH}x"
        f"{SIZE}x{SIZE} uint8 through device_augment(out_s2d=True) and the "
        f"s2d stem, then 1 with aug_enable=False: loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in history)
        + f"; proportion {float(history[-2]['proportion']):.2f}; launches "
        f"mosaic_warp {warp_launches}, topk_rows {topk_rows.launches}")
    if simota_fused.launches != 0:
        raise AssertionError("the dense-assignment paths launched the fused "
                             "assignment kernel")

    # 8. training with loss: {pallas_assign: true}: the fused assignment
    # kernel in place of the dense SimOTA and its two top-k launches
    note("training with the fused assignment")
    from pl_yolo_tpu_torch.ops import simota as simota_module
    fused_cfg = copy.deepcopy(cfg)
    fused_cfg["loss"]["pallas_assign"] = True
    fused_model = build_model(fused_cfg, NUM_CLASSES, seed=0)
    fused_loss = fused_model.loss.train_loss
    optimizer, _ = build_optimizer(fused_model.module, cfg["optimizer"],
                                   total_steps=TOTAL_STEPS)
    state = TrainState.create(fused_model.module, optimizer)
    fused_step = make_train_step(fused_loss)
    fused_aug_step = make_train_step(
        fused_loss, apply_fn=s2d_apply,
        augment_fn=augment.make_augment_fn(aug_cfg, out_s2d=True))
    simota_calls = []  # the kernel's inputs as the loss hands them over

    def recording(*args, **kw):
        simota_calls.append(args)
        return simota_fused(*args, **kw)

    history = []
    simota_module.simota_fused = recording
    nms_suppress.launches = topk_rows.launches = mosaic_warp.launches = 0
    simota_fused.launches = 0
    try:
        for n in range(TRAIN_STEPS + AUG_STEPS + 1):
            counts = (simota_fused.launches, topk_rows.launches,
                      mosaic_warp.launches)
            if n < TRAIN_STEPS:
                history.append(fused_step(state, images, labels))
            else:
                history.append(fused_aug_step(
                    state, aug_images, labels, generator=gen,
                    aug_enable=n < TRAIN_STEPS + AUG_STEPS))
            per_step = (simota_fused.launches - counts[0],
                        topk_rows.launches - counts[1],
                        mosaic_warp.launches - counts[2])
            want = (1, 0, 2 if n >= TRAIN_STEPS else 0)
            if per_step != want:
                raise AssertionError(
                    f"fused-assignment step {n}: {per_step} simota_assign, "
                    f"top-k and mosaic-warp launches, not {want}")
    finally:
        simota_module.simota_fused = simota_fused
    torch.cuda.synchronize()
    simota_launches = simota_fused.launches
    if simota_launches == 0 or topk_rows.launches != 0 \
            or nms_suppress.launches != 0:
        raise AssertionError("the fused-assignment path launched the wrong "
                             "kernels")
    for n, losses in enumerate(history):
        for k, v in losses.items():
            if v.requires_grad or not bool(torch.isfinite(v)):
                raise AssertionError(f"fused-assignment step {n}: bad {k} {v}")
        if not float(losses["proportion"]) > 0:
            raise AssertionError(f"fused-assignment step {n}: no anchor "
                                 f"assigned")
    for k, v in fused_model.module.state_dict().items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"fused-assignment path: non-finite {k}")
    log(f"[training] bf16 with loss: {{pallas_assign: true}}: {TRAIN_STEPS} "
        f"steps of {BATCH}x{SIZE}x{SIZE} as in phase 5, then {AUG_STEPS}+1 "
        f"augmented steps as in phase 7: loss "
        + " ".join(f"{float(h['loss']):.4f}" for h in history)
        + f"; launches simota_assign {simota_launches} (one a step), "
        f"topk_rows {topk_rows.launches}, mosaic_warp {mosaic_warp.launches}")

    # the kernel on those steps' own inputs: against its plain version, and
    # against the dense SimOTA (sums in another order: ties may flip)
    step_inputs = {"M=50 un-augmented step": simota_calls[0],
                   "M=100 augmented step": simota_calls[TRAIN_STEPS]}
    for what, args in step_inputs.items():
        got, err = check_simota(f"the {what}'s input", args)
        simota_err = max(simota_err, err)
        dense = simota_assign(*args)
        flips = int((got[0] != dense.fg_mask).sum())
        agree = 1.0 - flips / got[0].numel()
        both = got[0] & dense.fg_mask
        rematched = int((both & (got[1] != dense.matched_gt)).sum())
        log(f"[kernel] simota_assign == plain (bit for bit) on the {what}'s "
            f"input ({int(args[2].sum())} valid labels of "
            f"{args[2].numel()}, {int(got[0].sum())} foreground anchors); "
            f"against the dense SimOTA: fg agreement {agree:.6f}, "
            f"{flips} anchors change side, {rematched} foreground anchors "
            f"matched to another label")
        if agree < SIMOTA_FG_AGREE:
            raise AssertionError(f"fused vs dense SimOTA on the {what}: fg "
                                 f"agreement {agree} < {SIMOTA_FG_AGREE}")

    # the loss through the fused assignment against the dense loss, on phase
    # 6's fp32 head maps at B=2: equal assignments give equal losses
    sides = {}
    for name, fn in (("fused", fused_loss),
                     ("dense", models["float32"].loss.train_loss)):
        outs = [m.detach().requires_grad_() for m in maps]
        losses = fn(outs, labels[:2], use_l1=True)
        losses["loss"].backward()
        sides[name] = ({k: float(v.detach()) for k, v in losses.items()},
                       [o.grad for o in outs])
    with torch.no_grad():
        d = yolox_decode(maps, strides)
        lab = labels[:2]
        args = (lab[..., 1:5], lab[..., 0].long(), lab.sum(dim=2) > 0,
                d.preds[..., :4], d.preds[..., 4], d.preds[..., 5:],
                d.x_shifts, d.y_shifts, d.strides)
        fused_a, dense_a = simota_fused(*args), simota_assign(*args)
    same = (torch.equal(fused_a[0], dense_a.fg_mask)
            and torch.equal(fused_a[1], dense_a.matched_gt))
    (lf, gf), (ld, gd) = sides["fused"], sides["dense"]
    loss_err = max(abs(lf[k] - ld[k]) / max(abs(ld[k]), 1e-12) for k in ld)
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(gf, gd))
    log(f"[loss] fused vs dense assignment on the card, phase 6's fp32 maps "
        f"at B=2: assignments equal {same} ({int(fused_a[0].sum())} "
        f"foreground anchors), loss {lf['loss']:.6f} vs {ld['loss']:.6f}, max "
        f"relative error of a loss entry {loss_err:.3e}, of a map's gradient "
        f"{grad_err:.3e} (tolerance {LOSS_TOL} where the assignments agree)")
    if same and not (loss_err <= LOSS_TOL and grad_err <= LOSS_TOL):
        raise AssertionError(f"loss through the fused assignment != dense: "
                             f"{loss_err}, {grad_err}")
    if not same and float((fused_a[0] == dense_a.fg_mask).float().mean()) \
            < SIMOTA_FG_AGREE:
        raise AssertionError("fused vs dense SimOTA disagree on phase 6's "
                             "maps")

    # 9. times
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

    note("times: nms_suppress")
    main_rec = nms_record(torch, cand.nms_boxes, cand.valid)
    # one launch a call: the split into its passes is the whole kernel's
    # device time against the copy cut after the IoU pass
    split = chip_nms_ab.phase_split(
        torch, chip_nms_ab.bare_call(torch, build.load("nms_suppress")),
        chip_nms_ab.bare_call(torch, nms_cut), cand.nms_boxes, cand.valid, IOU)
    log(f"[profile] nms_suppress stages on the main-path input, us per call: "
        f"nms_cluster_kernel {split['whole_us']:.2f}, of it the IoU pass "
        f"(the copy cut after it) {split['iou_us']:.2f} and the sweep (the "
        f"rest) {split['sweep_us']:.2f}")
    syn_boxes, syn_valid = nms_cases(torch, dev)[0][1:3]
    syn_rec = nms_record(torch, syn_boxes, syn_valid)
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

    # the same step with augmentation, as bench.py runs it, from uint8
    note("times: augmentation and the augmented step")
    aug_fn = augment.make_augment_fn(aug_cfg, out_s2d=True)
    aug_step = make_train_step(loss_fn, augment_fn=aug_fn, apply_fn=s2d_apply)
    aug_ms = cuda_ms(torch, lambda: aug_fn(gen, aug_images, labels), iters=20)
    # the in-step A/B: the same state and batches through the dense and the
    # fused assignment, in turns (dense, fused, fused, dense) at each batch
    ab_steps = {"dense": aug_step, "fused": make_train_step(
        fused_loss, augment_fn=aug_fn, apply_fn=s2d_apply)}
    aug_images64 = bench_images(torch, dev, images64.shape[0], seed=1)
    ab_batches = {BATCH: (aug_images, labels, 8, 2),
                  4 * BATCH: (aug_images64, labels64, 4, 2)}
    ab_ms = {(v, b): [] for v in ab_steps for b in ab_batches}
    ab_busy, ab_peak = {}, {}
    for b, (imgs, labs, iters, warmup) in ab_batches.items():
        for v in ("dense", "fused", "fused", "dense"):
            torch.cuda.reset_peak_memory_stats()
            ab_ms[v, b].append(cuda_ms(torch, lambda: ab_steps[v](
                state, imgs, labs, generator=gen), iters=iters,
                warmup=warmup))
            ab_peak[v, b] = torch.cuda.max_memory_allocated() / 2**30
        for v in ab_steps:
            ab_busy[v, b] = device_profile(torch, lambda: ab_steps[v](
                state, imgs, labs, generator=gen), 2)
    ab_ms = {key: sum(ms) / len(ms) for key, ms in ab_ms.items()}
    aug_step_ms, aug_step64_ms = ab_ms["dense", BATCH], ab_ms["dense", 4 * BATCH]
    aug_peak = ab_peak["dense", 4 * BATCH]
    aug_busy_ms, aug_top = ab_busy["dense", BATCH]
    # the split: the same step fed the batch augmented beforehand (the s2d
    # layout, 100 label slots), and the augmentation's own device time
    pre_img, pre_lab = aug_fn(gen, aug_images, labels)
    pre_step = make_train_step(loss_fn, apply_fn=s2d_apply)
    pre_step_ms = cuda_ms(torch, lambda: pre_step(state, pre_img, pre_lab),
                          iters=10)
    # and the un-augmented step with its labels padded to as many slots
    labels_wide = torch.cat([labels, labels.new_zeros(
        (BATCH, AUG_MAX_LABELS - MAX_LABELS, 5))], dim=1)
    wide_step_ms = cuda_ms(torch, lambda: step(state, images, labels_wide),
                           iters=10)
    aug_alone_busy_ms, aug_alone_top = device_profile(
        torch, lambda: aug_fn(gen, aug_images, labels), 5, 10)
    del pre_img, pre_lab
    del images64, labels64, aug_images64
    for b in ab_batches:
        for v in ab_steps:
            busy, top = ab_busy[v, b]
            log(f"[profile] {v} assignment, augmented step B={b}: device busy "
                f"{busy:.3f} ms of {ab_ms[v, b]:.3f} ms (idle share "
                f"{1.0 - busy / ab_ms[v, b]:.3f}); top kernels, ms per step: "
                + "; ".join(f"{ms:.4f} {name[:48]}" for name, ms in top[:6]))
    for b in ab_batches:
        dense_ms, fused_ms = ab_ms["dense", b], ab_ms["fused", b]
        log(f"[time] augmented train step bf16 B={b}, in turns: dense SimOTA "
            f"{dense_ms:.3f} ms/step ({b * 1000.0 / dense_ms:.1f} images/s, "
            f"device busy {ab_busy['dense', b][0]:.3f} ms), fused "
            f"simota_assign {fused_ms:.3f} ms/step ({b * 1000.0 / fused_ms:.1f}"
            f" images/s, device busy {ab_busy['fused', b][0]:.3f} ms): fused / "
            f"dense {fused_ms / dense_ms:.4f}; peak device memory "
            f"{ab_peak['dense', b]:.2f} / {ab_peak['fused', b]:.2f} GiB on "
            f"{card}")
    log(f"[profile] device busy {aug_busy_ms:.3f} ms of {aug_step_ms:.3f} ms "
        f"per augmented train step (idle share "
        f"{1.0 - aug_busy_ms / aug_step_ms:.3f}); top kernels, ms per step:")
    for name, ms in aug_top:
        log(f"[profile]   {ms:9.4f}  {name[:110]}")
    log(f"[profile] augmentation alone: device busy {aug_alone_busy_ms:.3f} "
        f"ms of {aug_ms:.3f} ms per batch; top kernels, ms per batch:")
    for name, ms in aug_alone_top:
        log(f"[profile]   {ms:9.4f}  {name[:110]}")
    log(f"[time] augmentation alone (device_augment, out_s2d, uint8 in) B="
        f"{BATCH}: {aug_ms:.3f} ms/batch; the train step on the batch "
        f"augmented beforehand (s2d, {AUG_MAX_LABELS} label slots) "
        f"{pre_step_ms:.3f} ms/step; the un-augmented step with its labels "
        f"padded to {AUG_MAX_LABELS} slots {wide_step_ms:.3f} ms/step on "
        f"{card}")
    for b, ms, plain in ((BATCH, aug_step_ms, step_ms),
                         (4 * BATCH, aug_step64_ms, step64_ms)):
        log(f"[time] augmented train step bf16 B={b}: {ms:.3f} ms/step, "
            f"{b * 1000.0 / ms:.1f} images/s; un-augmented in this call "
            f"{plain:.3f} ms/step, {b * 1000.0 / plain:.1f} images/s"
            + (f"; peak device memory {aug_peak:.2f} GiB" if b > BATCH
               else "") + f" on {card}")
    for last in (step(state, images, labels),
                 aug_step(state, aug_images, labels, generator=gen)):
        if not all(bool(torch.isfinite(v)) for v in last.values()):
            raise AssertionError(f"non-finite losses after the timed steps: "
                                 f"{last}")

    def topk_record(x):
        rows, a = x.shape[0] * x.shape[1], x.shape[2]
        # every entry is compared at least once; the bytes bound it
        bound = {"operations": rows * a / PEAK_FP32_FLOPS * 1e3,
                 "bytes": (rows * a + rows * TOPK_K) * 4 / PEAK_BYTES * 1e3}
        bound_by = max(bound, key=bound.get)

        def call():
            return topk_rows(x, TOPK_K)

        def device(fn):
            return kernel_device_ms(torch, fn, ("topk_rows_kernel",))[
                "topk_rows_kernel"]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        host_ms = (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
        return dict(
            ms=cuda_ms(torch, call, iters=50), host_ms=host_ms,
            device_ms=device(call), cold_ms=device(l2_cold(torch, call)),
            plain_ms=cuda_ms(torch, lambda: topk_plain(x, TOPK_K), iters=10),
            library_ms=cuda_ms(
                torch, lambda: torch.topk(x, TOPK_K, dim=-1).values, iters=50),
            bound_ms=bound[bound_by], bound_by=bound_by)

    def us(ms):
        return "not measured" if ms is None else f"{ms * 1e3:.2f} us"

    note("times: topk_rows")
    topk_recs = {name: topk_record(x) for name, x in topk_inputs.items()}
    topk_recs["random"] = topk_record(torch.randn(
        topk_inputs["-cost M=50"].shape, device=dev,
        generator=torch.Generator(dev).manual_seed(3)))
    for name, r in topk_recs.items():
        shape = tuple(topk_inputs.get(name, topk_inputs["-cost M=50"]).shape)
        log(f"[time] topk_rows on {name} {shape} k={TOPK_K}: device time in "
            f"the profiler {us(r['cold_ms'])} with the L2 cold "
            f"({L2_FLUSH_BYTES >> 20} MB written before each launch), "
            f"{us(r['device_ms'])} back to back; {r['ms'] * 1e3:.2f} us a call "
            f"by CUDA events, {r['host_ms'] * 1e3:.2f} us of the host a call; "
            f"plain {r['plain_ms'] * 1e3:.2f} us, torch.topk "
            f"{r['library_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) on {card}")
    # and inside the train steps, where its input comes warm from the L2
    for what, fn in (
            ("the un-augmented step (M=50)",
             lambda: step(state, images, labels)),
            ("the augmented step (M=100)",
             lambda: aug_step(state, aug_images, labels, generator=gen))):
        in_step = kernel_device_ms(torch, fn, ("topk_rows_kernel",), iters=2,
                                   traces=2)["topk_rows_kernel"]
        log(f"[time] topk_rows inside {what}'s profiler window: "
            f"{us(None if in_step is None else in_step / 2)} of device time "
            f"a launch (2 a step) on {card}")

    def mean(key):
        return (topk_recs["pair_iou M=50"][key]
                + topk_recs["-cost M=50"][key]) / 2

    # the mosaic warp on the augmented step's own two calls, recorded as the
    # augmentation makes them
    note("times: mosaic_warp")
    calls = warp_step_calls(torch, aug_fn, gen, aug_images, labels)
    warp_recs = {}
    for what, (args, kw) in zip(("mosaic (K=4)", "mixup (K=1)"), calls):
        got, want = mosaic_warp(*args, **kw), warp_plain(
            *with_origins(torch, args), **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"mosaic_warp != plain on the step's {what}")
        warp_err = max(warp_err, float((got.float() - want.float()).abs().max()))
        bound_ms, bound_by, texels = warp_bound(
            torch, *with_origins(torch, args), kw["hix"], kw["hiy"])
        warp_recs[what] = dict(
            ms=cuda_ms(torch, lambda: mosaic_warp(*args, **kw), iters=50),
            device_ms=kernel_device_ms(
                torch, lambda: mosaic_warp(*args, **kw),
                ("mosaic_warp_kernel",))["mosaic_warp_kernel"],
            plain_ms=cuda_ms(torch, lambda: warp_plain(
                *with_origins(torch, args), **kw), iters=10),
            bound_ms=bound_ms, bound_by=bound_by, texels=texels)
    split = warp_split(torch, calls)
    # the library yardstick: grid_sample over the same [B,3,H,W] output with
    # the K=1 warp's grid (the same sampling but for the partial blend at
    # the edge); the port never calls it. In fp32: grid_sample takes a grid
    # of its input's dtype, and a bf16 grid cannot address 640 columns to
    # within a pixel.
    pool, idx, _, _, xs, ys = with_origins(torch, calls[1][0])
    source = pool[idx[:, 0].long()].float()
    grid = torch.stack([
        (xs * (2.0 / (SIZE - 1)) - 1.0)[:, None, :].expand(-1, SIZE, -1),
        (ys * (2.0 / (SIZE - 1)) - 1.0)[:, :, None].expand(-1, -1, SIZE)],
        dim=-1)

    def library():
        return F.grid_sample(source, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    grid_ms = cuda_ms(torch, library, iters=50)
    same = float(((library() - warp_plain(source, torch.arange(
        BATCH, device=dev)[:, None], *with_origins(torch, calls[1][0])[2:],
        **calls[1][1])).abs() <= 1e-2).float().mean())
    for i, (what, r) in enumerate(warp_recs.items()):
        device_us = ("not measured" if r["device_ms"] is None
                     else f"{r['device_ms'] * 1e3:.2f} us")
        old_dev, old_ev = FIRST_WARP_US[what]
        log(f"[time] mosaic_warp on the step's {what} [{BATCH},3,{SIZE},"
            f"{SIZE}] bf16: {r['ms'] * 1e3:.2f} us a call by CUDA events "
            f"(first version: {old_ev}), {device_us} of device time in the "
            f"profiler (first version: {old_dev}), plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}: {r['texels']} "
            f"distinct source texels) on {card}")
        log(f"[time] mosaic_warp split on the step's {what}, device us a "
            f"call: " + ", ".join(
                f"{name} " + ("not measured" if ms is None
                              else f"{ms * 1e3:.2f}")
                for name, ms in split[i].items())
            + f" on {card}")
    log(f"[time] grid_sample (bilinear, zeros, align_corners, fp32) on the "
        f"mixup call's grid: {grid_ms * 1e3:.2f} us (beside the first "
        f"version: {FIRST_GRID_SAMPLE_US}; {same:.4f} of its values within "
        f"1e-2 of the fp32 K=1 warp's) on {card}")
    # the pool the warps read: the uint8 NHWC batch to bf16, then to the
    # channel-major layout (data/augment.py's two copies before the warps)
    from pl_yolo_tpu_torch.ops.mosaic import to_chw
    _, pool_kernels = device_profile(
        torch, lambda: to_chw(aug_images.to(torch.bfloat16)), 20, 4)
    log(f"[time] the augmentation's pool build (uint8 [{BATCH},{SIZE},{SIZE},"
        f"3] -> bf16 -> [{BATCH},3,{SIZE},{SIZE}]): "
        f"{sum(ms for _, ms in pool_kernels) * 1e3:.2f} us of device time ("
        + "; ".join(f"{ms * 1e3:.2f} {name[:60]}" for name, ms in pool_kernels)
        + f") on {card}")

    def warp_mean(key):
        return sum(r[key] for r in warp_recs.values()) / len(warp_recs)

    # the fused assignment on the fused path's own two inputs: the kernel
    # beside its bound and its plain version, and the assignment alone by
    # the three routes of the loss, in turns
    note("times: simota_assign")
    simota_recs = {}
    for what, args in step_inputs.items():
        bound_ms, bound_by = simota_bound(args)
        by_name = kernel_device_ms(torch, lambda: simota_fused(*args),
                                   [f"{p}_pass" for p in SIMOTA_PASSES])
        passes = {p: by_name[f"{p}_pass"] for p in SIMOTA_PASSES}
        routes = {"fused": lambda: simota_fused(*args),
                  "dense": lambda: simota_assign(*args),
                  "chunked": lambda: simota_assign(*args, chunk=10)}
        alone = {r: [] for r in routes}
        for r in ("fused", "dense", "chunked", "chunked", "dense", "fused"):
            alone[r].append(cuda_ms(torch, routes[r],
                                    iters=50 if r == "fused" else 10))
        simota_recs[what] = dict(
            ms=sum(alone["fused"]) / 2,
            device_ms=(None if None in passes.values()
                       else sum(passes.values())),
            passes=passes,
            plain_ms=cuda_ms(torch, lambda: simota_fused_plain(*args),
                             iters=3, warmup=1),
            dense_ms=sum(alone["dense"]) / 2,
            chunked_ms=sum(alone["chunked"]) / 2,
            bound_ms=bound_ms, bound_by=bound_by,
            candidates=simota_candidates(torch, args))
    for what, r in simota_recs.items():
        old_dev, old_ev, old_passes = FIRST_SIMOTA_US[what]
        device_us = ("not measured" if r["device_ms"] is None
                     else f"{r['device_ms'] * 1e3:.2f} us (passes "
                     + ", ".join(f"{p} " + ("not measured" if ms is None
                                            else f"{ms * 1e3:.2f}")
                                 for p, ms in r["passes"].items()) + ")")
        log(f"[time] simota_assign on the {what}'s input: "
            f"{r['ms'] * 1e3:.2f} us a call by CUDA events (first version: "
            f"{old_ev}), {device_us} of device time in the profiler (first "
            f"version: {old_dev}; {old_passes}), plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); candidates an "
            f"image {r['candidates'][0]} of {n_anchors}; valid rows with "
            f"fewer than 10 anchors inside both gates {r['candidates'][1]} "
            f"on {card}")
        log(f"[time] SimOTA assignment alone on the {what}'s input, in "
            f"turns: fused kernel {r['ms'] * 1e3:.2f} us, dense "
            f"{r['dense_ms'] * 1e3:.2f} us, chunked (assign_chunk 10) "
            f"{r['chunked_ms'] * 1e3:.2f} us on {card}")

    # and on the first synthetic case (B=16, M=100, 1-99 labels an image)
    name, args = synthetic[0]
    syn_ms = cuda_ms(torch, lambda: simota_fused(*args), iters=20)
    syn_plain_ms = cuda_ms(torch, lambda: simota_fused_plain(*args), iters=3,
                           warmup=1)
    syn_dense_ms = cuda_ms(torch, lambda: simota_assign(*args), iters=5,
                           warmup=1)
    by_name = kernel_device_ms(torch, lambda: simota_fused(*args),
                               [f"{p}_pass" for p in SIMOTA_PASSES], 10)
    passes = {p: ms for p in SIMOTA_PASSES
              if (ms := by_name[f"{p}_pass"]) is not None}
    log(f"[time] simota_assign on the synthetic case '{name}' "
        f"({int(args[2].sum())} valid labels): {syn_ms * 1e3:.2f} us a call "
        f"by CUDA events (device time of the passes, us: "
        + ", ".join(f"{p} {ms * 1e3:.2f}" for p, ms in passes.items())
        + f"), plain {syn_plain_ms:.3f} ms, dense SimOTA {syn_dense_ms:.3f} "
        f"ms on {card}")

    def simota_mean(key):
        return sum(r[key] for r in simota_recs.values()) / len(simota_recs)

    # 10. the trainer, in process and through the CLI
    note("trainer")
    phase_trainer(torch, card, dev)

    # 11. the anchor families
    note("anchor families")
    v7 = phase_anchor(torch, card, dev)

    def v7_mean(key):
        recs = [v7["records"]["M=50", name] for name in ("IoU", "-cost")]
        return sum(r[key] for r in recs) / len(recs)

    # 12. the accuracy gate and the YOLOX trainer's options
    note("accuracy gate and options")
    options = phase_options(torch, card, dev)
    max_err = max(max_err, options["max_abs_err"]["nms_suppress"])
    topk_err = max(topk_err, options["max_abs_err"]["topk_rows"])
    warp_err = max(warp_err, options["max_abs_err"]["mosaic_warp"])

    # 13. the transformer backbones
    note("transformer backbones")
    swin = phase_transformers(torch, card, dev)
    max_err = max(max_err, swin["max_abs_err"]["nms_suppress"])
    warp_err = max(warp_err, swin["max_abs_err"]["mosaic_warp"])

    def swin_mean(key):
        recs = [swin["records"][f"M={MAX_LABELS}", name]
                for name in ("IoU", "-cost")]
        return sum(r[key] for r in recs) / len(recs)

    # 14. the mobile backbones: e-YOLOX's launches are added to the YOLOX
    # path's, and given alone as "launches_e_yolox_s"
    note("mobile backbones")
    mobile = phase_mobile(torch, card, dev)
    max_err = max(max_err, mobile["max_abs_err"]["nms_suppress"])
    topk_err = max(topk_err, mobile["max_abs_err"]["topk_rows"])
    warp_err = max(warp_err, mobile["max_abs_err"]["mosaic_warp"])
    e_yolox = mobile["launches"]

    # 15. deploy: a trained checkpoint through every exporter, served
    note("deploy")
    deploy = phase_deploy(torch, card, dev)
    max_err = max(max_err, deploy["max_abs_err"])

    # 16. several ranks on the card: DP, ZeRO, GPipe, torchrun
    note("parallel")
    parallel = phase_parallel(torch, card, dev)
    pl = parallel["launches"]
    max_err = max(max_err, parallel["max_abs_err"]["nms_suppress"])
    topk_err = max(topk_err, parallel["max_abs_err"]["topk_rows"])
    warp_err = max(warp_err, parallel["max_abs_err"]["mosaic_warp"])

    # 17. tensor, spatial and expert parallelism on the card
    note("tpsp")
    tpsp = phase_tpsp(torch, card, dev)
    tl = tpsp["launches"]
    max_err = max(max_err, tpsp["max_abs_err"]["nms_suppress"])
    topk_err = max(topk_err, tpsp["max_abs_err"]["topk_rows"])
    warp_err = max(warp_err, tpsp["max_abs_err"]["mosaic_warp"])

    # 18. the extra backbones and the attention registry: the ConvNeXt
    # path's launches are added, and given alone as "launches_extras"
    note("extras")
    extras = phase_extras(torch, card, dev)
    ex = extras["launches"]
    max_err = max(max_err, extras["max_abs_err"]["nms_suppress"])
    topk_err = max(topk_err, extras["max_abs_err"]["topk_rows"])
    warp_err = max(warp_err, extras["max_abs_err"]["mosaic_warp"])

    # 19. ZeRO, remat, DropBlock and depthwise convs under the model,
    # spatial and expert axes
    note("combos")
    combos = phase_combos(torch, card, dev)
    cl, fl = combos["launches"], combos["families"]
    max_err = max(max_err, combos["max_abs_err"]["nms_suppress"])
    topk_err = max(topk_err, combos["max_abs_err"]["topk_rows"])
    warp_err = max(warp_err, combos["max_abs_err"]["mosaic_warp"])

    if nms_suppress.large_k_launches != 0:
        raise AssertionError(f"{nms_suppress.large_k_launches} NMS calls of "
                             f"phases 4-19 took the two-launch path")
    log(f"[kernel] every NMS call of phases 4-19 in this process and its "
        f"ranks took the cluster kernel, none the two-launch path")
    log(f"[smoke] total wall time {time.perf_counter() - _T0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "nms_suppress", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/nms_pallas.py:29",
        "launches": (nms_launches + e_yolox["nms_suppress"]
                     + deploy["launches"] + pl["nms_suppress"]
                     + tl["nms_suppress"] + ex["nms_suppress"]
                     + cl["nms_suppress"]),
        "launches_e_yolox_s": e_yolox["nms_suppress"],
        "launches_extras": ex["nms_suppress"],
        "launches_deploy": deploy["launches"],
        "launches_parallel": pl["nms_suppress"],
        "launches_tpsp": tl["nms_suppress"],
        "launches_combos": cl["nms_suppress"],
        "launches_families": fl["nms_suppress"],
        "max_abs_err": max_err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "ms_deploy": deploy["record"]["ms"],
        "plain_ms_deploy": deploy["record"]["plain_ms"],
        "bound_ms_deploy": deploy["record"]["bound_ms"],
        "library_ms": None}, {
        "name": "topk_rows", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/topk_rows.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/topk_pallas.py:26",
        "launches": (topk_launches + e_yolox["topk_rows"] + pl["topk_rows"]
                     + tl["topk_rows"] + ex["topk_rows"] + cl["topk_rows"]),
        "launches_e_yolox_s": e_yolox["topk_rows"],
        "launches_extras": ex["topk_rows"],
        "launches_parallel": pl["topk_rows"],
        "launches_tpsp": tl["topk_rows"], "launches_combos": cl["topk_rows"],
        "launches_families": fl["topk_rows"],
        "max_abs_err": topk_err,
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": topk_recs["-cost M=50"]["bound_ms"],
        "bound_by": topk_recs["-cost M=50"]["bound_by"],
        "library_ms": mean("library_ms")}, {
        "name": "mosaic_warp", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/mosaic_warp.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/mosaic_pallas.py:71",
        "launches": (warp_launches + e_yolox["mosaic_warp"]
                     + pl["mosaic_warp"] + tl["mosaic_warp"]
                     + ex["mosaic_warp"] + cl["mosaic_warp"]),
        "launches_e_yolox_s": e_yolox["mosaic_warp"],
        "launches_extras": ex["mosaic_warp"],
        "launches_parallel": pl["mosaic_warp"],
        "launches_tpsp": tl["mosaic_warp"],
        "launches_combos": cl["mosaic_warp"],
        "launches_families": fl["mosaic_warp"],
        "max_abs_err": warp_err,
        "ms": warp_mean("ms"), "plain_ms": warp_mean("plain_ms"),
        "bound_ms": warp_mean("bound_ms"),
        "bound_by": warp_recs["mosaic (K=4)"]["bound_by"],
        "library_ms": grid_ms}, {
        "name": "simota_assign", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/simota_assign.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/simota_pallas.py:49",
        "launches": (simota_launches + e_yolox["simota_assign"]
                     + ex["simota_assign"]),
        "launches_e_yolox_s": e_yolox["simota_assign"],
        "launches_extras": ex["simota_assign"], "max_abs_err": simota_err,
        "ms": simota_mean("ms"), "plain_ms": simota_mean("plain_ms"),
        "bound_ms": simota_mean("bound_ms"),
        "bound_by": simota_recs["M=100 augmented step"]["bound_by"],
        "library_ms": None}, {
        "name": "topk_rows (yolov7 OTA rows)", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/topk_rows.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/topk_pallas.py:26",
        "launches": v7["launches"], "max_abs_err": v7["max_abs_err"],
        "ms": v7_mean("ms"), "plain_ms": v7_mean("plain_ms"),
        "bound_ms": v7["records"]["M=50", "-cost"]["bound_ms"],
        "bound_by": v7["records"]["M=50", "-cost"]["bound_by"],
        "library_ms": v7_mean("library_ms")}, {
        "name": "topk_rows (swin_tiny rows, A=34000)", "route": "cuda",
        "source": "pl_yolo_tpu_torch/csrc/topk_rows.cu",
        "replaces": "pl_yolo_tpu/ops/pallas/topk_pallas.py:26",
        "launches": swin["launches"],
        "max_abs_err": swin["max_abs_err"]["topk_rows"],
        "ms": swin_mean("ms"), "plain_ms": swin_mean("plain_ms"),
        "bound_ms": swin["records"][f"M={MAX_LABELS}", "-cost"]["bound_ms"],
        "bound_by": swin["records"][f"M={MAX_LABELS}", "-cost"]["bound_by"],
        "library_ms": swin_mean("library_ms")}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                   *sys.argv[5:7])
        sys.exit(0)
    sys.exit(main())
