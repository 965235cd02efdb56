"""PyTorch / CUDA port of pl_yolo_tpu for one NVIDIA H100.

Slice 1 covers the YOLOX inference path: the eval forward of CSPDarknet,
CSPPAFPN and DecoupledHead (`models.detector.build_model`), the YOLOX eval
decode (`models.losses.yolox.yolox_eval_decode`) and fixed-shape NMS
(`ops.nms.postprocess`), whose suppression step runs a hand-written CUDA
kernel (`csrc/nms_suppress.cu`).

Slice 2 covers the YOLOX train step without augmentation: the SimOTA loss
(`models.losses.yolox.yolox_loss`), whose dynamic-k runs a hand-written CUDA
row top-k kernel (`ops.topk.topk_lastdim`, `csrc/topk_rows.cu`), train-mode
BatchNorm with flax's running statistics, the optimizer and LR schedule
(`train.optim.build_optimizer`), the EMA (`train.ema.ema_update`) and the
step itself (`train.state.TrainState`, `make_train_step`, `make_eval_step`).

Slice 3 covers the device augmentation the train step runs
(`data.augment.device_augment`, `make_augment_fn`: mosaic, mixup, HSV and
flip on the batch, from random numbers drawn up front by `sample_draws`),
whose mosaic and mixup sampling runs a hand-written CUDA warp kernel
(`ops.mosaic`, `csrc/mosaic_warp.cu`), and the Focus stem fed its
space-to-depth output (`layers.blocks.stem_input_s2d`).

Slice 4 covers the train step with `loss: {pallas_assign: true}`: the whole
SimOTA assignment as one hand-written CUDA kernel
(`ops.simota.simota_assign_fused`, `csrc/simota_assign.cu`) in place of the
dense [B,M,A] path and its top-k launches.

Slice 5 redesigned two kernels: the mosaic warp computes its taps once a
block and checks its tile indices on the card without a host read-back, and
the SimOTA assignment skips the costs that cannot decide an assignment.

Slice 6 covers the program a user starts, `python -m pl_yolo_tpu_torch -c
<model.yaml> -d <data.yaml>` (`__main__`): the host data side (datasets,
the loader and its pinned, non-blocking `device_prefetch`, the data
modules), COCO and VOC evaluation, checkpoints (`train.checkpoint`), and
`train.trainer.Trainer` with `fit`, `validate` and `test`, which drive the
kernels above on decoded JPEGs. The numpy / PIL modules of the JAX package
that import no JAX are kept here as copies, which a test holds to their
originals.

Slice 7 redesigned the row top-k kernel as one streaming pass.

Slice 8 covers the anchor families: the YOLOv7 model (E-ELAN, the YOLOv7
neck with optional RepConv, the implicit head) and its OTA loss, whose two
top-k calls run the row top-k kernel; YOLOv5-s with its loss; the YOLOv3
loss and decode; CIoU / DIoU; RepConv fusion (`utils.fuse`); and the
copied anchor-family YAMLs, which the trainer and CLI train on the NHWC
augmentation (E-ELAN has no Focus stem).

Slice 9 covers the accuracy gate (`tools.accuracy_gate`, on the hard-shapes
set of `tools.make_shapes_dataset`), the profiler (`utils.profiler`) and
the YOLOX trainer's remaining options: DropBlock / DropPath
(`layers.drops`), `norm: ln`, `remat: true` (`layers.blocks.
maybe_checkpoint`), `optimizer: {accumulate_steps}`, multi-scale buckets
(`data.augment.multiscale_resize`) and the general-gather augmentation
for degrees, shear and perspective.

Layouts at the public edges follow the JAX package: images [B,H,W,3] in
0-255 float, per-level head maps [B,H,W,5+C] out. Entry points place
tensors on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card, which must then exist; "cpu" is honoured."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
