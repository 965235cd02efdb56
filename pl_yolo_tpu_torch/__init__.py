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
