"""YOLOv3 loss + decoder, port of `pl_yolo_tpu/models/losses/yolov3.py`.

Per-label best-anchor assignment at the label's cell (wh IoU argmax); the
noobj mask zeroed where an anchor's wh IoU > the ignore threshold (0.5);
BCE on sigmoid cx/cy against the in-cell offsets, MSE on raw w/h against
log(gt/anchor), conf BCE (obj + 0.5*noobj), cls BCE; per-term weights
xy 2.5 / wh 2.5 / conf 1 / cls 1.

The targets are batched scatters into [na, H, W+1] grids, whose extra
column absorbs the writes of invalid (padded) labels. Two valid labels
whose best anchor falls in the same cell write the same target slot: the
last valid label in label order wins, as the reference's per-label loop
leaves it (the JAX package's `.at[].set` leaves that choice to XLA, and a
plain `index_put_` on the card leaves it to the scheduler). Here each
target is written by one label only, so the result is deterministic.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ...ops.boxes import cxcywh2xyxy
from ...ops.constant import constant
from ...parallel.mesh import batch_mean, data_sum

DEFAULT_V3_ANCHORS = (((116, 90), (156, 198), (373, 326)),
                      ((30, 61), (62, 45), (59, 119)),
                      ((10, 13), (16, 30), (33, 23)))


def _wh_iou(gwh: torch.Tensor, awh: torch.Tensor) -> torch.Tensor:
    """IoU of [..., M, 2] label whs with [na, 2] anchor whs, centred at the
    origin, with the reference's +1 inflation -> [..., M, na]."""
    inter = ((torch.minimum(gwh[..., :, None, 0], awh[:, 0]) + 1.0)
             * (torch.minimum(gwh[..., :, None, 1], awh[:, 1]) + 1.0))
    a1 = (gwh[..., 0] + 1.0) * (gwh[..., 1] + 1.0)
    a2 = (awh[:, 0] + 1.0) * (awh[:, 1] + 1.0)
    return inter / (a1[..., :, None] + a2 - inter + 1e-16)


def _bce(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    p = p.clamp(eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def last_writer(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, M] bool: the label is valid and no later valid label of its image
    has the same key (the label whose write a sequential loop keeps)."""
    same = keys[:, :, None] == keys[:, None, :]            # [B, M, M']
    later = torch.ones_like(same[0]).triu(diagonal=1)      # m' > m
    return valid & ~(same & later & valid[:, None, :]).any(dim=2)


@torch.no_grad()
def build_targets(gt_frac, gt_cls, gt_valid, h: int, w: int,
                  sa: torch.Tensor, num_classes: int,
                  ignore_threshold: float):
    """One level's target grids, each [B, na, H, W] (tcls [..., C]): mask,
    noobj, tx, ty, tw, th, tcls, from labels as fractions of the image
    (gt_frac [B, M, 4] cxcywh), classes and validity [B, M], and the
    level's anchors in grid units sa [na, 2]."""
    B, M = gt_valid.shape
    na = sa.shape[0]
    dev = gt_frac.device
    gx = gt_frac[..., 0] * w
    gy = gt_frac[..., 1] * h
    gw = gt_frac[..., 2] * w
    gh = gt_frac[..., 3] * h
    gi = gx.to(torch.int64).clamp(0, w - 1)
    gj = gy.to(torch.int64).clamp(0, h - 1)
    iou = _wh_iou(torch.stack([gw, gh], -1), sa)       # [B, M, na]
    best = iou.argmax(dim=-1)                          # [B, M]
    # the extra column x=w takes the writes of invalid labels and of
    # labels a later one overwrites
    plane = na * h * (w + 1)
    key = best * (h * (w + 1)) + gj * (w + 1) + gi
    slot = torch.where(last_writer(key, gt_valid), key,
                       best * (h * (w + 1)) + gj * (w + 1) + w)
    slot = (slot + torch.arange(B, device=dev)[:, None] * plane).reshape(-1)

    def grid(values, extra=()):
        out = torch.zeros((B * plane,) + extra, device=dev)
        out[slot] = values.reshape((-1,) + extra)
        return out.reshape((B, na, h, w + 1) + extra)[:, :, :, :w]

    cls_ok = ((gt_cls >= 0) & (gt_cls < num_classes))[..., None]
    onehot = F.one_hot(gt_cls.clamp(0, num_classes - 1),
                       num_classes).to(torch.float32) * cls_ok
    sa_best = sa[best]                                 # [B, M, 2]
    targets = (grid(torch.ones_like(gx)), grid(gx - gi), grid(gy - gj),
               grid(torch.log(gw / sa_best[..., 0] + 1e-16)),
               grid(torch.log(gh / sa_best[..., 1] + 1e-16)),
               grid(onehot, (num_classes,)))
    # noobj: every anchor whose wh IoU with a label > the threshold, at the
    # label's cell
    over = (iou > ignore_threshold) & gt_valid[..., None]    # [B, M, na]
    cell = torch.where(over, (gj * (w + 1) + gi)[..., None],
                       (gj * (w + 1) + w)[..., None])
    noobj_slot = (torch.arange(na, device=dev) * (h * (w + 1))
                  + cell).reshape(B, -1)
    noobj = torch.ones((B, plane), device=dev).scatter_reduce(
        1, noobj_slot, torch.where(over, 0.0, 1.0).reshape(B, -1), "amin")
    noobj = noobj.reshape(B, na, h, w + 1)[..., :w]
    mask, tx, ty, tw, th, tcls = targets
    return mask, noobj, tx, ty, tw, th, tcls


def yolov3_loss(
    outputs: Sequence[torch.Tensor],   # per-level NHWC [B,H,W,na*(5+C)]
    labels: torch.Tensor,              # [B, M, 5] cls,cx,cy,w,h pixels
    num_classes: int,
    img_size=(640, 640),
    anchors=DEFAULT_V3_ANCHORS,
    ignore_threshold: float = 0.5,
) -> dict[str, torch.Tensor]:
    w_xy = w_wh = 2.5
    w_conf = w_cls = 1.0
    labels = labels.to(torch.float32)
    dev = labels.device
    gt_valid = labels.sum(dim=2) > 0
    gt_cls = labels[..., 0].to(torch.int64)
    gt_frac = labels[..., 1:5] / constant(
        (img_size[0], img_size[1], img_size[0], img_size[1]), torch.float32,
        dev)
    total = 0.0
    for li, level in enumerate(outputs):
        level = level.float()
        b, h, w, _ = level.shape
        na = len(anchors[li])
        pred = level.reshape(b, h, w, na, 5 + num_classes)
        pred = pred.permute(0, 3, 1, 2, 4)              # [B, na, H, W, ch]
        cx = torch.sigmoid(pred[..., 0])
        cy = torch.sigmoid(pred[..., 1])
        pw = pred[..., 2]
        ph = pred[..., 3]
        conf = torch.sigmoid(pred[..., 4])
        cls_p = torch.sigmoid(pred[..., 5:])

        stride_w = img_size[0] / w
        stride_h = img_size[1] / h
        sa = (constant(anchors[li], torch.float32, dev)
              / constant((stride_w, stride_h), torch.float32, dev))  # grid units

        mask, noobj, tx, ty, tw, th, tcls = build_targets(
            gt_frac, gt_cls, gt_valid, h, w, sa, num_classes,
            ignore_threshold)

        # means and counts over the global batch (parallel.mesh)
        loss_x = batch_mean(_bce(cx * mask, tx * mask))
        loss_y = batch_mean(_bce(cy * mask, ty * mask))
        loss_w = batch_mean((pw * mask - tw * mask) ** 2)
        loss_h = batch_mean((ph * mask - th * mask) ** 2)
        loss_conf = (batch_mean(_bce(conf * mask, mask))
                     + 0.5 * batch_mean(_bce(conf * noobj,
                                             torch.zeros_like(noobj))))
        # cls BCE over the positive cells only, normalized by their count
        n_pos = data_sum(mask.sum()).clamp(min=1.0)
        loss_cls = (_bce(cls_p, tcls) * mask[..., None]).sum() / (
            n_pos * num_classes)
        total = total + (w_xy * (loss_x + loss_y) + w_wh * (loss_w + loss_h)
                         + w_conf * loss_conf + w_cls * loss_cls)
    return {"loss": total}


def yolov3_eval_decode(outputs, strides, anchors, num_classes,
                       img_size=(640, 640)):
    """Decode: xy = (sigmoid + grid)*stride, wh = exp(raw)*anchor; obj/cls
    sigmoid; boxes xyxy -> [B, A, 5+C], cell-major then anchor within a
    level."""
    preds = []
    for li, level in enumerate(outputs):
        level = level.float()
        b, h, w, _ = level.shape
        na = len(anchors[li])
        pred = level.reshape(b, h, w, na, 5 + num_classes)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=level.device),
            torch.arange(w, dtype=torch.float32, device=level.device),
            indexing="ij")
        stride_w = img_size[0] / w
        stride_h = img_size[1] / h
        awh = constant(anchors[li], torch.float32, level.device)  # pixels
        x = (torch.sigmoid(pred[..., 0]) + gx[None, :, :, None]) * stride_w
        y = (torch.sigmoid(pred[..., 1]) + gy[None, :, :, None]) * stride_h
        bw = torch.exp(pred[..., 2]) * awh[:, 0]
        bh = torch.exp(pred[..., 3]) * awh[:, 1]
        rest = torch.sigmoid(pred[..., 4:])
        flat = torch.cat([torch.stack([x, y, bw, bh], -1), rest], -1).reshape(
            b, h * w * na, 5 + num_classes)
        boxes = cxcywh2xyxy(flat[..., :4])
        preds.append(torch.cat([boxes, flat[..., 4:]], -1))
    return torch.cat(preds, dim=1)
