"""YOLOv7 anchor-based loss: find-3-positive + OTA matching + CIoU/obj/cls,
port of `pl_yolo_tpu/models/losses/yolov7.py`.

Every label contributes a fixed candidate slab [L levels x na anchors x 3
cells] (its centre cell, one x-neighbour and one y-neighbour, the g=0.5
scheme) with validity masks, so that the assignment is one fixed-shape
computation. Where the JAX package vmaps a per-image function, the batch
dim is written out here: the OTA assignment runs on [B, M, Ca] tensors
(Ca = M*L*na*3 candidates an image) under `torch.no_grad()`, and its two
top-k calls go through `ops.topk.topk_lastdim`, which on the card is the
row top-k kernel on rows of length Ca.

Decode (eval): xy = (sig*2 - 0.5 + grid)*stride, wh = (sig*2)^2 * anchor;
obj/cls sigmoid; boxes to xyxy. Loss weights: balance (4.0, 1.0, 0.4) per
level (the ultralytics order; see the JAX package's docstring), box 0.05,
obj 1, cls 0.5*C/80, overridable by `gain`; label smoothing as smooth_BCE.

Semantics held to the JAX package: the neighbour tests take Python's
modulo (`torch.remainder`, not `fmod`); a candidate claimed by more than
one label goes to the label of least cost (the first on a tie); `tobj` is a
scatter-max of the clamped CIoU, whose invalid candidates write 0 to
anchor 0.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ...ops.boxes import ciou, cxcywh2xyxy, pairwise_iou
from ...ops.constant import constant
from ...ops.topk import topk_lastdim
from ...parallel.mesh import batch_mean, data_sum

INVALID_PENALTY = 1e9
DEFAULT_V7_ANCHORS = (((12, 16), (19, 36), (40, 28)),
                      ((36, 75), (76, 55), (72, 146)),
                      ((142, 110), (192, 243), (459, 401)))


class V7Decode(NamedTuple):
    flat: torch.Tensor        # [B, A, 5+C] raw logits, anchor-major per level
    grid_xy: torch.Tensor     # [A, 2] cell coords
    anchor_wh: torch.Tensor   # [A, 2] anchor sizes in grid units
    strides: torch.Tensor     # [A]
    level_sizes: tuple        # per-level flat sizes (na*H*W)


def flatten_v7_outputs(outputs: Sequence[torch.Tensor],
                       strides: Sequence[int], anchors,
                       num_classes: int) -> V7Decode:
    """Per-level NHWC maps [B,H,W,na*(5+C)] -> flat [B, A, 5+C] with
    per-row grid/anchor metadata. Row order: level-major, anchor-major,
    then row-major cells (a*H*W + y*W + x). Decode math runs in fp32."""
    na = len(anchors[0])
    ch = 5 + num_classes
    flats, gxy, awh, ss, sizes = [], [], [], [], []
    for i, (level, stride) in enumerate(zip(outputs, strides)):
        level = level.float()
        dev = level.device
        b, h, w, _ = level.shape
        x = level.reshape(b, h, w, na, ch).permute(0, 3, 1, 2, 4)
        flats.append(x.reshape(b, na * h * w, ch))
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        cell = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # [H*W, 2]
        gxy.append(cell.repeat(na, 1))
        anc = constant(anchors[i], torch.float32, dev) / stride  # grid units
        awh.append(anc.repeat_interleave(h * w, dim=0))
        ss.append(torch.full((na * h * w,), float(stride), device=dev))
        sizes.append(na * h * w)
    return V7Decode(flat=torch.cat(flats, dim=1), grid_xy=torch.cat(gxy),
                    anchor_wh=torch.cat(awh), strides=torch.cat(ss),
                    level_sizes=tuple(sizes))


def yolov7_eval_decode(outputs: Sequence[torch.Tensor],
                       strides: Sequence[int], anchors,
                       num_classes: int) -> torch.Tensor:
    """Eval decode -> [B, A, 5+C] xyxy + probs."""
    d = flatten_v7_outputs(outputs, strides, anchors, num_classes)
    p = torch.sigmoid(d.flat)
    xy = (p[..., :2] * 2.0 - 0.5 + d.grid_xy[None]) * d.strides[None, :, None]
    wh = (p[..., 2:4] * 2.0) ** 2 * (d.anchor_wh * d.strides[:, None])[None]
    boxes = cxcywh2xyxy(torch.cat([xy, wh], dim=-1))
    return torch.cat([boxes, p[..., 4:]], dim=-1)


def _find_positive_candidates(gt_boxes, gt_valid, shapes, strides, anchors,
                              threshold: float = 4.0):
    """Fixed-shape find_3_positive for a batch.

    gt_boxes: [B, M, 4] cxcywh pixels; gt_valid [B, M]; shapes: (H, W) per
    level. Returns per-candidate tensors of shape [B, M, L, na, 3]: cells
    (int64, [..., 2] as (x, y)), valid, anchor index and level index."""
    B, M = gt_boxes.shape[:2]
    na = len(anchors[0])
    dev = gt_boxes.device
    cells, valids, anchor_ids, level_ids = [], [], [], []
    for i, ((h, w), stride) in enumerate(zip(shapes, strides)):
        t_xy = gt_boxes[..., :2] / stride                # [B, M, 2] grid units
        t_wh = gt_boxes[..., 2:4] / stride
        anc = constant(anchors[i], torch.float32, dev) / stride  # [na, 2]
        r = t_wh[..., None, :] / anc                     # [B, M, na, 2]
        wh_ok = torch.maximum(r, 1.0 / r).amax(dim=-1) < threshold
        wh_ok = wh_ok & gt_valid[..., None]

        gx, gy = t_xy[..., 0], t_xy[..., 1]
        fx, fy = torch.remainder(gx, 1.0), torch.remainder(gy, 1.0)
        # x neighbour: the left cell if frac < .5, the right one by the
        # inverse test
        j = (fx < 0.5) & (gx > 1.0)
        l = (torch.remainder(w - gx, 1.0) < 0.5) & ((w - gx) > 1.0)
        k = (fy < 0.5) & (gy > 1.0)
        m = (torch.remainder(h - gy, 1.0) < 0.5) & ((h - gy) > 1.0)
        # the JAX package's offset is NaN where neither test holds, and
        # nan_to_num makes it 0 there
        x_off = torch.where(j, 0.5, torch.where(l, -0.5, 0.0))
        y_off = torch.where(k, 0.5, torch.where(m, -0.5, 0.0))

        center = torch.floor(t_xy)
        x_nb = torch.stack([torch.floor(gx - x_off), torch.floor(gy)], -1)
        y_nb = torch.stack([torch.floor(gx), torch.floor(gy - y_off)], -1)
        cand = torch.stack([center, x_nb, y_nb], dim=2)  # [B, M, 3, 2]
        hi = constant((w - 1, h - 1), torch.float32, dev)
        cand = torch.minimum(cand.clamp(min=0.0), hi)
        cand_ok = torch.stack([torch.ones_like(j), j | l, k | m], dim=-1)

        cells.append(cand[:, :, None].expand(B, M, na, 3, 2))
        valids.append(wh_ok[..., None] & cand_ok[:, :, None, :])
        anchor_ids.append(torch.arange(na, device=dev)[:, None]
                          .expand(B, M, na, 3))
        level_ids.append(torch.full((B, M, na, 3), i, dtype=torch.int64,
                                    device=dev))
    stack = lambda xs: torch.stack(xs, dim=2)           # -> [B, M, L, na, 3, ...]
    return (stack(cells).to(torch.int64), stack(valids), stack(anchor_ids),
            stack(level_ids))


def _flat_index(cells, anchor_ids, level_ids, shapes, level_sizes):
    """Flat row index into [A] of each candidate: level_offset + a*H*W +
    y*W + x."""
    dev = cells.device
    offsets = [0]
    for sz in level_sizes[:-1]:
        offsets.append(offsets[-1] + sz)
    offs = constant(tuple(offsets), torch.int64, dev)[level_ids]
    ws = constant(tuple(w for _, w in shapes), torch.int64, dev)[level_ids]
    hws = constant(tuple(h * w for h, w in shapes), torch.int64,
                   dev)[level_ids]
    return offs + anchor_ids * hws + cells[..., 1] * ws + cells[..., 0]


class V7Assign(NamedTuple):
    flat_idx: torch.Tensor     # [B, Ca] candidate row in [A] (0 if invalid)
    matched_gt: torch.Tensor   # [B, Ca] int64 label slot (valid where fg)
    fg: torch.Tensor           # [B, Ca] bool
    level_ids: torch.Tensor    # [B, Ca]
    cells: torch.Tensor        # [B, Ca, 2] float (x, y)
    stride: torch.Tensor       # [B, Ca]
    anchor_wh: torch.Tensor    # [B, Ca, 2] grid units


def ota_assign(gt_boxes, gt_classes, gt_valid, d: V7Decode, shapes, strides,
               anchors, num_classes: int) -> V7Assign:
    """OTA assignment over the candidate slab, for a batch; not
    differentiated (call it on detached predictions)."""
    B, M = gt_boxes.shape[:2]
    cells, valid, anchor_ids, level_ids = _find_positive_candidates(
        gt_boxes, gt_valid, shapes, strides, anchors)
    Ca = cells[0].numel() // 2
    cells = cells.reshape(B, Ca, 2)
    valid = valid.reshape(B, Ca)
    anchor_ids = anchor_ids.reshape(B, Ca)
    level_ids = level_ids.reshape(B, Ca)
    flat_idx = _flat_index(cells, anchor_ids, level_ids, shapes,
                           d.level_sizes)
    flat_idx = torch.where(valid, flat_idx, 0)

    # decode the candidates' predictions
    pred = d.flat.gather(1, flat_idx[..., None].expand(-1, -1,
                                                       d.flat.shape[-1]))
    stride_c = d.strides[flat_idx]                        # [B, Ca]
    anc_c = d.anchor_wh[flat_idx]                         # [B, Ca, 2]
    cells_f = cells.to(torch.float32)
    pxy = ((torch.sigmoid(pred[..., :2]) * 2.0 - 0.5 + cells_f)
           * stride_c[..., None])
    pwh = ((torch.sigmoid(pred[..., 2:4]) * 2.0) ** 2 * anc_c
           * stride_c[..., None])
    pboxes = torch.cat([pxy, pwh], dim=-1)

    mask = gt_valid[..., None] & valid[:, None, :]        # [B, M, Ca]
    iou = pairwise_iou(cxcywh2xyxy(gt_boxes), cxcywh2xyxy(pboxes))
    iou = torch.where(mask, iou, 0.0)
    iou_cost = -torch.log(iou + 1e-8)

    p = torch.sqrt(torch.sigmoid(pred[..., 5:])
                   * torch.sigmoid(pred[..., 4])[..., None])  # [B, Ca, C]
    p = p.clamp(1e-7, 1.0 - 1e-7)
    logit = torch.log(p) - torch.log1p(-p)
    # BCE-with-logits(logit(y), onehot) == BCE(y, onehot), one-hot decomposed
    log_p = F.logsigmoid(logit).transpose(1, 2)           # [B, C, Ca]
    log_1mp = F.logsigmoid(-logit).transpose(1, 2)
    s_all = -log_1mp.sum(dim=1)                           # [B, Ca]
    batch = torch.arange(B, device=gt_boxes.device)[:, None]
    cls_idx = gt_classes.clamp(0, num_classes - 1)
    cls_cost = (s_all[:, None, :] - log_p[batch, cls_idx]
                + log_1mp[batch, cls_idx])
    cost = cls_cost + 3.0 * iou_cost + INVALID_PENALTY * (~mask)

    # dynamic k: trunc(sum of the top-10 IoUs), in [1, 10]; the k cheapest
    # candidates: at or below the k-th smallest cost
    topk_iou = topk_lastdim(iou, min(10, Ca))
    dynamic_k = topk_iou.sum(dim=-1).to(torch.int64).clamp(1, 10)
    neg_top = topk_lastdim(-cost, 10)
    kth = -neg_top.gather(-1, dynamic_k[..., None] - 1)
    matching = (cost <= kth) & mask

    # a candidate claimed by several labels goes to the one of least cost
    n_claims = matching.sum(dim=1)                        # [B, Ca]
    argmin_gt = cost.argmin(dim=1)                        # first on a tie
    only_min = F.one_hot(argmin_gt, M).transpose(1, 2).bool() & mask
    matching = torch.where(n_claims[:, None, :] > 1, only_min, matching)

    fg = matching.any(dim=1)
    # argmax of a bool column: the first claiming label (bool -> uint8)
    matched_gt = matching.to(torch.uint8).argmax(dim=1)
    return V7Assign(flat_idx=flat_idx, matched_gt=matched_gt, fg=fg,
                    level_ids=level_ids, cells=cells_f, stride=stride_c,
                    anchor_wh=anc_c)


def _bce_logits(logits: torch.Tensor, targets) -> torch.Tensor:
    """BCE with logits, elementwise (reduction 'none')."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _positive_ciou(d: V7Decode, flat_idx, matched_gt, gt_boxes, cells,
                   stride, anchor_wh):
    """(predictions at the candidates [B, Ca, 5+C], CIoU of each
    candidate's box with its label's, both in grid units [B, Ca])."""
    pred_pos = d.flat.gather(1, flat_idx[..., None].expand(
        -1, -1, d.flat.shape[-1]))
    tgt_boxes = gt_boxes.gather(1, matched_gt[..., None].expand(-1, -1, 4))
    pxy = torch.sigmoid(pred_pos[..., :2]) * 2.0 - 0.5
    pwh = (torch.sigmoid(pred_pos[..., 2:4]) * 2.0) ** 2 * anchor_wh
    txy = tgt_boxes[..., :2] / stride[..., None] - cells
    twh = tgt_boxes[..., 2:4] / stride[..., None]
    iou = ciou(torch.cat([pxy, pwh], dim=-1), torch.cat([txy, twh], dim=-1),
               fmt_cxcywh=True)
    return pred_pos, iou


def _objectness(d: V7Decode, flat_idx, iou, pos_f, balance):
    """The balanced per-level obj BCE over every anchor, with targets the
    scatter-max of the clamped CIoU of the positives (0 elsewhere)."""
    B, A = d.flat.shape[:2]
    iou_pos = iou.detach().clamp(min=0.0) * pos_f
    tobj = torch.zeros((B, A), dtype=torch.float32, device=d.flat.device)
    tobj = tobj.scatter_reduce(1, flat_idx, iou_pos, "amax", include_self=True)
    obj_bce = _bce_logits(d.flat[..., 4], tobj)
    obj_loss = 0.0
    start = 0
    for i, sz in enumerate(d.level_sizes):
        obj_loss = (obj_loss
                    + batch_mean(obj_bce[:, start:start + sz]) * balance[i])
        start += sz
    return obj_loss


def _level_means(values, level_ids, pos_f, n_levels, denom_scale=1.0):
    """sum over levels of mean(values) over that level's positives (0 for a
    level without positives); the mean's count is scaled by
    `denom_scale`. The counts are the global batch's (parallel.mesh)."""
    total = 0.0
    for i in range(n_levels):
        lvl = (level_ids == i).to(torch.float32) * pos_f
        n = data_sum(lvl.sum())
        total = total + torch.where(
            n > 0, (values * lvl).sum() / (n * denom_scale).clamp(min=1.0),
            0.0)
    return total


def yolov7_loss(
    outputs: Sequence[torch.Tensor],
    labels: torch.Tensor,               # [B, max_labels, 5] cls,cx,cy,w,h
    num_classes: int,
    strides: Sequence[int] = (8, 16, 32),
    anchors=DEFAULT_V7_ANCHORS,
    label_smoothing: float = 0.0,
    balance: Sequence[float] = (4.0, 1.0, 0.4),
    gain: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Training loss, batched. `gain` overrides the top-level loss weights
    (keys box/obj/cls). A label slot is valid where its row sums > 0."""
    gain = gain or {}
    box_ratio = float(gain.get("box", 0.05))
    obj_ratio = float(gain.get("obj", 1.0))
    cls_ratio = float(gain.get("cls", 0.5 * (num_classes / 80.0)))
    cp = 1.0 - 0.5 * label_smoothing
    cn = 0.5 * label_smoothing

    shapes = tuple((o.shape[1], o.shape[2]) for o in outputs)
    d = flatten_v7_outputs(outputs, strides, anchors, num_classes)
    if d.flat.shape[-1] != 5 + num_classes:
        raise ValueError(f"head maps carry {d.flat.shape[-1] - 5} classes, "
                         f"the loss was built for {num_classes}")

    labels = labels.to(torch.float32)
    gt_valid = labels.sum(dim=2) > 0
    gt_classes = labels[..., 0].to(torch.int64)
    gt_boxes = labels[..., 1:5]

    with torch.no_grad():
        a = ota_assign(gt_boxes, gt_classes, gt_valid,
                       d._replace(flat=d.flat.detach()), shapes, strides,
                       anchors, num_classes)

    pred_pos, iou = _positive_ciou(d, a.flat_idx, a.matched_gt, gt_boxes,
                                   a.cells, a.stride, a.anchor_wh)
    tgt_cls = gt_classes.gather(1, a.matched_gt)          # [B, Ca]
    fg_f = a.fg.to(torch.float32)

    # cls BCE over the positives with a smoothed one-hot (mean over n*C)
    cls_logits = pred_pos[..., 5:]
    bce_cn = _bce_logits(cls_logits, cn)
    onehot = F.one_hot(tgt_cls.clamp(0, num_classes - 1), num_classes).to(
        torch.float32) * ((tgt_cls >= 0) & (tgt_cls < num_classes))[..., None]
    bce_adjust = _bce_logits(cls_logits, cp) - bce_cn
    cls_per_cand = (bce_cn + onehot * bce_adjust).sum(dim=-1)

    L = len(shapes)
    box_loss = _level_means(1.0 - iou, a.level_ids, fg_f, L)
    cls_loss = _level_means(cls_per_cand, a.level_ids, fg_f, L,
                            denom_scale=num_classes)
    obj_loss = _objectness(d, a.flat_idx, iou, fg_f, balance)

    box_loss = box_loss * box_ratio
    obj_loss = obj_loss * obj_ratio
    cls_loss = cls_loss * cls_ratio
    loss = box_loss + obj_loss + cls_loss
    return {"loss": loss, "loss_iou": box_loss, "loss_obj": obj_loss,
            "loss_cls": cls_loss,
            "proportion": (fg_f.sum()
                           / data_sum(gt_valid.sum()).clamp(min=1))}
