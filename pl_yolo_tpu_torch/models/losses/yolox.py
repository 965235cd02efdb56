"""YOLOX loss: grid decode + SimOTA label assignment + GIoU/BCE losses,
port of `pl_yolo_tpu/models/losses/yolox.py`.

Anchor a at (row y, col x) of a level has shifts (x, y) and decodes as
xy = (raw_xy + (x, y)) * stride, wh = exp(raw_wh) * stride; anchors are
level-major with 'ij' grids within a level. Decode and loss math run in fp32.

SimOTA is one fixed-shape computation on [B, M, A] tensors (B images, M
label slots, A anchors), masked by label validity; where the JAX package
vmaps a per-image function, the batch dim is written out here. The
assignment is not differentiated: `yolox_loss` runs it under
`torch.no_grad()` on detached predictions. Its dynamic-k uses
`ops.topk.topk_lastdim` (k <= 10), which on the card is the row top-k
kernel. The cls BCE cost uses the one-hot decomposition
    sum_c BCE(p_c, onehot_c) = S - log p_cls + log(1 - p_cls),
    S = -sum_c log(1 - p_c),
an [A, C] pass plus [M, A] selections. Where the JAX package selects a
column or a row with a one-hot matmul (a choice for the TPU's matrix unit),
this port indexes: the same values and gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ...ops.boxes import cxcywh2xyxy, iou_loss, pairwise_iou
from ...ops.topk import topk_lastdim

# Additive penalties for masked-out cost entries: CENTER_PENALTY is the soft
# penalty for candidates outside box-and-center; INVALID_PENALTY excludes
# non-candidate anchors and invalid labels entirely.
CENTER_PENALTY = 100000.0
INVALID_PENALTY = 1e9


class DecodeOut(NamedTuple):
    preds: torch.Tensor       # [B, A, 5+C] decoded (cxcywh abs, obj/cls logits)
    ori_boxes: torch.Tensor   # [B, A, 4] raw reg outputs (for the L1 loss)
    x_shifts: torch.Tensor    # [A]
    y_shifts: torch.Tensor    # [A]
    strides: torch.Tensor     # [A]


def yolox_decode(outputs: Sequence[torch.Tensor],
                 strides: Sequence[int]) -> DecodeOut:
    """Decode per-level NHWC head maps [B,H,W,5+C] into flat predictions."""
    preds, oris, xs, ys, ss = [], [], [], [], []
    for level, stride in zip(outputs, strides):
        level = level.float()
        b, h, w, c = level.shape
        flat = level.reshape(b, h * w, c)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=flat.dtype, device=flat.device),
            torch.arange(w, dtype=flat.dtype, device=flat.device),
            indexing="ij")
        gx = gx.reshape(-1)
        gy = gy.reshape(-1)
        xy = (flat[..., :2] + torch.stack([gx, gy], dim=-1)[None]) * stride
        wh = torch.exp(flat[..., 2:4]) * stride
        preds.append(torch.cat([xy, wh, flat[..., 4:]], dim=-1))
        oris.append(flat[..., :4])
        xs.append(gx)
        ys.append(gy)
        ss.append(torch.full((h * w,), float(stride), dtype=flat.dtype,
                             device=flat.device))
    return DecodeOut(
        preds=torch.cat(preds, dim=1),
        ori_boxes=torch.cat(oris, dim=1),
        x_shifts=torch.cat(xs),
        y_shifts=torch.cat(ys),
        strides=torch.cat(ss),
    )


def yolox_eval_decode(outputs: Sequence[torch.Tensor],
                      strides: Sequence[int]) -> torch.Tensor:
    """Eval branch: sigmoid obj/cls, boxes as xyxy -> [B, A, 5+C]."""
    d = yolox_decode(outputs, strides)
    boxes = cxcywh2xyxy(d.preds[..., :4])
    scores = torch.sigmoid(d.preds[..., 4:])
    return torch.cat([boxes, scores], dim=-1)


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE with logits, elementwise (reduction 'none')."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


class AssignOut(NamedTuple):
    fg_mask: torch.Tensor      # [B, A] bool: anchor is a matched foreground
    matched_gt: torch.Tensor   # [B, A] int64: matched label slot (valid where fg)
    pred_ious: torch.Tensor    # [B, A] IoU with the matched label
    num_fg: torch.Tensor       # [B] float
    num_gt: torch.Tensor       # [B] float


def _gates(gt_boxes, gt_valid, xc, yc, strides, center_radius):
    """In-box and in-center tests of anchor centres [A] against labels
    [B, m, 4] -> two [B, m, A] bool masks, False for invalid labels."""
    gx, gy, gw, gh = (t[..., None] for t in gt_boxes.unbind(-1))  # [B, m, 1]
    l = xc - (gx - 0.5 * gw)
    r = (gx + 0.5 * gw) - xc
    t = yc - (gy - 0.5 * gh)
    b = (gy + 0.5 * gh) - yc
    in_box = torch.minimum(torch.minimum(l, r), torch.minimum(t, b)) > 0.0
    rad = center_radius * strides
    cl = xc - (gx - rad)
    cr = (gx + rad) - xc
    ct = yc - (gy - rad)
    cb = (gy + rad) - yc
    in_center = torch.minimum(torch.minimum(cl, cr),
                              torch.minimum(ct, cb)) > 0.0
    valid = gt_valid[..., None]
    return in_box & valid, in_center & valid


def _cls_cost_terms(obj_logits, cls_logits):
    """Per-anchor ingredients of the cls cost: log p and log(1-p) as
    [B, C, A] (class-major, so a label's class selects a row) and S [B, A]."""
    p = torch.sqrt(torch.sigmoid(cls_logits)
                   * torch.sigmoid(obj_logits)[..., None])
    p = p.clamp(1e-8, 1.0 - 1e-8)
    log_p = torch.log(p)
    log_1mp = torch.log1p(-p)
    s_all = -log_1mp.sum(dim=-1)
    return log_p.transpose(1, 2), log_1mp.transpose(1, 2), s_all


def _cost_and_claims(gt_boxes, gt_classes, gt_valid, in_box_and_center,
                     fg_cand, pred_xyxy, log_p_t, log_1mp_t, s_all):
    """For labels [B, m, ...]: the masked pair IoU, the cost and the
    dynamic-k claims, each [B, m, A], plus the validity mask."""
    num_classes = log_p_t.shape[1]
    vmask = gt_valid[..., None] & fg_cand[:, None, :]
    pair_iou = pairwise_iou(cxcywh2xyxy(gt_boxes), pred_xyxy)
    pair_iou = torch.where(vmask, pair_iou, 0.0)
    iou_cost = -torch.log(pair_iou + 1e-8)

    batch = torch.arange(gt_boxes.shape[0], device=gt_boxes.device)[:, None]
    cls_idx = gt_classes.clamp(0, num_classes - 1)
    cls_cost = (s_all[:, None, :] - log_p_t[batch, cls_idx]
                + log_1mp_t[batch, cls_idx])
    cost = (cls_cost + 3.0 * iou_cost
            + CENTER_PENALTY * (~in_box_and_center)
            + INVALID_PENALTY * (~vmask))

    # dynamic-k: k = clamp(trunc(sum of the top-10 IoUs), 1, 10)
    topk_iou = topk_lastdim(pair_iou, min(10, pair_iou.shape[-1]))
    dynamic_k = topk_iou.sum(dim=-1).to(torch.int64).clamp(1, 10)
    # the k cheapest anchors per label: threshold at the k-th smallest cost
    neg_top = topk_lastdim(-cost, 10)
    kth_cost = -neg_top.gather(-1, dynamic_k[..., None] - 1)
    matching = (cost <= kth_cost) & vmask
    return pair_iou, cost, matching, vmask


def simota_assign(
    gt_boxes: torch.Tensor,      # [B, M, 4] cxcywh (abs pixels)
    gt_classes: torch.Tensor,    # [B, M] integer
    gt_valid: torch.Tensor,      # [B, M] bool
    pred_boxes: torch.Tensor,    # [B, A, 4] cxcywh decoded
    obj_logits: torch.Tensor,    # [B, A]
    cls_logits: torch.Tensor,    # [B, A, C]
    x_shifts: torch.Tensor,      # [A]
    y_shifts: torch.Tensor,      # [A]
    strides: torch.Tensor,       # [A]
    center_radius: float = 2.5,
    chunk: int | None = None,
) -> AssignOut:
    """SimOTA for a batch, fixed-shape. `chunk`: optional label-axis
    chunking (`_simota_assign_chunked`): the same outputs with [B, chunk, A]
    peak temporaries in place of [B, M, A]."""
    m = gt_boxes.shape[1]
    if chunk is not None and chunk < m:
        return _simota_assign_chunked(
            gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
            cls_logits, x_shifts, y_shifts, strides, center_radius, chunk)
    xc = (x_shifts + 0.5) * strides                      # [A] anchor centres
    yc = (y_shifts + 0.5) * strides
    in_box, in_center = _gates(gt_boxes, gt_valid, xc, yc, strides,
                               center_radius)
    fg_cand = (in_box | in_center).any(dim=1)            # [B, A]
    pair_iou, cost, matching, vmask = _cost_and_claims(
        gt_boxes, gt_classes, gt_valid, in_box & in_center, fg_cand,
        cxcywh2xyxy(pred_boxes), *_cls_cost_terms(obj_logits, cls_logits))

    # conflict resolution: an anchor claimed by more than one label goes to
    # its argmin-cost label, even if that label's threshold had not claimed it
    n_claims = matching.sum(dim=1)                       # [B, A]
    argmin_gt = cost.argmin(dim=1)                       # first minimum
    rows = torch.arange(m, device=cost.device)[None, :, None]
    only_min = (rows == argmin_gt[:, None, :]) & vmask
    matching = torch.where(n_claims[:, None, :] > 1, only_min, matching)

    fg_mask = matching.any(dim=1)
    matched_gt = matching.to(torch.uint8).argmax(dim=1)  # first True, else 0
    pred_ious = torch.where(matching, pair_iou, 0.0).sum(dim=1)
    return AssignOut(
        fg_mask=fg_mask, matched_gt=matched_gt, pred_ious=pred_ious,
        num_fg=fg_mask.sum(dim=1).float(), num_gt=gt_valid.sum(dim=1).float())


def _simota_assign_chunked(
    gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits, cls_logits,
    x_shifts, y_shifts, strides, center_radius, chunk: int,
) -> AssignOut:
    """Label-axis-chunked SimOTA: the dense path's outputs without any
    [B, M, A] tensor. A loop over ceil(M/chunk) label chunks carries
    per-anchor accumulators:

      * n_claims: how many labels' dynamic-k sets claimed the anchor;
      * sum_row: the sum of claiming label slots (for n_claims == 1 this is
        the matched slot);
      * sum_iou: the sum of the claiming labels' IoU (likewise);
      * running (min_cost, argmin_row, iou_at_min), updated on strict <, so
        that the first minimum wins across chunks as `argmin` does.

    The dense path's conflict resolution is then a per-anchor select between
    the two accumulator families."""
    b, m = gt_boxes.shape[:2]
    a = pred_boxes.shape[1]
    dev = pred_boxes.device
    xc = (x_shifts + 0.5) * strides
    yc = (y_shifts + 0.5) * strides
    pred_xyxy = cxcywh2xyxy(pred_boxes)
    cls_terms = _cls_cost_terms(obj_logits, cls_logits)
    spans = [slice(r, min(r + chunk, m)) for r in range(0, m, chunk)]

    fg_cand = torch.zeros((b, a), dtype=torch.bool, device=dev)
    for s in spans:
        in_box, in_center = _gates(gt_boxes[:, s], gt_valid[:, s], xc, yc,
                                   strides, center_radius)
        fg_cand |= (in_box | in_center).any(dim=1)

    n_claims = torch.zeros((b, a), dtype=torch.int64, device=dev)
    sum_row = torch.zeros((b, a), dtype=torch.int64, device=dev)
    sum_iou = torch.zeros((b, a), dtype=torch.float32, device=dev)
    min_cost = torch.full((b, a), torch.inf, dtype=torch.float32, device=dev)
    argmin_row = torch.zeros((b, a), dtype=torch.int64, device=dev)
    iou_at_min = torch.zeros((b, a), dtype=torch.float32, device=dev)
    for s in spans:
        in_box, in_center = _gates(gt_boxes[:, s], gt_valid[:, s], xc, yc,
                                   strides, center_radius)
        pair, cost, matching, _ = _cost_and_claims(
            gt_boxes[:, s], gt_classes[:, s], gt_valid[:, s],
            in_box & in_center, fg_cand, pred_xyxy, *cls_terms)
        rows = torch.arange(s.start, s.stop, device=dev)[None, :, None]
        n_claims += matching.sum(dim=1)
        sum_row += torch.where(matching, rows, 0).sum(dim=1)
        sum_iou += torch.where(matching, pair, 0.0).sum(dim=1)

        chunk_min, chunk_arg = cost.min(dim=1)           # first minimum
        chunk_iou = pair.gather(1, chunk_arg[:, None, :])[:, 0]
        upd = chunk_min < min_cost
        min_cost = torch.where(upd, chunk_min, min_cost)
        argmin_row = torch.where(upd, s.start + chunk_arg, argmin_row)
        iou_at_min = torch.where(upd, chunk_iou, iou_at_min)

    multi = n_claims > 1
    fg_mask = n_claims >= 1
    return AssignOut(
        fg_mask=fg_mask,
        matched_gt=torch.where(multi, argmin_row, sum_row),
        pred_ious=torch.where(multi, iou_at_min, sum_iou),
        num_fg=fg_mask.sum(dim=1).float(), num_gt=gt_valid.sum(dim=1).float())


def yolox_loss(
    outputs: Sequence[torch.Tensor],   # per-level NHWC head maps
    labels: torch.Tensor,              # [B, max_labels, 5] = [cls, cx, cy, w, h]
    num_classes: int,
    strides: Sequence[int] = (8, 16, 32),
    use_l1: bool | torch.Tensor = False,
    assign_chunk: int | None = None,
    pallas_assign: bool = False,
) -> dict[str, torch.Tensor]:
    """Training loss: GIoU*5 + obj BCE + cls BCE (+ L1), normalized by the
    batch's foreground count. `use_l1` is a bool (the L1 term computed or
    not) or a 0/1 tensor that gates a computed term, for a schedule that
    flips it without a sync. A label slot is valid where its row sums > 0."""
    if pallas_assign:
        raise NotImplementedError(
            "loss: {pallas_assign: true} selects the fused SimOTA assignment "
            "kernel, which is not ported yet (ROADMAP queue B, item 4)")
    d = yolox_decode(outputs, strides)
    bbox_preds = d.preds[..., :4]
    obj_logits = d.preds[..., 4]
    cls_logits = d.preds[..., 5:]
    if cls_logits.shape[-1] != num_classes:
        raise ValueError(f"head maps carry {cls_logits.shape[-1]} classes, "
                         f"the loss was built for {num_classes}")

    labels = labels.to(torch.float32)
    gt_valid = labels.sum(dim=2) > 0
    gt_classes = labels[..., 0].to(torch.int64)
    gt_boxes = labels[..., 1:5]

    with torch.no_grad():
        assign = simota_assign(
            gt_boxes, gt_classes, gt_valid, bbox_preds.detach(),
            obj_logits.detach(), cls_logits.detach(),
            d.x_shifts, d.y_shifts, d.strides, chunk=assign_chunk)

    fg = assign.fg_mask.to(torch.float32)                      # [B, A]
    num_fgs = assign.num_fg.sum().clamp(min=1.0)
    num_gts = assign.num_gt.sum().clamp(min=1.0)

    batch = torch.arange(labels.shape[0], device=labels.device)[:, None]
    reg_targets = gt_boxes[batch, assign.matched_gt]           # [B, A, 4]

    loss_iou = (iou_loss(bbox_preds, reg_targets, "giou") * fg).sum() / num_fgs
    loss_obj = _bce_logits(obj_logits, fg).sum() / num_fgs

    # cls BCE with targets onehot(cls)*iou, decomposed so that the [B, A, C]
    # target tensor never exists:
    #   sum_c BCE(l_c, t_c) = sum_c [max(l_c,0) + log1p(exp(-|l_c|))]
    #                         - iou * l_{matched class}
    # (the same value and gradient: d/dl = sigmoid(l) - t elementwise).
    s1 = (cls_logits.clamp(min=0)
          + torch.log1p(torch.exp(-cls_logits.abs()))).sum(dim=-1)
    matched_cls = gt_classes.gather(1, assign.matched_gt)      # [B, A]
    in_range = (matched_cls >= 0) & (matched_cls < num_classes)
    l_sel = cls_logits.gather(
        2, matched_cls.clamp(0, num_classes - 1)[..., None])[..., 0]
    l_sel = torch.where(in_range, l_sel, 0.0)  # a class outside [0, C): no target
    loss_cls = ((s1 - assign.pred_ious * l_sel) * fg).sum() / num_fgs

    if isinstance(use_l1, bool) and not use_l1:
        loss_l1 = torch.zeros((), dtype=torch.float32, device=labels.device)
    else:
        # L1 in grid units
        st = d.strides[None, :]
        l1_t = torch.stack([
            reg_targets[..., 0] / st - d.x_shifts[None, :],
            reg_targets[..., 1] / st - d.y_shifts[None, :],
            torch.log(reg_targets[..., 2] / st + 1e-8),
            torch.log(reg_targets[..., 3] / st + 1e-8),
        ], dim=-1)
        loss_l1 = ((d.ori_boxes - l1_t).abs().sum(dim=-1) * fg).sum() / num_fgs
        if not isinstance(use_l1, bool):
            loss_l1 = loss_l1 * torch.as_tensor(
                use_l1, device=loss_l1.device).to(torch.float32)

    reg_weight = 5.0
    loss = reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
    return {
        "loss": loss,
        "loss_iou": loss_iou,
        "loss_obj": loss_obj,
        "loss_cls": loss_cls,
        "loss_l1": loss_l1,
        "proportion": assign.num_fg.sum() / num_gts,
    }
