"""Target assignment — which anchor answers for which ground-truth box
(counterpart of ``custom_yolo_tpu/train/assigner.py``).

Both assigners work on padded fixed-shape ground truth, batched over
(image, GT, anchor). Wherever candidates tie, the lowest index wins, as
``jnp.argmin`` / ``jnp.argmax`` decide it: ``torch.argmin`` and
``torch.argmax`` make no such promise, so :func:`_first_argmax` spells it
out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from custom_yolo_tpu_torch.ops.boxes import box_iou_pairwise


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (lowest index on ties)."""
    best = x.amax(dim=dim, keepdim=True)
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    index = torch.arange(size, device=x.device).view(shape)
    return torch.where(x == best, index, size).amin(dim=dim)


class NearestAssignment(NamedTuple):
    """One anchor index per (padded) GT."""
    anchor_idx: torch.Tensor   # (N, G) int64 — nearest anchor per GT
    valid: torch.Tensor        # (N, G) bool — GT validity mask


def nearest_center_assign(gt_centers: torch.Tensor,
                          pred_centers: torch.Tensor,
                          gt_mask: torch.Tensor) -> NearestAssignment:
    """gt_centers (N, G, 2) px, pred_centers (N, M, 2) px, gt_mask (N, G):
    each GT takes the anchor whose predicted box centre is nearest, by the
    exact squared distance (a direct difference, not the matmul
    expansion, which loses near-tie decisions to cancellation)."""
    diff = gt_centers[:, :, None, :] - pred_centers[:, None, :, :]
    dist2 = (diff * diff).sum(dim=-1)                            # (N, G, M)
    return NearestAssignment(anchor_idx=_first_argmax(-dist2, dim=-1),
                             valid=gt_mask.bool())


class TALAssignment(NamedTuple):
    target_boxes: torch.Tensor     # (N, M, 4) xyxy px of the assigned GT
    target_labels: torch.Tensor    # (N, M) int64
    target_scores: Optional[torch.Tensor]  # (N, M, C) soft class targets,
                                   # or None with dense_scores=False
    fg_mask: torch.Tensor          # (N, M) bool — anchor is a positive
    anchor_scores: torch.Tensor    # (N, M) soft score of the assigned class
                                   # (target_scores == one_hot(labels)·this)


def task_aligned_assign(pred_scores: torch.Tensor,
                        pred_boxes_xyxy: torch.Tensor,
                        anchor_points_px: torch.Tensor,
                        gt_boxes_xyxy: torch.Tensor,
                        gt_labels: torch.Tensor,
                        gt_mask: torch.Tensor,
                        num_classes: int,
                        topk: int = 10,
                        alpha: float = 0.5,
                        beta: float = 6.0,
                        eps: float = 1e-9,
                        dense_scores: bool = True) -> TALAssignment:
    """Task-aligned assigner: anchors inside a GT box are scored by
    ``score^alpha · IoU^beta``, the top-k per GT are positives, and an
    anchor claimed by several GTs goes to the one of highest IoU.

    pred_scores (N, M, C) sigmoid class scores; pred_boxes_xyxy (N, M, 4)
    px; anchor_points_px (M, 2); gt_boxes_xyxy (N, G, 4); gt_labels and
    gt_mask (N, G)."""
    n, m, _ = pred_scores.shape
    g = gt_boxes_xyxy.shape[1]
    gt_valid = gt_mask.bool()

    # 1. candidates: anchor centre strictly inside the GT box
    ax = anchor_points_px[None, None, :, 0]                       # (1,1,M)
    ay = anchor_points_px[None, None, :, 1]
    x1, y1 = gt_boxes_xyxy[..., 0:1], gt_boxes_xyxy[..., 1:2]     # (N,G,1)
    x2, y2 = gt_boxes_xyxy[..., 2:3], gt_boxes_xyxy[..., 3:4]
    in_box = (ax > x1) & (ax < x2) & (ay > y1) & (ay < y2)        # (N,G,M)
    in_box = in_box & gt_valid[..., None]

    # 2. alignment metric = score[gt class]^alpha · IoU^beta
    iou = box_iou_pairwise(gt_boxes_xyxy, pred_boxes_xyxy).clamp_min(0.0)
    labels_safe = gt_labels.long().clamp(0, num_classes - 1)
    cls_scores = torch.gather(
        pred_scores.transpose(1, 2),                               # (N,C,M)
        1, labels_safe[..., None].expand(n, g, m))                 # (N,G,M)
    metric = (cls_scores ** alpha) * (iou ** beta)
    metric = torch.where(in_box, metric, 0.0)

    # 3. top-k per GT by k rounds of first-argmax and mask: among equal
    #    metrics the lower anchor index is taken first (torch.topk gives
    #    no order among equals)
    k = min(topk, m)
    pos = torch.zeros(n, g, m, dtype=torch.bool, device=metric.device)
    remaining = metric
    anchor_ids = torch.arange(m, device=metric.device)
    for _ in range(k):
        best = _first_argmax(remaining, dim=-1)                   # (N,G)
        hit = best[..., None] == anchor_ids                       # (N,G,M)
        ok = remaining.amax(dim=-1, keepdim=True) > eps           # (N,G,1)
        pos = pos | (hit & ok)
        remaining = torch.where(hit, -torch.inf, remaining)
    pos = pos & in_box

    # 4. an anchor claimed by more than one GT keeps the highest IoU
    masked_iou = torch.where(pos, iou, -1.0)                      # (N,G,M)
    best_gt = _first_argmax(masked_iou, dim=1)                    # (N,M)
    fg = pos.any(dim=1)                                           # (N,M)
    gt_ids = torch.arange(g, device=metric.device)[None, :, None]
    pos = (best_gt[:, None, :] == gt_ids) & pos                   # (N,G,M)

    # 5. per-anchor targets
    tb = torch.gather(gt_boxes_xyxy, 1, best_gt[..., None].expand(n, m, 4))
    tl = torch.gather(labels_safe, 1, best_gt)                    # (N,M)
    tl = torch.where(fg, tl, 0)

    # 6. soft scores: per GT the metric is scaled so that its maximum
    #    equals the GT's best IoU; an anchor's score is its scaled metric
    metric_pos = torch.where(pos, metric, 0.0)
    max_metric = metric_pos.amax(dim=-1, keepdim=True)            # (N,G,1)
    max_iou = torch.where(pos, iou, 0.0).amax(dim=-1, keepdim=True)
    norm = metric_pos * max_iou / (max_metric + eps)              # (N,G,M)
    anchor_score = norm.amax(dim=1)                               # (N,M)
    if dense_scores:
        one_hot = tl[..., None] == torch.arange(num_classes,
                                                device=metric.device)
        target_scores = torch.where(one_hot & fg[..., None],
                                    anchor_score[..., None], 0.0)
    else:
        target_scores = None

    return TALAssignment(target_boxes=tb, target_labels=tl,
                         target_scores=target_scores, fg_mask=fg,
                         anchor_scores=torch.where(fg, anchor_score, 0.0))
