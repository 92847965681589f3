"""Batched, fixed-shape non-max suppression (counterpart of
``custom_yolo_tpu/ops/nms.py``).

1. gate by confidence and take a fixed ``top_k`` pool per image, score
   sorted (stable, so equal scores keep the lower index first, as
   ``jax.lax.top_k`` does);
2. offset boxes by ``class_id · MAX_WH`` for class-aware suppression;
3. exact greedy suppression over the pool (``ops.nms_kernel.nms_keep``:
   the CUDA kernel on the card, the plain twin on the CPU);
4. fixed-shape ``(max_det)`` outputs with a validity mask.

No step synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from custom_yolo_tpu_torch.ops.boxes import box_iou_pairwise
from custom_yolo_tpu_torch.ops.nms_kernel import nms_keep

MAX_WH = 7680.0  # class-offset magnitude (reference model_utils.py:210)


class NMSResult(NamedTuple):
    boxes: torch.Tensor      # (N, max_det, 4) xyxy
    scores: torch.Tensor     # (N, max_det)
    classes: torch.Tensor    # (N, max_det) int32
    valid: torch.Tensor      # (N, max_det) bool
    num_valid: torch.Tensor  # (N,) int32


def _top(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, descending, lower index first
    among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_candidates(boxes_xyxy, scores, classes, *, conf_thres, top_k):
    """Per image (batched over the leading axis): confidence gate + top-k
    pool, score-sorted."""
    k = min(top_k, scores.shape[-1])
    gated = torch.where(scores > conf_thres, scores,
                        torch.full_like(scores, -1.0))
    cand_scores, cand_idx = _top(gated, k)
    cand_boxes = torch.gather(boxes_xyxy, 1,
                              cand_idx[..., None].expand(-1, -1, 4))
    return (cand_boxes, cand_scores, torch.gather(classes, 1, cand_idx),
            cand_scores > conf_thres)


def _select_result(cand_boxes, cand_scores, cand_classes, keep, *,
                   conf_thres, max_det):
    k = cand_scores.shape[-1]
    final_scores = torch.where(keep, cand_scores,
                               torch.full_like(cand_scores, -1.0))
    out_scores, out_idx = _top(final_scores, min(max_det, k))
    out_valid = out_scores > conf_thres
    boxes = torch.gather(cand_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    num = out_valid.to(torch.int32).sum(-1, dtype=torch.int32)
    return (boxes, torch.where(out_valid, out_scores,
                               torch.zeros_like(out_scores)),
            torch.gather(cand_classes, 1, out_idx), out_valid, num)


def _merge_boxes(shifted, cand_boxes, cand_scores, cand_valid, keep,
                 iou_thres):
    """Merge-NMS (batched over images): each kept box becomes the
    score-weighted mean of every valid candidate overlapping it above
    ``iou_thres`` in class-offset space; a kept box with no second
    supporter is dropped."""
    iou = box_iou_pairwise(shifted, shifted)                # (N, K, K)
    overlap = (iou > iou_thres) & cand_valid[:, None, :]
    weights = torch.where(cand_valid, cand_scores,
                          torch.zeros_like(cand_scores))
    w = overlap * weights[:, None, :]
    merged = (w @ cand_boxes) / w.sum(-1, keepdim=True).clamp_min(1e-12)
    boxes = torch.where(keep[..., None], merged, cand_boxes)
    redundant_keep = keep & (overlap.sum(-1) > 1)          # self counts once
    return boxes, redundant_keep


def batched_nms(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, conf_thres: float = 0.25,
                iou_thres: float = 0.45, top_k: int = 1024,
                max_det: int = 300, agnostic: bool = False,
                merge: bool = False,
                class_filter: Optional[Tuple[int, ...]] = None,
                multi_label: bool = False,
                all_scores: Optional[torch.Tensor] = None) -> NMSResult:
    """Class-aware NMS over a batch: hard NMS, merge-NMS (applied per image
    only when ``1 < n < 3000`` candidates pass the gate), class filtering
    and multi-label candidates.

    Args:
      boxes_xyxy: (N, M, 4) boxes in xyxy pixels.
      scores: (N, M) best-class confidence per box.
      classes: (N, M) int class ids.
      multi_label: one candidate per (box, class) above ``conf_thres``;
        needs ``all_scores`` (N, M, nc).
    Returns a fixed-shape :class:`NMSResult` (padding has valid=False).
    """
    boxes_xyxy = boxes_xyxy.float()
    scores = scores.float()
    classes = classes.to(torch.int32)

    if multi_label:
        if all_scores is None:
            raise ValueError("multi_label=True requires all_scores")
        n_img, m, nc = all_scores.shape
        scores = all_scores.float().reshape(n_img, m * nc)
        classes = torch.arange(nc, dtype=torch.int32,
                               device=scores.device).repeat(n_img, m)
        boxes_xyxy = boxes_xyxy.repeat_interleave(nc, dim=1)

    if class_filter is not None:
        # compared class by class: a tensor of the classes would be a copy
        # from the host, which waits for the device and cannot be captured
        # in a CUDA graph
        allowed = torch.zeros_like(classes, dtype=torch.bool)
        for c in class_filter:
            allowed |= classes == c
        scores = torch.where(allowed, scores, torch.full_like(scores, -1.0))

    # candidate count before the pool cap (reference n) — gates merge
    n_pre = (scores > conf_thres).sum(-1)

    cand_boxes, cand_scores, cand_classes, cand_valid = _gather_candidates(
        boxes_xyxy, scores, classes, conf_thres=conf_thres, top_k=top_k)

    if agnostic:
        shifted = cand_boxes
    else:
        shifted = cand_boxes + (cand_classes.float() * MAX_WH)[..., None]

    keep = nms_keep(shifted.contiguous(), cand_valid.contiguous(),
                    iou_thres) & cand_valid

    if merge:
        merged_boxes, merged_keep = _merge_boxes(
            shifted, cand_boxes, cand_scores, cand_valid, keep, iou_thres)
        apply = ((n_pre > 1) & (n_pre < 3000))[:, None]    # reference :266
        cand_boxes = torch.where(apply[..., None], merged_boxes, cand_boxes)
        keep = torch.where(apply, merged_keep, keep)

    return NMSResult(*_select_result(cand_boxes, cand_scores, cand_classes,
                                     keep, conf_thres=conf_thres,
                                     max_det=max_det))


def nms_to_lists(result: NMSResult):
    """Fixed-shape NMS output → per-image list of (n, 6)
    [x1, y1, x2, y2, conf, cls] numpy arrays."""
    boxes = result.boxes.cpu().numpy()
    scores = result.scores.cpu().numpy()
    classes = result.classes.cpu().numpy()
    valid = result.valid.cpu().numpy()
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append(np.concatenate([
            boxes[i][v], scores[i][v, None],
            classes[i][v, None].astype(np.float32)], axis=1))
    return out
