"""Box geometry (counterpart of ``custom_yolo_tpu/ops/boxes.py``).

Operation order follows the JAX functions exactly: NMS keep-sets depend
on the last bit of the IoU.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) centre-xywh → corner-xyxy."""
    xy, wh = boxes[..., :2], boxes[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner-xyxy → centre-xywh."""
    tl, br = boxes[..., :2], boxes[..., 2:4]
    return torch.cat([(tl + br) * 0.5, br - tl], dim=-1)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True) -> torch.Tensor:
    """ltrb distances (..., 4) + anchor centres (..., 2) → boxes (..., 4)."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(boxes_xyxy: torch.Tensor, anchor_points: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Inverse of :func:`dist2bbox`: target ltrb, clamped to
    ``[0, reg_max − 1 − 0.01]`` (the DFL target range)."""
    x1y1, x2y2 = boxes_xyxy[..., :2], boxes_xyxy[..., 2:4]
    lt = anchor_points - x1y1
    rb = x2y2 - anchor_points
    return torch.cat([lt, rb], dim=-1).clamp(0, reg_max - 1 - 0.01)


def box_iou_pairwise(boxes1_xyxy: torch.Tensor, boxes2_xyxy: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """All-pairs IoU: (..., N, 4) × (..., M, 4) → (..., N, M)."""
    a = boxes1_xyxy[..., :, None, :]
    b = boxes2_xyxy[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def box_iou_aligned(boxes1_xyxy: torch.Tensor, boxes2_xyxy: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of aligned box tensors: (..., 4) × (..., 4) → (...)."""
    lt = torch.maximum(boxes1_xyxy[..., :2], boxes2_xyxy[..., :2])
    rb = torch.minimum(boxes1_xyxy[..., 2:4], boxes2_xyxy[..., 2:4])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = ((boxes1_xyxy[..., 2] - boxes1_xyxy[..., 0])
             * (boxes1_xyxy[..., 3] - boxes1_xyxy[..., 1]))
    area2 = ((boxes2_xyxy[..., 2] - boxes2_xyxy[..., 0])
             * (boxes2_xyxy[..., 3] - boxes2_xyxy[..., 1]))
    return inter / (area1 + area2 - inter + eps)


def box_ciou(boxes1_xyxy: torch.Tensor, boxes2_xyxy: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise Complete-IoU (aligned shapes): IoU − centre distance over
    the enclosing diagonal − the aspect-ratio penalty, whose weight
    ``alpha`` carries no gradient."""
    iou = box_iou_aligned(boxes1_xyxy, boxes2_xyxy, eps)

    c1 = (boxes1_xyxy[..., :2] + boxes1_xyxy[..., 2:4]) * 0.5
    c2 = (boxes2_xyxy[..., :2] + boxes2_xyxy[..., 2:4]) * 0.5
    rho2 = ((c1 - c2) ** 2).sum(dim=-1)

    enc_tl = torch.minimum(boxes1_xyxy[..., :2], boxes2_xyxy[..., :2])
    enc_br = torch.maximum(boxes1_xyxy[..., 2:4], boxes2_xyxy[..., 2:4])
    diag2 = ((enc_br - enc_tl) ** 2).sum(dim=-1) + eps

    w1 = boxes1_xyxy[..., 2] - boxes1_xyxy[..., 0]
    h1 = boxes1_xyxy[..., 3] - boxes1_xyxy[..., 1]
    w2 = boxes2_xyxy[..., 2] - boxes2_xyxy[..., 0]
    h2 = boxes2_xyxy[..., 3] - boxes2_xyxy[..., 1]
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - rho2 / diag2 - alpha * v
