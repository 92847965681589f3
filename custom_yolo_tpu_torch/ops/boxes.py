"""Box geometry (counterpart of ``custom_yolo_tpu/ops/boxes.py``).

Operation order follows the JAX functions exactly: NMS keep-sets depend
on the last bit of the IoU.
"""

from __future__ import annotations

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
