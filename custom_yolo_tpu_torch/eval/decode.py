"""Prediction decoding for the validation metrics path (counterpart of
``custom_yolo_tpu/eval/decode.py``).

Equivalent of the reference ``decode_predictions``
(``src/training/train_model.py:14-142``): DFL expectation → ltrb→xywh →
×stride → confidence gate (0.25) → top-k (100), batched, with fixed output
shapes and no wait for the device. The reference applies **no NMS** here
(quirk #5 — it inflates FP counts); pass ``use_nms=True`` for the corrected
variant.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from custom_yolo_tpu_torch.ops.boxes import dist2bbox, xyxy2xywh
from custom_yolo_tpu_torch.ops.dfl import dfl_decode
from custom_yolo_tpu_torch.ops.nms import _top, batched_nms


class DecodedBatch(NamedTuple):
    boxes_xywh: torch.Tensor   # (N, K, 4) center-xywh px
    scores: torch.Tensor       # (N, K)
    classes: torch.Tensor      # (N, K) int32
    valid: torch.Tensor        # (N, K) bool


@torch.no_grad()
def decode_predictions(preds: torch.Tensor, anchors: torch.Tensor,
                       strides: torch.Tensor, conf_threshold: float = 0.25,
                       top_k: int = 100, reg_max: int = 16,
                       use_nms: bool = False) -> DecodedBatch:
    top_k = min(top_k, preds.shape[1])
    preds = preds.float()
    ltrb = dfl_decode(preds[..., :4 * reg_max], reg_max)
    stride_v = strides[None, :, 0:1]
    scores_all = torch.sigmoid(preds[..., 4 * reg_max:])
    best_scores = scores_all.amax(-1)                            # (N, M)
    best_classes = scores_all.argmax(-1).to(torch.int32)

    if use_nms:
        boxes_xyxy = dist2bbox(ltrb, anchors[None], xywh=False) * stride_v
        r = batched_nms(boxes_xyxy, best_scores, best_classes,
                        conf_thres=conf_threshold, max_det=top_k)
        return DecodedBatch(xyxy2xywh(r.boxes), r.scores, r.classes, r.valid)

    boxes_xywh = dist2bbox(ltrb, anchors[None], xywh=True) * stride_v
    gated = torch.where(best_scores >= conf_threshold, best_scores,
                        torch.full_like(best_scores, -1.0))
    # equal scores keep the lower index first, as jax.lax.top_k orders them
    top_scores, idx = _top(gated, top_k)                         # (N, K)
    return DecodedBatch(
        boxes_xywh=torch.gather(boxes_xywh, 1,
                                idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(top_scores > 0, top_scores,
                           torch.zeros_like(top_scores)),
        classes=torch.gather(best_classes, 1, idx),
        valid=top_scores >= conf_threshold,
    )


def decoded_to_lists(decoded: DecodedBatch) -> List[np.ndarray]:
    """Fixed-shape decode → per-image (M, 5) [cx,cy,w,h,cls] numpy arrays
    (the reference's output convention for DetectionMetrics)."""
    boxes = decoded.boxes_xywh.cpu().numpy()
    classes = decoded.classes.cpu().numpy()
    valid = decoded.valid.cpu().numpy()
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append(np.concatenate(
            [boxes[i][v], classes[i][v, None].astype(np.float32)], axis=1))
    return out
