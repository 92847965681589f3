"""Greedy detection metrics (own copy of ``custom_yolo_tpu/eval/metrics.py``,
pure numpy) — behavioral parity with the reference
``DetectionMetrics`` (``src/training/metrics.py:44-207``): per-prediction
greedy best-unmatched-target matching with class equality and IoU ≥ 0.5,
accumulating global and per-class TP/FP/FN; ``compute`` reports
precision/recall/F1 and the reference's "mAP" (mean per-class precision over
classes with GT — NOT a real AP, quirk documented in SURVEY §2). For the
true COCO metric use :mod:`custom_yolo_tpu_torch.eval.coco_map`.

``all_reduce`` sums the counters over every process of a distributed
validation (``custom_yolo_tpu/eval/metrics.py:119-132``).

Implementation: numpy, with the inner match vectorized over targets (the
reference double-loops in python over preds×targets — hot-loop #3 in
SURVEY §3.2).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def box_iou_batch(boxes1_xywh: np.ndarray, boxes2_xywh: np.ndarray
                  ) -> np.ndarray:
    """(N,4)×(M,4) center-xywh → (N,M) IoU (reference metrics.py:6-41)."""
    a = _xywh_to_xyxy(boxes1_xywh)
    b = _xywh_to_xyxy(boxes2_xywh)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-6)


class DetectionMetrics:
    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold
        self.reset()

    def reset(self) -> None:
        self.total_predictions = 0
        self.total_ground_truths = 0
        self.true_positives = 0
        self.false_positives = 0
        self.false_negatives = 0
        self.class_tp = np.zeros(self.num_classes)
        self.class_fp = np.zeros(self.num_classes)
        self.class_fn = np.zeros(self.num_classes)
        self.class_gt_count = np.zeros(self.num_classes)

    def update(self, predictions: np.ndarray, targets: np.ndarray,
               pred_scores: Optional[np.ndarray] = None,
               score_threshold: float = 0.5) -> None:
        """predictions (N,5) [cx,cy,w,h,cls]; targets (M,5) same layout."""
        predictions = np.asarray(predictions, np.float32).reshape(-1, 5)
        targets = np.asarray(targets, np.float32).reshape(-1, 5)
        if predictions.size == 0 and targets.size == 0:
            return
        if pred_scores is not None and predictions.size > 0:
            keep = np.asarray(pred_scores) >= score_threshold
            predictions = predictions[keep]

        if predictions.size == 0:
            self.false_negatives += len(targets)
            for cls_id in targets[:, 4].astype(int):
                if 0 <= cls_id < self.num_classes:
                    self.class_fn[cls_id] += 1
                    self.class_gt_count[cls_id] += 1
            return
        if targets.size == 0:
            self.false_positives += len(predictions)
            for cls_id in predictions[:, 4].astype(int):
                if 0 <= cls_id < self.num_classes:
                    self.class_fp[cls_id] += 1
            return

        ious = box_iou_batch(predictions[:, :4], targets[:, :4])
        pred_cls = predictions[:, 4].astype(int)
        tgt_cls = targets[:, 4].astype(int)
        matched = np.zeros(len(targets), bool)

        # greedy in prediction order (reference :116-154), inner argmax
        # vectorized over targets
        for i in range(len(predictions)):
            cand = (tgt_cls == pred_cls[i]) & ~matched
            row = np.where(cand, ious[i], 0.0)
            j = int(np.argmax(row))
            best = row[j]
            if best >= self.iou_threshold and best > 0:
                self.true_positives += 1
                matched[j] = True
                if 0 <= pred_cls[i] < self.num_classes:
                    self.class_tp[pred_cls[i]] += 1
            else:
                self.false_positives += 1
                if 0 <= pred_cls[i] < self.num_classes:
                    self.class_fp[pred_cls[i]] += 1

        self.false_negatives += int((~matched).sum())
        for j in range(len(targets)):
            if 0 <= tgt_cls[j] < self.num_classes:
                self.class_gt_count[tgt_cls[j]] += 1
                if not matched[j]:
                    self.class_fn[tgt_cls[j]] += 1

        self.total_predictions += len(predictions)
        self.total_ground_truths += len(targets)

    def all_reduce(self) -> "DetectionMetrics":
        """Sum the counters over every process (multi-process validation):
        the five totals and the four per-class arrays. Nothing in a single
        process."""
        from custom_yolo_tpu_torch.parallel.collectives import reduce_value
        for attr in ("total_predictions", "total_ground_truths",
                     "true_positives", "false_positives",
                     "false_negatives"):
            setattr(self, attr, int(reduce_value(
                getattr(self, attr), average=False)))
        for attr in ("class_tp", "class_fp", "class_fn", "class_gt_count"):
            setattr(self, attr, np.asarray(reduce_value(
                getattr(self, attr), average=False)))
        return self

    def compute(self) -> Dict[str, float]:
        precision = self.true_positives / (
            self.true_positives + self.false_positives + 1e-6)
        recall = self.true_positives / (
            self.true_positives + self.false_negatives + 1e-6)
        f1 = 2 * precision * recall / (precision + recall + 1e-6)
        class_precision = self.class_tp / (
            self.class_tp + self.class_fp + 1e-6)
        valid = self.class_gt_count > 0
        map_value = float(class_precision[valid].mean()) if valid.any() else 0.0
        return {
            "precision": float(precision),
            "recall": float(recall),
            "f1_score": float(f1),
            "mAP": map_value,
            "true_positives": int(self.true_positives),
            "false_positives": int(self.false_positives),
            "false_negatives": int(self.false_negatives),
            "total_predictions": int(self.total_predictions),
            "total_ground_truths": int(self.total_ground_truths),
        }

    def get_class_metrics(self, class_id: int) -> Dict[str, float]:
        tp = self.class_tp[class_id]
        fp = self.class_fp[class_id]
        fn = self.class_fn[class_id]
        precision = tp / (tp + fp + 1e-6)
        recall = tp / (tp + fn + 1e-6)
        return {
            "precision": float(precision),
            "recall": float(recall),
            "f1_score": float(2 * precision * recall
                              / (precision + recall + 1e-6)),
            "true_positives": int(tp),
            "false_positives": int(fp),
            "false_negatives": int(fn),
            "ground_truths": int(self.class_gt_count[class_id]),
        }


def compute_average_iou(predictions: List[np.ndarray],
                        targets: List[np.ndarray]) -> float:
    """Mean best-IoU per prediction (reference metrics.py:210-235)."""
    total, pairs = 0.0, 0
    for pred, tgt in zip(predictions, targets):
        if pred.size == 0 or tgt.size == 0:
            continue
        ious = box_iou_batch(pred[:, :4], tgt[:, :4])
        total += ious.max(axis=1).sum()
        pairs += len(pred)
    return total / (pairs + 1e-6)
