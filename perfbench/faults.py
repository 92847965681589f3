"""Faults planted in the program underneath a run, for the check that
each one makes ``correct`` come out false (``tests/test_perfbench_
control.py``) and for reading a fault's numbers on the card
(``calibrate.py``). Each wraps a traffic generator's builder; nothing here runs in
the benchmark's own runs."""

from __future__ import annotations

import collections

import torch

Result = collections.namedtuple("Result", "boxes scores classes num_valid")


class _Serving:
    """A detector whose ``serve`` hands each result to ``alter``."""

    def __init__(self, det, alter):
        self.det, self.alter, self.model = det, alter, det.model
        self.last = None

    def serve(self, images, **kw):
        res = self.det.serve(images, **kw)
        out = self.alter(self, Result(res.boxes, res.scores, res.classes,
                                      res.num_valid))
        self.last = res
        return out


def _stale(det, res):
    """Each batch answered with the previous batch's detections: a step
    that returns its state unchanged."""
    return res if det.last is None else Result(
        det.last.boxes, det.last.scores, det.last.classes,
        det.last.num_valid)


def _half(det, res):
    """The second half of the batch left out."""
    n = res.num_valid.clone()
    n[n.shape[0] // 2:] = 0
    return res._replace(num_valid=n)


def _altered(det, res):
    """Every served score moved by half a logit where it is produced."""
    s = res.scores.clamp(1e-6, 1 - 1e-6)
    return res._replace(scores=torch.sigmoid(torch.log(s / (1 - s)) + 0.5))


# kept boxes that the truncating NMS fault leaves an image
TRUNCATE = 32


class _Suppression:
    """A detector whose NMS keep mask (``ops.nms.nms_keep``, K2) is
    replaced by ``keep(original, boxes, valid, iou_thres)`` while it
    serves."""

    def __init__(self, det, keep):
        self.det, self.keep, self.model = det, keep, det.model

    def serve(self, images, **kw):
        from custom_yolo_tpu_torch.ops import nms

        original = nms.nms_keep
        nms.nms_keep = lambda *args: self.keep(original, *args)
        try:
            return self.det.serve(images, **kw)
        finally:
            nms.nms_keep = original


def _no_suppression(original, boxes, valid, iou_thres):
    """NMS that suppresses nothing: every candidate of the pool kept."""
    return valid.clone()


def _truncated(original, boxes, valid, iou_thres):
    """NMS that keeps only the first ``TRUNCATE`` boxes it would keep."""
    keep = original(boxes, valid, iou_thres)
    return keep & (keep.cumsum(-1) <= TRUNCATE)


SERVE = {"stale": (_Serving, _stale), "half_batch": (_Serving, _half),
         "altered": (_Serving, _altered),
         "no_suppression": (_Suppression, _no_suppression),
         "truncated_keep": (_Suppression, _truncated)}


def serving(original, name):
    wrapper, fault = SERVE[name]

    def build(cfg, state, device):
        return wrapper(original(cfg, state, device), fault)
    return build


def training(original, name):
    """``unchanged``: the step computes its loss and returns the state it
    was given; ``half_batch``: the step sees the first half of each batch,
    the mean taken over the rest; ``altered``: the loss the step
    differentiates and reports is 10% off where it is produced."""
    def build(cfg, mix, state_dict, dev):
        model, opt, state, step, loss = original(cfg, mix, state_dict, dev)
        if name == "half_batch":
            def run(state, batch):
                n = batch["images"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
        elif name == "unchanged":
            def run(state, batch):
                with torch.no_grad():
                    _, metrics = loss(*model(batch["images"]),
                                      batch["gt_boxes"], batch["gt_labels"],
                                      batch["gt_mask"])
                return state, metrics
        elif name == "altered":
            inner = loss.inner

            def altered(*args):
                total, metrics = inner(*args)
                return total * 1.1, dict(
                    metrics, total_loss=metrics["total_loss"] * 1.1)
            loss.inner = altered
            run = step
        else:
            raise ValueError(name)
        return model, opt, state, run, loss
    return build


TRAIN = ("unchanged", "half_batch", "altered")
