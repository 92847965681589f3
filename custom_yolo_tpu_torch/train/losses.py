"""Detection losses (counterpart of ``custom_yolo_tpu/train/losses.py``):
QFL + DFL for the ``nearest`` assigner and BCE + CIoU + DFL for ``tal``,
batched over (image, GT, anchor) on padded fixed-shape ground truth.

``nearest``: quality focal loss (β=2) summed over anchors × classes and
divided by the anchor count, averaged over images; DFL as a two-bin
cross-entropy on target ltrb in grid units, per-image mean over GTs and
sides, averaged over *all* images (an image with no box adds 0);
total = λ_dfl·DFL + λ_cls·QFL. ``tal``: BCE against soft targets, CIoU and
DFL on the positives, each weighted by the target score and divided by
``max(Σ scores, 1)``. GT boxes are centre-format xywh in pixels;
``iou_compat_bug=True`` reproduces the original implementation's
swapped-operand IoU for parity tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from custom_yolo_tpu_torch.ops.boxes import (bbox2dist, box_ciou,
                                             box_iou_aligned, dist2bbox,
                                             xywh2xyxy)
from custom_yolo_tpu_torch.ops.dfl import dfl_decode
from custom_yolo_tpu_torch.train.assigner import (nearest_center_assign,
                                                  task_aligned_assign)
from custom_yolo_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LossConfig:
    num_classes: int = 172
    reg_max: int = 16
    lambda_cls: float = 1.0
    lambda_box: float = 1.5
    lambda_dfl: float = 1.5
    assigner: str = "nearest"       # "nearest" | "tal"
    qfl_beta: float = 2.0
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    iou_compat_bug: bool = False    # the original bbox_iou, bug included
    # sparse targets: the QFL/BCE sum is a dense term with all-zero targets
    # plus a gathered correction at the positives, so no (N, M, C) target
    # tensor is built. The same sum in another order as the dense form.
    sparse_targets: bool = True


_LOG_EPS = -27.631021115928547  # log(1e-12)


def _log_sig_eps(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x) + 1e-12)`` as
    ``logaddexp(log_sigmoid(x), log 1e-12)``. Keep this form: written as
    ``log(1 − σ + 1e-12)`` the epsilon vanishes beside the 1 once fp32 σ
    rounds to 1.0 (logits ≥ 16.6), and one saturated anchor turns the
    whole loss into −inf."""
    return torch.logaddexp(F.logsigmoid(x), x.new_tensor(_LOG_EPS))


def quality_focal_loss(pred_logits: torch.Tensor, target_scores: torch.Tensor,
                       beta: float = 2.0) -> torch.Tensor:
    """Per-image QFL: −(t·(1−σ)^β·log σ + (1−t)·σ^β·log(1−σ)) summed over
    anchors and classes, divided by the anchor count. Input (..., M, C);
    returns (...)."""
    p = torch.sigmoid(pred_logits)
    pos = target_scores * (1 - p) ** beta * _log_sig_eps(pred_logits)
    neg = (1 - target_scores) * p ** beta * _log_sig_eps(-pred_logits)
    m = pred_logits.shape[-2]
    return -(pos + neg).sum(dim=(-2, -1)) / m


def _two_bin_ce(pred_dist_logits: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss core: cross-entropy against the floor and
    ceil bins of ``target``, weighted by linear interpolation.
    pred_dist_logits (..., reg_max); target (...) in [0, reg_max−1) — the
    clamp lives in :func:`bbox2dist`; only the right bin is clipped here."""
    logp = F.log_softmax(pred_dist_logits, dim=-1)
    left = target.floor().long()
    right = left + 1
    wl = right.to(target.dtype) - target
    wr = target - left.to(target.dtype)
    right_c = right.clamp(0, logp.shape[-1] - 1)
    lp_left = torch.gather(logp, -1, left[..., None])[..., 0]
    lp_right = torch.gather(logp, -1, right_c[..., None])[..., 0]
    return -(lp_left * wl + lp_right * wr)


def _qfl_sparse(pred_logits: torch.Tensor, idx: torch.Tensor,
                labels: torch.Tensor, iou: torch.Tensor,
                gt_mask: torch.Tensor, beta: float) -> torch.Tensor:
    """QFL without the dense (N, M, C) target tensor: the targets are zero
    except at the ≤G matched (anchor, class) slots, so

      QFL = Σ_{m,c} −p^β·log(1−p)                            [dense, t = 0]
          + Σ_{winners} −t·[(1−p)^β·log p − p^β·log(1−p)]    [correction]

    Two GTs matched to the same anchor and class resolve to the one of
    higher IoU, and equal IoUs to the lower GT index — what a max-scatter
    into the dense targets gives. idx, labels, iou (zero at padding) and
    gt_mask are (N, G). Returns the per-image QFL (N,)."""
    n, m, c = pred_logits.shape
    p = torch.sigmoid(pred_logits)
    base = -(p ** beta * _log_sig_eps(-pred_logits)).sum(dim=(-2, -1))

    g_idx = torch.arange(idx.shape[1], device=idx.device)
    same = ((idx[:, :, None] == idx[:, None, :])
            & (labels[:, :, None] == labels[:, None, :])
            & gt_mask[:, :, None] & gt_mask[:, None, :])           # (N, G, G)
    better = ((iou[:, None, :] > iou[:, :, None])
              | ((iou[:, None, :] == iou[:, :, None])
                 & (g_idx[None, None, :] < g_idx[None, :, None])))
    winner = gt_mask & ~(same & better).any(dim=2)                 # (N, G)

    flat = torch.gather(pred_logits.reshape(n, -1), 1, idx * c + labels)
    pg = torch.sigmoid(flat)
    corr_terms = iou * ((1 - pg) ** beta * _log_sig_eps(flat)
                        - pg ** beta * _log_sig_eps(-flat))
    corr = -torch.where(winner, corr_terms, 0.0).sum(dim=1)
    return (base + corr) / m


def _iou_xywh_reference_bug(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The original ``bbox_iou`` on centre-xywh boxes *including* its
    swapped-operand bug on box1's y2 (``h + y_centre/2`` for
    ``y_centre + h/2``). Only for parity through
    ``LossConfig.iou_compat_bug``."""
    b1_x1 = b1[..., 0] - b1[..., 2] / 2
    b1_y1 = b1[..., 1] - b1[..., 3] / 2
    b1_x2 = b1[..., 0] + b1[..., 2] / 2
    b1_y2 = b1[..., 3] + b1[..., 1] / 2          # <-- the bug
    b2_x1 = b2[..., 0] - b2[..., 2] / 2
    b2_y1 = b2[..., 1] - b2[..., 3] / 2
    b2_x2 = b2[..., 0] + b2[..., 2] / 2
    b2_y2 = b2[..., 1] + b2[..., 3] / 2
    iw = (torch.minimum(b1_x2, b2_x2)
          - torch.maximum(b1_x1, b2_x1)).clamp_min(0)
    ih = (torch.minimum(b1_y2, b2_y2)
          - torch.maximum(b1_y1, b2_y1)).clamp_min(0)
    inter = iw * ih
    area1 = (b1_x2 - b1_x1) * (b1_y2 - b1_y1)
    area2 = (b2_x2 - b2_x1) * (b2_y2 - b2_y1)
    return inter / (area1 + area2 - inter + 1e-6)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid BCE."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


class DetectionLoss:
    """Callable criterion on padded fixed-shape ground truth:

      loss, metrics = loss_fn(preds, anchors, strides,
                              gt_boxes, gt_labels, gt_mask)

      preds:     (N, M, 4·reg_max + C) raw head output (anchor-major)
      anchors:   (M, 2) grid-unit cell centres
      strides:   (M, 1)
      gt_boxes:  (N, G, 4) centre-xywh in pixels
      gt_labels: (N, G) integer
      gt_mask:   (N, G) bool/int — 1 for real boxes, 0 for padding

    ``global_batch=True`` (every rank of the default process group holds
    part of the batch, as under dp and fsdp): the loss is that of the
    global batch. Under ``tal`` the sums are divided by the global
    ``score_sum`` (all-reduced; the assigner's inputs carry no gradient),
    under ``nearest`` the image means are over every rank's images. The
    metrics are the global values, and the returned loss is this rank's
    share times the world size, so that the gradient average that DDP and
    FSDP take is the gradient of the global loss.
    """

    def __init__(self, config: LossConfig, global_batch: bool = False):
        self.cfg = config
        self.global_batch = global_batch

    def _global_sum(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` (no gradient) summed over every rank under
        ``global_batch``, else itself."""
        if not self.global_batch:
            return value
        value = value.detach().clone()
        # the span names the collective in a profile
        # (scripts/torch_multichip_report.py)
        with span("collective/loss"):
            dist.all_reduce(value)
        return value

    def __call__(self, preds, anchors, strides, gt_boxes, gt_labels, gt_mask
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        total, metrics = self._local(preds, anchors, strides, gt_boxes,
                                     gt_labels, gt_mask)
        if not self.global_batch:
            return total, metrics
        if self.cfg.assigner == "nearest":
            # image means: this rank's share of the global batch's
            n = torch.tensor(float(preds.shape[0]), device=preds.device)
            frac = n / self._global_sum(n)
            total = total * frac
            metrics = {k: v * frac for k, v in metrics.items()}
        keys = list(metrics)
        summed = self._global_sum(torch.stack([metrics[k] for k in keys]))
        return total * dist.get_world_size(), dict(zip(keys, summed))

    def _local(self, preds, anchors, strides, gt_boxes, gt_labels, gt_mask
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        preds = preds.float()
        gt_boxes = gt_boxes.float()
        gt_labels = gt_labels.long()
        gt_mask = gt_mask.bool()

        rm = cfg.reg_max
        pred_dist = preds[..., : 4 * rm]                     # (N, M, 4·rm)
        pred_logits = preds[..., 4 * rm:]                    # (N, M, C)

        ltrb = dfl_decode(pred_dist, rm)                     # (N, M, 4) grid
        stride_v = strides[None, :, 0:1]                     # (1, M, 1)
        if cfg.assigner == "nearest":
            pred_xywh_px = dist2bbox(ltrb, anchors[None], xywh=True) * stride_v
            return self._nearest_loss(
                pred_dist, pred_logits, pred_xywh_px, anchors, strides,
                gt_boxes, gt_labels, gt_mask)
        pred_xyxy_px = dist2bbox(ltrb, anchors[None], xywh=False) * stride_v
        return self._tal_loss(
            pred_dist, pred_logits, pred_xyxy_px, anchors, strides,
            gt_boxes, gt_labels, gt_mask)

    # ---------------------------------------------------------------- nearest
    def _nearest_loss(self, pred_dist, pred_logits, pred_xywh_px, anchors,
                      strides, gt_boxes, gt_labels, gt_mask):
        cfg = self.cfg
        n, m, _ = pred_logits.shape
        g = gt_boxes.shape[1]
        rm = cfg.reg_max

        with span("train/assign"):
            assign = nearest_center_assign(
                gt_boxes[..., :2], pred_xywh_px[..., :2], gt_mask)
        idx = assign.anchor_idx                               # (N, G)

        matched_xywh = torch.gather(
            pred_xywh_px, 1, idx[..., None].expand(n, g, 4))  # (N, G, 4)
        matched_dist = torch.gather(
            pred_dist.reshape(n, m, 4, rm), 1,
            idx[..., None, None].expand(n, g, 4, rm))         # (N, G, 4, rm)
        matched_anchor = anchors[idx]                         # (N, G, 2)
        matched_stride = strides[idx][..., 0:1]               # (N, G, 1)

        # DFL: target ltrb in grid units
        gt_xyxy_grid = xywh2xyxy(gt_boxes) / matched_stride
        tgt_ltrb = bbox2dist(gt_xyxy_grid, matched_anchor, rm)  # (N, G, 4)
        dfl_all = _two_bin_ce(matched_dist, tgt_ltrb)           # (N, G, 4)
        dfl_per_gt = dfl_all.mean(dim=-1)                       # (N, G)
        gt_count = gt_mask.sum(dim=1)                           # (N,)
        dfl_per_img = torch.where(gt_mask, dfl_per_gt, 0.0).sum(
            dim=1) / gt_count.clamp_min(1)
        mean_dfl = dfl_per_img.mean()   # images without GT contribute 0

        # QFL targets: IoU at the matched anchor, in the class channel
        if cfg.iou_compat_bug:
            iou = _iou_xywh_reference_bug(matched_xywh, gt_boxes)
        else:
            iou = box_iou_aligned(xywh2xyxy(matched_xywh),
                                  xywh2xyxy(gt_boxes))        # (N, G)
        iou = torch.where(gt_mask, iou, 0.0)
        labels_safe = gt_labels.clamp(0, cfg.num_classes - 1)

        if cfg.sparse_targets:
            qfl_per_img = _qfl_sparse(pred_logits, idx, labels_safe, iou,
                                      gt_mask, cfg.qfl_beta)
        else:
            # scatter; duplicate (anchor, class) slots merge by max, padding
            # goes to an extra row that is cut off again
            safe_idx = torch.where(gt_mask, idx, m)
            target_scores = torch.zeros(
                n, (m + 1) * cfg.num_classes, dtype=pred_logits.dtype,
                device=pred_logits.device).scatter_reduce(
                    1, safe_idx * cfg.num_classes + labels_safe, iou,
                    reduce="amax", include_self=True)
            target_scores = target_scores.view(n, m + 1, cfg.num_classes)[
                :, :m]
            qfl_per_img = quality_focal_loss(pred_logits, target_scores,
                                             cfg.qfl_beta)     # (N,)
        mean_cls = qfl_per_img.mean()

        total = cfg.lambda_dfl * mean_dfl + cfg.lambda_cls * mean_cls
        return total, {
            "total_loss": total,
            "box_loss": mean_dfl,   # DFL is reported as the box loss
            "cls_loss": mean_cls,
        }

    # -------------------------------------------------------------------- TAL
    def _tal_loss(self, pred_dist, pred_logits, pred_xyxy_px, anchors,
                  strides, gt_boxes, gt_labels, gt_mask):
        cfg = self.cfg
        n, m, _ = pred_logits.shape
        rm = cfg.reg_max

        anchor_px = anchors * strides                          # (M, 2)
        gt_xyxy = xywh2xyxy(gt_boxes)

        # the assigner's inputs carry no gradient
        with span("train/assign"):
            asn = task_aligned_assign(
                torch.sigmoid(pred_logits).detach(), pred_xyxy_px.detach(),
                anchor_px, gt_xyxy, gt_labels, gt_mask,
                num_classes=cfg.num_classes, topk=cfg.tal_topk,
                alpha=cfg.tal_alpha, beta=cfg.tal_beta,
                dense_scores=not cfg.sparse_targets)

        score_sum = self._global_sum(asn.anchor_scores.sum()).clamp_min(1.0)

        if cfg.sparse_targets:
            # BCE(l, t) = [max(l, 0) + log1p(e^−|l|)] − l·t, and t is zero
            # except at each positive's assigned class: a dense base minus
            # a gathered (N, M) correction
            base = (pred_logits.clamp_min(0)
                    + torch.log1p(torch.exp(-pred_logits.abs()))).sum()
            picked = torch.gather(pred_logits, 2,
                                  asn.target_labels[..., None])[..., 0]
            corr = (picked * asn.anchor_scores).sum()
            cls_loss = (base - corr) / score_sum
        else:
            cls_loss = sigmoid_bce(pred_logits,
                                   asn.target_scores).sum() / score_sum

        # box: CIoU on the positives, weighted by the target score
        weight = asn.anchor_scores                             # (N, M)
        ciou = box_ciou(pred_xyxy_px, asn.target_boxes)        # (N, M)
        box_loss = torch.where(asn.fg_mask, (1.0 - ciou) * weight,
                               0.0).sum() / score_sum

        # DFL on the positives
        stride_v = strides[None, :, 0:1]
        tgt_xyxy_grid = asn.target_boxes / stride_v    # (N,M,4)/(1,M,1)
        tgt_ltrb = bbox2dist(tgt_xyxy_grid, anchors[None], rm)  # (N, M, 4)
        dfl_all = _two_bin_ce(pred_dist.reshape(n, m, 4, rm), tgt_ltrb)
        dfl_loss = torch.where(
            asn.fg_mask[..., None], dfl_all * weight[..., None] / 4.0,
            0.0).sum() / score_sum

        total = (cfg.lambda_cls * cls_loss + cfg.lambda_box * box_loss
                 + cfg.lambda_dfl * dfl_loss)
        return total, {
            "total_loss": total,
            "box_loss": box_loss,
            "cls_loss": cls_loss,
            "dfl_loss": dfl_loss,
        }
