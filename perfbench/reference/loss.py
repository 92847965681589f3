"""Plain fp32 reference of the training step's arithmetic: the
task-aligned assigner, the BCE + CIoU + DFL loss on its targets (dense
targets, written out), global-norm clipping, AdamW with decoupled weight
decay, and the EMA with its warm-up ramp.

A frozen copy of the published formulas (the port's ``train/assigner.py``
and ``train/losses.py`` state the same): nothing of the program is
imported or called.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.model import dfl_decode


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2] - b[..., 2:4] * 0.5,
                      b[..., :2] + b[..., 2:4] * 0.5], -1)


def iou_pairwise(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """(…, N, 4) × (…, M, 4) xyxy → (…, N, M)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7
         ) -> torch.Tensor:
    """Aligned Complete-IoU; the aspect weight carries no gradient."""
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    w1, h1 = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    w2, h2 = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    rho2 = (((a[..., :2] + a[..., 2:]) - (b[..., :2] + b[..., 2:])) ** 2
            ).sum(-1) * 0.25
    diag2 = ((torch.maximum(a[..., 2:], b[..., 2:])
              - torch.minimum(a[..., :2], b[..., :2])) ** 2).sum(-1) + eps
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - rho2 / diag2 - alpha * v


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The lowest index among the maxima along ``dim``."""
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    idx = torch.arange(size, device=x.device).view(shape)
    return torch.where(x == x.amax(dim, keepdim=True), idx, size).amin(dim)


def assign(scores, boxes, anchors_px, gt_xyxy, gt_labels, gt_mask,
           num_classes, topk=10, alpha=0.5, beta=6.0, eps=1e-9):
    """Task-aligned assignment: anchors whose centre lies inside a GT box
    are ranked by ``score^α·IoU^β``; each GT's top ``topk`` are positives;
    an anchor claimed twice goes to the GT of higher IoU. Returns (target
    boxes (N, M, 4), dense target scores (N, M, C), positives (N, M))."""
    n, m, _ = scores.shape
    g = gt_xyxy.shape[1]
    ax, ay = anchors_px[:, 0], anchors_px[:, 1]
    inside = ((ax > gt_xyxy[..., 0:1]) & (ax < gt_xyxy[..., 2:3])
              & (ay > gt_xyxy[..., 1:2]) & (ay < gt_xyxy[..., 3:4])
              & gt_mask[..., None])                            # (N, G, M)
    iou = iou_pairwise(gt_xyxy, boxes).clamp_min(0.0)
    labels = gt_labels.clamp(0, num_classes - 1)
    cls = torch.gather(scores.transpose(1, 2), 1,
                       labels[..., None].expand(n, g, m))
    metric = torch.where(inside, cls ** alpha * iou ** beta, 0.0)
    pos = torch.zeros_like(inside)
    left = metric
    ids = torch.arange(m, device=metric.device)
    for _ in range(min(topk, m)):
        hit = _first_argmax(left, -1)[..., None] == ids
        pos |= hit & (left.amax(-1, keepdim=True) > eps)
        left = torch.where(hit, -torch.inf, left)
    pos &= inside
    best = _first_argmax(torch.where(pos, iou, -1.0), 1)       # (N, M)
    fg = pos.any(1)
    pos &= best[:, None, :] == torch.arange(g, device=pos.device)[
        None, :, None]
    tboxes = torch.gather(gt_xyxy, 1, best[..., None].expand(n, m, 4))
    tlabels = torch.where(fg, torch.gather(labels, 1, best), 0)
    mpos = torch.where(pos, metric, 0.0)
    norm = mpos * torch.where(pos, iou, 0.0).amax(-1, keepdim=True) / (
        mpos.amax(-1, keepdim=True) + eps)
    score = torch.where(fg, norm.amax(1), 0.0)                 # (N, M)
    targets = F.one_hot(tlabels, num_classes).float() * score[..., None]
    return tboxes, targets, fg


def tal_loss(preds, anchors, strides, gt_boxes, gt_labels, gt_mask,
             num_classes, reg_max, lambdas=(1.0, 1.5, 1.5)):
    """``λ_cls·BCE + λ_box·(1 − CIoU) + λ_dfl·DFL`` on the task-aligned
    targets, each summed and divided by ``max(Σ target scores, 1)``."""
    preds = preds.float()
    n, m, _ = preds.shape
    dist = preds[..., :4 * reg_max]
    logits = preds[..., 4 * reg_max:]
    ltrb = dfl_decode(dist, reg_max)
    boxes = torch.cat([anchors[None] - ltrb[..., :2],
                       anchors[None] + ltrb[..., 2:]], -1) * strides[None]
    gt_xyxy = xywh2xyxy(gt_boxes.float())
    with torch.no_grad():
        tboxes, targets, fg = assign(
            torch.sigmoid(logits), boxes, anchors * strides, gt_xyxy,
            gt_labels.long(), gt_mask.bool(), num_classes)
    weight = targets.sum(-1)                                   # (N, M)
    denom = weight.sum().clamp_min(1.0)
    cls = F.binary_cross_entropy_with_logits(logits, targets,
                                             reduction="sum") / denom
    box = torch.where(fg, (1.0 - ciou(boxes, tboxes)) * weight,
                      0.0).sum() / denom
    tgt = torch.cat([anchors[None] - tboxes[..., :2] / strides[None],
                     tboxes[..., 2:] / strides[None] - anchors[None]],
                    -1).clamp(0, reg_max - 1 - 0.01)           # (N, M, 4)
    logp = F.log_softmax(dist.reshape(n, m, 4, reg_max), -1)
    left = tgt.floor().long()
    right = (left + 1).clamp(max=reg_max - 1)
    wl = (left + 1).float() - tgt
    wr = tgt - left.float()
    dfl = -(torch.gather(logp, -1, left[..., None])[..., 0] * wl
            + torch.gather(logp, -1, right[..., None])[..., 0] * wr)
    dfl = torch.where(fg[..., None], dfl * weight[..., None] / 4.0,
                      0.0).sum() / denom
    lc, lb, ld = lambdas
    return lc * cls + lb * box + ld * dfl


class AdamW:
    """AdamW (β 0.9, 0.999, ε 1e-8) with weight decay on every leaf,
    applied to a dict of fp32 tensors in place, after clipping the
    gradients to a global norm."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, clip: float):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients it used."""
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values())).float()
        factor = self.clip / torch.clamp(norm, min=self.clip)
        clipped = {k: g * factor for k, g in grads.items()}
        self.t += 1
        b1, b2 = 0.9, 0.999
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = clipped[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + 1e-8
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        return clipped


def ema_update(ema: Dict[str, torch.Tensor], live: Dict[str, torch.Tensor],
               decay: float, tau: float, step: int) -> None:
    """ema ← d·ema + (1 − d)·live, d = decay·(1 − exp(−(step + 1)/τ))."""
    d = decay * (1.0 - math.exp(-(step + 1) / tau))
    for k in ema:
        ema[k].lerp_(live[k], 1.0 - d)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   keys: List[str]) -> Tuple[float, str]:
    """max over ``keys`` of |program − reference| ÷ max(reference, the
    median leaf's reference), with the leaf that gives it."""
    ref = sorted(reference[k] for k in keys)
    median = ref[len(ref) // 2]
    worst, where = 0.0, ""
    for k in keys:
        gap = abs(program[k] - reference[k]) / max(reference[k], median,
                                                    1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where
