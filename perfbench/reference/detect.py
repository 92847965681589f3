"""Plain reference of the serving result and the comparison that judges
the program's detections against it.

The reference detections come from plain class-aware greedy NMS over the
reference's fp32 scores and boxes (the serving arguments' gate, pool and
cap). The program's served set is held to the reference's **kept** set:

* a served detection (box ``b``, score ``s``, class ``c``) and a kept
  reference detection at anchor ``a`` lie apart by the largest of the
  box's distance to the reference's box at ``a`` in units of ``a``'s
  stride, ``|logit(s) − L_ref[a, c]|``, and ``max L_ref[a] − L_ref[a, c]``
  (the class's shortfall below the reference's best there, so that a
  near tie of two classes may go either way);
* each served detection is matched to the kept detection nearest it, and
  each kept detection to the served one nearest it; a pair within
  :data:`MATCH` is one detection;
* a served detection that no kept one matches, or a kept detection that
  no served one matches, is a fault of the set (a box NMS should have
  suppressed, or one it should have kept), unless its logit lies within
  :data:`MARGIN` of the other side's cut (the gate, the pool's last
  candidate, or the last of ``max_det`` kept), where a rounding may
  rightly push it either way.

Greedy NMS also keeps no two boxes of one class that overlap above the
threshold, whatever the order of their scores: :func:`overlapping_pairs`
counts the served pairs that do. It holds the suppression itself where
the cut blurs the sets: on a large frame the best 1,024 boxes lie far
apart, NMS suppresses few of them, and a served set that suppresses
nothing differs from the kept set mostly near the cut.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference.loss import iou_pairwise

MAX_WH = 7680.0  # class offset of class-aware suppression
# two detections lie within this many logits and DFL bins of each other
MATCH = 0.5
# a detection this close (logits) to the other side's cut may be left out
MARGIN = 0.1
# served pairs overlap where their IoU passes the threshold by this share:
# the band below it takes any rounding of another IoU arithmetic, and no
# more, since the pairs a fault keeps spread over (threshold, 1]
IOU_BAND = 2.0 ** -10


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def served_logit(raw: torch.Tensor) -> torch.Tensor:
    """A reference logit through the same fp32 sigmoid as the served
    scores, which saturates beyond ±16.6."""
    return logit(torch.sigmoid(raw.float()))


def nms(boxes: torch.Tensor, logits: torch.Tensor, conf: float,
        iou_thres: float, top_k: int, max_det: int) -> List[Dict]:
    """Greedy class-aware NMS per image: gate at ``conf``, the ``top_k``
    best by score (ties: lower anchor first), a kept box clears every
    later one of its class it overlaps above ``iou_thres``; up to
    ``max_det`` kept, best first. Returns per image ``{"anchor", "class",
    "logit", "box"}`` tensors, ``pool_cut`` (the pool's last logit where
    the pool is full, else the gate's) and ``cut`` (the last kept logit
    where ``max_det`` were kept, else ``pool_cut``)."""
    n, m, _ = boxes.shape
    best, cls = logits.max(-1)
    score = torch.sigmoid(best)
    gated = torch.where(score > conf, score, torch.full_like(score, -1.0))
    order = torch.sort(gated, dim=-1, descending=True,
                       stable=True)[1][:, :top_k]
    valid = torch.gather(gated, 1, order) > conf
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ccls = torch.gather(cls, 1, order)
    iou = iou_pairwise(cand + ccls[..., None] * MAX_WH,
                       cand + ccls[..., None] * MAX_WH)
    keep = valid.clone()
    k = order.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    for i in range(k):
        keep &= ~((iou[:, i] > iou_thres) & later[i] & keep[:, i:i + 1])
    floor = math.log(conf) - math.log1p(-conf)
    out = []
    for j in range(n):
        idx = order[j][keep[j]][:max_det]
        lg = served_logit(best[j, idx])
        pool_cut = (float(served_logit(best[j, order[j, -1]]))
                    if bool(valid[j].all()) and k == top_k else floor)
        out.append({"anchor": idx, "class": cls[j, idx],
                    "logit": best[j, idx].double(), "box": boxes[j, idx],
                    "pool_cut": pool_cut,
                    "cut": float(lg[-1]) if len(idx) == max_det
                    else pool_cut})
    return out


def overlapping_pairs(boxes: torch.Tensor, classes: torch.Tensor,
                      iou_thres: float) -> int:
    """Pairs of one image's served detections (``boxes`` (D, 4) xyxy,
    ``classes`` (D,)) of one class whose IoU passes ``iou_thres`` by more
    than :data:`IOU_BAND` of it; greedy NMS keeps none. The boxes are set
    apart by class as :func:`nms` does."""
    shifted = boxes.float() + classes.float()[:, None] * MAX_WH
    iou = iou_pairwise(shifted, shifted)
    return int((iou > iou_thres * (1.0 + IOU_BAND)).triu(1).sum())


def image_gaps(prog_boxes: torch.Tensor, prog_scores: torch.Tensor,
               prog_classes: torch.Tensor, ref_boxes: torch.Tensor,
               ref_logits: torch.Tensor, strides: torch.Tensor,
               ref_dets: Dict, max_det: int) -> Dict[str, torch.Tensor]:
    """One image's comparison: ``gap`` and ``box`` (the distance and its
    box part, one a served detection that a kept one matches),
    ``unmatched`` (served and kept detections clear of the cuts that the
    other side does not match) and ``counted`` (those clear of the cuts).
    ``prog_*``: the program's valid detections (D, …) on the reference's
    device; ``ref_boxes`` (M, 4), ``ref_logits`` (M, C), ``strides`` (M,
    1); ``ref_dets``: this image's :func:`nms`."""
    dev = ref_boxes.device
    a = ref_dets["anchor"]
    lr = served_logit(ref_logits[a])                            # (K, C)
    kept = lr.amax(-1)                                          # (K,)
    lp = logit(prog_scores)                                     # (D,)
    k, d = len(a), len(lp)
    box = torch.full((k, d), math.inf, dtype=torch.float64, device=dev)
    err = box.clone()
    if k and d:
        lr_c = lr[:, prog_classes.long()]                       # (K, D)
        box = ((prog_boxes[None].double() - ref_boxes[a][:, None].double())
               .abs().amax(-1) / strides[a].double())
        err = torch.maximum(torch.maximum(box, (lp[None] - lr_c).abs()),
                            kept[:, None] - lr_c)
    # an unmatched row and column of infinities stand for "no counterpart"
    served_err, nearest = torch.cat([err, err.new_full((1, d), math.inf)]
                                    ).min(0)
    kept_err = torch.cat([err, err.new_full((k, 1), math.inf)], 1).min(1)[0]
    box = torch.cat([box, box.new_full((1, d), math.inf)])
    prog_cut = ref_dets["pool_cut"]
    if d == max_det:
        prog_cut = max(prog_cut, float(lp.min()))
    served_clear = lp > ref_dets["cut"] + MARGIN
    kept_clear = kept > prog_cut + MARGIN
    match = served_err <= MATCH
    return {"gap": served_err[match],
            "box": box[nearest, torch.arange(d, device=dev)][match],
            "unmatched": int((~match & served_clear).sum())
            + int(((kept_err > MATCH) & kept_clear).sum()),
            "counted": int(served_clear.sum()) + int(kept_clear.sum())}
