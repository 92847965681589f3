"""True COCO-protocol mAP evaluator (bbox); own copy of
``custom_yolo_tpu/eval/coco_map.py``, pure numpy.

Not present in the reference — its "mAP" is mean per-class precision
(``src/training/metrics.py:174-179``, SURVEY §7 "hard parts"). This module
implements the full official COCO detection protocol (the pycocotools
``COCOeval`` semantics) in numpy, because it is the north-star parity
instrument (BASELINE.json):

* IoU thresholds 0.50:0.05:0.95 (10), 101-point interpolated AP
* area ranges  all / small(<32²) / medium(32²..96²) / large(>96²)
* maxDets {1, 10, 100} with AR reported at each
* greedy score-ranked matching with the exact COCOeval tie-breaking
  (each det takes the *highest-IoU* still-free GT; ignored GTs are only
  taken when no valid GT clears the threshold; crowd GTs can match many
  dets and never block)
* per-class AP averaged over classes with ≥1 non-ignored GT

Agreement with the reference protocol is regression-tested against an
independent line-by-line transcription of ``pycocotools.cocoeval`` in
``tests/test_coco_map.py`` on randomized scenes (pycocotools itself is not
installable here — zero egress).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# set (pre-fork) by COCOmAP.compute so pool workers inherit the per-class
# record buckets copy-on-write instead of pickling the whole det store
_POOL_BUCKETS = None


def _class_stats_worker(cls: int):
    return COCOmAP._class_stats(_POOL_BUCKETS[cls])

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)   # 10 thresholds
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def crowd_iou(det_xyxy: np.ndarray, gt_xyxy: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU with the COCO crowd rule: for crowd GTs the denominator
    is the det area alone (maskUtils.iou semantics)."""
    d, g = len(det_xyxy), len(gt_xyxy)
    if d == 0 or g == 0:
        return np.zeros((d, g), np.float64)
    lt = np.maximum(det_xyxy[:, None, :2], gt_xyxy[None, :, :2])
    rb = np.minimum(det_xyxy[:, None, 2:], gt_xyxy[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = ((det_xyxy[:, 2] - det_xyxy[:, 0]) *
              (det_xyxy[:, 3] - det_xyxy[:, 1]))[:, None]
    area_g = ((gt_xyxy[:, 2] - gt_xyxy[:, 0]) *
              (gt_xyxy[:, 3] - gt_xyxy[:, 1]))[None, :]
    union = np.where(iscrowd[None, :], area_d,
                     area_d + area_g - inter)
    return inter / np.maximum(union, 1e-12)


def _match_image(ious: np.ndarray, gt_ignore: np.ndarray,
                 iscrowd: np.ndarray, det_area_bad: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """COCOeval.evaluateImg matching for one (image, class, area-range).

    ious: (D, G) with dets already score-sorted and GTs already sorted so
    non-ignored come first. Returns (dt_matched (T, D) bool,
    dt_ignore (T, D) bool). Crowd GTs never lock (can match many dets).

    Semantics (kept bit-identical to the naive T×D×G greedy loop, which is
    itself a transcription of ``COCOeval.evaluateImg``; equivalence is
    asserted by the randomized-scene tests in ``tests/test_coco_map.py``):
    each det takes the *last argmax* IoU ≥ thr among still-free non-ignored
    GTs; only when none qualifies may it take an ignored GT (GTs arrive
    ignore-sorted, so the reference loop breaks at the region boundary).
    The 10 IoU thresholds are independent given the det order — here they
    run as one vectorized (T, G) pass so Python iterates over D only.
    """
    t = len(IOU_THRESHOLDS)
    d, g = ious.shape
    matched = np.zeros((t, d), bool)
    dt_ig = np.zeros((t, d), bool)
    if d == 0 or g == 0:
        dt_ig |= det_area_bad[None, :]
        return matched, dt_ig

    thr = np.minimum(IOU_THRESHOLDS, 1.0 - 1e-10)[:, None]    # (T, 1)
    gtm = np.zeros((t, g), bool)
    free = np.empty((t, g), bool)
    # GTs are ignore-sorted: [0, n_non) non-ignored (never crowd — crowd
    # implies ignored), [n_non, g) ignored
    n_non = int((~gt_ignore).sum())
    for di in range(d):
        row = ious[di]                                        # (G,)
        np.invert(gtm, out=free)
        free[:, n_non:] |= iscrowd[None, n_non:]
        cand = free & (row[None, :] >= thr)                   # (T, G)

        def last_argmax(c, r):
            # the reference loop updates on ``iou >= best``, so among the
            # candidate set it keeps the LAST index attaining the exact
            # float maximum — reproduce with exact == (no keyed-sum
            # approximations, which would flip near-ties)
            w = c.shape[1]
            if w == 0:
                return np.zeros(t, bool), np.zeros(t, np.int64)
            vals = np.where(c, r[None, :], -1.0)
            mx = vals.max(axis=1, keepdims=True)
            is_mx = (vals == mx) & c
            pick = w - 1 - np.argmax(is_mx[:, ::-1], axis=1)
            return c.any(axis=1), pick

        has_non, pick_non = last_argmax(cand[:, :n_non], row[:n_non])
        has_ig, pick_ig_rel = last_argmax(cand[:, n_non:], row[n_non:])
        hit = has_non | has_ig
        pick = np.where(has_non, pick_non, n_non + pick_ig_rel)  # (T,)
        ti_hit = np.nonzero(hit)[0]
        gtm[ti_hit, pick[ti_hit]] = True
        matched[ti_hit, di] = True
        dt_ig[ti_hit, di] = gt_ignore[pick[ti_hit]]
    dt_ig |= (~matched) & det_area_bad[None, :]
    return matched, dt_ig


class COCOmAP:
    """Accumulate per-image detections, then compute COCO AP/AR statistics.

    update(preds, scores, targets, crowd=None): center-xywh boxes + class
      ids — preds (N, 5) [cx,cy,w,h,cls], scores (N,), targets (M, 5),
      optional crowd (M,) bool marking COCO iscrowd GTs.
    compute() → the 12 standard COCO metrics (plus legacy aliases).
    """

    def __init__(self, num_classes: int, max_det: int = 100):
        self.num_classes = num_classes
        self.max_det = max_det  # largest maxDets bucket (COCO: 100)
        self._images: List[tuple] = []

    def reset(self) -> None:
        self._images = []

    def update(self, preds: np.ndarray, scores: np.ndarray,
               targets: np.ndarray,
               crowd: Optional[np.ndarray] = None) -> None:
        # float64 throughout: COCOeval matches in double precision, and
        # near-threshold IoU ties must not flip on f32 rounding
        preds = np.asarray(preds, np.float64).reshape(-1, 5)
        scores = np.asarray(scores, np.float64).reshape(-1)
        targets = np.asarray(targets, np.float64).reshape(-1, 5)
        if crowd is None:
            crowd = np.zeros(len(targets), bool)
        crowd = np.asarray(crowd, bool).reshape(-1)
        # keep dets score-sorted; trim to the largest maxDets bucket
        order = np.argsort(-scores, kind="stable")[: self.max_det]
        self._images.append((preds[order], scores[order], targets, crowd))

    # ------------------------------------------------------------------
    def _class_buckets(self):
        """One pass over the image records → {cls: [(p, s, g, cr), ...]}.

        The naive layout re-scanned every image once per class (172 ×
        n_images selector evaluations); bucketing makes per-class work
        proportional to the class's actual det/GT volume."""
        buckets: Dict[int, list] = {}
        for preds, scores, targets, crowd in self._images:
            present = np.unique(np.concatenate(
                [preds[:, 4], targets[:, 4]])).astype(np.int64)
            for cls in present:
                if not 0 <= cls < self.num_classes:
                    continue
                p_sel = preds[:, 4] == cls
                t_sel = targets[:, 4] == cls
                buckets.setdefault(int(cls), []).append(
                    (preds[p_sel], scores[p_sel], targets[t_sel],
                     crowd[t_sel]))
        return buckets

    @staticmethod
    def _evaluate_class(recs):
        """Match records for one class (``recs`` from `_class_buckets`).

        Returns {area: (list-of (scores, tp, ig) per image, n_gt)} where
        each image entry keeps its dets score-sorted (so per-image top-md
        trimming is a prefix slice).
        """
        per_area = {a: {"imgs": [], "ngt": 0} for a in AREA_RANGES}
        for p, s, g, cr in recs:
            p_xyxy = _cxcywh_to_xyxy(p[:, :4])
            g_xyxy = _cxcywh_to_xyxy(g[:, :4])
            g_area = g[:, 2] * g[:, 3]
            p_area = p[:, 2] * p[:, 3]
            # IoU is area-range independent (only the GT ordering changes
            # per range) — compute once, permute columns per range
            iou_full = crowd_iou(p_xyxy, g_xyxy, cr)
            for aname, (lo, hi) in AREA_RANGES.items():
                acc = per_area[aname]
                # crowd GTs are always ignored as GT (never counted),
                # but stay matchable
                g_ig = cr | (g_area < lo) | (g_area > hi)
                g_order = np.argsort(g_ig, kind="stable")
                d_bad = (p_area < lo) | (p_area > hi)
                tp, ig = _match_image(iou_full[:, g_order], g_ig[g_order],
                                      cr[g_order], d_bad)
                acc["imgs"].append((s, tp, ig))
                acc["ngt"] += int((~g_ig).sum())
        return per_area

    @staticmethod
    def _ap_101(recall: np.ndarray, precision: np.ndarray) -> float:
        """COCOeval.accumulate: right-to-left precision envelope then
        101-point interpolation sampled with searchsorted(left)."""
        prec = np.maximum.accumulate(precision[::-1])[::-1]
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        vals = np.zeros(len(RECALL_POINTS))
        ok = idx < len(prec)
        vals[ok] = prec[idx[ok]]
        return float(vals.mean())

    @classmethod
    def _class_stats(cls_, recs) -> Tuple[np.ndarray, np.ndarray]:
        """AP/AR for one class: (t, n_area, n_md) arrays, -1 = not valid."""
        t = len(IOU_THRESHOLDS)
        n_area, n_md = len(AREA_RANGES), len(MAX_DETS)
        ap = np.full((t, n_area, n_md), -1.0)
        ar = np.full((t, n_area, n_md), -1.0)
        per_area = cls_._evaluate_class(recs)
        for ai, aname in enumerate(AREA_RANGES):
            imgs = per_area[aname]["imgs"]
            n_gt = per_area[aname]["ngt"]
            if n_gt == 0:
                continue
            for mi, md in enumerate(MAX_DETS):
                if imgs:
                    scores = np.concatenate([s[:md] for s, _, _ in imgs])
                    tp = np.concatenate([x[:, :md] for _, x, _ in imgs],
                                        axis=1)
                    ig = np.concatenate([x[:, :md] for _, _, x in imgs],
                                        axis=1)
                else:
                    scores = np.zeros(0, np.float32)
                    tp = ig = np.zeros((t, 0), bool)
                order = np.argsort(-scores, kind="mergesort")
                tpo, igo = tp[:, order], ig[:, order]
                tps = tpo & ~igo
                fps = ~tpo & ~igo
                cum_tp = np.cumsum(tps, axis=1).astype(np.float64)
                cum_fp = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(t):
                    if cum_tp.shape[1] == 0:
                        ar[ti, ai, mi] = 0.0
                        ap[ti, ai, mi] = 0.0
                        continue
                    rc = cum_tp[ti] / n_gt
                    pr = cum_tp[ti] / np.maximum(
                        cum_tp[ti] + cum_fp[ti], np.spacing(1))
                    ar[ti, ai, mi] = rc[-1]
                    ap[ti, ai, mi] = cls_._ap_101(rc, pr)
        return ap, ar

    def compute(self) -> Dict[str, float]:
        t = len(IOU_THRESHOLDS)
        n_area, n_md = len(AREA_RANGES), len(MAX_DETS)
        ap = np.full((t, self.num_classes, n_area, n_md), -1.0)
        ar = np.full((t, self.num_classes, n_area, n_md), -1.0)
        buckets = self._class_buckets()
        classes = sorted(buckets)
        n_recs = sum(len(v) for v in buckets.values())
        workers = int(os.environ.get(
            "COCO_MAP_WORKERS", min(os.cpu_count() or 1, 16)))
        # fork-based class parallelism: children inherit the buckets
        # copy-on-write (no pickling of the det store); per-class results
        # are tiny. Deterministic — classes are independent.
        if (workers > 1 and n_recs >= 2048 and len(classes) > 1
                and hasattr(os, "fork")):
            import multiprocessing as mp
            global _POOL_BUCKETS
            _POOL_BUCKETS = buckets
            try:
                with mp.get_context("fork").Pool(
                        min(workers, len(classes))) as pool:
                    stats = pool.map(_class_stats_worker, classes,
                                     chunksize=max(1, len(classes)
                                                   // (4 * workers)))
            finally:
                _POOL_BUCKETS = None
            for cls, (ap_c, ar_c) in zip(classes, stats):
                ap[:, cls], ar[:, cls] = ap_c, ar_c
        else:
            for cls in classes:
                ap[:, cls], ar[:, cls] = self._class_stats(buckets[cls])
        return self._summarize(ap, ar)

    def _summarize(self, ap: np.ndarray, ar: np.ndarray) -> Dict[str, float]:
        def mean_valid(x):
            v = x[x > -1]
            return float(v.mean()) if v.size else 0.0

        i75 = int(np.argmin(np.abs(IOU_THRESHOLDS - 0.75)))
        a = {n: i for i, n in enumerate(AREA_RANGES)}
        m100 = MAX_DETS.index(100)
        return {
            "mAP_50_95": mean_valid(ap[:, :, a["all"], m100]),
            "mAP_50": mean_valid(ap[0, :, a["all"], m100]),
            "mAP_75": mean_valid(ap[i75, :, a["all"], m100]),
            "mAP_small": mean_valid(ap[:, :, a["small"], m100]),
            "mAP_medium": mean_valid(ap[:, :, a["medium"], m100]),
            "mAP_large": mean_valid(ap[:, :, a["large"], m100]),
            "AR_1": mean_valid(ar[:, :, a["all"], MAX_DETS.index(1)]),
            "AR_10": mean_valid(ar[:, :, a["all"], MAX_DETS.index(10)]),
            "AR_100": mean_valid(ar[:, :, a["all"], m100]),
            "AR_small": mean_valid(ar[:, :, a["small"], m100]),
            "AR_medium": mean_valid(ar[:, :, a["medium"], m100]),
            "AR_large": mean_valid(ar[:, :, a["large"], m100]),
        }
