#!/usr/bin/env python
"""Split detection quality into score RANKING and box LOCALISATION, with
the PyTorch port (counterpart of ``scripts/rank_diag.py``).

For a checkpoint, collects the validation predictions once (near-zero
gate, as ``scripts/torch_sweep_eval.py`` does), then scores COCO
mAP@50:95 twice:

* ``as-is``: the model's own confidence ranking;
* ``oracle``: the same boxes and labels, each score replaced by the
  prediction's best IoU with a ground truth of its class (a perfect
  ranking).

``oracle − as-is`` is what mis-ranking loses; a low ``oracle`` means the
boxes themselves are bad. Also reports the mean best IoU over the ground
truths (coverage) and the Spearman rank correlation between confidence
and best IoU over the predictions.

The same flags as the JAX script, with ``--device cuda|cpu`` (``cuda`` by
default, no fallback to the CPU); checkpoints are read as
``torch_evaluate.py`` reads them.

    python scripts/torch_rank_diag.py --config configs/quality_gen2_n.yaml \\
        --checkpoint dataset_gen2/experiments/quality_ckpt --epoch 49
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ranking/localisation "
                                            "diagnostic (PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint parent dir")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ref_box_convention", action="store_true")
    p.add_argument("--no_ema", action="store_true")
    return p.parse_args(argv)


def iou_matrix(a, b):
    """IoU between (N,4) and (M,4) centre-xywh boxes."""
    import numpy as np
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ax1, ay1 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax2, ay2 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    ix = (np.minimum(ax2[:, None], bx2[None]) -
          np.maximum(ax1[:, None], bx1[None])).clip(0)
    iy = (np.minimum(ay2[:, None], by2[None]) -
          np.maximum(ay1[:, None], by1[None])).clip(0)
    inter = ix * iy
    union = ((ax2 - ax1) * (ay2 - ay1))[:, None] + \
            ((bx2 - bx1) * (by2 - by1))[None] - inter
    return inter / np.maximum(union, 1e-9)


def best_ious(plist, targets):
    """Best same-class IoU of each prediction and of each ground truth."""
    import numpy as np
    ious = iou_matrix(plist[:, :4], targets[:, :4])
    ious = ious * (plist[:, 4:5] == targets[None, :, 4])
    per_pred = ious.max(axis=1) if ious.shape[1] else \
        np.zeros(len(plist), np.float32)
    per_gt = ious.max(axis=0) if ious.shape[0] else \
        np.zeros(len(targets), np.float32)
    return per_pred, per_gt


def spearman(x, y) -> float:
    """Rank correlation through a rank transform (no scipy), as the JAX
    script computes it."""
    import numpy as np

    def ranks(v):
        r = np.empty(len(v))
        r[np.argsort(v)] = np.arange(len(v))
        return r
    return float(np.corrcoef(ranks(x), ranks(y))[0, 1]) \
        if len(x) > 1 else float("nan")


def main(argv=None):
    """Run the diagnostic; returns ``{"as_is", "oracle", "mean_best_iou",
    "gt_iou_ge_0.5", "spearman", "images", "preds", "gt"}``."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.eval.coco_map import COCOmAP
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches
    from scripts.torch_evaluate import restore_detector
    from scripts.torch_sweep_eval import collect, val_loader

    cfg = Config.from_yaml(args.config)
    device = torch.device(args.device)
    det = restore_detector(
        cfg, os.path.join(args.checkpoint, f"model_epoch_{args.epoch}"),
        device, args.no_ema)
    _, loader = val_loader(cfg)
    per_image = collect(det, loader, cfg, device, args.top_k,
                        args.ref_box_convention)

    cmap_asis = COCOmAP(cfg.model.num_classes)
    cmap_oracle = COCOmAP(cfg.model.num_classes)
    all_conf, all_iou, gt_cov = [], [], []
    for plist, sc, targets in per_image:
        per_pred, per_gt = best_ious(plist, targets)
        cmap_asis.update(plist, sc, targets)
        cmap_oracle.update(plist, per_pred, targets)
        all_conf.append(sc)
        all_iou.append(per_pred)
        gt_cov.append(per_gt)
    asis = {k: float(v) for k, v in cmap_asis.compute().items()}
    oracle = {k: float(v) for k, v in cmap_oracle.compute().items()}
    conf = np.concatenate(all_conf)
    iou = np.concatenate(all_iou)
    cov = np.concatenate(gt_cov)
    rho = spearman(conf, iou)
    print(f"[diag] epoch {args.epoch}: {len(per_image)} images, "
          f"{len(conf)} preds, {len(cov)} GT")
    print(f"  as-is  COCO mAP@50:95 = {asis['mAP_50_95']:.4f}  "
          f"mAP@50 = {asis['mAP_50']:.4f}")
    print(f"  oracle COCO mAP@50:95 = {oracle['mAP_50_95']:.4f}  "
          f"mAP@50 = {oracle['mAP_50']:.4f}   "
          f"(ranking loss = {oracle['mAP_50_95'] - asis['mAP_50_95']:.4f})")
    print(f"  mean best-IoU over GT   = {cov.mean():.4f}  "
          f"(GT with IoU>=0.5: {(cov >= 0.5).mean():.3f})")
    print(f"  spearman(conf, best-IoU) = {rho:.4f}")
    out = {"as_is": asis, "oracle": oracle,
           "mean_best_iou": float(cov.mean()),
           "gt_iou_ge_0.5": float((cov >= 0.5).mean()), "spearman": rho,
           "images": len(per_image), "preds": len(conf), "gt": len(cov)}
    print(f"[INFO] results: {json.dumps(out)}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}")
    return out


if __name__ == "__main__":
    main()
