#!/usr/bin/env python
"""Checkpoint × confidence-threshold evaluation sweep of the PyTorch port
(counterpart of ``scripts/sweep_eval.py``).

Runs the validation forward once per checkpoint at a near-zero confidence
gate, keeps the decoded per-image predictions on the host, then scores
every requested threshold afterwards. That is exact because the decode's
top-k orders by score (``eval/decode.py``: equal scores keep the lower
index first), so gating then taking the top k keeps what taking the top k
then gating keeps: a threshold's row equals ``torch_evaluate.py
--conf_threshold t`` (COCO mAP with ``--model_coords``: the sweep scores
in model-input pixels, as the JAX script does).

Metrics per (checkpoint, threshold): the greedy P/R/F1/"mAP" (the
reference's single-threshold metric, no NMS) and COCO mAP@50:95 / mAP@50
over the detections above the threshold.

The same flags as the JAX script, with ``--device cuda|cpu`` (``cuda`` by
default, no fallback to the CPU). Checkpoints are read as
``torch_evaluate.py`` reads them (``utils/checkpoint.py``: a train
state's EMA weights unless ``--no_ema``, or a ``save_weights``
directory); predictions are decoded with the config's ``model.reg_max``.

    python scripts/torch_sweep_eval.py --config configs/quality_gen2_n.yaml \\
        --epochs all --thresholds 0.05,0.1,0.25,0.4 --out sweep.json
"""

import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)

BASE_THRESHOLD = 5e-4  # forward/decode gate; all swept thresholds are above


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="checkpoint/threshold sweep "
                                            "(PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint parent dir (defaults to config's)")
    p.add_argument("--epochs", default="all",
                   help="'all', 'latest', or comma-separated epoch numbers")
    p.add_argument("--thresholds",
                   default="0.001,0.05,0.1,0.25,0.4,0.5,0.6,0.75")
    p.add_argument("--top_k", type=int, default=100,
                   help="per-image detection cap (reference decode: 100)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--ref_box_convention", action="store_true",
                   help="score predictions as top-left-xywh (the correction "
                        "for migrated reference checkpoints)")
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--out", default=None, help="write results JSON here")
    return p.parse_args(argv)


def val_loader(cfg):
    """The validation set of ``cfg`` in order, as the evaluate CLI reads
    it."""
    from custom_yolo_tpu_torch.data.dataset import DetectionDataset
    from custom_yolo_tpu_torch.data.loader import DataLoader
    from custom_yolo_tpu_torch.utils.common import get_num_workers

    ds = DetectionDataset(
        os.path.join(cfg.data.processed_dir, cfg.data.val_parquet),
        cfg.data.val_images, input_size=tuple(cfg.model.input_size),
        is_test=cfg.training.is_test, max_gt=cfg.data.max_gt_boxes,
        seed=cfg.project.seed, letterbox=cfg.data.letterbox)
    return ds, DataLoader(ds, cfg.training.batch_size, shuffle=False,
                          drop_last=False, num_workers=get_num_workers(),
                          seed=cfg.project.seed)


def collect(det, loader, cfg, device, top_k: int,
            ref_box_convention: bool = False) -> list:
    """One forward pass over ``loader`` at ``BASE_THRESHOLD``; per real
    image (pred (M, 5) centre-xywh + class, score (M,), target (T, 5)) in
    model-input pixels."""
    import numpy as np

    from custom_yolo_tpu_torch.data.transforms import make_device_batch
    from custom_yolo_tpu_torch.eval.decode import (decode_predictions,
                                                   decoded_to_lists)

    per_image = []
    for host_batch in loader:
        images = make_device_batch(host_batch, None, device, train=False,
                                   pin_memory=cfg.data.pin_memory)["images"]
        preds, anchors, strides = det(images)
        decoded = decode_predictions(
            preds, anchors, strides, conf_threshold=BASE_THRESHOLD,
            top_k=top_k, reg_max=cfg.model.reg_max)
        pred_lists = decoded_to_lists(decoded)
        scores = decoded.scores.cpu().numpy()
        valid = decoded.valid.cpu().numpy()
        gt_boxes = host_batch["gt_boxes"]
        gt_labels = host_batch["gt_labels"]
        gt_mask = host_batch["gt_mask"]
        pad = host_batch.get("sample_pad",
                             np.zeros(gt_boxes.shape[0], bool))
        for i, plist in enumerate(pred_lists):
            if pad[i]:
                continue
            if ref_box_convention and len(plist):
                plist = plist.copy()
                plist[:, 0] += plist[:, 2] / 2
                plist[:, 1] += plist[:, 3] / 2
            m = gt_mask[i]
            targets = np.concatenate(
                [gt_boxes[i][m], gt_labels[i][m, None].astype(np.float32)],
                axis=1)
            per_image.append((plist, scores[i][valid[i]], targets))
    return per_image


def score(per_image, thr: float, num_classes: int) -> dict:
    """The greedy metrics and COCO mAP of the detections scoring ≥ thr."""
    from custom_yolo_tpu_torch.eval.coco_map import COCOmAP
    from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics

    det = DetectionMetrics(num_classes)
    cmap = COCOmAP(num_classes)
    for plist, sc, targets in per_image:
        keep = sc >= thr
        det.update(plist[keep], targets)
        cmap.update(plist[keep], sc[keep], targets)
    out = {k: float(v) for k, v in det.compute().items()}
    out.update({k: float(v) for k, v in cmap.compute().items()})
    return out


def main(argv=None):
    """Run the sweep; returns ``{epoch: {threshold: metrics}}`` (both keys
    strings, as in the JSON written with ``--out``)."""
    args = parse_args(argv)

    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches
    from scripts.torch_evaluate import restore_detector

    cfg = Config.from_yaml(args.config)
    if args.batch_size:
        cfg.training.batch_size = args.batch_size
    device = torch.device(args.device)

    ckpt_dir = args.checkpoint or cfg.checkpoint.checkpoint_dir
    epoch_dirs = sorted(
        glob.glob(os.path.join(ckpt_dir, "model_epoch_*")),
        key=lambda d: int(os.path.basename(d).rsplit("_", 1)[1]))
    if not epoch_dirs:
        raise SystemExit(f"[ERROR] no model_epoch_* under {ckpt_dir}")
    epochs_avail = [int(os.path.basename(d).rsplit("_", 1)[1])
                    for d in epoch_dirs]
    if args.epochs == "all":
        epochs = epochs_avail
    elif args.epochs == "latest":
        epochs = [epochs_avail[-1]]
    else:
        epochs = [int(e) for e in args.epochs.split(",")]
    thresholds = [float(t) for t in args.thresholds.split(",")]
    if not all(t >= BASE_THRESHOLD for t in thresholds):
        raise SystemExit(f"[ERROR] thresholds must be ≥ the decode gate "
                         f"{BASE_THRESHOLD}")

    ds, loader = val_loader(cfg)
    print(f"[INFO] sweeping {len(epochs)} checkpoints × "
          f"{len(thresholds)} thresholds over {len(ds)} images")

    results = {}
    for epoch in epochs:
        det = restore_detector(
            cfg, os.path.join(ckpt_dir, f"model_epoch_{epoch}"), device,
            args.no_ema)
        per_image = collect(det, loader, cfg, device, args.top_k,
                            args.ref_box_convention)
        n_preds = sum(len(p[0]) for p in per_image)
        results[str(epoch)] = {}
        for thr in thresholds:
            r = score(per_image, thr, cfg.model.num_classes)
            results[str(epoch)][f"{thr:g}"] = r
            print(f"[epoch {epoch:>3}] conf={thr:<5g} "
                  f"P={r.get('precision', 0):.4f} "
                  f"R={r.get('recall', 0):.4f} "
                  f"greedy_mAP={r.get('mAP', 0):.4f} "
                  f"coco={r['mAP_50_95']:.4f} coco50={r['mAP_50']:.4f}",
                  flush=True)
        print(f"[epoch {epoch:>3}] {n_preds} raw preds at "
              f"gate {BASE_THRESHOLD}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[INFO] wrote {args.out}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}")
    return results


if __name__ == "__main__":
    main()
