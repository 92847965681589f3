#!/usr/bin/env python
"""Evaluation entry point of the PyTorch port (counterpart of
``scripts/evaluate.py``): load a checkpoint, run the validation set
through the forward and the decode, and report the reference's greedy
metrics and, with ``--coco_map``, COCO mAP@50:95.

The same flags as the JAX package's script, with ``--device cuda|cpu``
(``cuda`` by default, no fallback to the CPU). ``--checkpoint`` is a
``model_epoch_N`` directory or a root of the port's ``CheckpointManager``
(the EMA weights by default, the live ones with ``--no_ema``), or a
``Detector.save_weights`` directory. Predictions are decoded with the
config's ``model.reg_max`` (the JAX script decodes with 16 whatever the
config says), and ``--use_nms`` runs eagerly.

Usage:
  python scripts/torch_evaluate.py --config <yaml> \\
      --checkpoint <dir>/model_epoch_0 --coco_map [--use_nms] \\
      [--quantize static]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="checkpoint evaluation "
                                            "(PyTorch)")
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (defaults to config's)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--dataset_percent", type=float, default=1.0)
    p.add_argument("--conf_threshold", type=float, default=0.25)
    p.add_argument("--use_nms", action="store_true",
                   help="apply NMS before metrics (the reference's metric "
                        "decode skips NMS)")
    p.add_argument("--coco_map", action="store_true",
                   help="also compute true COCO mAP@50:95")
    p.add_argument("--model_coords", action="store_true",
                   help="score COCO mAP in model-input pixels instead of "
                        "original-image coordinates (the official protocol "
                        "uses original coordinates: area ranges depend on "
                        "true pixel sizes)")
    p.add_argument("--ref_box_convention", action="store_true",
                   help="interpret predicted box centres as TOP-LEFT "
                        "corners (the reference trains on top-left-xywh "
                        "ground truth fed to a centre-xywh loss) and shift "
                        "predictions by +[w/2, h/2]")
    p.add_argument("--quantize", default="none",
                   choices=["none", "dynamic", "static"],
                   help="evaluate the int8 serving path: fuse and quantize "
                        "the restored weights; 'static' also calibrates "
                        "input scales on the first --calib_batches batches")
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--no_ema", action="store_true",
                   help="evaluate the LIVE parameters even when the "
                        "checkpoint tracks EMA weights (the default scores "
                        "the EMA, the deployed weights)")
    return p.parse_args(argv)


def restore_detector(cfg, checkpoint, device, no_ema: bool = False):
    """A ``Detector`` of ``cfg``'s model on ``device`` with the weights
    under ``checkpoint`` (the config's checkpoint directory when None).
    Refuses a given ``checkpoint`` under which nothing is found; without
    one it warns and keeps seeded init weights."""
    from custom_yolo_tpu_torch.models.detector import Detector
    from custom_yolo_tpu_torch.utils.checkpoint import (find_weights,
                                                        restore_variables)

    det = Detector(cfg.model.width, cfg.model.depth, cfg.model.csp,
                   num_classes=cfg.model.num_classes,
                   reg_max=cfg.model.reg_max,
                   precision=cfg.training.sharding.precision,
                   input_size=tuple(cfg.model.input_size), device=device)
    ckpt_dir = checkpoint or cfg.checkpoint.checkpoint_dir
    kind, where, epoch = find_weights(ckpt_dir)
    if kind == "weights":
        det.load_weights(where)
        print(f"[INFO] loaded Detector weights from {where}")
    elif kind == "state":
        variables, restored, which = restore_variables(where, epoch,
                                                       live=no_ema)
        det.load_variables(variables)
        print(f"[INFO] restored epoch {restored} from {where} "
              f"({which} params)")
    elif checkpoint:
        raise SystemExit(f"[ERROR] no model_epoch_* checkpoints under "
                         f"{where} — refusing to silently score init "
                         "weights (pass no --checkpoint to allow that)")
    else:
        print(f"[WARN] no checkpoint under {where}; evaluating init "
              "weights")
        det.init(cfg.project.seed)
    return det


def to_original(arr5, scale, offset):
    """Centre-xywh + class in model-input pixels → original-image pixels:
    orig = (model − offset) / scale."""
    out = arr5.copy()
    out[:, 0] = (arr5[:, 0] - offset[0]) / scale[0]
    out[:, 1] = (arr5[:, 1] - offset[1]) / scale[1]
    out[:, 2] = arr5[:, 2] / scale[0]
    out[:, 3] = arr5[:, 3] / scale[1]
    return out


def main(argv=None):
    """Run the evaluation; returns ``{"metrics", "coco", "images",
    "seconds"}`` (``coco`` None without ``--coco_map``)."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.data.dataset import DetectionDataset
    from custom_yolo_tpu_torch.data.loader import DataLoader
    from custom_yolo_tpu_torch.data.transforms import make_device_batch
    from custom_yolo_tpu_torch.eval.coco_map import COCOmAP
    from custom_yolo_tpu_torch.eval.decode import (decode_predictions,
                                                   decoded_to_lists)
    from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics
    from custom_yolo_tpu_torch.utils.common import get_num_workers
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    cfg = Config.from_yaml(args.config)
    if args.batch_size:
        cfg.training.batch_size = args.batch_size
    device = torch.device(args.device)
    det = restore_detector(cfg, args.checkpoint, device, args.no_ema)

    ds = DetectionDataset(
        os.path.join(cfg.data.processed_dir, cfg.data.val_parquet),
        cfg.data.val_images, input_size=tuple(cfg.model.input_size),
        is_test=cfg.training.is_test, percent=args.dataset_percent,
        max_gt=cfg.data.max_gt_boxes, seed=cfg.project.seed,
        letterbox=cfg.data.letterbox)
    loader = DataLoader(ds, cfg.training.batch_size, shuffle=False,
                        drop_last=False, num_workers=get_num_workers(),
                        seed=cfg.project.seed)
    print(f"[INFO] evaluating {len(ds)} images")

    def device_images(host_batch):
        return make_device_batch(host_batch, None, device, train=False,
                                 pin_memory=cfg.data.pin_memory)["images"]

    if args.quantize != "none":
        det.quantize(skip="auto")
        if args.quantize == "static":
            det.calibrate(device_images(host_batch) for _, host_batch
                          in zip(range(args.calib_batches), loader))
            print(f"[INFO] int8 static scales calibrated on "
                  f"{args.calib_batches} batches")
        else:
            print("[INFO] evaluating dynamic-int8 serving path")

    metrics = DetectionMetrics(cfg.model.num_classes)
    cmap = COCOmAP(cfg.model.num_classes) if args.coco_map else None
    t0 = time.time()
    n_images = 0
    for host_batch in loader:
        preds, anchors, strides = det(device_images(host_batch))
        decoded = decode_predictions(
            preds, anchors, strides, conf_threshold=args.conf_threshold,
            reg_max=cfg.model.reg_max, use_nms=args.use_nms)
        pred_lists = decoded_to_lists(decoded)
        gt_boxes = host_batch["gt_boxes"]
        gt_labels = host_batch["gt_labels"]
        gt_mask = host_batch["gt_mask"]
        scores = decoded.scores.cpu().numpy()
        valid = decoded.valid.cpu().numpy()
        scale = host_batch["scale"]       # (N, 2) sx, sy
        offset = host_batch["offset"]     # (N, 2) dx, dy
        pad = host_batch.get("sample_pad",
                             np.zeros(gt_boxes.shape[0], bool))
        for i, plist in enumerate(pred_lists):
            if pad[i]:
                continue  # a repeat that pads the batch, not an image
            if args.ref_box_convention and len(plist):
                # the predicted "centre" is the top-left corner: the true
                # centre sits half an extent down-right of it
                plist = plist.copy()
                plist[:, 0] += plist[:, 2] / 2
                plist[:, 1] += plist[:, 3] / 2
            m = gt_mask[i]
            targets = np.concatenate(
                [gt_boxes[i][m], gt_labels[i][m, None].astype(np.float32)],
                axis=1)
            metrics.update(plist, targets)
            if cmap is not None:
                if args.model_coords:
                    cmap.update(plist, scores[i][valid[i]], targets)
                else:
                    cmap.update(to_original(plist, scale[i], offset[i]),
                                scores[i][valid[i]],
                                to_original(targets, scale[i], offset[i]))
        n_images += int((~pad).sum())
    dt = time.time() - t0

    results = metrics.compute()
    print(f"[INFO] {n_images} images in {dt:.1f}s "
          f"({n_images / max(dt, 1e-9):.1f} img/s)")
    for k, v in results.items():
        print(f"  {k}: {v}")
    coco = None
    if cmap is not None:
        coco = cmap.compute()
        for k, v in coco.items():
            print(f"  {k}: {v:.4f}")
    out = {"metrics": results, "coco": coco, "images": n_images,
           "seconds": dt}
    print(f"[INFO] results: {json.dumps(out)}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}")
    return out


if __name__ == "__main__":
    main()
