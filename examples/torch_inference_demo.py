#!/usr/bin/env python
"""Checkpoint → inference → visualization demo of the PyTorch port
(counterpart of ``examples/inference_demo.py``): restore a train-state
checkpoint (its EMA weights where it tracks them, the deployed ones),
optionally fold conv+BN, detect on one image and print the detections.

Usage:
  python examples/torch_inference_demo.py --image photo.jpg \\
      --config <yaml> --checkpoint <checkpoint dir> [--fuse] [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Detect on ``--image``; returns its (n, 6) [x1, y1, x2, y2, conf,
    cls] detections in model-input pixels."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image", required=True, help="image path")
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--checkpoint", default=None,
                   help="train-state checkpoint root or model_epoch_N "
                        "directory (default: checkpoint.checkpoint_dir)")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--save", default=None,
                   help="output figure path (needs matplotlib, which the "
                        "GPU machine lacks: in practice a --device cpu "
                        "option)")
    p.add_argument("--fuse", action="store_true",
                   help="fold conv+BN before inference")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import numpy as np

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.models.detector import Detector
    from custom_yolo_tpu_torch.utils.checkpoint import (find_weights,
                                                        restore_variables)
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    cfg = Config.from_yaml(args.config)
    det = Detector(cfg.model.width, cfg.model.depth, cfg.model.csp,
                   num_classes=cfg.model.num_classes,
                   reg_max=cfg.model.reg_max,
                   precision=cfg.training.sharding.precision,
                   input_size=tuple(cfg.model.input_size),
                   device=args.device)
    det.init(seed=cfg.project.seed)

    kind, root, epoch = find_weights(args.checkpoint
                                     or cfg.checkpoint.checkpoint_dir)
    if kind == "state":
        # EMA weights (when tracked) are the deployed ones
        variables, restored, _ = restore_variables(root, epoch)
        det.load_variables(variables)
        print(f"[INFO] restored epoch {restored}")
    else:
        print("[WARN] no checkpoint; using random init")

    if args.fuse:
        det.fuse()

    detections = det.inference(args.image, conf_thres=args.conf,
                               iou_thres=args.iou)[0]
    print(f"{len(detections)} detections:")
    for x1, y1, x2, y2, conf, cls in detections[:25]:
        print(f"  cls={int(cls):3d} conf={conf:.3f} "
              f"box=({x1:.0f},{y1:.0f},{x2:.0f},{y2:.0f})")

    if args.save:
        from PIL import Image

        from custom_yolo_tpu_torch.utils.visualization import draw_bboxes
        img = np.asarray(Image.open(args.image).convert("RGB").resize(
            (det.input_size[1], det.input_size[0])))
        boxes_xywh = np.stack([
            (detections[:, 0] + detections[:, 2]) / 2,
            (detections[:, 1] + detections[:, 3]) / 2,
            detections[:, 2] - detections[:, 0],
            detections[:, 3] - detections[:, 1]], axis=1) \
            if len(detections) else np.zeros((0, 4))
        ax = draw_bboxes(img, boxes_xywh, detections[:, 5],
                         detections[:, 4], color="red")
        ax.figure.savefig(args.save, dpi=120, bbox_inches="tight")
        print(f"saved {args.save}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}",
          flush=True)
    return detections


if __name__ == "__main__":
    main()
