#!/usr/bin/env python
"""Batch-serve a folder of JPEGs with the PyTorch port (counterpart of
``examples/serve_folder.py``): native decode (PIL where the native
decoder does not build) → normalise → ``Detector.serve`` (forward + decode
+ NMS) → detections JSON.

Usage:
  python examples/torch_serve_folder.py --images photos/ --config <yaml> \\
      --checkpoint <Detector.save_weights dir> [--device cpu]
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Serve the folder; returns the detections written to ``--out``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", default=None,
                   help="folder of JPEGs (default: config data.test_images)")
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--checkpoint", default=None,
                   help="a Detector.save_weights directory")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--out", default="detections.json")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       Detector)
    from custom_yolo_tpu_torch.runtime import NativeDecoder, native_available
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    cfg = Config.from_yaml(args.config)
    if args.images is None:
        args.images = cfg.data.test_images  # the reference's test split dir
    det = Detector(cfg.model.width, cfg.model.depth, cfg.model.csp,
                   num_classes=cfg.model.num_classes,
                   precision=cfg.training.sharding.precision,
                   input_size=tuple(cfg.model.input_size),
                   device=args.device)
    if args.checkpoint:
        det.load_weights(args.checkpoint)
    else:
        det.init(seed=cfg.project.seed)
    det.fuse()

    paths = sorted(glob.glob(os.path.join(args.images, "*.jpg")))
    if not paths:
        sys.exit(f"no JPEGs under {args.images}")
    h, w = det.input_size

    if native_available():
        decoder = NativeDecoder(8)
        decode = lambda batch: decoder.decode_batch(batch, h, w)[:2]
        backend = "native"
    else:
        from PIL import Image

        def decode(batch):
            imgs, sizes = [], []
            for path in batch:
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    sizes.append(im.size)
                    imgs.append(np.asarray(
                        im.resize((w, h), Image.Resampling.BILINEAR)))
            return np.stack(imgs), np.asarray(sizes, np.int32)
        backend = "pil"

    results = {}
    t0 = time.time()
    for i in range(0, len(paths), args.batch_size):
        batch_paths = paths[i:i + args.batch_size]
        images, sizes = decode(batch_paths)
        n = len(batch_paths)
        if n < args.batch_size:  # keep one batch shape
            rep = images[np.arange(args.batch_size - n) % n]
            images = np.concatenate([images, rep])
        x = (images.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        r = det.serve(torch.from_numpy(x), conf_thres=args.conf)
        boxes = r.boxes.cpu().numpy()
        scores = r.scores.cpu().numpy()
        classes = r.classes.cpu().numpy()
        valid = r.valid.cpu().numpy()
        for j, path in enumerate(batch_paths):
            sx = sizes[j, 0] / w
            sy = sizes[j, 1] / h
            v = valid[j]
            dets = [{
                "bbox_xyxy": [float(x1 * sx), float(y1 * sy),
                              float(x2 * sx), float(y2 * sy)],
                "score": float(s), "class_id": int(c),
            } for (x1, y1, x2, y2), s, c in
                zip(boxes[j][v], scores[j][v], classes[j][v])]
            results[os.path.basename(path)] = dets
    dt = time.time() - t0

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_det = sum(len(v) for v in results.values())
    print(f"{len(paths)} images in {dt:.2f}s "
          f"({len(paths) / dt:.1f} img/s, {backend} decode), "
          f"{n_det} detections → {args.out}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}",
          flush=True)
    return results


if __name__ == "__main__":
    main()
