#!/usr/bin/env python
"""Generate a synthetic tiny-COCO fixture (images + annotation JSON) and run
the PyTorch port's ETL over it (counterpart of ``scripts/make_fixture.py``).

The same flags, the same seeded draws and the same JPEG settings as the
JAX package's script, so at the same arguments both write the same image
files and the same annotation JSON; the Parquet comes from
``custom_yolo_tpu_torch.data.preprocess`` and needs no JAX.

Usage:
  python scripts/torch_make_fixture.py --root dataset_gen2 --images 256 \
      --size 640 --seed 2
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="./dataset", help="dataset root dir")
    p.add_argument("--images", type=int, default=24)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--size", type=int, default=160,
                   help="max image side length")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from PIL import Image

    from custom_yolo_tpu_torch.data.preprocess import DataPreprocess

    rng = np.random.RandomState(args.seed)
    ann_dir = os.path.join(args.root, "raw", "annotations")
    os.makedirs(ann_dir, exist_ok=True)

    class_names = [f"class_{chr(ord('a') + i)}" for i in range(args.classes)]
    categories = [{"id": 100 + i, "name": name, "supercategory": "synthetic"}
                  for i, name in enumerate(class_names)]

    # deterministic class→color map: the task is LEARNABLE across splits
    # (a model that generalizes gets val mAP > 0, not just memorization)
    import colorsys
    class_colors = [
        tuple(int(c * 255) for c in colorsys.hsv_to_rgb(
            i / max(args.classes, 1), 0.9, 0.9))
        for i in range(args.classes)]

    for split in ("train", "val"):
        img_dir = os.path.join(args.root, "raw", "images", split)
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        n = args.images if split == "train" else max(4, args.images // 3)
        for i in range(n):
            w = int(rng.randint(args.size // 2, args.size))
            h = int(rng.randint(args.size // 2, args.size))
            name = f"{split}_{i:05d}.jpg"
            # blocks of color so boxes correspond to real structure
            img = np.full((h, w, 3), 30, np.uint8)
            anns = []
            for _ in range(int(rng.randint(1, 5))):
                bw = int(rng.randint(10, max(11, w // 2)))
                bh = int(rng.randint(10, max(11, h // 2)))
                x = int(rng.randint(0, max(1, w - bw)))
                y = int(rng.randint(0, max(1, h - bh)))
                cid = int(rng.randint(0, args.classes))
                jitter = rng.randint(-15, 16, 3)
                color = np.clip(np.asarray(class_colors[cid]) + jitter,
                                0, 255).astype(np.uint8)
                img[y:y + bh, x:x + bw] = color
                anns.append({
                    "id": len(annotations) + len(anns) + 1,
                    "image_id": i + 1, "category_id": 100 + cid,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0,
                    "segmentation": [[float(x), float(y),
                                      float(x + bw), float(y),
                                      float(x + bw), float(y + bh)]],
                })
            Image.fromarray(img).save(os.path.join(img_dir, name),
                                      quality=92)
            images.append({"id": i + 1, "file_name": name,
                           "height": h, "width": w})
            annotations.extend(anns)
        with open(os.path.join(ann_dir,
                               f"instances_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)
        # empty stuff file so the default two-file CLI invocation works
        with open(os.path.join(ann_dir, f"stuff_{split}2017.json"),
                  "w") as f:
            json.dump({"images": [], "annotations": [],
                       "categories": []}, f)

        out_dir = os.path.join(args.root, "processed", "parquet")
        DataPreprocess.create_parquet_data(
            annotations_dir=ann_dir, output_dir=out_dir,
            output_folder=split,
            file_names=[f"instances_{split}2017.json"],
            keys=["images", "annotations", "categories"],
            columns=[["id", "file_name", "height", "width"],
                     ["id", "image_id", "category_id", "bbox", "area",
                      "iscrowd", "segmentation"],
                     ["id", "name", "supercategory"]],
            chunk_sizes=[10_000, 50_000, 1_000], is_test=False)
        print(f"[INFO] {split}: {len(images)} images, "
              f"{len(annotations)} annotations")
    print(f"[INFO] fixture ready under {args.root}")


if __name__ == "__main__":
    main()
