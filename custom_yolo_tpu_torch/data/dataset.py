"""Parquet-backed detection dataset (the port's own copy of
``custom_yolo_tpu/data/dataset.py``).

Each sample is a uint8 image decoded and resized to the model's input on
the host (squash, or letterbox with 114-grey padding) and fixed-shape
padded targets: centre-xywh boxes in model-input pixels (converted from
COCO's top-left xywh), labels and a validity mask, with the geometry that
maps model coordinates back to the original image. Photometric
augmentation and normalisation run on the device
(:mod:`custom_yolo_tpu_torch.data.transforms`). ``percent`` subsampling is
seeded. ``pandas`` (parquet) and ``PIL`` (decode) are imported only where
they are used.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np


class DetectionDataset:
    def __init__(self, parquet_path: str, image_dir: str,
                 input_size: Tuple[int, int] = (640, 640),
                 is_test: bool = False, percent: float = 1.0,
                 max_gt: int = 128, seed: int = 42,
                 letterbox: bool = False):
        import pandas as pd

        if os.path.isdir(parquet_path):
            files = sorted(glob.glob(os.path.join(parquet_path, "*.parquet")))
            self.df = pd.concat([pd.read_parquet(f) for f in files],
                                ignore_index=True)
        else:
            self.df = pd.read_parquet(parquet_path)
        if percent < 1.0:
            self.df = self.df.sample(frac=percent, random_state=seed)
        if is_test:
            self.df = self.df.head(20)  # the reference's fixture size
        self.df = self.df.reset_index(drop=True)
        self.image_dir = image_dir
        self.input_size = tuple(input_size)
        self.max_gt = max_gt
        # aspect-preserving resize + 114-grey padding instead of a squash
        # resize; boxes map as model = orig * scale + offset
        self.letterbox = letterbox

    def _geometry(self, orig_w: int, orig_h: int):
        """Per-image mapping model = orig * (sx, sy) + (dx, dy)."""
        th, tw = self.input_size
        if self.letterbox:
            s = min(th / max(orig_h, 1), tw / max(orig_w, 1))
            nw, nh = int(round(orig_w * s)), int(round(orig_h * s))
            dx, dy = (tw - nw) // 2, (th - nh) // 2
            return (s, s), (float(dx), float(dy)), (nw, nh)
        sx = tw / max(orig_w, 1)
        sy = th / max(orig_h, 1)
        return (sx, sy), (0.0, 0.0), (tw, th)

    def _pack_targets(self, row, scale, offset):
        (sx, sy), (dx, dy) = scale, offset
        bboxes = np.asarray([list(b) for b in row["bbox"]],
                            dtype=np.float32).reshape(-1, 4)
        labels = np.asarray(list(row["category_id"]), dtype=np.int32)
        # COCO top-left XYWH → center-xywh in model-input pixels
        cx = (bboxes[:, 0] + bboxes[:, 2] / 2) * sx + dx
        cy = (bboxes[:, 1] + bboxes[:, 3] / 2) * sy + dy
        w = bboxes[:, 2] * sx
        h = bboxes[:, 3] * sy
        boxes = np.stack([cx, cy, w, h], axis=1)
        k = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_mask = np.zeros((self.max_gt,), bool)
        gt_boxes[:k] = boxes[:k]
        gt_labels[:k] = labels[:k]
        gt_mask[:k] = True
        return gt_boxes, gt_labels, gt_mask, k

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        row = self.df.iloc[idx]
        path = os.path.join(self.image_dir, row["file_name"])
        with Image.open(path) as img:
            img = img.convert("RGB")
            orig_w, orig_h = img.size
            scale, offset, (nw, nh) = self._geometry(orig_w, orig_h)
            img = img.resize((nw, nh), Image.Resampling.BILINEAR)
            if self.letterbox:
                th, tw = self.input_size
                image = np.full((th, tw, 3), 114, np.uint8)
                dx, dy = int(offset[0]), int(offset[1])
                image[dy:dy + nh, dx:dx + nw] = np.asarray(img, np.uint8)
            else:
                image = np.asarray(img, dtype=np.uint8)

        gt_boxes, gt_labels, gt_mask, k = self._pack_targets(
            row, scale, offset)

        return {
            "image": image,                      # (H, W, 3) uint8
            "gt_boxes": gt_boxes,                # (max_gt, 4) center-xywh px
            "gt_labels": gt_labels,              # (max_gt,)
            "gt_mask": gt_mask,                  # (max_gt,)
            "image_id": np.int64(row["id"]),
            "num_gt": np.int32(k),
            # inverse geometry for original-coordinate eval:
            # orig = (model - offset) / scale
            "scale": np.asarray(scale, np.float32),    # (2,) sx, sy
            "offset": np.asarray(offset, np.float32),  # (2,) dx, dy
            "orig_size": np.asarray([orig_w, orig_h], np.int32),
        }

    @property
    def image_ids(self) -> np.ndarray:
        return self.df["id"].to_numpy()

    def image_path(self, idx: int) -> str:
        return os.path.join(self.image_dir, self.df.iloc[idx]["file_name"])

    def annotations(self, idx: int, orig_w: int, orig_h: int
                    ) -> Dict[str, np.ndarray]:
        """Ground truth only (the image decoded elsewhere, by the native
        decoder): boxes padded and converted exactly as ``__getitem__``
        does."""
        row = self.df.iloc[idx]
        scale, offset, _ = self._geometry(orig_w, orig_h)
        gt_boxes, gt_labels, gt_mask, k = self._pack_targets(
            row, scale, offset)
        return {"gt_boxes": gt_boxes, "gt_labels": gt_labels,
                "gt_mask": gt_mask, "image_id": np.int64(row["id"]),
                "num_gt": np.int32(k),
                "scale": np.asarray(scale, np.float32),
                "offset": np.asarray(offset, np.float32),
                "orig_size": np.asarray([orig_w, orig_h], np.int32)}
