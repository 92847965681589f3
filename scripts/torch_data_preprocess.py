#!/usr/bin/env python
"""COCO JSON → Parquet ETL entry point of the PyTorch port (counterpart of
``scripts/data_preprocess.py``): ``--mode train|val`` processes
``instances_{mode}2017.json`` and ``stuff_{mode}2017.json`` from the
config's ``data.annotations_dir`` into ``data.processed_dir/{mode}``.

Usage:
  python scripts/torch_data_preprocess.py --mode val --config <yaml>
"""

import argparse
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

from custom_yolo_tpu_torch.config import Config  # noqa: E402
from custom_yolo_tpu_torch.data.preprocess import DataPreprocess  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description="COCO → Parquet preprocessing")
    p.add_argument("--mode", required=True, choices=["train", "val"])
    p.add_argument("--config", default="configs/config.yaml")
    args = p.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    file_names = [f"instances_{args.mode}2017.json",
                  f"stuff_{args.mode}2017.json"]
    DataPreprocess.create_parquet_data(
        annotations_dir=cfg.data.annotations_dir,
        output_dir=cfg.data.processed_dir,
        output_folder=args.mode,
        file_names=file_names,
        keys=["images", "annotations", "categories"],
        columns=[["id", "file_name", "height", "width"],
                 ["id", "image_id", "category_id", "bbox", "area",
                  "iscrowd", "segmentation"],
                 ["id", "name", "supercategory"]],
        chunk_sizes=[10_000, 50_000, 1_000],
        is_test=cfg.data.is_test,
    )
    print(f"[INFO] wrote {args.mode} parquet to {cfg.data.processed_dir}")


if __name__ == "__main__":
    main()
