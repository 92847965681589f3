"""Data: on-device augmentation (``transforms``), the parquet dataset and
the threaded host loader."""
