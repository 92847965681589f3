"""Host resource helpers (the port's own copy of
``custom_yolo_tpu/utils/common.py``)."""

from __future__ import annotations

import multiprocessing
import os
from typing import Optional


def get_num_workers(cap: int = 16) -> int:
    """Decode-worker count from the SLURM environment (SLURM_CPUS_PER_TASK,
    SLURM_CPUS_PER_GPU) or the host's CPU count, capped."""
    for var in ("SLURM_CPUS_PER_TASK", "SLURM_CPUS_PER_GPU"):
        val = os.environ.get(var)
        if val:
            try:
                return max(1, min(int(val), cap))
            except ValueError:
                pass
    return max(1, min(multiprocessing.cpu_count(), cap))


def get_num_threads(world_size: int = 1) -> int:
    """Host threads available per process."""
    return max(1, multiprocessing.cpu_count() // max(1, world_size))


def find_latest_checkpoint(folder: str) -> Optional[str]:
    """The most recently modified checkpoint path in a folder (the sidecar
    aside), or None."""
    if not os.path.isdir(folder):
        return None
    entries = [os.path.join(folder, f) for f in os.listdir(folder)
               if not f.startswith(".")]
    entries = [e for e in entries if os.path.basename(e) != "model_config.json"]
    if not entries:
        return None
    return max(entries, key=os.path.getmtime)
