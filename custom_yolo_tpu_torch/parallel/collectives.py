"""Host-level collectives (counterpart of
``custom_yolo_tpu/parallel/collectives.py``: ``reduce_value`` :22-34,
``reduce_metrics`` :37-46).

For values that live outside the train step: per-process detection-metric
counters and the validation loss means. Each is summed (or averaged) over
every process in float64 by one ``all_reduce``; in a single process
nothing is done.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from custom_yolo_tpu_torch.core.mesh import world_size


def _device() -> torch.device:
    """Where the default group's collectives take their tensors: this
    rank's card under NCCL, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_value(value, average: bool = True):
    """All-reduce a Python/numpy scalar or array over every process, in
    float64: the mean with ``average``, else the sum. The value itself in
    a single process."""
    if world_size() == 1:
        return value
    arr = np.asarray(value, np.float64)
    t = torch.from_numpy(arr.copy()).to(_device())
    dist.all_reduce(t)
    total = t.cpu().numpy()
    return total / world_size() if average else total


def reduce_metrics(metrics: Dict[str, float], average: bool = True
                   ) -> Dict[str, float]:
    """Reduce a whole metrics dict over every process in one
    ``all_reduce``, by sorted key (the same order on every rank)."""
    if world_size() == 1:
        return metrics
    keys = sorted(metrics)
    stacked = np.asarray([float(metrics[k]) for k in keys], np.float64)
    reduced = reduce_value(stacked, average=average)
    return {k: float(v) for k, v in zip(keys, np.asarray(reduced))}
