"""Distribution-focal box decode (counterpart of
``custom_yolo_tpu/ops/dfl.py::dfl_decode``)."""

from __future__ import annotations

import torch


def dfl_decode(pred_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., M, 4·reg_max) bin logits → (..., M, 4) expected ltrb: fp32
    softmax over each side's ``reg_max`` bins, then the expectation."""
    dist = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max)
    probs = torch.softmax(dist.float(), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=probs.device)
    return (probs * bins).sum(dim=-1)
