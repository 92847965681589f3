"""Model summary (counterpart of ``custom_yolo_tpu/utils/summary.py``):
parameter counts per module group and totals, over a model's state-dict
names."""

from __future__ import annotations

from typing import Dict

from torch import nn


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def summarize(model: nn.Module, depth: int = 2) -> str:
    """Human-readable summary grouped to ``depth`` module levels."""
    grouped: Dict[str, int] = {}
    for name, param in model.named_parameters():
        key = ".".join(name.split(".")[:depth])
        grouped[key] = grouped.get(key, 0) + param.numel()
    total = sum(grouped.values())
    stats_total = sum(b.numel() for name, b in model.named_buffers()
                      if name.endswith(("running_mean", "running_var")))
    lines = [f"{'module':<48s} {'params':>14s}", "-" * 63]
    for key in sorted(grouped):
        lines.append(f"{key:<48s} {grouped[key]:>14,d}")
    lines.append("-" * 63)
    lines.append(f"{'total trainable':<48s} {total:>14,d}")
    if stats_total:
        lines.append(f"{'batch statistics':<48s} {stats_total:>14,d}")
    return "\n".join(lines)
