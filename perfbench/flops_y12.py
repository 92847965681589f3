"""YOLO12's FLOPs an image served, counted by ``FlopCounterMode`` on the
plain reference (``reference/yolo12.py``) on the meta device, every
BatchNorm folded, the depthwise convs counted as convolutions: the same
count whatever implements the model."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.yolo12 import Reference, fold, state_layout


@functools.lru_cache(maxsize=None)
def _count(config_json: str) -> float:
    cfg = json.loads(config_json)
    layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                          cfg["num_classes"], cfg["reg_max"])
    state = {k: torch.empty(s, device="meta",
                            dtype=torch.long if k.endswith("tracked")
                            else torch.float32)
             for k, s in layout.items()}
    h, w = cfg["input_size"]
    ref = Reference(cfg["width"], cfg["depth"], cfg["csp"],
                    cfg["num_classes"], cfg["reg_max"])
    ref.taps = False
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref(fold(state), torch.empty(1, h, w, cfg["width"][0], device="meta"))
    return float(counter.get_total_flops())


def per_image(config: dict) -> float:
    return _count(json.dumps(config, sort_keys=True))

