"""The model's FLOPs an image, counted by ``FlopCounterMode`` on the plain
reference on the meta device (no arithmetic is done): the same count
whatever implements the model. Serving: the forward with every
BatchNorm folded. Training: forward and backward of the unfused model."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.model import Reference, fold, state_layout


@functools.lru_cache(maxsize=None)
def _count(config_json: str, train: bool) -> float:
    cfg = json.loads(config_json)
    layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                          cfg["num_classes"], cfg["reg_max"])
    state = {k: torch.empty(s, device="meta",
                            dtype=torch.long if k.endswith("tracked")
                            else torch.float32)
             for k, s in layout.items()}
    h, w = cfg["input_size"]
    x = torch.empty(1, h, w, cfg["width"][0], device="meta")
    ref = Reference(cfg["width"], cfg["depth"], cfg["csp"],
                    cfg["num_classes"], cfg["reg_max"],
                    mode="train" if train else "eval")
    counter = FlopCounterMode(display=False)
    if train:
        params = {k: (v.requires_grad_(True) if ".running_" not in k
                      and v.is_floating_point() else v)
                  for k, v in state.items()}
        with counter:
            preds = ref(params, x)[0]
            preds.sum().backward()
    else:
        with torch.no_grad(), counter:
            ref(fold(state), x)
    return float(counter.get_total_flops())


def per_image(config: dict, train: bool) -> float:
    return _count(json.dumps(config, sort_keys=True), train)
