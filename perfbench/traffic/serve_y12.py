"""Serving traffic for YOLO12 (``Detector(..., arch="yolo12")``): the loop
and the check of ``traffic/serve.py``, unchanged, with its
architecture's names bound to YOLO12's: ``build_detector``,
``state_layout``, ``Reference``, ``settle_statistics`` and
``make_state`` (whose attention logits spread as a trained network's
do). The mix's parameters are ``serve.py``'s.

``run`` and ``check`` are ``serve.py``'s functions run with this module's
names, so ``build_detector`` is read from here at call time, where
``calibrate_y12.py`` plants the int8 control and the faults. A program
without YOLO12 fails at once, at the import of its model."""

from __future__ import annotations

import types
from typing import Any, Dict

import torch

from perfbench import weights
from perfbench.reference.yolo12 import (HEAD_DIM, Reference, decode,  # noqa
                                        fold, state_layout)
from perfbench.traffic import serve

# serve.py's module names, those above and below taking their place
globals().update({k: v for k, v in vars(serve).items()
                  if not k.startswith("__") and k not in globals()})


# the attention's q and k channels: their BatchNorm scale, bn_gain times
# this. At bn_gain alone the logits of a query spread by 0.06 and every
# query takes its strip's mean, which no fault of the keys changes; at 6
# they spread by about 2 and each query picks out its tokens, as a trained
# network's attention does
QK_GAIN = 6.0


def make_state(layout, seed, device, bn_gain):
    """``weights.make_state`` with the q and k channels of each ``qkv``
    BatchNorm scaled by :data:`QK_GAIN`."""
    state = weights.make_state(layout, seed, device, bn_gain)
    for key, value in state.items():
        if key.endswith(".attn.qkv.bn.weight"):
            value.view(-1, 3, HEAD_DIM)[:, :2] *= QK_GAIN
    return state


def build_detector(cfg: Dict[str, Any], state, device):
    from custom_yolo_tpu_torch.models.detector import Detector

    det = Detector(cfg["width"], cfg["depth"], cfg["csp"],
                   cfg["num_classes"], cfg["reg_max"],
                   precision=cfg["precision"],
                   input_size=tuple(cfg["input_size"]), device=device,
                   arch=cfg["arch"])
    det.load_variables(state)
    return det.fuse()


@torch.no_grad()
def settle_statistics(state, config, batches):
    """``weights.settle_statistics`` with YOLO12's reference: each
    BatchNorm's running statistics the mean over ``batches`` of the
    batch's own in an fp32 training forward."""
    ref = Reference(config["width"], config["depth"], config["csp"],
                    config["num_classes"], config["reg_max"], mode="train")
    ref.momentum = 1.0
    sums: Dict[str, torch.Tensor] = {}
    for images in batches:
        mean = torch.tensor([0.485, 0.456, 0.406], device=images.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=images.device)
        ref(state, ((images.float() / 255.0) - mean) / std)
        for k, v in ref.new_stats.items():
            sums[k] = sums[k] + v if k in sums else v.clone()
    return {**state, **{k: v / len(batches) for k, v in sums.items()}}


def _here(fn):
    """``fn`` of serve.py, reading its global names from this module."""
    return types.FunctionType(fn.__code__, globals(), fn.__name__,
                              fn.__defaults__, fn.__closure__)


# serve.check is wrapped in torch.no_grad(): its own code is rebound
check = torch.no_grad()(_here(serve.check.__wrapped__))
_loop = _here(serve.run)


def run(r) -> Dict[str, Any]:
    from custom_yolo_tpu_torch.models import yolo12  # noqa: F401

    return _loop(r)
