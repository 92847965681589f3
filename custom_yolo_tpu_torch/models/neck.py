"""FPN-PAN neck (counterpart of ``custom_yolo_tpu/models/neck.py``):
top-down path with 2× nearest upsampling (h1, h2), bottom-up path with
stride-2 convs and fusion (h3–h6)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from custom_yolo_tpu_torch.nn.blocks import C3K2, ConvBN
from custom_yolo_tpu_torch.utils.profiling import span

# each stage's span in a profile, under the neck's name in the model
# (``YoloModel.fpn``)
STAGE_SPANS = {name: f"fwd/fpn.{name}" for name in
               ("h1", "h2", "h3", "h4", "h5", "h6")}


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsampling of an NCHW tensor (keeps its memory
    format)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Neck(nn.Module):
    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], fused: bool = False,
                 merged: bool = False, quantized: bool = False):
        super().__init__()
        w, d, c = width, depth, csp
        kw = dict(fused=fused, quantized=quantized)
        ckw = dict(kw, merged=merged)
        self.h1 = C3K2(w[5] + w[4], w[4], d[5], c[0], r=2, **ckw)
        # the backbone's p3 and p4 both carry w[4] channels
        self.h2 = C3K2(w[4] + w[4], w[3], d[5], c[0], r=2, **ckw)
        self.h3 = ConvBN(w[3], w[3], 3, stride=2, padding=1, **kw)
        self.h4 = C3K2(w[3] + w[4], w[4], d[5], c[0], r=2, **ckw)
        self.h5 = ConvBN(w[4], w[4], 3, stride=2, padding=1, **kw)
        self.h6 = C3K2(w[4] + w[5], w[5], d[5], c[1], r=2, **ckw)

    def forward(self, feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        p3, p4, p5 = feats
        p4 = self._stage("h1", torch.cat([upsample2x_nearest(p5), p4], dim=1))
        p3 = self._stage("h2", torch.cat([upsample2x_nearest(p4), p3], dim=1))
        p4 = self._stage("h4", torch.cat([self._stage("h3", p3), p4], dim=1))
        p5 = self._stage("h6", torch.cat([self._stage("h5", p4), p5], dim=1))
        return p3, p4, p5

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        with span(STAGE_SPANS[name]):
            return getattr(self, name)(x)
