"""CSP backbone (counterpart of ``custom_yolo_tpu/models/backbone.py``):
five stride-2 stages, C3K2 at p2–p5 (r=4 at p2/p3, r=2 at p4/p5), SPPF
and PSA at p5; emits (p3, p4, p5) at strides 8/16/32."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from custom_yolo_tpu_torch.nn.blocks import PSA, SPPF, C3K2, ConvBN
from custom_yolo_tpu_torch.utils.profiling import span


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCHW (B, C, H, W) → (B, r²·C, H/r, W/r), the phase first: channel
    ``(a·r + b)·C + c`` holds pixel phase (a, b) of each r×r block, as the
    reference orders it (``F.pixel_unshuffle`` puts the phase last)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, r * r * c, h // r, w // r)


def stem_kernel_to_s2d(kernel: np.ndarray) -> np.ndarray:
    """A 3×3 stride-2 stem kernel, HWIO ``(3, 3, cin, cout)``, as the
    equivalent 2×2 stride-1 kernel ``(2, 2, 4·cin, cout)`` over
    space-to-depth input padded one pixel at the top and left: output
    y[i, j] = Σ x[2i+di−1, 2j+dj−1]·K[di, dj] = Σ z[i−1+u, j−1+v,
    (2a+b)·cin + ·]·K[2u+a−1, 2v+b−1]; the taps with di or dj = −1 fall on
    the phase the 3×3 window never reaches and stay zero."""
    kernel = np.asarray(kernel, np.float32)
    kh, kw, cin, cout = kernel.shape
    assert (kh, kw) == (3, 3), "the s2d stem transform is for 3x3 s2 stems"
    k2 = np.zeros((2, 2, 4 * cin, cout), np.float32)
    for u in (0, 1):
        for a in (0, 1):
            di = 2 * u + a - 1
            if di < 0:
                continue
            for v in (0, 1):
                for b in (0, 1):
                    dj = 2 * v + b - 1
                    if dj < 0:
                        continue
                    ch = (a * 2 + b) * cin
                    k2[u, v, ch:ch + cin, :] = kernel[di, dj]
    return k2


# the stages, by the names that quant_skip takes
BACKBONE_STAGES = ("p1_conv", "p2_conv", "p2_csp", "p3_conv", "p3_csp",
                   "p4_conv", "p4_csp", "p5_conv", "p5_csp", "p5_sppf",
                   "p5_psa")
# each stage's span in a profile, under the backbone's name in the model
# (``YoloModel.net``)
STAGE_SPANS = {name: f"fwd/net.{name}" for name in BACKBONE_STAGES}


class Backbone(nn.Module):
    """``s2d_stem=True`` replaces the 3×3 stride-2 stem by space-to-depth
    and the equivalent 2×2 stride-1 conv (same output; kernel from
    :func:`stem_kernel_to_s2d`); ``merged=True`` merges the C3K branch
    convs (``nn.blocks.C3K``); ``quantized=True`` runs every stage int8
    except those named in ``quant_skip`` (``p1_conv`` … ``p5_psa``), which
    stay float."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], fused: bool = False,
                 s2d_stem: bool = False, merged: bool = False,
                 quantized: bool = False, quant_skip: Sequence[str] = ()):
        super().__init__()
        w, d, c = width, depth, csp

        def q(name):
            return dict(fused=fused,
                        quantized=quantized and name not in quant_skip)

        def down(c_in, c_out, name):
            return ConvBN(c_in, c_out, 3, stride=2, padding=1, **q(name))

        self.s2d_stem = s2d_stem
        self.p1_conv = (ConvBN(4 * w[0], w[1], 2, **q("p1_conv"))
                        if s2d_stem else down(w[0], w[1], "p1_conv"))
        self.p2_conv = down(w[1], w[2], "p2_conv")
        self.p2_csp = C3K2(w[2], w[3], d[0], c[0], r=4, merged=merged,
                           **q("p2_csp"))
        self.p3_conv = down(w[3], w[3], "p3_conv")
        self.p3_csp = C3K2(w[3], w[4], d[1], c[0], r=4, merged=merged,
                           **q("p3_csp"))
        self.p4_conv = down(w[4], w[4], "p4_conv")
        self.p4_csp = C3K2(w[4], w[4], d[2], c[1], r=2, merged=merged,
                           **q("p4_csp"))
        self.p5_conv = down(w[4], w[5], "p5_conv")
        self.p5_csp = C3K2(w[5], w[5], d[3], c[1], r=2, merged=merged,
                           **q("p5_csp"))
        self.p5_sppf = SPPF(w[5], w[5], **q("p5_sppf"))
        self.p5_psa = PSA(w[5], d[4], **q("p5_psa"))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.s2d_stem:
            # the reference pads ((1, 0), (1, 0)): one row on top, one
            # column on the left
            x = F.pad(space_to_depth(x, 2), (1, 0, 1, 0))
        p2 = self._stage("p2_csp", self._stage(
            "p2_conv", self._stage("p1_conv", x)))
        p3 = self._stage("p3_csp", self._stage("p3_conv", p2))
        p4 = self._stage("p4_csp", self._stage("p4_conv", p3))
        p5 = self._stage("p5_csp", self._stage("p5_conv", p4))
        return p3, p4, self._stage("p5_psa", self._stage("p5_sppf", p5))

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        with span(STAGE_SPANS[name]):
            return getattr(self, name)(x)
