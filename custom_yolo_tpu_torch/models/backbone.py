"""CSP backbone (counterpart of ``custom_yolo_tpu/models/backbone.py``):
five stride-2 stages, C3K2 at p2–p5 (r=4 at p2/p3, r=2 at p4/p5), SPPF
and PSA at p5; emits (p3, p4, p5) at strides 8/16/32."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from custom_yolo_tpu_torch.nn.blocks import PSA, SPPF, C3K2, ConvBN


class Backbone(nn.Module):
    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], fused: bool = False):
        super().__init__()
        w, d, c = width, depth, csp

        def down(c_in, c_out):
            return ConvBN(c_in, c_out, 3, stride=2, padding=1, fused=fused)

        self.p1_conv = down(w[0], w[1])
        self.p2_conv = down(w[1], w[2])
        self.p2_csp = C3K2(w[2], w[3], d[0], c[0], r=4, fused=fused)
        self.p3_conv = down(w[3], w[3])
        self.p3_csp = C3K2(w[3], w[4], d[1], c[0], r=4, fused=fused)
        self.p4_conv = down(w[4], w[4])
        self.p4_csp = C3K2(w[4], w[4], d[2], c[1], r=2, fused=fused)
        self.p5_conv = down(w[4], w[5])
        self.p5_csp = C3K2(w[5], w[5], d[3], c[1], r=2, fused=fused)
        self.p5_sppf = SPPF(w[5], w[5], fused=fused)
        self.p5_psa = PSA(w[5], d[4], fused=fused)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        p2 = self.p2_csp(self.p2_conv(self.p1_conv(x)))
        p3 = self.p3_csp(self.p3_conv(p2))
        p4 = self.p4_csp(self.p4_conv(p3))
        p5 = self.p5_csp(self.p5_conv(p4))
        return p3, p4, self.p5_psa(self.p5_sppf(p5))
