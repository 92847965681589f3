"""YOLO12's backbone and neck (``ultralytics/cfg/models/12/yolo12.yaml``;
arXiv:2502.12524), in its l/x form: grouped stride-2 convs at p2 and p3
(2 and 4 groups), C3K2 at p2/p3, area attention (:class:`nn.blocks.A2C2f`,
a layer-scale residual) at p4 over 4 strips and at p5 over the whole map,
no SPPF and no PSA; an FPN-PAN neck of ``A2C2f`` stages with C3K inner
blocks and a C3K2 at p5. It emits (p3, p4, p5) at strides 8/16/32 with
``width[3]``, ``width[4]`` and ``width[5]`` channels, as the YOLO11
backbone and neck do, so the same :class:`models.head.Head` reads them.

``width`` is that of the YOLO11 presets (six entries); ``depth`` the
repeats of p2, p3, p4, p5 and of the neck's stages (five entries);
``csp`` whether the C3K2 stages of p2/p3 and of the neck's p5 hold C3K
blocks. Stage names are those of ``models/backbone.py`` and
``models/neck.py`` where the stage is the same, so ``quant_skip`` and the
profile's ``fwd/net.<stage>`` and ``fwd/fpn.<stage>`` spans read alike."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from custom_yolo_tpu_torch.models.neck import upsample2x_nearest
from custom_yolo_tpu_torch.nn.blocks import A2C2f, C3K2, ConvBN
from custom_yolo_tpu_torch.utils.profiling import span

# the yaml at scale x (depth 1.00, width 1.50, max channels 512)
SCALES = {"x": {"width": [3, 96, 192, 384, 768, 768],
                "depth": [2, 2, 4, 4, 2], "csp": [True, True]}}
# strips of the area attention at p4 and at p5
AREA = (4, 1)

BACKBONE_STAGES = ("p1_conv", "p2_conv", "p2_csp", "p3_conv", "p3_csp",
                   "p4_conv", "p4_attn", "p5_conv", "p5_attn")
NECK_STAGES = ("h1", "h2", "h3", "h4", "h5", "h6")
STAGE_SPANS = {**{name: f"fwd/net.{name}" for name in BACKBONE_STAGES},
               **{name: f"fwd/fpn.{name}" for name in NECK_STAGES}}


class _Stages(nn.Module):
    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        with span(STAGE_SPANS[name]):
            return getattr(self, name)(x)


class Yolo12Backbone(_Stages):
    """``quantized=True`` runs every stage int8 except those named in
    ``quant_skip``, which stay float; γ stays float in every stage."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], fused: bool = False,
                 quantized: bool = False, quant_skip: Sequence[str] = ()):
        super().__init__()
        w, d, c = width, depth, csp

        def q(name):
            return dict(fused=fused,
                        quantized=quantized and name not in quant_skip)

        def down(c_in, c_out, name, groups=1):
            return ConvBN(c_in, c_out, 3, stride=2, padding=1, groups=groups,
                          **q(name))

        self.p1_conv = down(w[0], w[1], "p1_conv")
        self.p2_conv = down(w[1], w[2], "p2_conv", groups=2)
        self.p2_csp = C3K2(w[2], w[3], d[0], c[0], r=4, **q("p2_csp"))
        self.p3_conv = down(w[3], w[3], "p3_conv", groups=4)
        self.p3_csp = C3K2(w[3], w[4], d[1], c[0], r=4, **q("p3_csp"))
        self.p4_conv = down(w[4], w[4], "p4_conv")
        self.p4_attn = A2C2f(w[4], w[4], d[2], True, AREA[0],
                             **q("p4_attn"))
        self.p5_conv = down(w[4], w[5], "p5_conv")
        self.p5_attn = A2C2f(w[5], w[5], d[3], True, AREA[1],
                             **q("p5_attn"))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self._stage("p2_conv", self._stage("p1_conv", x))
        x = self._stage("p3_conv", self._stage("p2_csp", x))
        p3 = self._stage("p3_csp", x)
        p4 = self._stage("p4_attn", self._stage("p4_conv", p3))
        p5 = self._stage("p5_attn", self._stage("p5_conv", p4))
        return p3, p4, p5


class Yolo12Neck(_Stages):
    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        w, n = width, depth[4]
        kw = dict(fused=fused, quantized=quantized)
        self.h1 = A2C2f(w[5] + w[4], w[4], n, False, **kw)
        # the backbone's p3 and p4 both carry w[4] channels
        self.h2 = A2C2f(w[4] + w[4], w[3], n, False, **kw)
        self.h3 = ConvBN(w[3], w[3], 3, stride=2, padding=1, **kw)
        self.h4 = A2C2f(w[3] + w[4], w[4], n, False, **kw)
        self.h5 = ConvBN(w[4], w[4], 3, stride=2, padding=1, **kw)
        self.h6 = C3K2(w[4] + w[5], w[5], n, csp[1], r=2, **kw)

    def forward(self, feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        p3, p4, p5 = feats
        p4 = self._stage("h1", torch.cat([upsample2x_nearest(p5), p4], dim=1))
        p3 = self._stage("h2", torch.cat([upsample2x_nearest(p4), p3], dim=1))
        p4 = self._stage("h4", torch.cat([self._stage("h3", p3), p4], dim=1))
        p5 = self._stage("h6", torch.cat([self._stage("h5", p4), p5], dim=1))
        return p3, p4, p5
