"""Plain fp32 reference of YOLO12 at scale x
(``ultralytics/cfg/models/12/yolo12.yaml``, the blocks ``AAttn``,
``ABlock`` and ``A2C2f`` of ``ultralytics/nn/modules/block.py``;
arXiv:2502.12524), written from those sources:

* backbone: 3×3 stride-2 convs (the second with 2 groups, the third with
  4), C3K2 at p2 and p3 (hidden width a quarter of the output, C3K inner
  blocks at l/x), ``A2C2f`` at p4 (4 strips) and p5 (1 strip): a 1×1 conv
  to half the width, n pairs of ``ABlock``, concat, 1×1 conv, and the
  layer-scale residual ``x + γ·y``; no SPPF, no PSA;
* ``ABlock``: ``x + AAttn(x)``, then ``x + mlp(x)`` with a hidden width of
  ``int(1.2·c)``;
* ``AAttn``: 1×1 ``qkv`` to ``3c`` (per head of 32 channels ``[q | k |
  v]``), the row-major token sequence cut into ``area`` contiguous strips
  that attend within themselves, ``out + pe(v)`` with ``pe`` a 7×7
  depthwise conv, then 1×1 ``proj``;
* neck: FPN-PAN with ``A2C2f`` stages without attention (C3K inner
  blocks, no residual) and a C3K2 at p5;
* the head, DFL decode and anchors of ``reference/model.py`` (YOLO11's
  Detect, which YOLO12 shares).

Departures from the yaml: the class count (172, the configuration's
``reduced``); the cls tower's width ``max(80, width[3], num_classes)``
where the yaml has ``max(c3, min(nc, 100))`` (both 384 at x); the state
dict's names, which are the program's (``net.p4_attn.m0.1.attn.qkv``…);
the l/x form only (layer-scale residual, MLP ratio 1.2).

It imports nothing of the program. Its weights are a state dict keyed as
the program's; ``fold``, ``decode`` and the modes ``"eval"`` and
``"train"`` are those of ``reference/model.py``. The attention runs one
strip and one block of heads at a time, so that no score matrix passes
``SCORE_BYTES`` (a p4 call's whole scores at 2176×3840 take 12.8 GB in
fp32). Depthwise convs are written as sums of shifted products, one
elementwise pass a tap: cuDNN runs fp32 depthwise convs on 4K maps as
hundreds of thousands of small launches.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import model
from perfbench.reference.model import decode, fold  # noqa: F401

# the area attention's head width, strips at p4 and p5, MLP ratio
HEAD_DIM = 32
AREA = (4, 1)
MLP_RATIO = 1.2
# the largest fp32 score block the attention forms at once
SCORE_BYTES = 1 << 30


class Reference(model.Reference):
    """YOLO12 as a function of a state dict. ``width``, ``depth`` (p2, p3,
    p4, p5, neck), ``csp``: the configuration's (``configs/y12x4k.json``).
    ``taps`` (on by default) computes depthwise convs as shifted sums;
    off, as ``F.conv2d`` (the FLOP count, on the meta device)."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16,
                 mode: str = "eval", quant=None):
        super().__init__(width, depth, csp, num_classes, reg_max, mode,
                         quant)
        self.taps = True

    # ------------------------------------------------------------ layers
    def conv(self, x, weight, bias=None, stride=1):
        c, k = x.shape[1], weight.shape[-1]
        if not (self.taps and k > 1 and weight.shape[1] == 1
                and weight.shape[0] == c and stride == 1):
            return super().conv(x, weight, bias, stride)
        if self.q is not None:
            x, weight = self.q(x), self.q(weight)
        h, w = x.shape[2:]
        xp = F.pad(x, (k // 2,) * 4)
        y = torch.zeros_like(x) if bias is None else \
            bias[None, :, None, None].expand_as(x).clone()
        for i in range(k):
            for j in range(k):
                y.addcmul_(xp[:, :, i:i + h, j:j + w],
                           weight[None, :, 0, i, j, None, None])
        return y

    def attend(self, t: torch.Tensor) -> torch.Tensor:
        """Token-major ``(b, T, heads, 3·HEAD_DIM)`` → the attention's
        output ``(b, T, heads·HEAD_DIM)``, a block of heads at a time."""
        b, n, nh, _ = t.shape
        block = max(1, min(nh, SCORE_BYTES // (4 * b * n * n)))
        outs = []
        for h0 in range(0, nh, block):
            part = t[:, :, h0:h0 + block]
            q, k, v = part.split(HEAD_DIM, dim=-1)
            if self.q is not None:
                q, k, v = self.q(q), self.q(k), self.q(v)
            attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                                 * HEAD_DIM ** -0.5, dim=-1)
            if self.q is not None:
                attn = self.q(attn)
            outs.append(torch.einsum("bhqk,bkhd->bqhd", attn, v))
        return torch.cat(outs, dim=2).reshape(b, n, nh * HEAD_DIM)

    def area_attention(self, name, x, area):
        b, c, h, w = x.shape
        n = h * w
        if n % area:
            raise ValueError(f"a {h}×{w} map does not split into {area} "
                             "strips")
        nh = c // HEAD_DIM
        qkv = self.conv_bn(f"{name}.qkv", x, act=False)
        t = qkv.flatten(2).transpose(1, 2).reshape(b, area, n // area, nh,
                                                   3 * HEAD_DIM)
        out = torch.cat([self.attend(t[:, s]) for s in range(area)], dim=1)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        v = t[..., 2 * HEAD_DIM:].reshape(b, n, c).transpose(1, 2).reshape(
            b, c, h, w)
        pe = self.conv_bn(f"{name}.pe", v, act=False)
        return self.conv_bn(f"{name}.proj", out + pe, act=False)

    def ablock(self, name, x, area):
        x = x + self.area_attention(f"{name}.attn", x, area)
        return x + self.conv_bn(f"{name}.ffn2",
                                self.conv_bn(f"{name}.ffn1", x), act=False)

    def a2c2f(self, name, x, n, area=None):
        """``area`` None: the neck's form, C3K inner blocks and no
        residual."""
        parts = [self.conv_bn(f"{name}.conv1", x)]
        for i in range(n):
            y = parts[-1]
            if area is None:
                y = self.c3k(f"{name}.m{i}", y)
            else:
                for j in range(2):
                    y = self.ablock(f"{name}.m{i}.{j}", y, area)
            parts.append(y)
        y = self.conv_bn(f"{name}.conv2", torch.cat(parts, 1))
        if area is None:
            return y
        return x + self.p[f"{name}.gamma"][None, :, None, None] * y

    # ------------------------------------------------------------- model
    def forward(self, params: Dict[str, torch.Tensor], images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NHWC fp32 images → (preds (N, M, 4·reg_max + nc), anchors (M, 2),
        strides (M, 1)). ``params``: folded (``eval``) or unfused
        (``train``) weights."""
        self.p, self.new_stats = params, {}
        d, c = self.d, self.c
        x = images.permute(0, 3, 1, 2)
        x = self.conv_bn("net.p1_conv", x, 2)
        x = self.conv_bn("net.p2_conv", x, 2)
        x = self.c3k2("net.p2_csp", x, d[0], c[0])
        x = self.conv_bn("net.p3_conv", x, 2)
        p3 = self.c3k2("net.p3_csp", x, d[1], c[0])
        x = self.conv_bn("net.p4_conv", p3, 2)
        p4 = self.a2c2f("net.p4_attn", x, d[2], AREA[0])
        x = self.conv_bn("net.p5_conv", p4, 2)
        p5 = self.a2c2f("net.p5_attn", x, d[3], AREA[1])

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        p4 = self.a2c2f("fpn.h1", torch.cat([up(p5), p4], 1), d[4])
        p3 = self.a2c2f("fpn.h2", torch.cat([up(p4), p3], 1), d[4])
        p4 = self.a2c2f("fpn.h4", torch.cat([self.conv_bn("fpn.h3", p3, 2),
                                             p4], 1), d[4])
        p5 = self.c3k2("fpn.h6", torch.cat([self.conv_bn("fpn.h5", p4, 2),
                                            p5], 1), d[4], c[1])
        return self.head((p3, p4, p5))

    __call__ = forward

    def head(self, feats):
        outs = []
        for i, f in enumerate(feats):
            b = self.conv_bn(f"head.box{i}_conv1", f)
            b = self.plain_conv(f"head.box{i}_out",
                                self.conv_bn(f"head.box{i}_conv2", b))
            y = f
            for part in ("dw1", "pw1", "dw2", "pw2"):
                y = self.conv_bn(f"head.cls{i}_{part}", y)
            y = self.plain_conv(f"head.cls{i}_out", y)
            outs.append(torch.cat([b, y], 1).flatten(2).transpose(1, 2))
        preds = torch.cat(outs, 1)
        anchors, strides = model.make_anchors(
            [(t.shape[2], t.shape[3]) for t in feats], device=preds.device)
        return preds, anchors, strides


def state_layout(width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every key of the unfused state dict with its shape, from the
    architecture's channel arithmetic, in a fixed order."""
    w, d, c = list(width), list(depth), list(csp)
    out: Dict[str, Tuple[int, ...]] = {}

    def convbn(name, cin, cout, k=1, groups=1):
        out[f"{name}.conv.weight"] = (cout, cin // groups, k, k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{leaf}"] = (cout,)
        out[f"{name}.bn.num_batches_tracked"] = ()

    def residual(name, ch):
        convbn(f"{name}.conv1", ch, ch, 3)
        convbn(f"{name}.conv2", ch, ch, 3)

    def c3k(name, cin, cout):
        half = cout // 2
        convbn(f"{name}.conv1", cin, half)
        convbn(f"{name}.conv2", cin, half)
        residual(f"{name}.res0", half)
        residual(f"{name}.res1", half)
        convbn(f"{name}.conv3", 2 * half, cout)

    def c3k2(name, cin, cout, n, is_csp, r):
        hidden = cout // r
        convbn(f"{name}.conv1", cin, 2 * hidden)
        for i in range(n):
            if is_csp:
                c3k(f"{name}.m{i}", hidden, hidden)
            else:
                convbn(f"{name}.m{i}.conv1", hidden, hidden // 2, 3)
                convbn(f"{name}.m{i}.conv2", hidden // 2, hidden, 3)
        convbn(f"{name}.conv2", (2 + n) * hidden, cout)

    def a2c2f(name, cin, cout, n, attention):
        hidden = cout // 2
        convbn(f"{name}.conv1", cin, hidden)
        for i in range(n):
            if not attention:
                c3k(f"{name}.m{i}", hidden, hidden)
                continue
            for j in range(2):
                blk = f"{name}.m{i}.{j}"
                convbn(f"{blk}.attn.qkv", hidden, 3 * hidden)
                convbn(f"{blk}.attn.pe", hidden, hidden, 7, groups=hidden)
                convbn(f"{blk}.attn.proj", hidden, hidden)
                convbn(f"{blk}.ffn1", hidden, int(hidden * MLP_RATIO))
                convbn(f"{blk}.ffn2", int(hidden * MLP_RATIO), hidden)
        convbn(f"{name}.conv2", (1 + n) * hidden, cout)
        if attention:
            out[f"{name}.gamma"] = (cout,)

    convbn("net.p1_conv", w[0], w[1], 3)
    convbn("net.p2_conv", w[1], w[2], 3, groups=2)
    c3k2("net.p2_csp", w[2], w[3], d[0], c[0], 4)
    convbn("net.p3_conv", w[3], w[3], 3, groups=4)
    c3k2("net.p3_csp", w[3], w[4], d[1], c[0], 4)
    convbn("net.p4_conv", w[4], w[4], 3)
    a2c2f("net.p4_attn", w[4], w[4], d[2], True)
    convbn("net.p5_conv", w[4], w[5], 3)
    a2c2f("net.p5_attn", w[5], w[5], d[3], True)
    a2c2f("fpn.h1", w[5] + w[4], w[4], d[4], False)
    a2c2f("fpn.h2", w[4] + w[4], w[3], d[4], False)
    convbn("fpn.h3", w[3], w[3], 3)
    a2c2f("fpn.h4", w[3] + w[4], w[4], d[4], False)
    convbn("fpn.h5", w[4], w[4], 3)
    c3k2("fpn.h6", w[4] + w[5], w[5], d[4], c[1], 2)
    box_ch = max(64, w[3] // 4)
    cls_ch = max(80, w[3], num_classes)
    for i, cin in enumerate((w[3], w[4], w[5])):
        convbn(f"head.box{i}_conv1", cin, box_ch, 3)
        convbn(f"head.box{i}_conv2", box_ch, box_ch, 3)
        out[f"head.box{i}_out.weight"] = (4 * reg_max, box_ch, 1, 1)
        out[f"head.box{i}_out.bias"] = (4 * reg_max,)
        convbn(f"head.cls{i}_dw1", cin, cin, 3, groups=cin)
        convbn(f"head.cls{i}_pw1", cin, cls_ch)
        convbn(f"head.cls{i}_dw2", cls_ch, cls_ch, 3, groups=cls_ch)
        convbn(f"head.cls{i}_pw2", cls_ch, cls_ch)
        out[f"head.cls{i}_out.weight"] = (num_classes, cls_ch, 1, 1)
        out[f"head.cls{i}_out.bias"] = (num_classes,)
    return out
