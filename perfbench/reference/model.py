"""Plain fp32 reference of the detector, written from the architecture
(``custom_yolo_tpu_torch/models`` and ``nn/blocks.py`` describe the same
network): CSP backbone with SPPF and PSA attention, FPN-PAN neck, the
decoupled head with DFL box bins, anchors and the DFL decode.

It imports nothing of the program. Its weights are a state dict keyed as
the program's (``net.p1_conv.conv.weight``, ``….bn.running_var``, …), the
benchmark's own seeded tensors. Two modes:

* ``"eval"``: every conv+BatchNorm folded here, in fp32, from the running
  statistics (the serving path's arithmetic, worked out again);
* ``"train"``: BatchNorm on the batch's statistics (biased variance), the
  new running statistics written into ``new_stats``.

``quant`` (a function on a tensor) rounds each conv's input and weight
before the product, with the gradient passed straight through: the
control's lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
STRIDES = (8, 16, 32)


def fold(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Unfused state → conv weights and biases with each BatchNorm folded
    in fp32: ``w·γ/√(var+eps)`` and ``β − mean·γ/√(var+eps)``."""
    out = {}
    for key, value in state.items():
        if ".bn." in key:
            continue
        prefix = key[:-len(".conv.weight")]
        if key.endswith(".conv.weight") and f"{prefix}.bn.weight" in state:
            gamma = state[f"{prefix}.bn.weight"].float()
            scale = gamma / torch.sqrt(
                state[f"{prefix}.bn.running_var"].float() + BN_EPS)
            out[key] = value.float() * scale[:, None, None, None]
            out[f"{prefix}.conv.bias"] = (
                state[f"{prefix}.bn.bias"].float()
                - state[f"{prefix}.bn.running_mean"].float() * scale)
        else:
            out[key] = value.float()
    return out


def straight_through(quant: Callable[[torch.Tensor], torch.Tensor]
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``quant`` in the forward, the identity in the backward."""
    def rounded(x: torch.Tensor) -> torch.Tensor:
        return x + (quant(x.detach()) - x.detach())
    return rounded


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    absolute maximum onto 448), and back to fp32."""
    amax = x.abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def make_anchors(shapes: Sequence[Tuple[int, int]],
                 strides: Sequence[int] = STRIDES,
                 device: torch.device | str = "cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell centres (M, 2), x fastest, level after level, and each
    anchor's stride (M, 1)."""
    pts, st = [], []
    for (h, w), s in zip(shapes, strides):
        gy, gx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                             indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2))
        st.append(np.full((h * w, 1), float(s)))
    return (torch.tensor(np.concatenate(pts), dtype=torch.float32,
                         device=device),
            torch.tensor(np.concatenate(st), dtype=torch.float32,
                         device=device))


class Reference:
    """The network as a function of a state dict.

    ``width``, ``depth``, ``csp``: the preset (``configs/*.json``)."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16,
                 mode: str = "eval",
                 quant: Optional[Callable[[torch.Tensor],
                                          torch.Tensor]] = None):
        if mode not in ("eval", "train"):
            raise ValueError(f"mode {mode!r}")
        self.w, self.d, self.c = list(width), list(depth), list(csp)
        self.nc, self.rm = num_classes, reg_max
        self.mode = mode
        # the running statistics' update weight; 1 takes the batch's own
        self.momentum = BN_MOMENTUM
        self.q = straight_through(quant) if quant is not None else None
        self.p: Dict[str, torch.Tensor] = {}
        self.new_stats: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------ layers
    def conv(self, x, weight, bias=None, stride=1):
        k = weight.shape[-1]
        groups = x.shape[1] // weight.shape[1]
        if self.q is not None:
            x, weight = self.q(x), self.q(weight)
        return F.conv2d(x, weight, bias, stride, k // 2, 1, groups)

    def conv_bn(self, name, x, stride=1, act=True):
        p = self.p
        if self.mode == "eval":
            y = self.conv(x, p[f"{name}.conv.weight"],
                          p[f"{name}.conv.bias"], stride)
        else:
            y = self.conv(x, p[f"{name}.conv.weight"], None, stride)
            var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                for stat, new in (("running_mean", mean), ("running_var",
                                                           var)):
                    key = f"{name}.bn.{stat}"
                    self.new_stats[key] = torch.lerp(p[key], new.detach(),
                                                     self.momentum)
            y = ((y - mean[None, :, None, None])
                 * torch.rsqrt(var + BN_EPS)[None, :, None, None]
                 * p[f"{name}.bn.weight"][None, :, None, None]
                 + p[f"{name}.bn.bias"][None, :, None, None])
        return F.silu(y) if act else y

    def residual(self, name, x):
        return x + self.conv_bn(f"{name}.conv2",
                                self.conv_bn(f"{name}.conv1", x))

    def c3k(self, name, x):
        y = self.conv_bn(f"{name}.conv1", x)
        z = self.conv_bn(f"{name}.conv2", x)
        y = self.residual(f"{name}.res1", self.residual(f"{name}.res0", y))
        return self.conv_bn(f"{name}.conv3", torch.cat([y, z], 1))

    def c3k2(self, name, x, n, csp):
        parts: List[torch.Tensor] = list(
            self.conv_bn(f"{name}.conv1", x).chunk(2, 1))
        for i in range(n):
            inner = self.c3k if csp else self.residual
            parts.append(inner(f"{name}.m{i}", parts[-1]))
        return self.conv_bn(f"{name}.conv2", torch.cat(parts, 1))

    def sppf(self, name, x):
        x = self.conv_bn(f"{name}.cv1", x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.conv_bn(f"{name}.cv2", torch.cat([x, p1, p2, p3], 1))

    def attention(self, name, x):
        b, c, h, w = x.shape
        nh = max(1, c // 64)
        dh = c // nh
        dk = dh // 2
        qkv = self.conv_bn(f"{name}.qkv", x, act=False)
        t = qkv.flatten(2).transpose(1, 2).reshape(b, h * w, nh,
                                                   2 * dk + dh)
        q, k, v = t[..., :dk], t[..., dk:2 * dk], t[..., 2 * dk:]
        if self.q is not None:
            q, k, v = self.q(q), self.q(k), self.q(v)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                             * dk ** -0.5, dim=-1)
        if self.q is not None:
            attn = self.q(attn)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = out.reshape(b, h * w, c).transpose(1, 2).reshape(b, c, h, w)
        v = v.reshape(b, h * w, c).transpose(1, 2).reshape(b, c, h, w)
        pe = self.conv_bn(f"{name}.pe", v, act=False)
        return self.conv_bn(f"{name}.proj", out + pe, act=False)

    def psa(self, name, x, n):
        a, b = self.conv_bn(f"{name}.conv1", x).chunk(2, 1)
        for i in range(n):
            blk = f"{name}.m{i}"
            b = b + self.attention(f"{blk}.attn", b)
            b = b + self.conv_bn(f"{blk}.ffn2",
                                 self.conv_bn(f"{blk}.ffn1", b), act=False)
        return self.conv_bn(f"{name}.conv2", torch.cat([a, b], 1))

    def plain_conv(self, name, x):
        return self.conv(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

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
        p4 = self.c3k2("net.p4_csp", x, d[2], c[1])
        x = self.conv_bn("net.p5_conv", p4, 2)
        x = self.c3k2("net.p5_csp", x, d[3], c[1])
        p5 = self.psa("net.p5_psa", self.sppf("net.p5_sppf", x), d[4])

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        p4 = self.c3k2("fpn.h1", torch.cat([up(p5), p4], 1), d[5], c[0])
        p3 = self.c3k2("fpn.h2", torch.cat([up(p4), p3], 1), d[5], c[0])
        p4 = self.c3k2("fpn.h4", torch.cat([self.conv_bn("fpn.h3", p3, 2),
                                            p4], 1), d[5], c[0])
        p5 = self.c3k2("fpn.h6", torch.cat([self.conv_bn("fpn.h5", p4, 2),
                                            p5], 1), d[5], c[1])
        outs = []
        for i, f in enumerate((p3, p4, p5)):
            b = self.conv_bn(f"head.box{i}_conv1", f)
            b = self.plain_conv(f"head.box{i}_out",
                                self.conv_bn(f"head.box{i}_conv2", b))
            y = f
            for part in ("dw1", "pw1", "dw2", "pw2"):
                y = self.conv_bn(f"head.cls{i}_{part}", y)
            y = self.plain_conv(f"head.cls{i}_out", y)
            outs.append(torch.cat([b, y], 1).flatten(2).transpose(1, 2))
        preds = torch.cat(outs, 1)
        anchors, strides = make_anchors(
            [(t.shape[2], t.shape[3]) for t in (p3, p4, p5)],
            device=preds.device)
        return preds, anchors, strides

    __call__ = forward


def dfl_decode(pred_dist: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(…, 4·reg_max) bin logits → (…, 4) expected ltrb in grid units."""
    probs = torch.softmax(
        pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max), dim=-1)
    return (probs * torch.arange(reg_max, dtype=probs.dtype,
                                 device=probs.device)).sum(-1)


def decode(preds: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor,
           reg_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head output → (boxes xyxy px (N, M, 4), class logits (N, M, nc))."""
    ltrb = dfl_decode(preds[..., :4 * reg_max], reg_max)
    boxes = torch.cat([anchors[None] - ltrb[..., :2],
                       anchors[None] + ltrb[..., 2:]], -1) * strides[None]
    return boxes, preds[..., 4 * reg_max:]


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

    def residual(name, ch, e):
        mid = int(ch * e)
        convbn(f"{name}.conv1", ch, mid, 3)
        convbn(f"{name}.conv2", mid, ch, 3)

    def c3k(name, cin, cout):
        half = cout // 2
        convbn(f"{name}.conv1", cin, half)
        convbn(f"{name}.conv2", cin, half)
        residual(f"{name}.res0", half, 1.0)
        residual(f"{name}.res1", half, 1.0)
        convbn(f"{name}.conv3", 2 * half, cout)

    def c3k2(name, cin, cout, n, is_csp, r):
        hidden = cout // r
        convbn(f"{name}.conv1", cin, 2 * hidden)
        for i in range(n):
            if is_csp:
                c3k(f"{name}.m{i}", hidden, hidden)
            else:
                residual(f"{name}.m{i}", hidden, 0.5)
        convbn(f"{name}.conv2", (2 + n) * hidden, cout)

    convbn("net.p1_conv", w[0], w[1], 3)
    convbn("net.p2_conv", w[1], w[2], 3)
    c3k2("net.p2_csp", w[2], w[3], d[0], c[0], 4)
    convbn("net.p3_conv", w[3], w[3], 3)
    c3k2("net.p3_csp", w[3], w[4], d[1], c[0], 4)
    convbn("net.p4_conv", w[4], w[4], 3)
    c3k2("net.p4_csp", w[4], w[4], d[2], c[1], 2)
    convbn("net.p5_conv", w[4], w[5], 3)
    c3k2("net.p5_csp", w[5], w[5], d[3], c[1], 2)
    convbn("net.p5_sppf.cv1", w[5], w[5] // 2)
    convbn("net.p5_sppf.cv2", 4 * (w[5] // 2), w[5])
    half = w[5] // 2
    nh = max(1, half // 64)
    dk = half // nh // 2
    convbn("net.p5_psa.conv1", w[5], 2 * half)
    for i in range(d[4]):
        blk = f"net.p5_psa.m{i}"
        convbn(f"{blk}.attn.qkv", half, half + 2 * dk * nh)
        convbn(f"{blk}.attn.pe", half, half, 3, groups=half)
        convbn(f"{blk}.attn.proj", half, half)
        convbn(f"{blk}.ffn1", half, 2 * half)
        convbn(f"{blk}.ffn2", 2 * half, half)
    convbn("net.p5_psa.conv2", 2 * half, w[5])
    c3k2("fpn.h1", w[5] + w[4], w[4], d[5], c[0], 2)
    c3k2("fpn.h2", w[4] + w[4], w[3], d[5], c[0], 2)
    convbn("fpn.h3", w[3], w[3], 3)
    c3k2("fpn.h4", w[3] + w[4], w[4], d[5], c[0], 2)
    convbn("fpn.h5", w[4], w[4], 3)
    c3k2("fpn.h6", w[4] + w[5], w[5], d[5], c[1], 2)
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
