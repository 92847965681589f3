"""Network blocks (counterpart of ``custom_yolo_tpu/nn/blocks.py``).

Modules take and return NCHW tensors in the compute dtype; the model's
input arrives NHWC and is permuted once, so activations stay
``channels_last`` in memory. Submodule names are those of the flax
modules (``conv``/``bn``, ``conv1``, ``m0``, ``res0``, ``attn.qkv``, …),
so a JAX variable tree maps onto the state dict by a tree walk
(``utils/weights.py``). Parameters stay float32 and are cast to the
activation dtype where they are used.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from custom_yolo_tpu_torch.ops.attention import psa_attention

# BatchNorm constants of the reference: eps 1e-3, torch momentum 0.03
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied with its weight (and bias) cast to ``x``'s dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation; ``fused=True`` holds the
    folded conv with bias and no BatchNorm."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 act: bool = True, fused: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                              groups=groups, bias=fused)
        self.bn = None if fused else nn.BatchNorm2d(
            c_out, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.conv)
        if self.bn is not None:
            # normalise in fp32 and round once, as flax's BatchNorm does
            bn = self.bn
            yf = y.float()
            if self.training:
                # flax's running update: the *biased* fp32 batch variance
                # (F.batch_norm would store the unbiased one, n/(n−1)
                # larger). One pass; flax's E[x²] − E[x]² is the same
                # number up to its cancellation error.
                with torch.no_grad():
                    var, mean = torch.var_mean(yf, dim=(0, 2, 3),
                                               unbiased=False)
                    bn.running_mean.lerp_(mean, bn.momentum)
                    bn.running_var.lerp_(var, bn.momentum)
                y = F.batch_norm(yf, None, None, bn.weight, bn.bias, True,
                                 0.0, bn.eps).to(x.dtype)
            else:
                y = F.batch_norm(yf, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, False, 0.0,
                                 bn.eps).to(x.dtype)
        return F.silu(y) if self.act else y


class Residual(nn.Module):
    """Two 3×3 ConvBNs with an additive skip."""

    def __init__(self, ch: int, e: float = 0.5, fused: bool = False):
        super().__init__()
        mid = int(ch * e)
        self.conv1 = ConvBN(ch, mid, 3, padding=1, fused=fused)
        self.conv2 = ConvBN(mid, ch, 3, padding=1, fused=fused)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class C3K(nn.Module):
    """CSP sub-block: conv1/conv2 split, two Residual(e=1) on the conv1
    branch, concat → conv3."""

    def __init__(self, c_in: int, out_ch: int, fused: bool = False):
        super().__init__()
        half = out_ch // 2
        self.conv1 = ConvBN(c_in, half, fused=fused)
        self.conv2 = ConvBN(c_in, half, fused=fused)
        self.res0 = Residual(half, e=1.0, fused=fused)
        self.res1 = Residual(half, e=1.0, fused=fused)
        self.conv3 = ConvBN(2 * half, out_ch, fused=fused)

    def forward(self, x):
        y = self.res1(self.res0(self.conv1(x)))
        return self.conv3(torch.cat([y, self.conv2(x)], dim=1))


class C3K2(nn.Module):
    """Main CSP stage: conv1 → split in two, n chained inner blocks (C3K or
    Residual), concat of all → conv2."""

    def __init__(self, c_in: int, out_ch: int, n: int, csp: bool, r: int,
                 fused: bool = False):
        super().__init__()
        hidden = out_ch // r
        self.conv1 = ConvBN(c_in, 2 * hidden, fused=fused)
        for i in range(n):
            blk = (C3K(hidden, hidden, fused=fused) if csp
                   else Residual(hidden, e=0.5, fused=fused))
            self.add_module(f"m{i}", blk)
        self.n = n
        self.conv2 = ConvBN((2 + n) * hidden, out_ch, fused=fused)

    def forward(self, x):
        parts: List[torch.Tensor] = list(self.conv1(x).chunk(2, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.conv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """1×1 reduce, three chained 5×5 stride-1 max-pools (−inf borders),
    4-way concat, 1×1 out."""

    def __init__(self, c_in: int, out_ch: int, k: int = 5,
                 fused: bool = False):
        super().__init__()
        self.cv1 = ConvBN(c_in, c_in // 2, fused=fused)
        self.cv2 = ConvBN(4 * (c_in // 2), out_ch, fused=fused)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class Attention(nn.Module):
    """Spatial multi-head self-attention with a depthwise positional branch.

    The qkv projection is handed to :func:`ops.attention.psa_attention`
    token-major, ``(B, H·W, nh·(2dk+dh))`` with per-head channels
    ``[q | k | v]``: the CUDA kernel on the card, the plain twin on the
    CPU."""

    def __init__(self, c: int, num_head: int, fused: bool = False):
        super().__init__()
        self.num_head = num_head
        self.dim_head = c // num_head
        self.dim_key = self.dim_head // 2
        self.qkv = ConvBN(c, c + self.dim_key * num_head * 2, act=False,
                          fused=fused)
        self.pe = ConvBN(c, c, 3, padding=1, groups=c, act=False, fused=fused)
        self.proj = ConvBN(c, c, act=False, fused=fused)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.qkv(x).flatten(2).transpose(1, 2).contiguous()
        out_tok, v_tok = psa_attention(tokens, self.num_head, self.dim_key,
                                       self.dim_head)
        out = out_tok.transpose(1, 2).reshape(b, c, h, w)
        v = v_tok.transpose(1, 2).reshape(b, c, h, w)
        return self.proj(out + self.pe(v))


class PSABlock(nn.Module):
    """Attention residual + two-conv MLP residual."""

    def __init__(self, c: int, num_head: int, fused: bool = False):
        super().__init__()
        self.attn = Attention(c, num_head, fused=fused)
        self.ffn1 = ConvBN(c, 2 * c, fused=fused)
        self.ffn2 = ConvBN(2 * c, c, act=False, fused=fused)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class PSA(nn.Module):
    """Split-channel CSP wrapper around n PSABlocks; ``max(1, (c//2)//64)``
    heads on the c/2 attended channels."""

    def __init__(self, c: int, n: int, fused: bool = False):
        super().__init__()
        half = c // 2
        self.conv1 = ConvBN(c, 2 * half, fused=fused)
        num_head = max(1, half // 64)
        for i in range(n):
            self.add_module(f"m{i}", PSABlock(half, num_head, fused=fused))
        self.n = n
        self.conv2 = ConvBN(2 * half, c, fused=fused)

    def forward(self, x):
        a, b = self.conv1(x).chunk(2, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.conv2(torch.cat([a, b], dim=1))
