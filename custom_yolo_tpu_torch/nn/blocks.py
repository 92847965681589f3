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

import contextlib
from typing import Iterator, List

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from custom_yolo_tpu_torch.ops.attention import psa_attention
from custom_yolo_tpu_torch.ops.quant import (int8_conv, int8_conv_static,
                                             quantize_act_int8)
from custom_yolo_tpu_torch.ops.sppf_kernel import (sppf_pyramid,
                                                   sppf_pyramid_reference)
from custom_yolo_tpu_torch.utils.profiling import span

# BatchNorm constants of the reference: eps 1e-3, torch momentum 0.03
BN_EPS = 1e-3
BN_MOMENTUM = 0.03

# C3K horizontal merge gate, the reference's: a C3K whose branches are
# narrower than this keeps its two separate convs, so that a merged tree of
# either package loads into the other
MERGE_MIN_HALF = 64


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied with its weight (and bias) cast to ``x``'s dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class _QuantConv(nn.Module):
    """int8 conv leaf of the quantized serving path: buffers ``weight``
    (int8 OIHW), ``scale`` (fp32, per output channel), ``bias`` (fp32) and,
    once calibrated, ``in_scale`` (fp32 scalar), as written by
    :func:`ops.quant.quantize_fused_params` and
    :func:`ops.quant.bake_static_scales`. The parent ConvBN applies the
    activation.

    The buffers choose the mode, as the JAX tree does: **static** when
    ``in_scale`` is present, **dynamic** (per-batch absmax) otherwise. A
    state dict loaded into the module sets it up for whichever it holds.
    While ``observing`` is on, a dynamic forward records in ``observed``
    the largest ``ascale·127`` of its inputs (127 for an all-zero input, as
    in the JAX package), which ``Detector.calibrate`` bakes."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 padding: int, groups: int):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        k = kernel_size
        self.register_buffer("weight", torch.zeros(
            c_out, c_in // groups, k, k, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(c_out))
        self.register_buffer("bias", torch.zeros(c_out))
        self.register_buffer("in_scale", None)
        self.observing = False
        self.observed = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        present = f"{prefix}in_scale" in state_dict
        self.in_scale = torch.ones((), device=self.scale.device) \
            if present else None
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kw = dict(stride=self.stride, padding=self.padding,
                  groups=self.groups, act=False)
        if self.in_scale is not None:
            return int8_conv_static(x, self.weight, self.scale, self.bias,
                                    self.in_scale, **kw)
        if self.observing:
            absmax = quantize_act_int8(x)[1] * 127.0
            self.observed = absmax if self.observed is None \
                else torch.maximum(self.observed, absmax)
        return int8_conv(x, self.weight, self.scale, self.bias, **kw)


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation; ``fused=True`` holds the
    folded conv with bias and no BatchNorm; ``quantized=True`` (fused only)
    an int8 :class:`_QuantConv`."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 act: bool = True, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        if quantized and not fused:
            raise ValueError("a quantized ConvBN must be fused")
        self.conv = (_QuantConv(c_in, c_out, kernel_size, stride, padding,
                               groups) if quantized else
                     nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                               groups=groups, bias=fused))
        self.bn = None if fused else nn.BatchNorm2d(
            c_out, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act
        # off while a rematerialised forward is recomputed in the backward
        # pass (frozen_statistics): the forward already took this batch
        self.update_stats = True
        # on while every rank of the default process group holds part of
        # the batch (parallel.sharding.shard_train_state): a training
        # forward then normalises with the global batch's statistics
        self.global_batch = False

    def _global_batch_norm(self, yf: torch.Tensor) -> torch.Tensor:
        """Training BatchNorm over the batch of every rank. Each rank takes
        its rows' per-channel mean and biased variance in fp32 (as the
        one-device path does), turns them into sums and sums of squares in
        float64, where E[x²] − E[x]² loses nothing that matters, and one
        ``all_reduce`` adds them and the element counts over the ranks;
        the gradient is carried back through it (the reduction's backward
        sums every rank's gradient of the statistics). The running update
        takes the global biased variance."""
        bn = self.bn
        c = yf.shape[1]
        var, mean = torch.var_mean(yf, dim=(0, 2, 3), unbiased=False)
        n = yf.numel() // c
        mean64 = mean.double()
        stats = torch.cat([mean64 * n, (var.double() + mean64 * mean64) * n,
                           mean64.new_full((1,), n)])
        stats = dist_fn.all_reduce(stats)
        count = stats[2 * c]
        mean64 = stats[:c] / count
        mean = mean64.float()
        var = (stats[c:2 * c] / count - mean64 * mean64).clamp_min(
            0.0).float()
        if self.update_stats:
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
        scale = (bn.weight * torch.rsqrt(var + bn.eps))[None, :, None, None]
        return (yf - mean[None, :, None, None]) * scale \
            + bn.bias[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (self.conv(x) if isinstance(self.conv, _QuantConv)
             else conv2d(x, self.conv))
        if self.bn is not None:
            # normalise in fp32 and round once, as flax's BatchNorm does
            bn = self.bn
            yf = y.float()
            if self.training and self.global_batch:
                y = self._global_batch_norm(yf).to(x.dtype)
            elif self.training:
                # flax's running update: the *biased* fp32 batch variance
                # (F.batch_norm would store the unbiased one, n/(n−1)
                # larger). One pass; flax's E[x²] − E[x]² is the same
                # number up to its cancellation error.
                if self.update_stats:
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


@contextlib.contextmanager
def frozen_statistics(module: nn.Module) -> Iterator[None]:
    """Every ConvBN inside ``module`` leaves its running statistics alone
    for the duration: the context of a rematerialised forward's recompute,
    which sees the batch a second time (flax updates them once)."""
    convbns = [m for m in module.modules() if isinstance(m, ConvBN)]
    for m in convbns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in convbns:
            m.update_stats = True


class Residual(nn.Module):
    """Two 3×3 ConvBNs with an additive skip."""

    def __init__(self, ch: int, e: float = 0.5, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        mid = int(ch * e)
        self.conv1 = ConvBN(ch, mid, 3, padding=1, **kw)
        self.conv2 = ConvBN(mid, ch, 3, padding=1, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class C3K(nn.Module):
    """CSP sub-block: conv1/conv2 split, two Residual(e=1) on the conv1
    branch, concat → conv3.

    ``merged=True`` (serving): conv1 and conv2 read the same input and each
    emit ``half`` channels, so they run as one conv of width ``2·half``
    (``conv12``) whose output is split. Each output channel is computed
    as before, so the result is the same. Applies only where ``half >=
    MERGE_MIN_HALF``; weights from ``models.detector.merge_c3k_params``."""

    def __init__(self, c_in: int, out_ch: int, fused: bool = False,
                 merged: bool = False, quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        half = out_ch // 2
        self.merged = merged and half >= MERGE_MIN_HALF
        if self.merged:
            self.conv12 = ConvBN(c_in, 2 * half, **kw)
        else:
            self.conv1 = ConvBN(c_in, half, **kw)
            self.conv2 = ConvBN(c_in, half, **kw)
        self.res0 = Residual(half, e=1.0, **kw)
        self.res1 = Residual(half, e=1.0, **kw)
        self.conv3 = ConvBN(2 * half, out_ch, **kw)

    def forward(self, x):
        if self.merged:
            y, z = self.conv12(x).chunk(2, dim=1)
        else:
            y, z = self.conv1(x), self.conv2(x)
        y = self.res1(self.res0(y))
        return self.conv3(torch.cat([y, z], dim=1))


class C3K2(nn.Module):
    """Main CSP stage: conv1 → split in two, n chained inner blocks (C3K or
    Residual), concat of all → conv2."""

    def __init__(self, c_in: int, out_ch: int, n: int, csp: bool, r: int,
                 fused: bool = False, merged: bool = False,
                 quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        hidden = out_ch // r
        self.conv1 = ConvBN(c_in, 2 * hidden, **kw)
        for i in range(n):
            blk = (C3K(hidden, hidden, merged=merged, **kw) if csp
                   else Residual(hidden, e=0.5, **kw))
            self.add_module(f"m{i}", blk)
        self.n = n
        self.conv2 = ConvBN((2 + n) * hidden, out_ch, **kw)

    def forward(self, x):
        parts: List[torch.Tensor] = list(self.conv1(x).chunk(2, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.conv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """1×1 reduce, three chained 5×5 stride-1 max-pools (−inf borders),
    4-way concat, 1×1 out.

    The pooling pyramid has one route per forward: one that needs no
    gradient goes to the registered op
    (:func:`ops.sppf_kernel.sppf_pyramid`: the fused kernel on a CUDA
    tensor, bit-exact, its twin on a CPU tensor), a training forward to
    the ``max_pool2d`` chain, which autograd differentiates (the kernel
    defines no gradient). The kernel pools 5×5 windows only, so no other
    ``k`` is built."""

    def __init__(self, c_in: int, out_ch: int, k: int = 5,
                 fused: bool = False, quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        if k != 5:
            raise ValueError(f"SPPF pools 5×5 windows only, got k={k}")
        self.cv1 = ConvBN(c_in, c_in // 2, **kw)
        self.cv2 = ConvBN(4 * (c_in // 2), out_ch, **kw)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        if torch.is_grad_enabled() and x.requires_grad:
            return self.cv2(sppf_pyramid_reference(x, self.k))
        return self.cv2(sppf_pyramid(
            x.contiguous(memory_format=torch.channels_last)))


class Attention(nn.Module):
    """Spatial multi-head self-attention with a depthwise positional branch.

    The qkv projection is handed to :func:`ops.attention.psa_attention`
    token-major, ``(B, H·W, nh·(2dk+dh))`` with per-head channels
    ``[q | k | v]``: the CUDA kernel on the card, the plain twin on the
    CPU."""

    def __init__(self, c: int, num_head: int, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        self.num_head = num_head
        self.dim_head = c // num_head
        self.dim_key = self.dim_head // 2
        self.qkv = ConvBN(c, c + self.dim_key * num_head * 2, act=False,
                          **kw)
        self.pe = ConvBN(c, c, 3, padding=1, groups=c, act=False, **kw)
        self.proj = ConvBN(c, c, act=False, **kw)

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

    def __init__(self, c: int, num_head: int, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        self.attn = Attention(c, num_head, **kw)
        self.ffn1 = ConvBN(c, 2 * c, **kw)
        self.ffn2 = ConvBN(2 * c, c, act=False, **kw)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class PSA(nn.Module):
    """Split-channel CSP wrapper around n PSABlocks; ``max(1, (c//2)//64)``
    heads on the c/2 attended channels."""

    def __init__(self, c: int, n: int, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        half = c // 2
        self.conv1 = ConvBN(c, 2 * half, **kw)
        num_head = max(1, half // 64)
        for i in range(n):
            self.add_module(f"m{i}", PSABlock(half, num_head, **kw))
        self.n = n
        self.conv2 = ConvBN(2 * half, c, **kw)

    def forward(self, x):
        a, b = self.conv1(x).chunk(2, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.conv2(torch.cat([a, b], dim=1))


# YOLO12's attention width: every area-attention head is 32 channels wide
# (ultralytics' ``A2C2f`` asserts the hidden width is a multiple of it)
AREA_HEAD_DIM = 32
# the hidden width of an ABlock's MLP over its channels (the yaml's l/x)
ABLOCK_MLP_RATIO = 1.2


class AAttn(nn.Module):
    """YOLO12's area attention: a 1×1 ``qkv`` ConvBN to ``3c`` channels
    (per head ``[q | k | v]``, 32 wide each), attention inside each of
    ``area`` strips of the row-major token sequence, a 7×7 depthwise
    positional ConvBN ``pe`` on v, and a 1×1 ``proj``.

    The strips are a view of the token-major qkv, ``(B·area, H·W/area,
    3c)``, handed to :func:`ops.attention.psa_attention` (K1 on the card)
    with ``dim_key = dim_head = 32``; the call is the ``attn/area`` span. A
    map whose ``H·W`` does not divide into ``area`` strips is refused."""

    def __init__(self, c: int, num_heads: int, area: int = 1,
                 fused: bool = False, quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        self.num_heads, self.area = num_heads, area
        self.dim_head = c // num_heads
        self.qkv = ConvBN(c, 3 * c, act=False, **kw)
        self.pe = ConvBN(c, c, 7, padding=3, groups=c, act=False, **kw)
        self.proj = ConvBN(c, c, act=False, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        if n % self.area:
            raise ValueError(f"area attention: a {h}×{w} map does not split "
                             f"into {self.area} strips of equal length")
        # channels_last: the token-major layout is the conv's own, so the
        # transpose's contiguous() copies nothing
        tokens = self.qkv(x).flatten(2).transpose(1, 2).contiguous()
        strips = tokens.view(b * self.area, n // self.area, 3 * c)
        with span("attn/area"):
            out_tok, v_tok = psa_attention(strips, self.num_heads,
                                           self.dim_head, self.dim_head)
        out = out_tok.reshape(b, n, c).transpose(1, 2).reshape(b, c, h, w)
        v = v_tok.reshape(b, n, c).transpose(1, 2).reshape(b, c, h, w)
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    """Area-attention residual + two-conv MLP residual (``c`` →
    ``int(c·ABLOCK_MLP_RATIO)`` → ``c``)."""

    def __init__(self, c: int, num_heads: int, area: int = 1,
                 fused: bool = False, quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        hidden = int(c * ABLOCK_MLP_RATIO)
        self.attn = AAttn(c, num_heads, area, **kw)
        self.ffn1 = ConvBN(c, hidden, **kw)
        self.ffn2 = ConvBN(hidden, c, act=False, **kw)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class A2C2f(nn.Module):
    """YOLO12's CSP stage: ``conv1`` to ``out_ch/2`` channels, n chained
    inner blocks, concat of all ``1 + n`` → ``conv2``. With ``attention``
    each inner block is two :class:`ABlock` (``m{i}.0``, ``m{i}.1``; heads
    of 32 channels) and the stage is a layer-scale residual ``x + γ·y``
    (the yaml's l/x form; γ per channel, 0.01 at initialisation); without,
    each inner block is a :class:`C3K` and the stage has no residual."""

    def __init__(self, c_in: int, out_ch: int, n: int, attention: bool,
                 area: int = 1, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        kw = dict(fused=fused, quantized=quantized)
        hidden = out_ch // 2
        if attention and hidden % AREA_HEAD_DIM:
            raise ValueError(f"A2C2f: {hidden} attended channels are not a "
                             f"multiple of {AREA_HEAD_DIM}")
        if attention and c_in != out_ch:
            raise ValueError("A2C2f: the layer-scale residual needs as many "
                             f"input as output channels ({c_in} ≠ {out_ch})")
        self.conv1 = ConvBN(c_in, hidden, **kw)
        for i in range(n):
            blk = (nn.Sequential(*(ABlock(hidden, hidden // AREA_HEAD_DIM,
                                          area, **kw) for _ in range(2)))
                   if attention else C3K(hidden, hidden, **kw))
            self.add_module(f"m{i}", blk)
        self.n = n
        self.conv2 = ConvBN((1 + n) * hidden, out_ch, **kw)
        self.gamma = (nn.Parameter(torch.full((out_ch,), 0.01))
                      if attention else None)

    def forward(self, x):
        parts: List[torch.Tensor] = [self.conv1(x)]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        y = self.conv2(torch.cat(parts, dim=1))
        if self.gamma is None:
            return y
        # x + γ·y, rounded once
        return torch.addcmul(x, self.gamma.to(y.dtype)[None, :, None, None],
                             y)
