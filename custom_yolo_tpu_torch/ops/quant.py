"""int8 quantization for the serving path (counterpart of
``custom_yolo_tpu/ops/quant.py``).

* **Weights**: per-output-channel symmetric int8, ``scale = absmax/127``
  (1.0 for an all-zero channel), quantized once from the *fused* fp32
  kernels, round-to-nearest or seeded stochastic rounding
  (:func:`stochastic_quantize_int8_many`, kernel K7, one launch for all
  leaves).
* **Activations**: per-tensor symmetric int8, dynamic (absmax of the batch)
  or static (an ``in_scale`` calibrated offline, :func:`bake_static_scales`).
* **Contraction**: int8 × int8 → int32, exact, then dequantized as
  ``acc · (ascale · wscale) + bias`` in fp32 and cast to the input's dtype.
  A dense conv goes through ``torch._int_mm`` (cuBLASLt's int8 product on
  the card) on an NHWC view (1×1) or an int8 im2col (k×k, strided); a
  depthwise conv through a float32 conv of the int8 values, exact because
  each output sums 9 products of at most 127² (49 for YOLO12's 7×7: still
  < 2²⁴); a grouped conv (YOLO12's down-sampling convs) as one dense
  product a group. The JAX package leaves this contraction to XLA, so it
  is a library call here too.

The port's weights are OIHW; the order of operations is the JAX package's
throughout, so weights, scales and int32 accumulators are bit-equal to it.
Tree functions work on flat state dicts: a quantized conv leaf is
``….conv.{weight (int8), scale, bias[, in_scale]}``.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch.ops.quant_kernel import stochastic_round_many

# Backbone stages that ``Detector.quantize(skip="auto")`` keeps in float:
# the JAX package's measured set (shallow stages where int8 requantization
# costs more than the int8 product saves).
DEFAULT_QUANT_SKIP = ("p1_conv", "p2_conv", "p2_csp")

# torch._int_mm on the H100 (torch 2.11, CUDA 12.8) takes more than 16 rows
# and K, N in multiples of 8, and refuses a row-major second operand at 17
# rows (CUBLAS_STATUS_NOT_SUPPORTED): the operands are padded with zeros to
# those rules on every device, and the weights go in column-major
MIN_ROWS = 17
ALIGN = 8

# ---------------------------------------------------------------- weights
def _channel_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax/127``, 1.0 where it is 0. The divisor is a tensor: CUDA
    turns a division by a Python number into a multiplication by its
    reciprocal, which is not always the correctly rounded quotient that the
    CPU and the JAX package compute."""
    return torch.where(absmax > 0, absmax / absmax.new_full((), 127.0),
                       torch.ones_like(absmax))


def quantize_kernel_int8(kernel: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float kernel → (int8 kernel, fp32 scale (O,)), symmetric per
    output channel, round half to even."""
    k = kernel.float()
    scale = _channel_scale(k.abs().amax(dim=(1, 2, 3)))
    q = torch.clamp(torch.round(k / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def stochastic_operand(kernel: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float kernel → (K7's operand, scale): the kernel divided by its
    per-channel scale and clipped to ±127, as the contiguous fp32 matrix
    ``(kh·kw·cin, cout)`` of the JAX package's flat (HWIO) layout."""
    k = kernel.float().permute(2, 3, 1, 0)                      # HWIO
    scale = _channel_scale(k.abs().amax(dim=(0, 1, 2)))
    scaled = torch.clamp(k / scale, -127.0, 127.0)
    return scaled.reshape(-1, scaled.shape[-1]).contiguous(), scale


def stochastic_quantize_int8_many(kernels: Sequence[torch.Tensor],
                                  seed: int = 0
                                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-channel int8 with seeded *stochastic* rounding (unbiased:
    E[q] = k/scale) of each OIHW kernel: the scales and the clips here, the
    rounding of all of them by one launch of K7, each kernel drawing at its
    own flat indices under ``seed``."""
    operands = [stochastic_operand(kernel) for kernel in kernels]
    rounded = stochastic_round_many([flat for flat, _ in operands], seed)
    out = []
    for kernel, q, (_, scale) in zip(kernels, rounded, operands):
        o, i, kh, kw = kernel.shape
        out.append((q.view(kh, kw, i, o).permute(3, 2, 0, 1).contiguous(),
                    scale))
    return out


def stochastic_quantize_int8(kernel: torch.Tensor, seed: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`stochastic_quantize_int8_many` of one kernel."""
    return stochastic_quantize_int8_many([kernel], seed)[0]


# ------------------------------------------------------------ activations
def quantize_act_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: (int8 x, fp32 scale scalar)."""
    xf = x.float()
    scale = _channel_scale(xf.abs().amax())
    return quantize_act_static(xf, scale), scale


def quantize_act_static(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """Per-tensor int8 with a calibrated scale: elementwise only."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


# ------------------------------------------------------------------ conv
def _pad(x: torch.Tensor, padding: int) -> torch.Tensor:
    return F.pad(x, (padding,) * 4) if padding else x


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_contract(qx: torch.Tensor, qweight: torch.Tensor, stride: int = 1,
                  padding: int = 0, groups: int = 1) -> torch.Tensor:
    """int8 NCHW ``qx`` × int8 OIHW ``qweight`` → the int32 accumulators,
    NHWC ``(B, Ho, Wo, O)``. Dense convs go through ``torch._int_mm``
    (operands padded with zeros to its shape rules), depthwise convs through
    a float32 conv of the int8 values, and a grouped conv as one dense
    product a group; all are exact."""
    o, cin_g, kh, kw = qweight.shape
    xp = _pad(qx, padding)
    b, c, h, w = xp.shape
    if groups == c == o and cin_g == 1:
        acc = F.conv2d(xp.float(), qweight.float(), stride=stride,
                       groups=groups)
        return acc.to(torch.int32).permute(0, 2, 3, 1)
    if groups != 1:
        if c % groups or o % groups:
            raise ValueError(f"int8_contract: groups={groups} does not divide "
                             f"{c} input and {o} output channels")
        return torch.cat([int8_contract(xg, wg, stride) for xg, wg in zip(
            xp.chunk(groups, dim=1), qweight.chunk(groups, dim=0))], dim=-1)
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    nhwc = xp.permute(0, 2, 3, 1)
    if kh == kw == stride == 1:
        cols = nhwc.reshape(b * ho * wo, c)
    else:
        # int8 im2col, K ordered (kh, kw, cin) as the weight matrix below
        taps = [nhwc[:, i:i + stride * (ho - 1) + 1:stride,
                     j:j + stride * (wo - 1) + 1:stride]
                for i in range(kh) for j in range(kw)]
        cols = torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c)
    m, k = cols.shape
    mp, kp, np_ = max(m, MIN_ROWS), _round_up(k, ALIGN), _round_up(o, ALIGN)
    if (mp, kp) != (m, k):
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    wmat = qweight.permute(0, 2, 3, 1).reshape(o, k)            # (O, K)
    if (np_, kp) != (o, k):
        wmat = F.pad(wmat, (0, kp - k, 0, np_ - o))
    # (Mp, Kp) row-major × (Kp, Np) column-major
    acc = torch._int_mm(cols.contiguous(), wmat.contiguous().t())
    return acc[:m, :o].view(b, ho, wo, o)


def int8_contract_reference(qx: torch.Tensor, qweight: torch.Tensor,
                            stride: int = 1, padding: int = 0,
                            groups: int = 1) -> torch.Tensor:
    """Plain twin of :func:`int8_contract`: a float64 conv of the int8
    values, exact (|sum| < 2⁵³), on any device."""
    acc = F.conv2d(_pad(qx, padding).double(), qweight.double(),
                   stride=stride, groups=groups)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


Contract = Callable[..., torch.Tensor]


def _int8_contract(qx, ascale, qweight, wscale, bias, stride, padding,
                   groups, act, out_dtype, contract: Contract
                   ) -> torch.Tensor:
    """The int32 accumulators of ``contract`` → NCHW ``out_dtype``:
    ``acc · (ascale · wscale) + bias`` in fp32, the scales' product first
    and no fused multiply-add, optional SiLU, then the cast."""
    acc = contract(qx, qweight, stride, padding, groups)
    out = acc.float() * (ascale * wscale) + bias
    if act:
        out = F.silu(out)
    return out.to(out_dtype).permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, qweight: torch.Tensor, wscale: torch.Tensor,
              bias: torch.Tensor, stride: int = 1, padding: int = 0,
              groups: int = 1, act: bool = True,
              contract: Contract = int8_contract) -> torch.Tensor:
    """NCHW float ``x`` → dynamic-int8 conv → NCHW output in ``x``'s dtype.
    ``contract`` is the int32 route (:func:`int8_contract`, or its float64
    twin)."""
    qx, ascale = quantize_act_int8(x)
    return _int8_contract(qx, ascale, qweight, wscale, bias, stride, padding,
                          groups, act, x.dtype, contract)


def int8_conv_static(x: torch.Tensor, qweight: torch.Tensor,
                     wscale: torch.Tensor, bias: torch.Tensor,
                     in_scale: torch.Tensor, stride: int = 1,
                     padding: int = 0, groups: int = 1, act: bool = True,
                     contract: Contract = int8_contract) -> torch.Tensor:
    """Static int8 conv: the input scale was calibrated offline, so no
    absmax pass runs."""
    qx = quantize_act_static(x, in_scale)
    return _int8_contract(qx, in_scale, qweight, wscale, bias, stride,
                          padding, groups, act, x.dtype, contract)


# ----------------------------------------------------------- tree rewrite
def quant_prefixes(state: Mapping[str, torch.Tensor]) -> list:
    """Prefixes ``….conv`` of the quantized conv leaves of a state dict, in
    its order."""
    return [key[:-len(".weight")] for key, value in state.items()
            if key.endswith(".conv.weight") and value.dtype == torch.int8]


def quantize_fused_params(state: Mapping[str, torch.Tensor],
                          stochastic: bool = False,
                          skip: Sequence[str] = ()
                          ) -> Dict[str, torch.Tensor]:
    """Fused state dict → quantized: each ConvBN's ``….conv.weight`` becomes
    int8 with ``….conv.scale`` beside it, ``….conv.bias`` fp32. The head's
    logit projections (``…_out``, which hold no ``.conv``) and every module
    under a name in ``skip`` stay float. Stochastic rounding seeds every
    leaf with 0, as the JAX package does, and rounds all of them in one
    launch of K7."""
    if any(".bn." in key for key in state):
        raise ValueError("quantize_fused_params expects a fused state (fuse "
                         "first)")
    out: Dict[str, torch.Tensor] = {}
    leaves = []
    for key, value in state.items():
        prefix = key[:-len(".weight")]
        if (not key.endswith(".conv.weight") or value.dtype == torch.int8
                or f"{prefix}.scale" in state
                or any(part in skip for part in key.split("."))):
            out.setdefault(key, value)
            continue
        leaves.append(key)
        out[key] = out[f"{prefix}.scale"] = None      # filled below
        out[f"{prefix}.bias"] = state[f"{prefix}.bias"].float()
    kernels = [state[key] for key in leaves]
    quantized = (stochastic_quantize_int8_many(kernels) if stochastic
                 else [quantize_kernel_int8(kernel) for kernel in kernels])
    for key, (q, s) in zip(leaves, quantized):
        out[key], out[f"{key[:-len('.weight')]}.scale"] = q, s
    return out


def bake_static_scales(state: Mapping[str, torch.Tensor],
                       stats: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Quantized state + calibration statistics → static-quant state: each
    int8 conv leaf ``P`` gains ``P.in_scale = absmax/127`` (1.0 for 0) from
    ``stats[P]``, the largest ``ascale·127`` observed at its input; a leaf
    without statistics (or ``stats=None``) gets 1.0."""
    stats = stats or {}
    out = dict(state)
    for prefix in quant_prefixes(state):
        device = state[f"{prefix}.scale"].device
        if prefix in stats:
            absmax = stats[prefix].float().max().to(device)
            out[f"{prefix}.in_scale"] = _channel_scale(absmax)
        else:
            out[f"{prefix}.in_scale"] = torch.ones((), device=device)
    return out


def has_static_scales(state: Mapping[str, torch.Tensor]) -> bool:
    """True if any int8 conv leaf carries a calibrated ``in_scale``."""
    return any(key.endswith(".conv.in_scale") for key in state)
