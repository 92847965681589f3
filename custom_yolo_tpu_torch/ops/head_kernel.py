"""Fused classification tower of the detection head: the CUDA kernel's
wrapper and its plain twin.

Counterpart of ``custom_yolo_tpu/ops/pallas/head_kernel.py::
cls_tower_pallas``: dw3×3 → pw1×1 → dw3×3 → pw1×1 → 1×1 logits, each
depthwise and pointwise conv followed by bias and SiLU, as two launches of
one fused stage kernel (the second also applies the logits projection), so
no depthwise output and not the last pointwise output reaches device
memory. The tensor is the port's NCHW ``(B, C, H, W)`` in ``channels_last``
memory (NHWC physically); the logits come back as ``(B, nc, H, W)`` in the
same format and dtype. Weights come as in the JAX function, each a
``(kernel, bias)`` pair in ``x``'s dtype: depthwise kernels ``(3, 3, C)``,
pointwise kernels ``(C_in, C_out)``, the logits' kernel ``(C_mid, nc)``.
Inference only: no gradient is defined, as for the TPU kernel. The stage
is a registered op (``torch.ops.custom_yolo_tpu_torch.cls_stage``, the
``(kernel, bias)`` pairs as tensor arguments), which ``torch.export``
keeps whole.

Rounding points, the same in the kernel and the twin: the nine depthwise
taps are accumulated in fp32, the bias added and SiLU applied in fp32, and
the result rounded to ``x``'s dtype; each 1×1 product is accumulated in
fp32 over all input channels, bias and SiLU in fp32, rounded once; the
logits are the fp32 product plus bias, rounded once. That is where a conv
chain in the compute dtype rounds too, except that it rounds once more
between each conv and its SiLU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch.ops.cuda import build, define

Pair = Tuple[torch.Tensor, torch.Tensor]

# the kernels walk input channels 32 at a time and output channels in
# passes of 128, 256 or 384
IN_MULTIPLE = 32
MID_MULTIPLE = 128


def _stage_reference(x: torch.Tensor, dw: Pair, pw: Pair,
                     out: Pair | None = None) -> torch.Tensor:
    """One stage of the twin; with ``out``, the logits' 1×1 after it."""
    dtype, c = x.dtype, x.shape[1]
    y = F.conv2d(x.float(), dw[0].float().permute(2, 0, 1)[:, None],
                 dw[1].float(), padding=1, groups=c)
    y = F.silu(y).to(dtype)
    z = F.conv2d(y.float(), pw[0].float().t()[:, :, None, None],
                 pw[1].float())
    z = F.silu(z).to(dtype)
    if out is None:
        return z
    logits = F.conv2d(z.float(), out[0].float().t()[:, :, None, None],
                      out[1].float())
    return logits.to(dtype)


def cls_tower_reference(x: torch.Tensor, dw1: Pair, pw1: Pair, dw2: Pair,
                        pw2: Pair, out: Pair) -> torch.Tensor:
    """Plain PyTorch twin: the conv chain in fp32, rounded to ``x``'s dtype
    at the kernel's rounding points."""
    return _stage_reference(_stage_reference(x, dw1, pw1), dw2, pw2, out)


def _padded(kernel: torch.Tensor) -> torch.Tensor:
    """The bf16 logits' kernel with its columns padded by zeros to a
    multiple of 8, so that the kernel copies its rows 16 bytes at a time
    (one small copy a call; 172 classes pad to 176)."""
    if kernel.shape[1] % 8 == 0:
        return kernel
    return F.pad(kernel, (0, -kernel.shape[1] % 8))


def _cls_stage_cpu(x: torch.Tensor, dw_kernel: torch.Tensor,
                   dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                   pw_bias: torch.Tensor, out_kernel: Optional[torch.Tensor],
                   out_bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _stage_reference(x, (dw_kernel, dw_bias), (pw_kernel, pw_bias),
                            None if out_kernel is None
                            else (out_kernel, out_bias))


def _cls_stage_cuda(x: torch.Tensor, dw_kernel: torch.Tensor,
                    dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                    pw_bias: torch.Tensor, out_kernel: Optional[torch.Tensor],
                    out_bias: Optional[torch.Tensor]) -> torch.Tensor:
    b, c, h, w = x.shape
    m = pw_kernel.shape[1]
    has_out = out_kernel is not None
    aligned = [x, dw_kernel, dw_bias, pw_kernel, pw_bias]
    if has_out and x.dtype == torch.bfloat16:
        aligned.append(out_kernel)
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("cls_tower: x and the depthwise, 1x1 and (bf16) "
                         "logits' kernels must start on a 16-byte boundary "
                         "(the kernels load 16 bytes at a time)")
    lib = build.load("head")
    need = build.query(lib, "cls_stage_smem_bytes", [ctypes.c_int] * 2,
                       ctypes.c_longlong, m, x.element_size())
    if need > build.SMEM_LIMIT:
        raise ValueError(
            f"cls_tower: {m} middle channels need {need} bytes of shared "
            f"memory (an 8x8 tile of all of them waits there for the "
            f"logits); the limit is {build.SMEM_LIMIT}")
    outk, outb = (out_kernel, out_bias) if has_out else (pw_kernel, pw_bias)
    nc = outb.shape[0]
    result = torch.empty((b, nc, h, w), dtype=x.dtype, device=x.device,
                         memory_format=torch.channels_last)
    build.launch(lib, "cls_stage",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9,
                 (x.data_ptr(), dw_kernel.data_ptr(), dw_bias.data_ptr(),
                  pw_kernel.data_ptr(), pw_bias.data_ptr(), outk.data_ptr(),
                  outb.data_ptr(), result.data_ptr(), b, h, w, c, m, nc,
                  outk.shape[1], int(has_out), x.element_size()),
                 x.device)
    build.count_launch(cls_tower)
    return result


def _cls_stage_fake(x, dw_kernel, dw_bias, pw_kernel, pw_bias, out_kernel,
                    out_bias):
    b, _, h, w = x.shape
    nc = (out_bias if out_bias is not None else pw_bias).shape[0]
    return torch.empty((b, nc, h, w), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


# One stage of the tower as a registered op (K6): dw3×3 → pw1×1, then the
# logits' 1×1 where out_kernel/out_bias are given; the twin for CPU
# tensors, one launch of the stage kernel for CUDA tensors.
_cls_stage_op = define(
    "cls_stage(Tensor x, Tensor dw_kernel, Tensor dw_bias, Tensor pw_kernel, "
    "Tensor pw_bias, Tensor? out_kernel, Tensor? out_bias) -> Tensor",
    _cls_stage_cpu, _cls_stage_cuda, _cls_stage_fake)


def _stage(x: torch.Tensor, dw: Pair, pw: Pair, out: Pair | None
           ) -> torch.Tensor:
    return _cls_stage_op(x, *dw, *pw,
                         *(out if out is not None else (None, None)))


def cls_tower(x: torch.Tensor, dw1: Pair, pw1: Pair, dw2: Pair, pw2: Pair,
              out: Pair) -> torch.Tensor:
    """The fused cls tower, two calls of the stage op ``cls_stage``:
    the twin for CPU tensors, two launches of the CUDA stage kernel
    (``ops/cuda/csrc/head.cu``) for CUDA tensors."""
    if x.device.type == "cpu":
        return _stage(_stage(x, dw1, pw1, None), dw2, pw2, out)
    if x.device.type != "cuda":
        raise ValueError(f"cls_tower: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"cls_tower: dtype {x.dtype}; want bfloat16 or "
                        "float32")
    if x.dim() != 4:
        raise ValueError(f"cls_tower: x {tuple(x.shape)}; want (B, C, H, W)")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("cls_tower: the kernel defines no gradient; "
                         "training takes the conv chain")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("cls_tower: x must be contiguous in channels_last "
                         "memory (NHWC)")
    c, mid, nc = x.shape[1], pw1[0].shape[1], out[0].shape[1]
    want = {"dw1": ((3, 3, c), (c,)), "pw1": ((c, mid), (mid,)),
            "dw2": ((3, 3, mid), (mid,)), "pw2": ((mid, mid), (mid,)),
            "out": ((mid, nc), (nc,))}
    for name, pair in zip(want, (dw1, pw1, dw2, pw2, out)):
        for tensor, shape in zip(pair, want[name]):
            if tuple(tensor.shape) != shape or tensor.dtype != x.dtype \
                    or tensor.device != x.device \
                    or not tensor.is_contiguous():
                raise ValueError(
                    f"cls_tower: {name} {tuple(tensor.shape)} {tensor.dtype} "
                    f"on {tensor.device}; want contiguous {shape} {x.dtype} "
                    f"on {x.device}")
    if c % IN_MULTIPLE or mid % MID_MULTIPLE:
        raise ValueError(
            f"cls_tower: {c} input and {mid} middle channels; the kernel "
            f"takes multiples of {IN_MULTIPLE} and {MID_MULTIPLE}")
    if x.numel() == 0:
        return torch.empty((x.shape[0], nc, *x.shape[2:]), dtype=x.dtype,
                           device=x.device,
                           memory_format=torch.channels_last)
    if x.dtype == torch.bfloat16:
        out = (_padded(out[0]), out[1])
    return _stage(_stage(x, dw1, pw1, None), dw2, pw2, out)


# one per launch of the stage kernel: two per call of cls_tower
cls_tower.launches = 0
