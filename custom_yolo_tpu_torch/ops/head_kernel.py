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
Inference only: no gradient is defined, as for the TPU kernel.

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
from typing import Tuple

import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch.ops.cuda import build

Pair = Tuple[torch.Tensor, torch.Tensor]

# the kernels walk input channels 32 at a time and output channels in
# passes of 128, 256 or 384
IN_MULTIPLE = 32
MID_MULTIPLE = 128


def _stage_reference(x: torch.Tensor, dw: Pair, pw: Pair) -> torch.Tensor:
    dtype, c = x.dtype, x.shape[1]
    y = F.conv2d(x.float(), dw[0].float().permute(2, 0, 1)[:, None],
                 dw[1].float(), padding=1, groups=c)
    y = F.silu(y).to(dtype)
    z = F.conv2d(y.float(), pw[0].float().t()[:, :, None, None],
                 pw[1].float())
    return F.silu(z).to(dtype)


def cls_tower_reference(x: torch.Tensor, dw1: Pair, pw1: Pair, dw2: Pair,
                        pw2: Pair, out: Pair) -> torch.Tensor:
    """Plain PyTorch twin: the conv chain in fp32, rounded to ``x``'s dtype
    at the kernel's rounding points."""
    z = _stage_reference(_stage_reference(x, dw1, pw1), dw2, pw2)
    logits = F.conv2d(z.float(), out[0].float().t()[:, :, None, None],
                      out[1].float())
    return logits.to(x.dtype)


def _padded(kernel: torch.Tensor) -> torch.Tensor:
    """The bf16 logits' kernel with its columns padded by zeros to a
    multiple of 8, so that the kernel copies its rows 16 bytes at a time
    (one small copy a call; 172 classes pad to 176)."""
    if kernel.shape[1] % 8 == 0:
        return kernel
    return F.pad(kernel, (0, -kernel.shape[1] % 8))


def _stage(x: torch.Tensor, dw: Pair, pw: Pair, out: Pair | None
           ) -> torch.Tensor:
    b, c, h, w = x.shape
    m = pw[0].shape[1]
    nc = out[1].shape[0] if out is not None else m
    result = torch.empty((b, nc, h, w), dtype=x.dtype, device=x.device,
                         memory_format=torch.channels_last)
    outk, outb = out if out is not None else pw
    build.launch(build.load("head"), "cls_stage",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9,
                 (x.data_ptr(), dw[0].data_ptr(), dw[1].data_ptr(),
                  pw[0].data_ptr(), pw[1].data_ptr(), outk.data_ptr(),
                  outb.data_ptr(), result.data_ptr(), b, h, w, c, m, nc,
                  outk.shape[1], int(out is not None), x.element_size()),
                 x.device)
    cls_tower.launches += 1
    return result


def cls_tower(x: torch.Tensor, dw1: Pair, pw1: Pair, dw2: Pair, pw2: Pair,
              out: Pair) -> torch.Tensor:
    """The fused cls tower: the twin for CPU tensors, two launches of the
    CUDA stage kernel (``ops/cuda/csrc/head.cu``) for CUDA tensors."""
    if x.device.type == "cpu":
        return cls_tower_reference(x, dw1, pw1, dw2, pw2, out)
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
    aligned = [x, *dw1, *pw1, *dw2, *pw2]
    if x.dtype == torch.bfloat16:
        out = (_padded(out[0]), out[1])
        aligned.append(out[0])
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("cls_tower: x and the depthwise, 1x1 and (bf16) "
                         "logits' kernels must start on a 16-byte boundary "
                         "(the kernels load 16 bytes at a time)")
    if c % IN_MULTIPLE or mid % MID_MULTIPLE:
        raise ValueError(
            f"cls_tower: {c} input and {mid} middle channels; the kernel "
            f"takes multiples of {IN_MULTIPLE} and {MID_MULTIPLE}")
    if x.numel() == 0:
        return torch.empty((x.shape[0], nc, *x.shape[2:]), dtype=x.dtype,
                           device=x.device,
                           memory_format=torch.channels_last)
    need = build.query(build.load("head"), "cls_stage_smem_bytes",
                       [ctypes.c_int] * 2, ctypes.c_longlong, mid,
                       x.element_size())
    if need > build.SMEM_LIMIT:
        raise ValueError(
            f"cls_tower: {mid} middle channels need {need} bytes of shared "
            f"memory (an 8x8 tile of all of them waits there for the "
            f"logits); the limit is {build.SMEM_LIMIT}")
    z = _stage(x, dw1, pw1, None)
    return _stage(z, dw2, pw2, out)


# one per launch of the stage kernel: two per call of cls_tower
cls_tower.launches = 0
