"""SPPF pooling pyramid: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``custom_yolo_tpu/ops/pallas/sppf_kernel.py::
sppf_pyramid_pallas``: ``concat[x, p(x), p²(x), p³(x)]`` along the channel
axis, ``p`` the 5×5 stride-1 max-pool with −inf borders. The tensor is the
port's NCHW ``(B, C, H, W)`` in ``channels_last`` memory — NHWC physically,
which is what the TPU kernel reads — and the result is ``(B, 4C, H, W)``
in the same format and dtype. Inference only: no gradient is defined, as
for the TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch.ops.cuda import build

# channel chunks of one block (powers of two), tried from the widest down
_CHUNKS = (16, 8)


def sppf_pyramid_reference(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Plain PyTorch twin: three chained ``max_pool2d`` and a concat."""
    y1 = F.max_pool2d(x, k, 1, k // 2)
    y2 = F.max_pool2d(y1, k, 1, k // 2)
    y3 = F.max_pool2d(y2, k, 1, k // 2)
    return torch.cat([x, y1, y2, y3], dim=1)


def sppf_pyramid(x: torch.Tensor) -> torch.Tensor:
    """The pooling pyramid: the twin for CPU tensors, the CUDA kernel
    (``ops/cuda/csrc/sppf.cu``) for CUDA tensors."""
    if x.device.type == "cpu":
        return sppf_pyramid_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"sppf_pyramid: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sppf_pyramid: dtype {x.dtype}; want bfloat16 or "
                        "float32")
    if x.dim() != 4:
        raise ValueError(f"sppf_pyramid: x {tuple(x.shape)}; want "
                         "(B, C, H, W)")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("sppf_pyramid: the kernel defines no gradient; "
                         "training takes the max_pool2d chain")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("sppf_pyramid: x must be contiguous in "
                         "channels_last memory (NHWC)")
    b, c, h, w = x.shape
    out = torch.empty((b, 4 * c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    tile = 2 * h * w * x.element_size()       # two copies, per channel
    chunk = next((ch for ch in _CHUNKS if tile * ch <= build.SMEM_LIMIT),
                 None)
    if chunk is None:
        raise ValueError(
            f"sppf_pyramid: a {h}x{w} map needs {tile * _CHUNKS[-1]} bytes "
            f"of shared memory for two copies of {_CHUNKS[-1]} channels; "
            f"the limit is {build.SMEM_LIMIT}")
    lib = build.load("sppf")
    build.launch(lib, "sppf_pyramid",
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6,
                 (x.data_ptr(), out.data_ptr(), b, h, w, c, chunk,
                  x.element_size()), x.device)
    sppf_pyramid.launches += 1
    return out


sppf_pyramid.launches = 0
