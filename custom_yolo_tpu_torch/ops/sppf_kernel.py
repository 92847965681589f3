"""SPPF pooling pyramid: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``custom_yolo_tpu/ops/pallas/sppf_kernel.py::
sppf_pyramid_pallas``: ``concat[x, p(x), p²(x), p³(x)]`` along the channel
axis, ``p`` the 5×5 stride-1 max-pool with −inf borders. The tensor is the
port's NCHW ``(B, C, H, W)`` in ``channels_last`` memory — NHWC physically,
which is what the TPU kernel reads — and the result is ``(B, 4C, H, W)``
in the same format and dtype. Inference only: no gradient is defined, as
for the TPU kernel. The kernel is a registered op
(``torch.ops.custom_yolo_tpu_torch.sppf_pyramid``), which ``torch.export``
keeps whole.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch.ops.cuda import build, define

# the widest tile side, and the vectors of channels a block takes, widest
# first; the kernel's shared-memory budget and halo; the blocks wanted for
# each SM of the card
MAX_TILE = 16
CHUNKS = (4, 2, 1)
SMEM_BUDGET = 48 * 1024
HALO = 6
BLOCKS_PER_SM = 2


def _vector(c: int, elem_size: int, *ptrs: int) -> int:
    """Channels a thread moves at once: 16 bytes where ``c`` and the
    addresses allow it, else one."""
    widths = (16 // elem_size, 1)
    return next(v for v in widths
                if c % v == 0 and all(p % (v * elem_size) == 0
                                      for p in ptrs))


def _split(n: int) -> int:
    """The tile side that splits ``n`` pixels into the fewest even tiles of
    at most MAX_TILE."""
    return -(-n // -(-n // MAX_TILE))


def launch_shape(b: int, c: int, h: int, w: int, elem_size: int, sms: int,
                 *ptrs: int) -> tuple:
    """(vec, th, tw, cvb) of a launch on a card of ``sms`` SMs: the channel
    vector, the tile and the vectors a block takes. ``cvb`` is the widest
    whose tile fits the shared-memory budget and still gives BLOCKS_PER_SM
    blocks for each SM (else the narrowest that fits), so small batches
    spread over the card."""
    return _launch_shape(b, c, h, w, elem_size, sms,
                         *(p % 16 for p in ptrs))


@functools.lru_cache(maxsize=256)
def _launch_shape(b: int, c: int, h: int, w: int, elem_size: int, sms: int,
                  *ptrs: int) -> tuple:
    vec = _vector(c, elem_size, *ptrs)
    nv, th, tw = c // vec, _split(h), _split(w)
    tiles = -(-h // th) * -(-w // tw)

    def smem(cvb):                      # the three row maxima of a tile
        return 3 * (th + 2 * HALO) * tw * cvb * vec * elem_size

    fits = [cvb for cvb in CHUNKS if smem(cvb) <= SMEM_BUDGET]
    cvb = next((cvb for cvb in fits
                if b * tiles * -(-nv // cvb) >= BLOCKS_PER_SM * sms),
               fits[-1])
    return vec, th, tw, cvb


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def max_pool_chain(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Three chained ``max_pool2d`` and a concat: the library's version of
    the pyramid. Where a window's maximum is a zero and the window holds
    zeros of both signs, its sign is the first zero's in scan order."""
    y1 = F.max_pool2d(x, k, 1, k // 2)
    y2 = F.max_pool2d(y1, k, 1, k // 2)
    y3 = F.max_pool2d(y2, k, 1, k // 2)
    return torch.cat([x, y1, y2, y3], dim=1)


def sppf_pyramid_reference(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Plain PyTorch twin: :func:`max_pool_chain`, with the sign of a zero
    maximum set as ``jnp.maximum`` sets it in the JAX kernel: +0 where the
    window holds a +0 (the chained windows of the indicator of +0 say
    where), else -0."""
    out = max_pool_chain(x, k)
    plus = max_pool_chain(((x == 0) & ~torch.signbit(x)).to(x.dtype), k) > 0
    return torch.where((out == 0) & plus, out.abs(), out)


def _sppf_pyramid_cpu(x: torch.Tensor) -> torch.Tensor:
    # the twin, in the kernel's channels_last layout
    return sppf_pyramid_reference(x).contiguous(
        memory_format=torch.channels_last)


def _sppf_pyramid_cuda(x: torch.Tensor) -> torch.Tensor:
    if not _on_cuda(x):
        raise ValueError(f"sppf_pyramid: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sppf_pyramid: dtype {x.dtype}; want bfloat16 or "
                        "float32")
    if x.dim() != 4:
        raise ValueError(f"sppf_pyramid: x {tuple(x.shape)}; want "
                         "(B, C, H, W)")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("sppf_pyramid: x must be contiguous in "
                         "channels_last memory (NHWC)")
    b, c, h, w = x.shape
    out = torch.empty((b, 4 * c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    vec, th, tw, cvb = launch_shape(b, c, h, w, x.element_size(),
                                    _sm_count(x.device), x.data_ptr(),
                                    out.data_ptr())
    lib = build.load("sppf")
    build.launch(lib, "sppf_pyramid",
                 [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9,
                 (x.data_ptr(), out.data_ptr(), b, h, w, c // vec,
                  x.element_size(), vec, th, tw, cvb), x.device)
    build.count_launch(sppf_pyramid)
    return out


def _sppf_pyramid_fake(x):
    b, c, h, w = x.shape
    return torch.empty((b, 4 * c, h, w), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


_sppf_pyramid_op = define("sppf_pyramid(Tensor x) -> Tensor",
                          _sppf_pyramid_cpu, _sppf_pyramid_cuda,
                          _sppf_pyramid_fake)


def sppf_pyramid(x: torch.Tensor) -> torch.Tensor:
    """The pooling pyramid, the registered op ``sppf_pyramid`` (K5): the
    twin for CPU tensors, the CUDA kernel (``ops/cuda/csrc/sppf.cu``) for
    CUDA tensors, at any map size: the kernel works on tiles of at most
    16 × 16 pixels with a halo of 6. Inference only."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sppf_pyramid: unsupported device {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("sppf_pyramid: the kernel defines no gradient; "
                         "training takes the max_pool2d chain")
    return _sppf_pyramid_op(x)


sppf_pyramid.launches = 0
