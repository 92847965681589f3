"""Seeded stochastic rounding to int8: the CUDA kernel's wrapper and its
plain twin.

Counterpart of the ``pallas_call`` in ``custom_yolo_tpu/ops/quant.py::
stochastic_quantize_int8`` (kernel ``_stochastic_round_kernel``). It takes
``flat``, a float32 matrix already divided by its per-channel scale and
clipped to ±127, and returns ``clip(floor(flat + u), -127, 127)`` as int8,
with ``u`` uniform in [0, 1).

Each element draws ``u`` from Philox4x32-10, keyed by the seed, at the
counter of its flat (row-major) index: ``u = (word0 >> 8) · 2⁻²⁴``. The
kernel (``ops/cuda/csrc/quant.cu``) and :func:`stochastic_round_reference`
compute the same stream, so they agree bit for bit. Neither matches the JAX
package's own streams (the TPU core's generator on a TPU, ``jax.random``
elsewhere); :func:`stochastic_round_given` takes the uniforms from the
caller, which is how the tests hold the rounding to JAX's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from custom_yolo_tpu_torch.ops.cuda import build

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a · m`` for uint32 values held in
    int64, from 16-bit limbs: the full product overflows int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = ((a_hi * m_lo + a_lo * m_hi) << 16) + a_lo * m_lo      # < 2⁵⁰
    return a_hi * m_hi + (mid >> 32), mid & _MASK32


def philox4x32_10(counter: Tuple[torch.Tensor, ...], key: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 in plain integer arithmetic: four int64 tensors of
    uint32 counter words and a key of two uint32 words → the four output
    words, as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _key(seed: int) -> Tuple[int, int]:
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return seed & _MASK32, seed >> 32


def philox_uniforms(n: int, seed: int, device=None) -> torch.Tensor:
    """The ``n`` float32 uniforms in [0, 1) that the kernel draws for
    elements 0 … n−1 under ``seed``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    word0 = philox4x32_10((idx & _MASK32, idx >> 32, zero, zero),
                          _key(seed))[0]
    return (word0 >> 8).to(torch.float32) * 2.0 ** -24


def stochastic_round_given(flat: torch.Tensor, u: torch.Tensor
                           ) -> torch.Tensor:
    """``clip(floor(flat + u), -127, 127)`` as int8, for uniforms ``u`` of
    the caller's (the JAX fallback's formula)."""
    return torch.clamp(torch.floor(flat + u), -127, 127).to(torch.int8)


def stochastic_round_reference(flat: torch.Tensor, seed: int
                               ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same Philox stream, on any
    device."""
    u = philox_uniforms(flat.numel(), seed, flat.device).view(flat.shape)
    return stochastic_round_given(flat, u)


def stochastic_round(flat: torch.Tensor, seed: int) -> torch.Tensor:
    """Stochastic rounding of float32 ``flat`` to int8 under ``seed``: the
    twin for CPU tensors, the CUDA kernel (``ops/cuda/csrc/quant.cu``) for
    CUDA tensors."""
    if flat.device.type == "cpu":
        return stochastic_round_reference(flat, seed)
    if flat.device.type != "cuda":
        raise ValueError(f"stochastic_round: unsupported device {flat.device}")
    if flat.dtype != torch.float32:
        raise TypeError(f"stochastic_round: dtype {flat.dtype}; want float32")
    if not flat.is_contiguous():
        raise ValueError("stochastic_round: flat must be contiguous")
    k0, k1 = _key(seed)
    out = torch.empty(flat.shape, dtype=torch.int8, device=flat.device)
    if out.numel() == 0:
        return out
    lib = build.load("quant")
    build.launch(lib, "stochastic_round_int8",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_uint32, ctypes.c_uint32],
                 (flat.data_ptr(), out.data_ptr(), flat.numel(), k0, k1),
                 flat.device)
    stochastic_round.launches += 1
    return out


stochastic_round.launches = 0
