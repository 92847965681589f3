"""Seeded stochastic rounding to int8: the CUDA kernel's wrapper and its
plain twin.

Counterpart of the ``pallas_call`` in ``custom_yolo_tpu/ops/quant.py::
stochastic_quantize_int8`` (kernel ``_stochastic_round_kernel``). It takes
``flat``, a float32 matrix already divided by its per-channel scale and
clipped to ±127, and returns ``clip(floor(flat + u), -127, 127)`` as int8,
with ``u`` uniform in [0, 1).

Each element draws ``u`` from Philox4x32-10, keyed by the seed, at the
counter of its flat (row-major) index within its array: ``u = (word0 >> 8)
· 2⁻²⁴``. :func:`stochastic_round_many` rounds many arrays (a model's int8
leaves) in one launch; :func:`stochastic_round` is that for one. The
kernel (``ops/cuda/csrc/quant.cu``) and :func:`stochastic_round_reference`
compute the same stream, so they agree bit for bit. Neither matches the JAX
package's own streams (the TPU core's generator on a TPU, ``jax.random``
elsewhere); :func:`stochastic_round_given` takes the uniforms from the
caller, which is how the tests hold the rounding to JAX's.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

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


# elements a thread and a block of the kernel take (its PER_THREAD and
# BLOCK_ELEMS; the C entry point checks the latter)
PER_THREAD = 8
BLOCK_ELEMS = 256 * PER_THREAD
# each result starts on a 16-byte boundary of one int8 buffer
_ALIGN = 16


def _on_one_cuda_device(flats: Sequence[torch.Tensor],
                        device: torch.device) -> bool:
    return device.type == "cuda" and all(f.device == device for f in flats)


def leaf_table(flats: Sequence[torch.Tensor], outs: Sequence[torch.Tensor]
               ) -> Tuple[list, int]:
    """The kernel's table of leaves, one row (source address, destination
    address, elements, first block) for each non-empty array, and the
    blocks of all of them; a leaf takes ⌈n / BLOCK_ELEMS⌉ blocks."""
    rows, blocks = [], 0
    for flat, out in zip(flats, outs):
        if flat.numel():
            rows.append((flat.data_ptr(), out.data_ptr(), flat.numel(),
                         blocks))
            blocks += -(-flat.numel() // BLOCK_ELEMS)
    return rows, blocks


def stochastic_round_many(flats: Sequence[torch.Tensor], seed: int
                          ) -> List[torch.Tensor]:
    """Stochastic rounding of each float32 array of ``flats`` to int8 under
    ``seed``, each drawing its uniforms at its own flat indices (so each
    result equals :func:`stochastic_round_reference` of that array alone):
    the twins for CPU tensors, one launch of the CUDA kernel
    (``ops/cuda/csrc/quant.cu``) over all of them for CUDA tensors, whose
    results are views of one int8 buffer."""
    flats = list(flats)
    k0, k1 = _key(seed)
    if all(flat.device.type == "cpu" for flat in flats):
        return [stochastic_round_reference(flat, seed) for flat in flats]
    device = flats[0].device
    if not _on_one_cuda_device(flats, device):
        raise ValueError("stochastic_round: unsupported devices "
                         f"{sorted({str(f.device) for f in flats})} (all "
                         "arrays on one CUDA device or all on the CPU)")
    for flat in flats:
        if flat.dtype != torch.float32:
            raise TypeError(f"stochastic_round: dtype {flat.dtype}; want "
                            "float32")
        if not flat.is_contiguous():
            raise ValueError("stochastic_round: each array must be "
                             "contiguous")
    # one allocation for all results, each on a 16-byte boundary
    sizes = []
    for flat in flats:
        sizes += [flat.numel(), -flat.numel() % _ALIGN]
    parts = torch.empty(sum(sizes), dtype=torch.int8,
                        device=device).split(sizes)
    outs = [part.view(flat.shape) for part, flat in zip(parts[::2], flats)]
    rows, blocks = leaf_table(flats, outs)
    if not rows:
        return outs
    # the table of leaves (quant.cu's Leaf rows), in one asynchronous copy
    # to the card from pinned memory; both allocators hand their memory on
    # only to work queued after the kernel
    table = torch.tensor(rows, dtype=torch.int64,
                         pin_memory=device.type == "cuda").to(
                             device, non_blocking=True)
    lib = build.load("quant")
    build.launch(lib, "stochastic_round_int8_grouped",
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32],
                 (table.data_ptr(), len(rows), blocks, BLOCK_ELEMS, k0, k1),
                 device)
    build.count_launch(stochastic_round_many)
    return outs


stochastic_round_many.launches = 0


def stochastic_round(flat: torch.Tensor, seed: int) -> torch.Tensor:
    """Stochastic rounding of one float32 array ``flat`` to int8 under
    ``seed``: :func:`stochastic_round_many` of a list of one."""
    return stochastic_round_many([flat], seed)[0]
