"""PSA attention forward: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``custom_yolo_tpu/ops/pallas/attention_kernel.py``
(``psa_attention_pallas`` and ``psa_attention_reference``). Token-major
qkv ``(B, T, nh·(2dk+dh))`` with per-head channels ``[q | k | v]`` →
``(out, v)``, each ``(B, T, nh·dh)``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from custom_yolo_tpu_torch.ops.cuda import build


def psa_attention_reference(qkv: torch.Tensor, num_heads: int, dim_key: int,
                            dim_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin with the reference's rounding points: fp32
    scores and softmax over exact products of the input-type values, ``p``
    rounded to the input type, ``p·v`` summed in fp32 and rounded."""
    b, t, _ = qkv.shape
    scale = dim_key ** -0.5
    qkv4 = qkv.reshape(b, t, num_heads, 2 * dim_key + dim_head)
    q = qkv4[..., :dim_key].float()
    k = qkv4[..., dim_key:2 * dim_key].float()
    v = qkv4[..., 2 * dim_key:]
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
    return (out.to(qkv.dtype).reshape(b, t, num_heads * dim_head),
            v.reshape(b, t, num_heads * dim_head))


def psa_attention(qkv: torch.Tensor, num_heads: int, dim_key: int,
                  dim_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSA attention forward: the twin for a CPU tensor, the CUDA kernel
    (``ops/cuda/csrc/attention.cu``) for a CUDA tensor."""
    if qkv.device.type == "cpu":
        return psa_attention_reference(qkv, num_heads, dim_key, dim_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"psa_attention: unsupported device {qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"psa_attention: dtype {qkv.dtype} is not bfloat16 "
                        "or float32")
    per_head = 2 * dim_key + dim_head
    if qkv.dim() != 3 or qkv.shape[2] != num_heads * per_head:
        raise ValueError(f"psa_attention: qkv shape {tuple(qkv.shape)} is "
                         f"not (B, T, {num_heads}·{per_head})")
    if not qkv.is_contiguous():
        raise ValueError("psa_attention: qkv must be contiguous")
    b, t, _ = qkv.shape
    lib = build.load("attention")
    smem_bytes = lib.psa_attention_smem_bytes
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem_bytes.restype = ctypes.c_longlong
    need = smem_bytes(t, dim_key)
    if need > build.SMEM_LIMIT:
        t_max = (build.SMEM_LIMIT // 4 - 33 * dim_key) // (dim_key + 32)
        raise ValueError(
            f"psa_attention: T={t} tokens at dk={dim_key} needs {need} bytes "
            f"of shared memory for a 32-row score tile plus kᵀ; the limit is "
            f"{build.SMEM_LIMIT} (T ≤ {t_max})")
    max_dh = lib.psa_attention_max_dh()
    if dim_head > max_dh or dim_key * (t + 1) < dim_head:
        raise ValueError(f"psa_attention: dh={dim_head} must be ≤ {max_dh} "
                         f"and ≤ dk·(T+1) = {dim_key * (t + 1)}")
    out = torch.empty(b, t, num_heads * dim_head, dtype=qkv.dtype,
                      device=qkv.device)
    v = torch.empty_like(out)
    fn = lib.psa_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(qkv.data_ptr(), out.data_ptr(), v.data_ptr(), b, t,
                num_heads, dim_key, dim_head, dim_key ** -0.5,
                int(qkv.dtype == torch.bfloat16),
                torch.cuda.current_stream(qkv.device).cuda_stream)
    build.check(lib, status, "psa_attention_fwd launch")
    psa_attention.launches += 1
    return out, v


psa_attention.launches = 0
