"""PSA attention, differentiable: the CUDA kernels' wrappers and their
plain twins. The forward is a registered op
(``torch.ops.custom_yolo_tpu_torch.psa_attention_fwd``) whose autograd
formula is the backward wrapper, so ``torch.export`` keeps it whole and
training reaches both kernels.

Counterpart of ``custom_yolo_tpu/ops/pallas/attention_kernel.py``
(``psa_attention`` with its custom VJP, ``psa_attention_pallas``,
``_psa_attention_bwd_pallas`` and ``psa_attention_reference``). Token-major
qkv ``(B, T, nh·(2dk+dh))`` with per-head channels ``[q | k | v]`` →
``(out, v)``, each ``(B, T, nh·dh)``.

There is one route per device and dtype: a CUDA tensor goes through the
hand-written kernels (``ops/cuda/csrc/attention.cu`` forward,
``attention_bwd.cu`` backward; bfloat16 on the tensor cores, float32 on
the CUDA cores, both at any T), a CPU tensor
through the plain twins, in serving and in training alike. The JAX package
trains through its einsum path unless ``pallas_attention=True`` selects the
kernel pair; the port corresponds to ``pallas_attention=True`` and has no
flag for it. As there, only ``qkv``
is kept between forward and backward, and the softmax is recomputed.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from custom_yolo_tpu_torch.ops.cuda import LIB, OPS, build, define


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


def psa_attention_bwd_reference(qkv: torch.Tensor, dout: torch.Tensor,
                                dv: torch.Tensor, num_heads: int,
                                dim_key: int, dim_head: int) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: ``d(out), d(v) → d(qkv)``
    written out, with the softmax recomputed from ``qkv`` and the
    reference's rounding points (``_attn_bwd_kernel``): fp32 scores and
    softmax ``p32``; ``dv = round(p32)ᵀ·do`` summed in fp32 plus the
    positional branch's ``dv``, rounded once; ``dp = do·vᵀ`` in fp32;
    ``ds = p32 ⊙ (dp − rowsum(dp ⊙ p32)) · scale`` rounded to the input
    type; ``dq = ds·k`` and ``dk = dsᵀ·q`` summed in fp32 and rounded."""
    b, t, _ = qkv.shape
    dtype = qkv.dtype
    scale = dim_key ** -0.5
    qkv4 = qkv.reshape(b, t, num_heads, 2 * dim_key + dim_head).float()
    q = qkv4[..., :dim_key]
    k = qkv4[..., dim_key:2 * dim_key]
    v = qkv4[..., 2 * dim_key:]
    do = dout.reshape(b, t, num_heads, dim_head).float()
    dv_pos = dv.reshape(b, t, num_heads, dim_head).float()
    p32 = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    pb = p32.to(dtype).float()
    dv_attn = torch.einsum("bhqk,bqhe->bkhe", pb, do)
    dp = torch.einsum("bqhe,bkhe->bhqk", do, v)
    delta = (dp * p32).sum(dim=-1, keepdim=True)
    ds = (p32 * (dp - delta) * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dqkv = torch.cat([dq.to(dtype), dk.to(dtype),
                      (dv_attn + dv_pos).to(dtype)], dim=-1)
    return dqkv.reshape(b, t, -1)


def _check_cuda_qkv(name: str, qkv: torch.Tensor, num_heads: int,
                    dim_key: int, dim_head: int) -> None:
    """What both kernels ask of ``qkv`` off the CPU; raises otherwise."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {qkv.dtype} is not bfloat16 or "
                        "float32")
    per_head = 2 * dim_key + dim_head
    if qkv.dim() != 3 or qkv.shape[2] != num_heads * per_head:
        raise ValueError(f"{name}: qkv shape {tuple(qkv.shape)} is not "
                         f"(B, T, {num_heads}·{per_head})")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")


def _psa_attention_fwd_cpu(qkv: torch.Tensor, num_heads: int, dim_key: int,
                           dim_head: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    out, v = psa_attention_reference(qkv, num_heads, dim_key, dim_head)
    # an op's outputs may not alias its input, and the twin's v is a view
    # of qkv where there is one head
    return out, v.clone()


def _psa_attention_fwd_cuda(qkv: torch.Tensor, num_heads: int, dim_key: int,
                            dim_head: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_qkv("psa_attention", qkv, num_heads, dim_key, dim_head)
    b, t, _ = qkv.shape
    lib = build.load("attention")
    max_dk = build.query(lib, "psa_attention_max_dk", [], ctypes.c_int)
    max_dh = build.query(lib, "psa_attention_max_dh", [], ctypes.c_int)
    if dim_key > max_dk or dim_head > max_dh:
        raise ValueError(f"psa_attention: dk={dim_key} must be ≤ {max_dk} "
                         f"and dh={dim_head} ≤ {max_dh}")
    out = torch.empty(b, t, num_heads * dim_head, dtype=qkv.dtype,
                      device=qkv.device)
    v = torch.empty_like(out)
    build.launch(lib, "psa_attention_fwd",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_int],
                 (qkv.data_ptr(), out.data_ptr(), v.data_ptr(), b, t,
                  num_heads, dim_key, dim_head, dim_key ** -0.5,
                  int(qkv.dtype == torch.bfloat16)), qkv.device)
    build.count_launch(psa_attention)
    return out, v


def _psa_attention_fwd_fake(qkv, num_heads, dim_key, dim_head):
    b, t, _ = qkv.shape
    out = qkv.new_empty(b, t, num_heads * dim_head)
    return out, torch.empty_like(out)


_psa_attention_fwd_op = define(
    "psa_attention_fwd(Tensor qkv, int num_heads, int dim_key, "
    "int dim_head) -> (Tensor, Tensor)",
    _psa_attention_fwd_cpu, _psa_attention_fwd_cuda, _psa_attention_fwd_fake)


def psa_attention_fwd(qkv: torch.Tensor, num_heads: int, dim_key: int,
                      dim_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PSA attention forward, the registered op (K1): the twin for a CPU
    tensor, the CUDA kernel (``ops/cuda/csrc/attention.cu``) for a CUDA
    tensor, whose launch it counts. ``torch.export`` keeps the op whole."""
    return _psa_attention_fwd_op(qkv, num_heads, dim_key, dim_head)


def psa_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, dv: torch.Tensor,
                      num_heads: int, dim_key: int,
                      dim_head: int) -> torch.Tensor:
    """PSA attention backward, ``d(out), d(v) → d(qkv)``: the twin for CPU
    tensors, the CUDA kernels (``ops/cuda/csrc/attention_bwd.cu``) for CUDA
    tensors. Counts one launch per call (the source's two kernels run back
    to back on the current stream)."""
    if qkv.device.type == "cpu":
        return psa_attention_bwd_reference(qkv, dout, dv, num_heads, dim_key,
                                           dim_head)
    name = "psa_attention_bwd"
    _check_cuda_qkv(name, qkv, num_heads, dim_key, dim_head)
    b, t, _ = qkv.shape
    for label, grad in (("dout", dout), ("dv", dv)):
        if grad.device != qkv.device or grad.dtype != qkv.dtype:
            raise ValueError(f"{name}: {label} is {grad.dtype} on "
                             f"{grad.device}, qkv {qkv.dtype} on "
                             f"{qkv.device}")
        if tuple(grad.shape) != (b, t, num_heads * dim_head):
            raise ValueError(f"{name}: {label} shape {tuple(grad.shape)} is "
                             f"not {(b, t, num_heads * dim_head)}")
        if not grad.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    lib = build.load("attention_bwd")
    max_dk = build.query(lib, "psa_attention_bwd_max_dk", [], ctypes.c_int)
    max_dh = build.query(lib, "psa_attention_bwd_max_dh", [], ctypes.c_int)
    if dim_key > max_dk or dim_head > max_dh:
        raise ValueError(f"{name}: dk={dim_key} must be ≤ {max_dk} and "
                         f"dh={dim_head} ≤ {max_dh}")
    dqkv = torch.empty_like(qkv)
    # per (b, head, query row): softmax row maximum, row sum, delta
    stats = torch.empty(b, num_heads, t, 3, dtype=torch.float32,
                        device=qkv.device)
    build.launch(lib, "psa_attention_bwd",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_int],
                 (qkv.data_ptr(), dout.data_ptr(), dv.data_ptr(),
                  dqkv.data_ptr(), stats.data_ptr(), b, t, num_heads,
                  dim_key, dim_head, dim_key ** -0.5,
                  int(qkv.dtype == torch.bfloat16)), qkv.device)
    build.count_launch(psa_attention_bwd)
    return dqkv


def _save_qkv(ctx, inputs, output):
    qkv, num_heads, dim_key, dim_head = inputs
    ctx.save_for_backward(qkv)
    ctx.dims = (num_heads, dim_key, dim_head)


def _psa_attention_backward(ctx, dout, dv):
    """K4 (:func:`psa_attention_bwd`) from the saved ``qkv`` alone; the
    softmax is recomputed. Both cotangents are consumed (``v`` feeds the
    positional depthwise conv); autograd hands an unused output's
    cotangent over as zeros."""
    (qkv,) = ctx.saved_tensors
    dqkv = psa_attention_bwd(qkv, dout.contiguous(), dv.contiguous(),
                             *ctx.dims)
    return dqkv, None, None, None


torch.library.register_autograd(f"{OPS}::psa_attention_fwd",
                                _psa_attention_backward,
                                setup_context=_save_qkv, lib=LIB)


def psa_attention(qkv: torch.Tensor, num_heads: int, dim_key: int,
                  dim_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable PSA attention: the registered forward op
    (:func:`psa_attention_fwd`, K1) with the hand-written backward (K4),
    the kernels on a CUDA tensor, the twins on a CPU tensor."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"psa_attention: unsupported device {qkv.device}")
    return _psa_attention_fwd_op(qkv, num_heads, dim_key, dim_head)


# kernel launches: the forward's on psa_attention, the backward's on
# psa_attention_bwd
psa_attention.launches = 0
psa_attention_bwd.launches = 0
