"""Greedy-NMS keep mask: the CUDA kernels' wrappers and their plain twin.

Counterpart of ``custom_yolo_tpu/ops/pallas/nms_kernel.py::
nms_keep_pallas_batched`` (:func:`nms_keep_batched`) and ``nms_keep_pallas``
(:func:`nms_keep_single`), and of ``custom_yolo_tpu/ops/nms.py::_suppress``.
Boxes ``(N, K, 4)`` xyxy, score-sorted and class-offset; ``valid (N, K)``
bool → ``keep (N, K)`` bool, the exact sequential greedy keep-set.
:func:`nms_keep` sends one image to the single-image kernels and a batch
to the batched one; both give the same keep-set as the twin.
"""

from __future__ import annotations

import ctypes

import torch

from custom_yolo_tpu_torch.ops.boxes import box_iou_pairwise
from custom_yolo_tpu_torch.ops.cuda import build


def nms_keep_reference(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float) -> torch.Tensor:
    """Plain PyTorch twin: the (K, K) IoU matrix per image, then the
    greedy sweep — a kept box clears every later box it overlaps above
    ``iou_thres`` (fp32, strict ``>``)."""
    iou = box_iou_pairwise(boxes, boxes)                    # (N, K, K)
    keep = valid.clone()
    k = boxes.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    for i in range(k):
        keep &= ~((iou[:, i] > iou_thres) & later[i] & keep[:, i:i + 1])
    return keep


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_keep: boxes on {boxes.device} and valid on "
                         f"{valid.device}; both must be on one CUDA device")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep: boxes {boxes.dtype} / valid "
                        f"{valid.dtype}; want float32 / bool")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"nms_keep: boxes {tuple(boxes.shape)} / valid "
                         f"{tuple(valid.shape)}; want (N, K, 4) / (N, K)")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep: boxes and valid must be contiguous")


def nms_keep_batched(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_thres: float) -> torch.Tensor:
    """One block per image (``nms_keep_kernel`` of ``ops/cuda/csrc/nms.cu``):
    the twin for CPU tensors, the kernel for CUDA tensors."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, iou_thres)
    _check(boxes, valid)
    n, k, _ = boxes.shape
    keep = torch.empty(n, k, dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    lib = build.load("nms")
    need = build.query(lib, "nms_keep_smem_bytes", [ctypes.c_int],
                       ctypes.c_longlong, k)
    if need > build.SMEM_LIMIT:
        raise ValueError(
            f"nms_keep: a pool of K={k} needs {need} bytes of shared memory "
            f"for boxes, areas and flags; the limit is {build.SMEM_LIMIT} "
            f"(K ≤ {build.SMEM_LIMIT // 24})")
    build.launch(lib, "nms_keep_batched",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float],
                 (boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), n, k,
                  iou_thres), boxes.device)
    nms_keep_batched.launches += 1
    return keep


def nms_keep_single(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """The bitmask route (``nms_mask_kernel`` + ``nms_sweep_kernel`` of
    ``ops/cuda/csrc/nms.cu``), which spreads one image's IoU tests over the
    card: the twin for CPU tensors, the kernels for CUDA tensors."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, iou_thres)
    _check(boxes, valid)
    n, k, _ = boxes.shape
    keep = torch.empty(n, k, dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    lib = build.load("nms")
    need = build.query(lib, "nms_sweep_smem_bytes", [ctypes.c_int],
                       ctypes.c_longlong, k)
    if need > build.SMEM_LIMIT:
        raise ValueError(
            f"nms_keep: a pool of K={k} needs {need} bytes of shared memory "
            f"for 64 rows of the bit matrix; the limit is {build.SMEM_LIMIT} "
            f"(K ≤ {64 * (build.SMEM_LIMIT // 520)})")
    words = (k + 63) // 64
    mask = torch.empty(n, k, words, dtype=torch.int64, device=boxes.device)
    build.launch(lib, "nms_keep_bitmask",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float],
                 (boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                  mask.data_ptr(), n, k, iou_thres), boxes.device)
    nms_keep_single.launches += 1
    return keep


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask: one image goes to :func:`nms_keep_single`, a
    batch to :func:`nms_keep_batched`."""
    if boxes.dim() == 3 and boxes.shape[0] == 1:
        return nms_keep_single(boxes, valid, iou_thres)
    return nms_keep_batched(boxes, valid, iou_thres)


nms_keep_batched.launches = 0
nms_keep_single.launches = 0
