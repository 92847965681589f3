"""Greedy-NMS keep mask: the CUDA kernels' wrappers and their plain twin.

Counterpart of ``custom_yolo_tpu/ops/pallas/nms_kernel.py::
nms_keep_pallas_batched`` (:func:`nms_keep_batched`) and ``nms_keep_pallas``
(:func:`nms_keep_single`), and of ``custom_yolo_tpu/ops/nms.py::_suppress``.
Boxes ``(N, K, 4)`` xyxy, score-sorted and class-offset; ``valid (N, K)``
bool → ``keep (N, K)`` bool, the exact sequential greedy keep-set, for
any pool size K. :func:`nms_keep` sends one image to
:func:`nms_keep_single` and a batch to :func:`nms_keep_batched`; both
launch the same kernels and give the same keep-set as the twin. Both are
registered ops (``torch.ops.custom_yolo_tpu_torch.nms_keep_*``), so
``torch.export`` keeps each whole instead of unrolling the twin's sweep.
"""

from __future__ import annotations

import ctypes

import torch

from custom_yolo_tpu_torch.ops.boxes import box_iou_pairwise
from custom_yolo_tpu_torch.ops.cuda import build, define


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


# removed words of one image that the sweep keeps in shared memory (K up to
# 64 × this); a larger pool keeps them in the global scratch. The kernel's
# own buffer caps it (nms.cu REMOVED_CAP); chip_smoke.py sets it to 0 to
# drive the global path at small K.
SHARED_REMOVED_WORDS = 1024


def _on_one_cuda_device(boxes: torch.Tensor, valid: torch.Tensor) -> bool:
    """The device test of :func:`_check`, apart so that a test on a machine
    without CUDA can stand in for it."""
    return boxes.device.type == "cuda" and valid.device == boxes.device


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if not _on_one_cuda_device(boxes, valid):
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


def _launch(boxes: torch.Tensor, valid: torch.Tensor,
            iou_thres: float) -> torch.Tensor:
    """``nms_keep_bitmask`` of ``ops/cuda/csrc/nms.cu`` on CUDA tensors:
    the bit matrix over the whole card, then one sweeping block per image.
    Any K: the scratch (the matrix, the column words of its diagonal, then
    the removed words of pools beyond shared memory) is one allocation, and
    a pool whose matrix does not fit in device memory fails there."""
    _check(boxes, valid)
    n, k, _ = boxes.shape
    keep = torch.empty(n, k, dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    words = (k + 63) // 64
    scratch = torch.empty(n * (words * (k + 1) + k), dtype=torch.int64,
                          device=boxes.device)
    build.launch(build.load("nms"), "nms_keep_bitmask",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_float, ctypes.c_int],
                 (boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                  scratch.data_ptr(), n, k, iou_thres, SHARED_REMOVED_WORDS),
                 boxes.device)
    return keep


def _nms_keep_cpu(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_thres: float) -> torch.Tensor:
    return nms_keep_reference(boxes, valid, iou_thres)


def _nms_keep_batched_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    keep = _launch(boxes, valid, iou_thres)
    if keep.numel():
        build.count_launch(nms_keep_batched)
    return keep


def _nms_keep_single_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    keep = _launch(boxes, valid, iou_thres)
    if keep.numel():
        build.count_launch(nms_keep_single)
    return keep


def _nms_keep_fake(boxes, valid, iou_thres):
    return torch.empty_like(valid)


_nms_keep_batched_op = define(
    "nms_keep_batched(Tensor boxes, Tensor valid, float iou_thres) -> Tensor",
    _nms_keep_cpu, _nms_keep_batched_cuda, _nms_keep_fake)
_nms_keep_single_op = define(
    "nms_keep_single(Tensor boxes, Tensor valid, float iou_thres) -> Tensor",
    _nms_keep_cpu, _nms_keep_single_cuda, _nms_keep_fake)


def _refuse_other_devices(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    """A CPU pool takes the twin; any other must lie on one CUDA device
    (a meta tensor would reach the ops' fake implementation)."""
    if boxes.device.type != "cpu" and not _on_one_cuda_device(boxes, valid):
        raise ValueError(f"nms_keep: boxes on {boxes.device} and valid on "
                         f"{valid.device}; both must be on one CUDA device")


def nms_keep_batched(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_thres: float) -> torch.Tensor:
    """The keep masks of a batch of images through the registered op
    ``nms_keep_batched``: the twin for CPU tensors, the kernels
    (``nms_keep_bitmask`` of ``ops/cuda/csrc/nms.cu``) for CUDA tensors."""
    _refuse_other_devices(boxes, valid)
    return _nms_keep_batched_op(boxes, valid, iou_thres)


def nms_keep_single(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """The keep mask of the one image of a request through the registered
    op ``nms_keep_single``: the same kernels as :func:`nms_keep_batched`,
    counted apart, so a run shows which path took them; the twin for CPU
    tensors."""
    _refuse_other_devices(boxes, valid)
    return _nms_keep_single_op(boxes, valid, iou_thres)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask: one image goes to :func:`nms_keep_single`, a
    batch to :func:`nms_keep_batched`."""
    if boxes.dim() == 3 and boxes.shape[0] == 1:
        return nms_keep_single(boxes, valid, iou_thres)
    return nms_keep_batched(boxes, valid, iou_thres)


nms_keep_batched.launches = 0
nms_keep_single.launches = 0
