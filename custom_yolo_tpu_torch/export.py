"""Deployment artifacts: the serving pipeline as a ``torch.export`` program
(counterpart of ``custom_yolo_tpu/export.py``).

``export_serving`` traces the body of :meth:`Detector.serve` (forward +
DFL decode + class-aware batched NMS, ``models.detector.serve_pipeline``)
with ``torch.export`` at a fixed batch and writes ``serving.pt2``
(``torch.export.save``; the weights travel inside it) and
``manifest.json``; ``load_exported`` restores a callable from that
directory without the model code or a checkpoint.

The hand-written kernels are registered ops
(``torch.ops.custom_yolo_tpu_torch.*``: PSA attention, the SPPF pyramid,
the cls-tower stage, the batched and single-image NMS keep masks), so the
exported graph holds one node for each launch instead of the plain
twins' arithmetic, on the CPU as on the card; running the artifact on a
CUDA input launches the kernels (and counts their launches). The
artifact therefore needs ``torch`` and this package's op library, whose
kernels are built from the repository's sources at first use, where the
JAX artifact needs only a JAX runtime. It is bound to the device type it
was exported on (the manifest's ``platforms``): export on the target.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from custom_yolo_tpu_torch.models.detector import serve_pipeline
# the op modules register the kernels' ops, which loading a program needs
from custom_yolo_tpu_torch.ops import (attention, head_kernel,  # noqa: F401
                                       nms_kernel, sppf_kernel)
from custom_yolo_tpu_torch.ops.nms import NMSResult

_BLOB = "serving.pt2"
_MANIFEST = "manifest.json"


class _ServingProgram(nn.Module):
    """The module ``torch.export`` traces: a preprocessed NHWC batch → the
    :class:`NMSResult` fields as a tuple."""

    def __init__(self, model: nn.Module, reg_max: int, nms: Dict[str, Any]):
        super().__init__()
        self.model = model
        self.reg_max = reg_max
        self.nms = nms

    def forward(self, images: torch.Tensor):
        return tuple(serve_pipeline(self.model, images, self.reg_max,
                                    **self.nms))


def export_serving(detector, path: str, batch_size: int = 1,
                   conf_thres: float = 0.25, iou_thres: float = 0.45,
                   max_det: int = 300, top_k: int = 1024,
                   merge: bool = False,
                   class_filter: Optional[Tuple[int, ...]] = None,
                   multi_label: bool = False) -> str:
    """Write ``detector``'s whole serving pipeline at a fixed
    ``batch_size`` (weights inside) to the directory ``path``; returns
    ``path``.

    The exported function maps a preprocessed NHWC batch
    ``(batch_size, H, W, 3)`` in the detector's compute dtype, on its
    device, to the fixed-shape :class:`NMSResult` of ``detector.serve``
    with the same arguments."""
    assert detector.model is not None, "call .init() or load weights"
    h, w = detector.input_size
    nms = {"conf_thres": conf_thres, "iou_thres": iou_thres,
           "max_det": max_det, "top_k": top_k, "merge": merge,
           "class_filter": tuple(class_filter) if class_filter else None,
           "multi_label": multi_label}
    dtype = detector.policy.compute_dtype
    example = torch.zeros(batch_size, h, w, 3, dtype=dtype,
                          device=detector.device)
    program = _ServingProgram(detector.model, detector.reg_max, nms)
    with torch.no_grad():
        exported = torch.export.export(program, (example,), strict=False)

    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _BLOB))
    manifest: Dict[str, Any] = {
        "format": "torch.export",
        "platforms": [detector.device.type],
        "input_shape": [batch_size, h, w, 3],
        "input_dtype": str(dtype).removeprefix("torch."),
        "output": "NMSResult(boxes,scores,classes,valid,num_valid)",
        "num_classes": detector.num_classes,
        "nms": {**nms, "class_filter": list(class_filter)
                if class_filter else None},
        "transforms": detector._transform_flags(),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


class ExportedServer:
    """Callable restored from an :func:`export_serving` artifact: no model
    code or checkpoint needed, only ``torch`` and this package's ops on a
    host with the artifact's device type."""

    def __init__(self, path: str):
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        here = {"cpu"} | ({"cuda"} if torch.cuda.is_available() else set())
        platforms = self.manifest["platforms"]
        if not here & set(platforms):
            raise RuntimeError(
                f"artifact was exported for {platforms}, this host runs "
                f"{sorted(here)} — re-export on the target platform")
        self.device = torch.device(platforms[0])
        self.dtype = getattr(torch, self.manifest["input_dtype"])
        program = torch.export.load(os.path.join(path, _BLOB))
        tensors = [*program.state_dict.values(),
                   *program.constants.values()]
        # torch.export.load may give a CUDA program's tensors back on the
        # CPU (seen with torch 2.11); they are moved to the exporting
        # device once
        self.weights_moved = any(isinstance(t, torch.Tensor)
                                 and t.device.type != self.device.type
                                 for t in tensors)
        if self.weights_moved:
            program = move_to_device_pass(program, self.device)
        self.program = program
        self._module = program.module()

    def __call__(self, images) -> NMSResult:
        shape = tuple(self.manifest["input_shape"])
        images = torch.as_tensor(images).to(self.device, self.dtype)
        if tuple(images.shape) != shape:
            raise ValueError(f"expected input {shape}, got "
                             f"{tuple(images.shape)}")
        with torch.inference_mode():
            return NMSResult(*self._module(images))


def load_exported(path: str) -> ExportedServer:
    return ExportedServer(path)
