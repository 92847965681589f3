"""custom_yolo_tpu_torch — the PyTorch/CUDA port of ``custom_yolo_tpu``.

The same YOLO detector (CSP backbone, SPPF + PSA attention, FPN-PAN neck,
anchor-free DFL head, class-aware batched NMS) served and trained on an
NVIDIA Hopper card. Plain tensor work runs through PyTorch; the
hand-written kernels of the serving and training paths (PSA attention
forward and backward, batched greedy-NMS keep mask) are CUDA C++ for
``sm_90a`` under ``ops/cuda/csrc``, each with a plain PyTorch twin that
tensors on the CPU take. ``train/`` holds the assigners, the detection
loss, AdamW with the plateau schedule, the train state and the train and
eval steps.

Public layouts follow the JAX package: images NHWC, predictions
anchor-major ``(N, M, 4·reg_max + nc)``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from custom_yolo_tpu_torch.models.detector import (  # noqa: F401
    Detector, YoloModel)
from custom_yolo_tpu_torch.models.presets import PRESETS  # noqa: F401
