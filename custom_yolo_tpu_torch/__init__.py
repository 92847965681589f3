"""custom_yolo_tpu_torch — the PyTorch/CUDA port of ``custom_yolo_tpu``.

The same YOLO detector (CSP backbone, SPPF + PSA attention, FPN-PAN neck,
anchor-free DFL head, class-aware batched NMS) served, trained and
evaluated on an NVIDIA Hopper card. Plain tensor work runs through PyTorch;
the hand-written kernels (PSA attention forward and backward, batched and
single-image greedy-NMS keep masks, the SPPF pooling pyramid, the fused cls
tower of the head, seeded stochastic rounding to int8) are CUDA C++ for
``sm_90a`` under ``ops/cuda/csrc``, each with a plain PyTorch twin that
tensors on the CPU take. ``ops/quant.py`` holds int8 serving (per-channel
weights, dynamic or calibrated activation scales). ``train/``
holds the assigners, the detection loss, AdamW with the plateau schedule,
the train state, the train and eval steps and the ``Trainer``; ``data/``
the on-device augmentation, the parquet dataset and the threaded loader
(``runtime/``: its native JPEG decoder); ``eval/`` the prediction decode
and the greedy and COCO-protocol metrics; ``config.py`` the typed YAML
configuration; ``utils/`` checkpoints, logging and the carrying of JAX
weights.

Public layouts follow the JAX package: images NHWC, predictions
anchor-major ``(N, M, 4·reg_max + nc)``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from custom_yolo_tpu_torch.models.detector import (  # noqa: F401
    Detector, YoloModel)
from custom_yolo_tpu_torch.models.presets import PRESETS  # noqa: F401
