"""K3, single-image greedy NMS (``ops/cuda/csrc/nms.cu``, the same two
kernels as K2 on one pool; ``Detector.inference``). The bound of
:mod:`k2_nms` at one image. Not read by a metric yet: no cell serves one
image."""

from perfbench import peaks

TRACE_NAMES = ("nms_mask_kernel", "nms_sweep_kernel")
CALL_NAME = "nms_sweep_kernel"
OPS_PER_PAIR = 14


def bound_s(k, pairs=0):
    return peaks.roofline(k * (16 + 1 + 1), pairs * OPS_PER_PAIR,
                          peaks.FP32_FLOPS)


def call_shape(config, batch=1, top_k=1024):
    h, w = config["input_size"]
    anchors = sum((h // s) * (w // s) for s in (8, 16, 32))
    return {"k": min(top_k, anchors)}
