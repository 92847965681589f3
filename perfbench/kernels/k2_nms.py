"""K2, batched greedy NMS (``ops/cuda/csrc/nms.cu``: a bit-matrix kernel,
then a sweep; one call a batch): each box (16 B), its validity and its
keep flag once; 14 fp32 operations an IoU test, each kept box tested
against every later box of its pool.

Which boxes are kept depends on the data and cannot be seen from outside
the program, so without ``pairs`` the bound is the bytes' alone, which is
never above the true least time."""

from perfbench import peaks

TRACE_NAMES = ("nms_mask_kernel", "nms_sweep_kernel")
CALL_NAME = "nms_sweep_kernel"
OPS_PER_PAIR = 14


def bound_s(n, k, pairs=0):
    return peaks.roofline(n * k * (16 + 1 + 1), pairs * OPS_PER_PAIR,
                          peaks.FP32_FLOPS)


def call_shape(config, batch, top_k=1024):
    h, w = config["input_size"]
    anchors = sum((h // s) * (w // s) for s in (8, 16, 32))
    return {"n": batch, "k": min(top_k, anchors)}
