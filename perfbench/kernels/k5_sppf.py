"""K5, the SPPF pyramid (``ops/cuda/csrc/sppf.cu``): the map read once and
its four slices (itself and three pooled) written once; three levels of
8 comparisons an element at the fp32 rate."""

from perfbench import peaks

TRACE_NAMES = ("sppf_pyramid_kernel",)
CALL_NAME = "sppf_pyramid_kernel"


def bound_s(b, c, h, w, elem=2):
    n = b * c * h * w
    return peaks.roofline(5 * n * elem, 3 * 8 * n, peaks.FP32_FLOPS)


def call_shape(config, batch):
    h, w = config["input_size"]
    return {"b": batch, "c": config["width"][5] // 2, "h": h // 32,
            "w": w // 32,
            "elem": 2 if config["precision"] == "bfloat16" else 4}
