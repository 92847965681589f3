"""K1, PSA attention forward (``ops/cuda/csrc/attention.cu``): each input
byte read once, each output byte written once (``out`` and ``v``); the
products ``q·kᵀ`` and ``p·v`` at the dtype's peak."""

from perfbench import peaks

# the kernels' names in a trace (bf16 tensor-core and fp32 routes)
TRACE_NAMES = ("psa_attention_fwd",)
# one event of this name per call
CALL_NAME = "psa_attention_fwd"


def bound_s(b, t, nh, dk, dh, elem=2):
    peak = peaks.BF16_FLOPS if elem == 2 else peaks.FP32_FLOPS
    qkv = b * t * nh * (2 * dk + dh) * elem
    out = b * t * nh * dh * elem
    return peaks.roofline(qkv + 2 * out, 2 * b * nh * t * t * (dk + dh),
                          peak)


def call_shape(config, batch):
    """The shape of every call in one forward: the PSA blocks at p5."""
    h, w = config["input_size"]
    half = config["width"][5] // 2
    nh = max(1, half // 64)
    dh = half // nh
    return {"b": batch, "t": (h // 32) * (w // 32), "nh": nh,
            "dk": dh // 2, "dh": dh,
            "elem": 2 if config["precision"] == "bfloat16" else 4}
