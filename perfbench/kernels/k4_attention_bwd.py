"""K4, PSA attention backward (``ops/cuda/csrc/attention_bwd.cu``, a dq
and a dkv kernel a call): ``qkv``, ``d(out)`` and ``d(v)`` read once,
``d(qkv)`` written once; the five products at the dtype's peak."""

from perfbench import peaks

TRACE_NAMES = ("psa_attention_bwd",)
CALL_NAME = "psa_attention_bwd_dq"


def bound_s(b, t, nh, dk, dh, elem=2):
    peak = peaks.BF16_FLOPS if elem == 2 else peaks.FP32_FLOPS
    qkv = b * t * nh * (2 * dk + dh) * elem
    out = b * t * nh * dh * elem
    return peaks.roofline(2 * qkv + 2 * out,
                          2 * b * nh * t * t * (3 * dk + 2 * dh), peak)


def call_shape(config, batch):
    h, w = config["input_size"]
    half = config["width"][5] // 2
    nh = max(1, half // 64)
    dh = half // nh
    return {"b": batch, "t": (h // 32) * (w // 32), "nh": nh,
            "dk": dh // 2, "dh": dh,
            "elem": 2 if config["precision"] == "bfloat16" else 4}
