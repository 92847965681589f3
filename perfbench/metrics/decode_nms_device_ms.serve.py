"""Device milliseconds a batch launched inside `serve` after the model's
forward returned: the DFL decode, the pool and the NMS kernel."""

from perfbench.readers import phase_ms


def read(view):
    return phase_ms(view, "decode_nms")
