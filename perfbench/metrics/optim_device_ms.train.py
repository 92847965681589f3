"""Device milliseconds a step under torch.optim's own span or launched
after the step's backward: the gradient norm, the clip, AdamW and the
EMA."""

from perfbench.readers import phase_ms


def read(view):
    return phase_ms(view, "optim")
