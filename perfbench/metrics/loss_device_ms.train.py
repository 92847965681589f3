"""Device milliseconds a step under the `loss/assign` span around the
loss the benchmark hands to the train step: TAL assignment and the
BCE/CIoU/DFL forward."""

from perfbench.readers import phase_ms


def read(view):
    return phase_ms(view, "loss")
