"""Device milliseconds a step launched by autograd's backward."""

from perfbench.readers import phase_ms


def read(view):
    return phase_ms(view, "bwd")
