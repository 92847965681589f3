"""Device milliseconds a batch under the `fwd/<stage>` spans that the
benchmark opens around each stage of the served model."""

from perfbench.readers import phase_ms


def read(view):
    return phase_ms(view, "fwd")
