"""Device milliseconds a batch launched under the program's
`serve/forward` span: the fused model's forward, eager or replayed as a
CUDA graph."""

from perfbench.program_spans import SERVE_FORWARD, device_ms


def read(view):
    return device_ms(view, SERVE_FORWARD)
