"""Device milliseconds a batch launched under the program's `serve/decode`
and `serve/nms` spans: the DFL decode, the pool, the NMS kernel and the
copy of the result out of the graphs' buffers."""

from perfbench.program_spans import SERVE_DECODE, SERVE_NMS, device_ms


def read(view):
    return device_ms(view, SERVE_DECODE, SERVE_NMS)
