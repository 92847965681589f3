"""Host milliseconds a batch that the main thread spends inside the
program's `serve/input` span: how long the input copy holds the host, and
with it the dispatch of the batches behind. Read in the traced window, so
it carries the profiler's cost on the ops inside."""

from perfbench.program_spans import SERVE_INPUT, host_ms


def read(view):
    return host_ms(view, SERVE_INPUT)
