"""The part of `idle_pct.serve` in gaps that open while the main thread is
inside the program's `serve` span but not inside its `serve/input`: the
idle share that only the program's dispatch can remove, in percent."""

from perfbench.program_spans import SERVE, SERVE_INPUT, dispatch_idle_pct


def read(view):
    return dispatch_idle_pct(view, SERVE, SERVE_INPUT)
