"""The part of `idle_pct.train` in gaps that open while the main thread is
inside the program's `train/step` span: the idle share that only the
program's dispatch can remove, in percent."""

from perfbench.program_spans import TRAIN_STEP, dispatch_idle_pct


def read(view):
    return dispatch_idle_pct(view, TRAIN_STEP)
