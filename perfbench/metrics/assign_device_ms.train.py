"""Device milliseconds a step launched under the program's `train/assign`
span: the assigner's call inside the loss (TAL here)."""

from perfbench.program_spans import TRAIN_ASSIGN, device_ms


def read(view):
    return device_ms(view, TRAIN_ASSIGN)
