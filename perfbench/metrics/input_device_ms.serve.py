"""Device milliseconds a batch launched under the program's `serve/input`
span: the batch's copy to the card and its normalisation."""

from perfbench.program_spans import SERVE_INPUT, device_ms


def read(view):
    return device_ms(view, SERVE_INPUT)
