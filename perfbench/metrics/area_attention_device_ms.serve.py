"""K1's device milliseconds an image in the traced serving window, read
by the kernel's name: a replayed CUDA graph runs no span inside the
forward, so the attention's part of a frame has no span of its own."""

from perfbench import core


def read(view):
    d = view.digest
    seconds, calls = d.kernel_s(core.kernel("k1_area_attention").TRACE_NAMES)
    return seconds * 1e3 / d.images if calls else None
