"""The train step's hand-written kernels (K1 forward, K4 backward) in the
traced window: the sum of their calls' least times over the sum of their
device times, in percent."""

from perfbench.readers import roofline_pct

KERNELS = ("k1_attention", "k4_attention_bwd")


def read(view):
    return roofline_pct(view, KERNELS)
