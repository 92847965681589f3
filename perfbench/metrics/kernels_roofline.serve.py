"""The serving path's hand-written kernels (K1 twice, K5, K2) in the
traced window: the sum of their calls' least times over the sum of their
device times, in percent."""

from perfbench.readers import roofline_pct

KERNELS = ("k1_attention", "k5_sppf", "k2_nms")


def read(view):
    return roofline_pct(view, KERNELS)
