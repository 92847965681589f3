"""K1 as YOLO12's area attention calls it, alone in the traced serving
window: the sum of its calls' least times over the sum of their device
times, in percent."""

from perfbench.readers import roofline_pct


def read(view):
    return roofline_pct(view, ("k1_area_attention",))
