"""The served model's FLOPs (the folded forward, counted on the reference)
for every image of the traced window, over the window, as a share of
the card's bf16 dense peak."""

from perfbench.readers import mfu_pct


def read(view):
    return mfu_pct(view, train=False)
