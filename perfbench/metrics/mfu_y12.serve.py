"""The served YOLO12's FLOPs (the folded forward, counted on its
reference, ``flops_y12.py``) at the untraced rest's images a second, as a
share of the card's bf16 dense peak."""

from perfbench import flops_y12, peaks
from perfbench.readers import MIN_REST_ITEMS


def read(view):
    d = view.digest
    if d.rest_items < MIN_REST_ITEMS:
        return None
    return (100.0 * flops_y12.per_image(view.config) * d.rest_images
            / d.rest_s / peaks.BF16_FLOPS)
