"""The arithmetic the per-layer metrics share. Each metric is a file of
``perfbench/metrics/`` that binds one of these to its cell's values; a
reader that finds nothing to read returns None and the metric is left
out of the result."""

from __future__ import annotations

from typing import Optional, Sequence

from perfbench import core, flops, peaks


# items the untraced rest of a window needs before its pace is read
MIN_REST_ITEMS = 5


def idle_pct(view) -> Optional[float]:
    """The share of the untraced pace in which the card is idle: 1 − the
    traced device busy time an item over the untraced wall time an item.
    The traced window's own length carries the profiler's host cost on
    every launch, which the untraced rest of the run does not."""
    d = view.digest
    if not d.events or d.rest_items < MIN_REST_ITEMS:
        return None
    return 100.0 * (1.0 - (d.busy_s / d.items) / (d.rest_s / d.rest_items))


def launches_per_item(view) -> Optional[float]:
    d = view.digest
    return len(d.events) / d.items if d.events else None


def phase_ms(view, phase: str) -> Optional[float]:
    """Device milliseconds a batch or step under ``phase``."""
    d = view.digest
    if not any(e["phase"] == phase for e in d.events):
        return None
    return d.phase_s(phase) * 1e3 / d.items


def rest_img_s(view) -> Optional[float]:
    """Images a second over the untraced rest of the window, on the host's
    clock."""
    d = view.digest
    if d.rest_items < MIN_REST_ITEMS:
        return None
    return d.rest_images / d.rest_s


def mfu_pct(view, train: bool) -> Optional[float]:
    """The model's FLOPs an image (counted on the reference) at the images
    a second of the untraced rest of the window, as a share of the bf16
    dense peak."""
    d = view.digest
    if d.rest_items < MIN_REST_ITEMS:
        return None
    per_image = flops.per_image(view.config, train)
    return (100.0 * per_image * d.rest_images / d.rest_s
            / peaks.BF16_FLOPS)


def roofline_pct(view, kernels: Sequence[str]) -> Optional[float]:
    """Σ least time ÷ Σ device time over the calls of ``kernels`` in the
    window, each call's least time from its shape."""
    d = view.digest
    bound = spent = 0.0
    for name in kernels:
        k = core.kernel(name)
        seconds, _ = d.kernel_s(k.TRACE_NAMES)
        _, calls = d.kernel_s((k.CALL_NAME,))
        if not calls:
            continue
        bound += calls * k.bound_s(**k.call_shape(view.config,
                                                  view.mix["batch"]))[0]
        spent += seconds
    return 100.0 * bound / spent if spent else None
