"""Device events (kernels, copies, memsets) in the traced window over the
batches it served: what the host dispatches for one batch."""

from perfbench.readers import launches_per_item as read  # noqa: F401
