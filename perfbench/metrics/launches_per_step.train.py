"""Device events (kernels, copies, memsets) in the traced window over the
train steps it ran: what the host dispatches for one step."""

from perfbench.readers import launches_per_item as read  # noqa: F401
