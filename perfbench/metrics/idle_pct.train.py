"""Share of the traced training window in which no kernel, copy or
memset ran on the card (the union of their intervals), in percent."""

from perfbench.readers import idle_pct as read  # noqa: F401
