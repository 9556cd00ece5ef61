"""Share of the exact-distance cell's traced window in which nothing ran on the
device, in %."""

from portbench.readers import idle_pct as read  # noqa: F401
