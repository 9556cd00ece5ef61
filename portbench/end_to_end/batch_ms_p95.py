"""Exact distances: the 95th percentile of every call's latency in the
window, in ms."""

from portbench.readers import batch_ms_p95 as read  # noqa: F401
