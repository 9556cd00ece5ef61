"""Exact distances: pairs of every call completed in the window over the
window's seconds."""

from portbench.readers import pairs_per_s as read  # noqa: F401
