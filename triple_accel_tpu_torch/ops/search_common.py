"""Search geometry shared by the search engines of the port (counterpart
of `window_span` and `seg_count` in the JAX package's ops/search_scan.py
and ops/pallas/search_myers.py)."""

from __future__ import annotations

__all__ = ["window_span", "seg_count"]


def window_span(needle_len: int, k: int, gap_cost: int,
                start_gap_cost: int) -> int:
    """Max haystack chars a cost-<=k match can span: m + (k - sgc)/gc gap
    extensions (each needle-gap consumes one haystack char and costs at
    least one gap extension after the mandatory gap start)."""
    return needle_len + max(0, k - start_gap_cost) // gap_cost


def seg_count(n: int, own_len: int) -> int:
    """Number of segments of `own_len` owned end positions that cover an
    n-char haystack (at least one)."""
    return max(1, -(-n // own_len))
