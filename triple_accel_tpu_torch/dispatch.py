"""Dispatch: band sizing, cost-dtype bucketing, path forcing, device choice.

Own copy, for the PyTorch/CUDA port, of the JAX package's `dispatch.py`
(same numeric rules, same `DispatchDecision` log), plus the one rule that
decides where work runs:

* every entry point takes a keyword-only ``device=``; ``None`` means
  ``"cuda"``.  A CUDA device that is not there raises `RuntimeError` —
  nothing moves to the CPU unless the caller names the CPU in the call.
* ``TRIPLE_ACCEL_TORCH_FORCE_PATH`` in {"oracle", "kernel", "band"} forces
  the scalar oracle, the device engines (the default), or — the counterpart
  of the JAX package's ``pallas_band`` — the general band kernel for
  unit-cost distance batches that would otherwise take the Myers kernel.
* ``TRIPLE_ACCEL_TORCH_DEBUG_DISPATCH=1`` logs every dispatch decision.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import torch

from .oracle.levenshtein import compute_max_k, compute_unit_k  # re-export
from .types import EditCosts

__all__ = [
    "compute_max_k",
    "compute_unit_k",
    "dispatch_unit_k",
    "select_cost_bucket",
    "forced_path",
    "debug_dispatch",
    "round_up_pow2",
    "DispatchDecision",
    "last_dispatch",
    "dispatch_history",
    "resolve_device",
]

# Reserve the dtype max as the overflow/infinity sentinel, exactly like the
# reference reserves u8::MAX etc. (levenshtein.rs:769: max_k <= u8::MAX - 1).
_COST_BUCKETS = (
    ("u8", (1 << 8) - 2),
    ("u16", (1 << 16) - 2),
    ("u32", (1 << 32) - 2),
)


def dispatch_unit_k(a_len: int, b_len: int, k: int, costs: EditCosts) -> int:
    """Band half-width as computed by the SIMD dispatcher.

    Unlike the scalar core's unit_k, the dispatcher additionally caps at
    max_len (reference levenshtein.rs:760-763).
    """
    max_k = compute_max_k(a_len, b_len, k, costs)
    return min(compute_unit_k(max_k, costs), max(a_len, b_len))


def select_cost_bucket(max_k: int) -> str:
    """Pick the narrowest cost dtype whose range (minus the INF sentinel)
    holds max_k — the analog of the 8/16/32-bit jewel ladder
    (reference levenshtein.rs:766-823)."""
    for name, cap in _COST_BUCKETS:
        if max_k <= cap:
            return name
    return "u32"


def forced_path() -> str | None:
    """Backend override from the environment: "oracle" | "kernel" |
    "band"."""
    v = os.environ.get("TRIPLE_ACCEL_TORCH_FORCE_PATH", "").strip().lower()
    return v if v in ("oracle", "kernel", "band") else None


def _debug_enabled() -> bool:
    return os.environ.get(
        "TRIPLE_ACCEL_TORCH_DEBUG_DISPATCH", "") not in ("", "0")


def debug_dispatch(msg: str) -> None:
    """Dispatch-coverage logging (analog of the reference `debug` feature)."""
    if _debug_enabled():
        print(f"Debug: {msg}", file=sys.stderr)


def round_up_pow2(n: int, minimum: int = 8) -> int:
    """Round a length up to the next power of two (shape bucketing)."""
    v = max(n, minimum)
    return 1 << (v - 1).bit_length()


@dataclass(frozen=True)
class DispatchDecision:
    """A record of one dispatch decision, for logging and tests."""

    # "oracle" | "myers" | "band" | "band_trace" | "myers_search" |
    # "myers_search_rdamerau" | "torch" (Hamming)
    path: str
    cost_bucket: str  # "u8" | "u16" | "u32"
    unit_k: int
    max_k: int
    padded_m: int
    padded_n: int

    def log(self, routine: str) -> None:
        global _LAST_DISPATCH
        _LAST_DISPATCH = self
        _HISTORY.append((routine, self))
        if len(_HISTORY) > 64:
            del _HISTORY[:-64]
        debug_dispatch(
            f"{routine} path={self.path} cost={self.cost_bucket} "
            f"unit_k={self.unit_k} max_k={self.max_k} "
            f"padded=({self.padded_m},{self.padded_n})"
        )


_LAST_DISPATCH: DispatchDecision | None = None
_HISTORY: list = []


def last_dispatch() -> DispatchDecision | None:
    """The most recent dispatch decision — the testable face of the debug
    log (tests assert which kernel path a call actually took)."""
    return _LAST_DISPATCH


def dispatch_history(clear: bool = False) -> list:
    """Recent (routine, DispatchDecision) records, most recent last (ring
    of 64).  With clear=True, empties the ring after returning it."""
    global _HISTORY
    out = list(_HISTORY)
    if clear:
        _HISTORY = []
    return out


# ---------------------------------------------------------------------------
# Device selection
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else "cuda".
    Raises `RuntimeError` for a CUDA device when no card is available —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "triple_accel_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
