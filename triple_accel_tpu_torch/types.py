"""Shared result types and edit-cost configuration.

Own copy, for the PyTorch/CUDA port, of the shared types of the reference library
(`triple_accel` v0.4.0): `Match` (src/lib.rs:135-142), `EditType`/`Edit`
(src/lib.rs:148-165), `SearchType` (src/lib.rs:171-174) and `EditCosts`
(src/levenshtein.rs:21-72).  Semantics (validation asserts, defaults,
tie-break contracts) are preserved exactly; representation is idiomatic
Python (frozen dataclasses / enums) so the types can be used as static
(hashable) values in dispatch records.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

__all__ = [
    "Match",
    "EditType",
    "Edit",
    "SearchType",
    "EditCosts",
    "LEVENSHTEIN_COSTS",
    "RDAMERAU_COSTS",
    "alloc_str",
    "fill_str",
    "check_no_null_bytes",
    "to_bytes_array",
    "to_symbol_array",
]


@dataclass(frozen=True)
class Match:
    """A single matching location returned by search routines.

    `start` is inclusive, `end` is exclusive, `k` is the edit cost of the
    match.  Mirrors reference src/lib.rs:135-142.
    """

    start: int
    end: int
    k: int


class EditType(enum.Enum):
    """Possible edit operations in a traceback (reference src/lib.rs:148-154)."""

    Match = "Match"
    Mismatch = "Mismatch"
    AGap = "AGap"
    BGap = "BGap"
    Transpose = "Transpose"


@dataclass(frozen=True)
class Edit:
    """A run-length encoded sequence of edits of the same type.

    Mirrors reference src/lib.rs:160-165.
    """

    edit: EditType
    count: int


class SearchType(enum.Enum):
    """Whether a search returns all matches or only the best ones.

    Mirrors reference src/lib.rs:171-174.
    """

    All = "All"
    Best = "Best"


@dataclass(frozen=True)
class EditCosts:
    """Edit costs for mismatches, gaps (affine) and optional transpositions.

    Mirrors reference src/levenshtein.rs:21-72, including every validation
    assert of `EditCosts::new` (levenshtein.rs:44-52) and `check_search`
    (levenshtein.rs:67-71).  Frozen + hashable so it can be a static argument
    in jit dispatch (the trace-time analog of the reference's runtime
    dispatch on cost widths).
    """

    mismatch_cost: int = 1
    gap_cost: int = 1
    start_gap_cost: int = 0
    transpose_cost: Optional[int] = None

    def __post_init__(self):
        # Validation mirrors EditCosts::new (reference levenshtein.rs:44-52).
        if not (0 < self.mismatch_cost <= 255):
            raise ValueError("mismatch_cost must be in 1..=255")
        if not (0 < self.gap_cost <= 255):
            raise ValueError("gap_cost must be in 1..=255")
        if not (0 <= self.start_gap_cost <= 255):
            raise ValueError("start_gap_cost must be in 0..=255")
        if self.transpose_cost is not None:
            if not (0 < self.transpose_cost <= 255):
                raise ValueError("transpose_cost must be in 1..=255")
            # transpose must be cheaper than the equivalent mismatch/gap combos
            if not (self.transpose_cost >> 1) < self.mismatch_cost:
                raise ValueError("transpose_cost / 2 must be < mismatch_cost")
            if not (self.transpose_cost >> 1) < self.gap_cost:
                raise ValueError("transpose_cost / 2 must be < gap_cost")

    def check_search(self) -> None:
        """Extra constraint for search routines (reference levenshtein.rs:67-71).

        Transpositions must not be cheaper than a started gap, so that free
        gaps at the beginning of the needle cannot take priority over
        transpositions.
        """
        if self.transpose_cost is not None:
            if not self.transpose_cost <= self.start_gap_cost + self.gap_cost:
                raise ValueError(
                    "transpose_cost must be <= start_gap_cost + gap_cost for searches"
                )

    @property
    def allow_transpose(self) -> bool:
        return self.transpose_cost is not None

    @property
    def transpose_cost_or_zero(self) -> int:
        return self.transpose_cost if self.transpose_cost is not None else 0


# Preset costs (reference levenshtein.rs:76-89).
LEVENSHTEIN_COSTS = EditCosts(1, 1, 0, None)
RDAMERAU_COSTS = EditCosts(1, 1, 0, 1)


BytesLike = Union[bytes, bytearray, memoryview, np.ndarray, Sequence[int]]


def to_bytes_array(s: BytesLike) -> np.ndarray:
    """Convert a byte string / sequence to a 1-D uint8 numpy array.

    The canonical string representation is a uint8 array;
    this is the analog of the reference's `&[u8]` slices.
    """
    if isinstance(s, np.ndarray):
        if s.dtype != np.uint8:
            s = s.astype(np.uint8)
        return np.ascontiguousarray(s).reshape(-1)
    if isinstance(s, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(s), dtype=np.uint8)
    return np.asarray(list(s), dtype=np.uint8)


def to_symbol_array(s: BytesLike) -> np.ndarray:
    """Convert to a 1-D int64 symbol array, preserving values above 255.

    The analog of the reference's generic `T: PartialEq` element type
    (`levenshtein_naive` is generic, reference levenshtein.rs:148): the
    scalar oracle's DP only ever compares symbols for equality, so any
    integer alphabet works.  Strings are mapped per-character to unicode
    code points.  The device paths remain u8 (the reference's SIMD cores
    are u8-only too); symbol inputs exceeding 255 route to the oracle.
    """
    if isinstance(s, str):
        return np.array([ord(c) for c in s], dtype=np.int64)
    if isinstance(s, np.ndarray):
        return np.ascontiguousarray(s.astype(np.int64)).reshape(-1)
    if isinstance(s, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(s), dtype=np.uint8).astype(np.int64)
    return np.asarray(list(s), dtype=np.int64)


def alloc_str(length: int) -> np.ndarray:
    """Allocate a zeroed uint8 buffer of `length` bytes.

    API-parity shim for the reference's `alloc_str` (src/lib.rs:197-205).
    The reference needed u128 alignment + 16-byte padding for its word-wise
    Hamming routines; numpy arrays are already suitably aligned and the device
    paths use length masks instead of padding tricks, so this is a plain
    zeroed array.
    """
    return np.zeros(length, dtype=np.uint8)


def fill_str(dest: np.ndarray, src: BytesLike) -> None:
    """Copy `src` bytes into the front of `dest` (reference src/lib.rs:229-235)."""
    src = to_bytes_array(src)
    if len(dest) < len(src):
        raise ValueError("destination is shorter than source")
    dest[: len(src)] = src


def check_no_null_bytes(s: BytesLike) -> None:
    """Raise if the string contains a zero byte (reference src/lib.rs:237-243).

    The reference bans null bytes in the haystack of SIMD Hamming searches
    because its needle vectors are zero padded.  The port uses
    length masks instead, so null bytes are actually supported; this check is
    kept only for strict API parity and is NOT called on the device paths.
    """
    arr = to_bytes_array(s)
    if arr.size and bool((arr == 0).any()):
        raise ValueError("No zero/null bytes allowed in the string!")
