"""Multi-word bit-vector arithmetic for the kernels' plain PyTorch versions.

torch has no unsigned 64-bit arithmetic and `>>` on int64 is arithmetic, so
the plain versions keep 32-bit words in int64 containers (last tensor
dimension = word index, word 0 = lowest bits) and mask after every shift
and add.  A kernel's 64-bit word is two of these.
"""

from __future__ import annotations

import torch

__all__ = ["WORD32", "M32", "shift_words_down", "shl1", "shr1", "add_words",
           "bnot", "popcount32", "low_mask", "pack_bits"]

WORD32 = 32
M32 = (1 << WORD32) - 1


def shift_words_down(x: torch.Tensor, d: int) -> torch.Tensor:
    """Word w <- word w-d along the last dimension, zeros shifted in."""
    if d >= x.shape[-1]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[..., :d]), x[..., :-d]], dim=-1)


def bnot(x: torch.Tensor) -> torch.Tensor:
    return x ^ M32


def shl1(x: torch.Tensor, bit0: int) -> torch.Tensor:
    """Vector << 1 across words; `bit0` fills bit 0 of word 0."""
    carry = shift_words_down((x >> (WORD32 - 1)) & 1, 1)
    if bit0:
        carry[..., 0] = 1
    return ((x << 1) & M32) | carry


def shr1(x: torch.Tensor, top_in: int) -> torch.Tensor:
    """Vector >> 1 across words; `top_in` fills the top bit of the last
    word."""
    up = torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)
    out = (x >> 1) | ((up & 1) << (WORD32 - 1))
    if top_in:
        out[..., -1] |= 1 << (WORD32 - 1)
    return out


def add_words(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multi-word add of masked vectors, carry-out of the last word
    dropped: a Kogge-Stone carry prefix over the word dimension."""
    nw = x.shape[-1]
    s = x + y
    if nw == 1:
        return s & M32
    c = shift_words_down(s >> WORD32, 1)  # carry into word w
    if nw > 2:
        pp = shift_words_down(((s & M32) == M32).to(s.dtype), 1)
        d = 1
        while d < nw - 1:
            c = c | (pp & shift_words_down(c, d))
            pp = pp & shift_words_down(pp, d)
            d <<= 1
    return (s + c) & M32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def low_mask(nbits: torch.Tensor) -> torch.Tensor:
    """Per-element mask of the low clip(nbits, 0, 32) bits."""
    nb = nbits.clamp(0, WORD32)
    return (torch.ones_like(nb) << nb) - 1


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 32 * nw] bool -> [..., nw] int64 words, bit t of word w =
    bits[..., 32 * w + t]."""
    nw = bits.shape[-1] // WORD32
    weights = torch.ones(WORD32, dtype=torch.int64, device=bits.device) << (
        torch.arange(WORD32, dtype=torch.int64, device=bits.device))
    b = bits.reshape(*bits.shape[:-1], nw, WORD32).to(torch.int64)
    return (b * weights).sum(dim=-1)
