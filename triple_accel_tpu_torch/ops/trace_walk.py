"""The traceback walk of traced band batches: kernel K10.

The JAX package walks every pair of a traced batch back from (m, n) to
(0, 0) over the band kernel's packed argmin codes in one jitted
`lax.scan` (triple_accel_tpu/ops/band_scan.py:189 `_walk_scan`, reached
by `walk_packed_traceback` and `band_trace_batch`): XLA code, no Pallas
kernel.  The port's plain version of that walk, as runs, is
`trace_walk_plain` (`band_scan.walk_packed_traceback`, a Python loop of
small torch ops a step, then `band_scan.run_length_encode`, a torch
run-length encoding); on the card `trace_walk` launches the
hand-written kernel of csrc/trace_walk.cu instead: a group of lanes a
pair, code tiles staged in shared memory ahead of the walk, runs written
as the walk goes.

Inputs are the band kernels' (ops/lev_band.py): codes int32 [B, rows,
ceil(W / 16)] (cell c of row i at bits 2 * (c % 16) of word c // 16 of row
i - 1), `a_t` uint8 [B, max_m], `b_t` uint8 [B, max_m + W] with each
pair's b at byte offset unit_k, `m`, `n` int32 [B].  The output is the
plain version's: (runs int32 [total], counts int32 [B]), pair p's
counts[p] runs after those of pairs 0 .. p - 1, each `count << 3 | step`
in reverse walk order (steps 0 Match, 1 Mismatch, 2 consume-b, 3
consume-a, 4 Transpose), for `band_scan.decode_walked_batch`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .band_scan import (RUN_COUNT_LIMIT, code_words, run_length_encode,
                        walk_packed_traceback, walk_steps)

__all__ = ["trace_walk", "trace_walk_plain", "walk_plan", "walk_steps",
           "run_bytes_per_pair"]

# K10's launch shapes, from `benches/band_sweep.py --walk` (NVIDIA H100
# 80GB HBM3, the three traced cells): a batch of many pairs is bound by
# issue (the 8,192-pair cell: 4 lanes a pair 0.18 ms, 8 lanes 0.22, 32
# lanes 0.58), one of few pairs by each walk's latency, which the staging
# lanes shorten (the 128- and 256-pair cells: 32 lanes a pair 0.80 and
# 0.26 ms, 4 lanes 1.43 and 0.37); windows of 2 words and tall tiles
# copy least.  At most WALK_FEW_PAIRS pairs (8 warps an SM at a warp a
# pair) take the few-pairs shape; the crossover was not swept.
WALK_FEW_PAIRS = 1024
WALK_MANY = {"lanes": 4, "tile_rows": 64, "window": 2, "threads": 128}
WALK_FEW = {"lanes": 32, "tile_rows": 128, "window": 2, "threads": 64}


def walk_plan(W: int, batch: int) -> dict:
    """K10's launch shape at band W for `batch` pairs: `lanes` lanes a
    pair, tiles of `tile_rows` rows x `window` words (at most a row's
    ceil(W / 16)), `threads` threads a block."""
    plan = dict(WALK_FEW if batch <= WALK_FEW_PAIRS else WALK_MANY)
    plan["window"] = min(plan["window"], code_words(W))
    return plan


def run_bytes_per_pair(max_m: int, unit_k: int) -> int:
    """Device bytes of a pair's run buffer: a run a step at most."""
    return 4 * walk_steps(max_m, unit_k)


def trace_walk_plain(codes: torch.Tensor, a_t: torch.Tensor,
                     b_t: torch.Tensor, m: torch.Tensor, n: torch.Tensor, *,
                     unit_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K10: `walk_packed_traceback`, then
    `run_length_encode` of its steps, on the device the codes lie on.
    Returns (runs int32 [total], counts int32 [B])."""
    seq, _ = walk_packed_traceback(codes, a_t, b_t, m, n, unit_k=unit_k)
    return run_length_encode(seq)


def _check_inputs(codes, a_t, b_t, m, n, unit_k: int) -> None:
    if unit_k < 0:
        raise ValueError(f"unit_k={unit_k} is negative")
    W = 2 * unit_k + 1
    if codes.dtype != torch.int32 or codes.dim() != 3:
        raise TypeError("codes must be int32 [B, rows, ceil(W / 16)]")
    if a_t.dtype != torch.uint8 or b_t.dtype != torch.uint8:
        raise TypeError("a_t and b_t must be uint8")
    B = codes.shape[0]
    if a_t.dim() != 2 or b_t.dim() != 2 or a_t.shape[0] != B \
            or b_t.shape[0] != B:
        raise ValueError("codes, a_t and b_t must hold the same B pairs")
    if codes.shape[1] < 1 or codes.shape[2] != code_words(W):
        raise ValueError(f"codes must hold >= 1 row of {code_words(W)} "
                         f"words at band {W}")
    if a_t.shape[1] < 1 or b_t.shape[1] != a_t.shape[1] + W:
        raise ValueError(f"row lengths must be max_m >= 1 and max_m + {W}")
    for t in (m, n):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError("m and n must be int32 [B]")
    devs = {t.device for t in (codes, a_t, b_t, m, n)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    steps = walk_steps(a_t.shape[1], unit_k)
    if steps >= RUN_COUNT_LIMIT:
        raise ValueError(
            f"walks of up to {steps} steps: a run's count must stay below "
            f"2^28 = {RUN_COUNT_LIMIT}")


def _launch_walk(codes, a_t, b_t, m, n, unit_k: int, plan: dict,
                 buf: torch.Tensor, counts: torch.Tensor) -> None:
    """The walk kernel alone: each pair's runs into its row of `buf` (int32
    [B, steps]), their number into `counts` (int32 [B])."""
    from ..utils.build import check_launch, load_kernels

    lib = load_kernels()
    tensors = [t.contiguous() for t in (codes, a_t, b_t, m, n)]
    B, rows, wpr = codes.shape
    with torch.cuda.device(codes.device):
        code = lib.ta_trace_walk(
            *(t.data_ptr() for t in tensors), buf.data_ptr(),
            counts.data_ptr(), B, rows, wpr, a_t.shape[1], b_t.shape[1],
            unit_k, buf.shape[1], plan["lanes"], plan["tile_rows"],
            plan["window"], plan["threads"],
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, code, "trace_walk")


def _launch(codes, a_t, b_t, m, n, unit_k: int, steps: int, plan: dict):
    """Launch the CUDA walk into a [B, steps] run buffer, then join the
    pairs' runs with the second kernel at their counts' running sums:
    (runs, counts).  The total is read on the host (one synchronisation)
    to size the output."""
    from ..utils.build import check_launch, load_kernels

    B = codes.shape[0]
    dev = codes.device
    buf = torch.empty((B, steps), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    _launch_walk(codes, a_t, b_t, m, n, unit_k, plan, buf, counts)
    lib = load_kernels()
    with torch.cuda.device(dev):
        ends = torch.cumsum(counts, 0)  # int64
        runs = torch.empty(int(ends[-1]) if B else 0, dtype=torch.int32,
                           device=dev)
        code = lib.ta_trace_walk_gather(
            buf.data_ptr(), counts.data_ptr(), ends.data_ptr(),
            runs.data_ptr(), B, steps,
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, code, "trace_walk (gather)")
    return runs, counts


def trace_walk(codes: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor,
               m: torch.Tensor, n: torch.Tensor, *, unit_k: int,
               plan: Optional[dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk every pair's traceback: (runs int32 [total], counts int32
    [B]), equal to `trace_walk_plain` on the same inputs.

    CUDA tensors launch the hand-written kernel (built at first use) at
    `plan` (default `walk_plan`) and count one launch in
    `trace_walk.launches`; a build or launch failure raises.  The kernel
    writes each pair's runs into a row of a [B, steps] buffer; a second
    kernel joins them.  CPU tensors — and only those — take the plain
    PyTorch version.  A batch whose walks could pass 2^28 steps raises.
    """
    _check_inputs(codes, a_t, b_t, m, n, unit_k)
    if codes.device.type == "cpu":
        return trace_walk_plain(codes, a_t, b_t, m, n, unit_k=unit_k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    steps = walk_steps(a_t.shape[1], unit_k)
    res = _launch(codes, a_t, b_t, m, n, unit_k, steps,
                  plan or walk_plan(2 * unit_k + 1, codes.shape[0]))
    if codes.shape[0]:
        trace_walk.launches += 1
    return res


trace_walk.launches = 0
