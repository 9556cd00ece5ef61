"""Kernel-only times of K1-K7 and K10 at the shapes chip_smoke.py's
phases give them, for comparing two versions of the port in one call.

    python3 -m triple_accel_tpu_torch.benches.kernel_ab [--tag NAME]
        [--kernels K1 K2 K3W K4 K4D K4W K5 K6 K7 K10]

Run from the root of a checkout (it imports that checkout's package and
`chip_smoke.py` input generators, and only calls the wrappers' arguments
every version of them takes), so a copy of an older commit unpacked
beside this one is timed by the same script:

* K1 `myers_distance`: the 196,608 pairs of 1000 bytes of the `distance`
  phase at k = 32, unit costs (the tensors `levenshtein_k_batch` gives it);
* K2 `myers_search`: the 24-byte needle over the 128 MiB headline haystack
  at k = 3, unit and restricted-Damerau, at the version's own plan (its
  halo rule: `search_halo` where the version has it, else the span
  rounded up to 256; its `suggest_own_len`);

* K5 `blocked_distance`: 1,024 pairs of 20,000 ACGT bytes with 10% edits,
  unit costs, then the restricted-Damerau costs on the pairs with 1%
  adjacent swaps (the `blocked_distance` phase);
* K6 `blocked_search`: the 3,000-byte needle over the 128 MiB ACGT
  haystack of the `blocked_search` phase at k = 150 (halo 3,328, the
  version's own `suggest_own_len_blocked`), unit and restricted-Damerau;
  anchored, one segment of 4,000 columns;
* K7 `search_diag`: the 24-byte needle over the 128 MiB headline haystack
  at k = 6 under the phase's two general cost models (the version's own
  `suggest_own_len_diag`);
* K4 `band_trace` past the band plan: the `past_plan` cell (128 x
  10,000 B ACGT at an unbounded threshold, rDamerau costs) at the band
  the version's traced dispatch chose (`K4_past_plan`) and at the
  longest b rounded up to 16 (`K4_past_plan_exact_band`), each at the
  version's own plan for it; 3 launches each;
* K4D `band_trace` past a cluster's columns: the `band_wide` phase's
  cases (e) and (f), 2 and 64 pairs of 90,000 ACGT bytes with 2% edits
  at k = 5000 under rDamerau costs (`WIDE_E`, `WIDE_F` here), at the band
  the version's traced dispatch chose for (e) and its own plan; 3
  launches each (before the ring, a launch took seconds);
* K3W / K4W `band_distance` / `band_trace` in the wide regime (bands of
  545 - 9,281 cells), the cases of chip_smoke.py's `band_wide` phase
  (`WIDE_*` here, so that a version without that phase is timed on the
  same inputs): (a) 4,096 pairs of 5,000 ACGT bytes with 10% edits at
  k = 1000, unit costs, then rDamerau with 1% adjacent swaps added;
  (c) 256 pairs of 20,000 bytes with 5% edits at k = 4000 under affine
  costs (2, 1, 2); (d) one pair of 1,900 bytes through `levenshtein()`
  and `rdamerau()`; (b, K4W) the first 512 pairs of (a) traced under
  rDamerau; each at the band, rows and plan the version's dispatch gives
  it (the entry point called once first), 15 launches for (d); then
  `band_sweep.py --wide`'s bands and batches (`K3W_sweep` / `K4W_sweep`:
  band -> [full batch, one pair] ms) at the version's own plan;
* K10 `trace_walk`: the walks of the three traced cells of the
  `band_trace` phase (8,192 x 1000 B at k = 32, 256 x 3000 B at k = 64,
  and `past_plan`, 128 x 10,000 B at an unbounded threshold; rDamerau
  costs) over the codes K4 gives at the band the traced call's dispatch
  chose; beside each, its longest walk alone with L2 warm and emptied
  (both output forms of `trace_walk` are read: runs and counts, or the
  step-major versions' [B, steps] steps).

CUDA events, one warm-up, the median (least, most) of 7 launches, 9 for
the anchored one and for K10.  Prints the card's name and power limit, then one JSON
line.  Needs one CUDA device and `nvcc`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..utils import profiling as prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="a name for the JSON line")
    ap.add_argument("--kernels", nargs="+", default=["K1", "K2", "K5", "K6",
                                                     "K7", "K10"],
                    choices=["K1", "K2", "K3W", "K4", "K4D", "K4W", "K5",
                             "K6", "K7", "K10"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from triple_accel_tpu_torch.ops import myers_chunked as mc
    from triple_accel_tpu_torch.ops import myers_distance as md
    from triple_accel_tpu_torch.ops import myers_search as msm
    from triple_accel_tpu_torch.ops import search_diag as sd
    from triple_accel_tpu_torch.ops.myers_search import prepare_myers_needles
    from triple_accel_tpu_torch.ops.search_common import window_span

    dev = torch.device("cuda", 0)
    print(cs.smi_line(), flush=True)
    out = {"tag": args.tag}

    def ms(fn, reps=7):
        return [round(x, 4) for x in cs.time_launches(fn, reps)]

    if "K1" in args.kernels:
        a_l, b_l = cs.make_pairs(cs.FULL_PAIRS)
        # max_m as levenshtein_k_batch pads it: the next power of two
        t = md.prepare_myers_inputs(a_l, b_l, cs.K_DIST,
                                    1 << (cs.STR_LEN - 1).bit_length(),
                                    ks=np.full(len(a_l), cs.K_DIST),
                                    device=dev)
        out["K1"] = ms(lambda: md.myers_distance(*t, k=cs.K_DIST), 15)
        del a_l, b_l, t
    if "K2" in args.kernels:
        needle, hay, _ = cs.make_haystack(cs.FULL_HAY_MB << 20)
        n = len(hay)
        span = window_span(cs.NEEDLE_LEN, cs.K_SEARCH, 1, 0)
        halo = (msm.search_halo(span, n) if hasattr(msm, "search_halo")
                else min(-(-span // 256) * 256, n))
        own = msm.suggest_own_len(n, halo)
        hay_d = torch.from_numpy(hay).to(dev)
        nd = prepare_myers_needles([needle], cs.NEEDLE_LEN, device=dev)
        for damerau in (False, True):
            out[f"K2_{'rdamerau' if damerau else 'unit'}"] = ms(
                lambda: msm.myers_search(hay_d, nd, own_len=own, halo=halo,
                                         damerau=damerau), 15)
        out["K2_halo_own_len"] = [halo, own]
        del hay_d, hay
    if "K4" in args.kernels:
        out.update(time_k4(cs, dev, ms))
    if "K4D" in args.kernels:
        out.update(time_deep(cs, dev, ms))
    if {"K3W", "K4W"} & set(args.kernels):
        out.update(time_wide(cs, dev, ms, args.kernels))
    if "K10" in args.kernels:
        out.update(time_k10(cs, dev, ms))
    if not {"K5", "K6", "K7"} & set(args.kernels):
        print(json.dumps(out), flush=True)
        return 0

    a_l, b_l = cs.make_long_pairs(cs.BLOCKED_PAIRS, cs.BLOCKED_LEN,
                                  cs.BLOCKED_EDIT_SHARE, seed=2024)
    b_sw = cs.swap_adjacent_list(b_l, cs.BLOCKED_SWAP_SHARE,
                                 np.random.default_rng(2025))
    for damerau, b_rows in ((False, b_l), (True, b_sw)):
        a_s = [a if len(a) <= len(b) else b for a, b in zip(a_l, b_rows)]
        b_s = [b if len(a) <= len(b) else a for a, b in zip(a_l, b_rows)]
        t = mc.prepare_blocked_distance_inputs(a_s, b_s, device=dev)
        out[f"K5_{'rdamerau' if damerau else 'unit'}"] = ms(
            lambda: mc.blocked_distance(*t, damerau=damerau))
        del t
    m, k = cs.LONG_NEEDLE_LEN, cs.K_LONG_NEEDLE
    needle, hay, _ = cs.make_long_haystack(
        cs.FULL_HAY_MB << 20, m, cs.N_PLANTED_LONG, cs.LONG_NEEDLE_SUBS,
        seed=3030)
    n = len(hay)
    halo = min(-(-window_span(m, k, 1, 0) // 256) * 256, n)
    own = mc.suggest_own_len_blocked(n, halo)
    hay_d = torch.from_numpy(hay).to(dev)
    nd = prepare_myers_needles([needle], m, device=dev)
    for damerau in (False, True):
        out[f"K6_{'rdamerau' if damerau else 'unit'}"] = ms(
            lambda: mc.blocked_search(hay_d, nd, own_len=own, halo=halo,
                                      damerau=damerau))
    cols = min(m + cs.K_ANCHORED_LONG, n)
    hay_a = hay_d[:cols]
    out["K6_anchored"] = ms(lambda: mc.blocked_search(
        hay_a, nd, own_len=cols, halo=0, anchored=True), 9)
    out["K6_own_len"] = own
    del hay_d, hay_a
    needle, hay, _ = cs.make_haystack(cs.FULL_HAY_MB << 20)
    hay_d = torch.from_numpy(hay).to(dev)
    nd = torch.from_numpy(needle).to(dev)
    for c in cs.GENERAL_COSTS:
        ct = cs.fuzz_costs_t(c)
        halo = min(window_span(len(needle), cs.K_GENERAL, ct[1], ct[2]),
                   len(hay))
        own = sd.suggest_own_len_diag(len(hay), halo)
        out[f"K7_{c}"] = ms(lambda: sd.search_diag(
            hay_d, nd, own_len=own, halo=halo, costs_t=ct))
        out[f"K7_{c}_own_len"] = own
    print(json.dumps(out), flush=True)
    return 0


def time_k4(cs, dev, ms) -> dict:
    """K4 at the `past_plan` cell; the inputs as chip_smoke.py makes them,
    the band as the version's traced call picks it, and the exact band."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import last_dispatch
    from triple_accel_tpu_torch.ops import lev_band as lb

    a_p, b_p = cs.make_long_pairs(cs.PAST_PLAN_PAIRS, cs.PAST_PLAN_LEN,
                                  cs.PAST_PLAN_EDIT_SHARE, seed=3030)
    b_p = cs.swap_adjacent_list(b_p, cs.PAST_PLAN_SWAP_SHARE,
                                np.random.default_rng(3031))
    sa = [a if len(a) <= len(b) else b for a, b in zip(a_p, b_p)]
    sb = [b if len(a) <= len(b) else a for a, b in zip(a_p, b_p)]
    costs = tt.RDAMERAU_COSTS
    tt.levenshtein_k_batch(a_p, b_p, cs.U32_MAX, costs, trace_on=True)
    dec = last_dispatch()
    exact = -(-max(len(b) for b in sb) // 16) * 16
    out = {"K4_past_plan_unit_k": [dec.unit_k, exact]}
    for name, uk in (("K4_past_plan", dec.unit_k),
                     ("K4_past_plan_exact_band", exact)):
        t = lb.prepare_band_tensors(sa, sb, uk, dec.padded_m, device=dev)
        out[name] = ms(lambda: lb.band_trace(
            *t, unit_k=uk, costs_t=cs.costs_tuple(costs)), 3)
        del t
        torch.cuda.empty_cache()
    return out


# chip_smoke.py's `band_wide` cases (e) and (f): pairs, bytes, edit share,
# k, the seed of its generator
WIDE_E = (2, 90_000, 0.02, 5000, 6065)
WIDE_F = (64, 90_000, 0.02, 5000, 6066)


def time_deep(cs, dev, ms) -> dict:
    """K4 at the `band_wide` cases (e) and (f); the inputs as chip_smoke.py
    makes them, the band as the version's traced call picks it for (e),
    the rows as it pads them, at the version's own plan.  Each entry: the
    median, least and most ms, then unit_k, rows and the plan's regime,
    CTAs a pair and threads a CTA."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import last_dispatch
    from triple_accel_tpu_torch.ops import lev_band as lb

    costs = tt.RDAMERAU_COSTS
    ct = cs.costs_tuple(costs)
    out, unit_k = {}, None
    for name, (n, length, share, k, seed) in (("K4D_e", WIDE_E),
                                              ("K4D_f", WIDE_F)):
        a_l, b_l = cs.make_long_pairs(n, length, share, seed=seed)
        sa, sb = cs.shorter_first(a_l, b_l)
        rows = -(-max(len(a) for a in sa) // 16) * 16
        if unit_k is None:
            dist, _ = tt.levenshtein_k_batch(a_l, b_l, k, costs,
                                             trace_on=True)
            unit_k = last_dispatch().unit_k
        t = lb.prepare_band_tensors(sa, sb, unit_k, rows, device=dev)
        if name == "K4D_e":
            got = lb.band_trace(*t, unit_k=unit_k, costs_t=ct)[0]
            assert np.array_equal(got.cpu().numpy().astype(np.int64), dist)
            del got
        plan = lb.band_plan(rows, unit_k, True, batch=n,
                            max_n=max(len(b) for b in sb))
        out[name] = ms(lambda: lb.band_trace(*t, unit_k=unit_k, costs_t=ct),
                       3) + [unit_k, rows, plan["regime"],
                             plan.get("ctas_per_pair", 1), plan["threads"]]
        del t
        torch.cuda.empty_cache()
    return out


# chip_smoke.py's `band_wide` cases: pairs, bytes, edit share, k (and
# the seeds of its generators)
WIDE_A = (4096, 5000, 0.10, 1000, 6060)
WIDE_SWAP_SHARE, WIDE_TRACE_PAIRS = 0.01, 512
WIDE_C = (256, 20_000, 0.05, 4000, 6062)
WIDE_D = (1, 1900, 0.10, None, 6063)


def time_wide(cs, dev, ms, kernels) -> dict:
    """K3 / K4 in the wide regime at the `band_wide` cases; the inputs as
    chip_smoke.py makes them, the band, rows and plan as the version's
    dispatch picks them."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import last_dispatch
    from triple_accel_tpu_torch.ops import lev_band as lb

    def case(a_l, b_l, k, costs, traced, reps=7):
        res = tt.levenshtein_k_batch(a_l, b_l, k, costs, trace_on=traced)
        dec = last_dispatch()
        sa = [a if len(a) <= len(b) else b for a, b in zip(a_l, b_l)]
        sb = [b if len(a) <= len(b) else a for a, b in zip(a_l, b_l)]
        t = lb.prepare_band_tensors(sa, sb, dec.unit_k, dec.padded_m,
                                    device=dev)
        fn = lb.band_trace if traced else lb.band_distance
        ct = cs.costs_tuple(costs)
        got = fn(*t, unit_k=dec.unit_k, costs_t=ct)
        got = got[0] if traced else got
        dist = res[0] if traced else res
        assert np.array_equal(got.cpu().numpy().astype(np.int64), dist)
        times = ms(lambda: fn(*t, unit_k=dec.unit_k, costs_t=ct), reps)
        del t, got
        torch.cuda.empty_cache()
        return times + [dec.unit_k, dec.padded_m]

    out = {}
    n, length, share, k, seed = WIDE_A
    a_l, b_l = cs.make_long_pairs(n, length, share, seed=seed)
    b_sw = cs.swap_adjacent_list(b_l, WIDE_SWAP_SHARE,
                                 np.random.default_rng(seed + 1))
    if "K3W" in kernels:
        out["K3W_a_unit"] = case(a_l, b_l, k, tt.LEVENSHTEIN_COSTS, False)
        out["K3W_a_rdamerau"] = case(a_l, b_sw, k, tt.RDAMERAU_COSTS, False)
    if "K4W" in kernels:
        out["K4W_b"] = case(a_l[:WIDE_TRACE_PAIRS], b_sw[:WIDE_TRACE_PAIRS],
                            k, tt.RDAMERAU_COSTS, True)
    out.update(time_wide_sweep(dev, ms, kernels))
    if "K3W" not in kernels:
        return out
    n, length, share, k, seed = WIDE_C
    a_l, b_l = cs.make_long_pairs(n, length, share, seed=seed)
    out["K3W_c_affine"] = case(a_l, b_l, k, tt.EditCosts(2, 1, 2), False)
    n, length, share, _, seed = WIDE_D
    a_l, b_l = cs.make_long_pairs(n, length, share, seed=seed)
    b_sw = cs.swap_adjacent_list(b_l, WIDE_SWAP_SHARE,
                                 np.random.default_rng(seed + 1))
    out["K3W_d_levenshtein"] = case(a_l, b_l, cs.U32_MAX,
                                    tt.LEVENSHTEIN_COSTS, False, 15)
    out["K3W_d_rdamerau"] = case(a_l, b_sw, cs.U32_MAX, tt.RDAMERAU_COSTS,
                                 False, 15)
    return out


def time_wide_sweep(dev, ms, kernels) -> dict:
    """The wide regime at `band_sweep.py --wide`'s bands (its inputs:
    `_make_batch`, rDamerau costs), a full batch and one pair, each at the
    plan the version's `band_plan` gives it."""
    from triple_accel_tpu_torch.ops import lev_band as lb

    from . import band_sweep as bsw

    bands = (545, 1025, 2049, 4097, 8193, 9281)
    out = {}
    for name, traced, full in (("K3W_sweep", False, 1024),
                               ("K4W_sweep", True, 256)):
        if name[:3] not in kernels:
            continue
        fn = lb.band_trace if traced else lb.band_distance
        times = {}
        for W in bands:
            unit_k = (W - 1) // 2
            times[W] = []
            for pairs in (full, 1):
                t = bsw._make_batch(dev, pairs, 2000, unit_k)
                times[W].append(ms(lambda: fn(
                    *t, unit_k=unit_k, costs_t=bsw.RDAMERAU_T), 5)[0])
                del t
                torch.cuda.empty_cache()
        out[name] = times
    return out


def walk_lengths(res) -> torch.Tensor:
    """Steps each pair walked, from what a version's `trace_walk` returns:
    (runs, counts) (`utils.profiling.walk_lengths`), or the step-major
    versions' (seq int8 [B, steps], steps)."""
    if isinstance(res[1], torch.Tensor):
        return prof.walk_lengths(*res)
    return (res[0] >= 0).sum(dim=1)


def walk_alone_ms(cs, tw, codes, t, unit_k: int, p: int, reps: int,
                  flush: bool) -> float:
    """Median time of the wrapper on pair p alone (one walk, one chain of
    dependent steps) over `reps` launches after a warm-up; with `flush`,
    L2 is emptied before each launch by writing K10_FLUSH_BYTES, so the
    codes come from device memory; without, they stay in L2."""
    import statistics

    one = [x[p:p + 1] for x in (codes, *t)]
    buf = torch.empty(cs.K10_FLUSH_BYTES, dtype=torch.uint8,
                      device=codes.device)
    times = []
    for _ in range(reps + 1):
        if flush:
            buf.fill_(1)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        tw.trace_walk(*one, unit_k=unit_k)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times[1:])


def traced_cells(cs, dev):
    """The three traced cells of chip_smoke.py's `band_trace` phase as K10
    sees them: (name, codes, band tensors, unit_k) with the codes K4 gives
    at the band the traced call's dispatch chose, one cell at a time."""
    import triple_accel_tpu_torch as tt
    from triple_accel_tpu_torch.dispatch import last_dispatch
    from triple_accel_tpu_torch.ops import lev_band as lb

    a_l, b_l = cs.make_pairs(cs.FULL_PAIRS)
    # the phase swaps over the whole batch with one generator
    b_all = np.stack(b_l)
    cs.swap_adjacent(b_all, cs.SWAPS_PER_PAIR, np.random.default_rng(4321))
    b_rows = b_all[:cs.TRACE_PAIRS]
    a_p, b_p = cs.make_long_pairs(cs.PAST_PLAN_PAIRS, cs.PAST_PLAN_LEN,
                                  cs.PAST_PLAN_EDIT_SHARE, seed=3030)
    b_p = cs.swap_adjacent_list(b_p, cs.PAST_PLAN_SWAP_SHARE,
                                np.random.default_rng(3031))
    cells = (("K10_short", a_l[:cs.TRACE_PAIRS], list(b_rows), cs.K_DIST),
             ("K10_long", *cs.make_edited_pairs(
                 cs.TRACE_LONG_PAIRS, cs.TRACE_LONG_LEN, 24, 12, seed=77),
              cs.K_TRACE_LONG),
             ("K10_past_plan",
              [a if len(a) <= len(b) else b for a, b in zip(a_p, b_p)],
              [b if len(a) <= len(b) else a for a, b in zip(a_p, b_p)],
              cs.U32_MAX))
    del a_l, b_l, b_all
    costs = tt.RDAMERAU_COSTS
    for name, a, b, k in cells:
        tt.levenshtein_k_batch(a, b, k, costs, trace_on=True)
        dec = last_dispatch()
        t = lb.prepare_band_tensors(a, b, dec.unit_k, dec.padded_m,
                                    device=dev)
        _, codes = lb.band_trace(*t, unit_k=dec.unit_k,
                                 costs_t=cs.costs_tuple(costs))
        yield name, codes, t, dec.unit_k
        del t, codes


def time_k10(cs, dev, ms) -> dict:
    """K10 at the three traced cells; the inputs as chip_smoke.py makes
    them, the band as the traced call's dispatch picks it.  Beside the
    batch: its longest walk alone with L2 warm and emptied, and (step-major
    versions) the wrapper's own -1 fill and transpose at the batch's
    shape."""
    from triple_accel_tpu_torch.ops import trace_walk as tw

    out = {}
    for name, codes, t, unit_k in traced_cells(cs, dev):
        out[name] = ms(lambda: tw.trace_walk(codes, *t, unit_k=unit_k), 9)
        res = tw.trace_walk(codes, *t, unit_k=unit_k)
        lens = walk_lengths(res)
        p = int(lens.argmax())
        steps = int(lens[p])
        alone = {}
        for kind, flush in (("warm", False), ("cold", True)):
            t_ms = walk_alone_ms(cs, tw, codes, t, unit_k, p, 9, flush)
            alone[kind] = [round(t_ms, 4), round(t_ms * 1e6 / steps, 1)]
        out[f"{name}_alone_ms_ns_a_step"] = alone
        out[f"{name}_longest_walk"] = steps
        out[f"{name}_walked_steps"] = int(lens.sum())
        if not isinstance(res[1], torch.Tensor):
            shape = res[0].shape[::-1]
            out[f"{name}_fill_ms"] = ms(lambda: torch.full(
                shape, -1, dtype=torch.int8, device=dev), 9)
            out[f"{name}_transpose_ms"] = ms(
                lambda: res[0].t().contiguous(), 9)
        del res
    return out


if __name__ == "__main__":
    sys.exit(main())
