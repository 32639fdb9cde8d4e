#!/usr/bin/env python3
"""Drive the PyTorch port's static, dynamic-round, separate-call and
set-algebra paths on one NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card, `nvcc` and
`g++`:

    python3 chip_smoke.py            # every phase, ~3 minutes
    python3 chip_smoke.py --profile  # only a `torch.profiler` table of
                                     # the separate-calls workload
    python3 chip_smoke.py --profile-algebra  # the same of the set algebra

Phases (any failure raises and the script exits non-zero):
1. print the card, its power limit and the versions; build the seven CUDA
   kernels of `cbl_tpu_torch` from `cbl_tpu_torch/csrc/` (one nvcc per
   source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (exact equality; B5, B6 and B7 also against
   `torch.sort`, their inputs unchanged, and the number of passes over
   device memory that B5, B6 and B7 launch against the Python
   schedule's; B7 also at B3's shapes of a fold and a log join, timed
   beside B3),
   time both with CUDA events, time the one PyTorch call that computes the
   same function where there is one, and work out each kernel's bound
   (the larger of bytes over the HBM peak and integer operations over
   the INT32 peak);
3. run the static path at full size: 32,000,000 random bases (one
   record) at K=25, `pack_stream` -> `insert_codes_stream` ->
   `count_device` -> `query_codes_stream(lazy=True)` with one sync, plain
   and canonical; `distinct` must equal `bench/baseline.cpp`'s count and
   every k-mer must be found;
4. query a multi-record stream that was never inserted against an index
   of the first 8 Mbp (its `positive` must equal a numpy oracle) and
   build a stream of two slabs;
5. run the dynamic path at full size (`bench.py --mode dynamic`): the same
   32 Mbp in 8 segments, round i = `dynamic_round(segs[i],
   segs[max(i-1, 0)], halves[i])`, one warm-up and one timed run;
   `distinct` and the summed `positive` must equal `bench/baseline.cpp
   dynamic`'s; then a query of the active log must equal the same query
   after `flush()`; then the same rounds under merge mode "bitonic",
   every merge on kernel B7 (23 launches, none of B3), with the same
   counts;
6. run the separate calls (`dynamic_round`'s fallback: per round
   `insert_codes_stream`, `query_codes_stream(lazy=True)`,
   `remove_codes_stream`, then `count_device()` and one sync) under the
   "mergepath" sort mode, where every sort is kernel B5: run A on the
   32 Mbp of phase 5 (inserts exceed the pending log and merge, removes
   stay in the log and fold), run B on its first 16 Mbp (inserts fit the
   log, so every query joins index and log); counts must equal
   `bench/baseline.cpp dynamic`'s and the launches of every kernel the
   numbers derived from the code; run A again in the default mode
   (`torch.sort`, no B5 launch) must give the same counts; then point
   operations against a Python oracle with no fold in between, and a
   round over a two-slab stream (the fallback) against the same three
   calls on a second index;
7. run set algebra as `bench.py --mode algebra` does (BASELINE config 4
   without its serde round-trip): `a` from the first 16 Mbp, `b` from the
   second, then `a | b`, `a & b`, `a - b`, `a ^ b`, each followed by
   `count()`, one warm-up and one counted pass, under three pairs of
   (merge mode, sort mode): ("bitonic", "bitonic") (merges on kernel B7,
   sorts on B6), ("sort", "bitonic") (no merge kernel, every tagged and
   compaction sort on B6) and the defaults (B3, `torch.sort`); the three
   must give equal keys, the counts must obey the set identities and
   equal a build of both halves as two records, the operands must keep
   their counts and the launches must equal the numbers derived from the
   code; then, on two overlapping 5 Mbp windows of phase 4's 8 Mbp (and a
   third), all eight operators, `CBL.merge` and `CBL.intersect` key for
   key against numpy's set functions over phase 4's oracle words, and the
   calls that follow on results with holes (query, insert, remove, log
   join, fold, `contains_kmers`) against the same sets;
8. require every kernel of each path to have been launched in that
   path's counted run, print the timings, the kernels' JSON line and,
   last, the device JSON line.

The script imports no JAX.  The kernels and the baseline are built into
`cbl_tpu_torch/_build/`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 25
MAIN_BASES = 32_000_000  # the static headline's stream (bench.py --bases)
SLAB = 1 << 25  # k-mers per slab (cbl_tpu_torch.cbl._FUSED_SLAB)
SEGS = 8  # dynamic rounds (bench.py SEGS, bench/baseline.cpp run_dynamic)
DEVICE = "cuda"
STATIC_KERNELS = ("necklace", "blank", "merge")
ROUND_KERNELS = STATIC_KERNELS + ("slog_scan",)  # the dynamic rounds'
ALGEBRA_KERNELS = ("necklace", "blank", "bitonic_sort", "bitonic_merge")
KERNELS = ROUND_KERNELS + ("sort", "bitonic_sort", "bitonic_merge")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# Peaks of one H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s; 67
# TFLOP/s of float32 outside the tensor cores counts a fused multiply-add
# as two, so its 128 float32 lanes an SM issue 33.5e12 operations a
# second.  Every kernel here works on integers, and an SM has 64 INT32
# lanes (adds, shifts, logic, compares, selects), half as many: 16.75e12
# 32-bit integer operations a second.
HBM_BYTES_S = 3.35e12
INT_OPS_S = 67e12 / 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def max_abs_err(got, want) -> float:
    """0.0 when the tensors are equal, else the largest difference."""
    import torch

    if torch.equal(got, want):
        return 0.0
    return float((got.double() - want.double()).abs().max())


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the HBM peak, or the 32-bit integer
    operations at the INT32 peak, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / INT_OPS_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def cols_equal(got, want) -> float:
    """`max_abs_err` over key columns (a tensor or a tuple of tensors)."""
    import torch

    got = (got,) if isinstance(got, torch.Tensor) else got
    want = (want,) if isinstance(want, torch.Tensor) else want
    assert len(got) == len(want)
    return max(max_abs_err(g, w) for g, w in zip(got, want))


# --- phase 2: each kernel against its plain version -------------------------


def check_kernels(card: str) -> dict:
    import torch

    from cbl_tpu_torch import cbl as cmod
    from cbl_tpu_torch.ops import (LAUNCHES, _build, merge, necklace, scan,
                                   sort)

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    results = {}

    # B1: 2^25 random 50-bit k-mers at K=25, and a small K=7 case
    errs = []
    for W, n in ((2 * K, SLAB), (14, 100_000)):
        x = torch.from_numpy(rng.integers(0, 1 << W, size=n)).to(dev)
        got = necklace.necklace_pos(x, W)
        want = necklace.necklace_pos_plain(x, W)
        errs += [max_abs_err(got[0], want[0]),
                 max_abs_err(got[1].long(), want[1].long())]
        log(f"B1 necklace W={W} n={n}: kernel == plain: {max(errs[-2:]) == 0}")
    x = torch.from_numpy(rng.integers(0, 1 << (2 * K), size=SLAB)).to(dev)
    ms = time_ms(lambda: necklace.necklace_pos(x, 2 * K), 10)
    plain_ms = time_ms(lambda: necklace.necklace_pos_plain(x, 2 * K), 3)
    # 8 bytes read, 8 + 4 written a k-mer.  Operations: W - 1 candidate
    # rotations, each at least seven 32-bit integer instructions on a word
    # held in two registers (two funnel shifts form it from the one
    # before, two compares order it against the best, three selects keep
    # the best's halves and its position).  The kernel's source also
    # masks each rotation, so it executes more than this count
    b1 = bound(SLAB * 20, SLAB * (2 * K - 1) * 7)
    log(f"B1 necklace bound: {b1['bound_ms']:.4f} ms by {b1['bound_by']} "
        f"({(2 * K - 1) * 7} INT32 operations a k-mer at {INT_OPS_S:.4g}/s); "
        f"by bytes alone {bound(SLAB * 20, 0)['bound_ms']:.4f} ms")
    results["necklace"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None, **b1)

    # B2: the delta arrays of a 2^25 slab (the static path's) and of a 2^22
    # slab (the dynamic rounds' and separate calls' 4 Mbp segments, 32 of
    # B2's 35 launches on the default paths), each with many records and a
    # short trailing record, and of one 4 Mbp record as the rounds give it
    idx = cmod.CBL(k=K, device=dev)

    def blank_case(nk, one_record):
        if one_record:
            lens = np.array([MAIN_BASES // SEGS])
        else:
            lens = rng.integers(K, 4096, size=nk // 4096)
            # fill the slab, then end on a short trailing record (< K): at
            # 2^25 the stream runs 5000 positions on into a second slab,
            # below 2^25 it stops 5000 short, or the slab would be 2 nk
            fill = nk + 5000 if nk == SLAB else nk - 5000
            lens = np.append(lens, [max(fill - int(lens.sum()), K), 10])
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        codes = rng.integers(0, 4, size=int(offsets[-1]), dtype=np.uint8)
        nk_pad, _, s_arr, e_arr, _ = idx.pack_stream(codes, offsets).slabs[0]
        assert nk_pad == nk, (nk_pad, nk)
        delta = cmod.blank_delta(s_arr, e_arr, nk_pad)
        got = scan.blank_mask(delta)
        want = scan.blank_mask_plain(delta)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        n_blank = int(want[0].sum())
        log(f"B2 blank n={nk_pad} records={len(lens)} blanked={n_blank} "
            f"n_valid={int(want[1])}: kernel == plain: {err == 0}")
        assert 0 < n_blank < nk_pad
        return delta, err

    # 4 bytes read and 4 written a row (the mask is int32, as
    # `blank_mask_pallas` writes it); an add and a compare a row.  The
    # library's way to the same function is `torch.cumsum`, a compare and
    # a sum: the plain version itself
    delta22, err22 = blank_case(1 << 22, True)
    _, err22m = blank_case(1 << 22, False)
    ms22 = time_ms(lambda: scan.blank_mask(delta22), 50)
    plain22 = time_ms(lambda: scan.blank_mask_plain(delta22), 10)
    b22 = bound((1 << 22) * 8 + 4, (1 << 22) * 2)
    log(f"B2 blank n={1 << 22} (a round's slab): {ms22:.4f} ms, plain "
        f"{plain22:.4f} ms, bound {b22['bound_ms']:.4f} ms by "
        f"{b22['bound_by']} [{card}]")
    delta, err = blank_case(SLAB, False)
    ms = time_ms(lambda: scan.blank_mask(delta), 20)
    plain_ms = time_ms(lambda: scan.blank_mask_plain(delta), 5)
    results["blank"] = dict(
        err=max(err, err22, err22m), ms=ms, plain_ms=plain_ms,
        library_ms=plain_ms, ms_2_22=ms22, plain_ms_2_22=plain22,
        bound_ms_2_22=b22["bound_ms"], **bound(SLAB * 8 + 4, SLAB * 2))
    del delta, delta22

    # B3: 2^25 + 2^25 (the self-query join), skewed sides, an empty side;
    # heavy duplicates and sentinel keys
    def sorted_keys(n, hi, sent_frac=0.0):
        v = rng.integers(0, hi, size=n)
        v[rng.random(n) < sent_frac] = (1 << 63) - 1
        return torch.sort(torch.from_numpy(v).to(dev)).values

    errs = []
    cases = [
        (SLAB, SLAB, 1 << 57, 0.01),  # tagged 56-bit words
        (SLAB, SLAB, 1 << 12, 0.05),  # heavy duplicates
        (SLAB, 4096, 1 << 20, 0.01),
        (0, SLAB, 1 << 20, 0.01),
        (SLAB, 0, 1 << 20, 0.01),
        (12_345, 777, 5, 0.1),
    ]
    for na, nb, hi, sf in cases:
        a, b = sorted_keys(na, hi, sf), sorted_keys(nb, hi, sf)
        errs.append(max_abs_err(merge.merge_sorted(a, b),
                                merge.merge_sorted_plain(a, b)))
        log(f"B3 merge {na} + {nb} (keys < 2^{hi.bit_length() - 1}): "
            f"kernel == plain: {errs[-1] == 0}")
    # two columns, (word, seqtag) rows: a fold's shape (the index of 2^25
    # rows against a sorted log of 2^21) and duplicate-heavy sides
    def sorted_rows(n, hi, sent_frac=0.02):
        w = rng.integers(0, hi, size=n)
        w[rng.random(n) < sent_frac] = (1 << 63) - 1
        t = rng.integers(2, 1 << 23, size=n)
        return merge.sort_cols_plain((torch.from_numpy(w).to(dev),
                                      torch.from_numpy(t).to(dev)))

    for na, nb, hi in ((SLAB, 1 << 21, 1 << 56), (1 << 22, 1 << 22, 50),
                       (0, 5000, 3)):
        a, b = sorted_rows(na, hi), sorted_rows(nb, hi)
        errs.append(cols_equal(merge.merge_sorted(a, b),
                               merge.merge_sorted_plain(a, b)))
        log(f"B3 merge, two columns, {na} + {nb} (words < "
            f"2^{hi.bit_length() - 1}): kernel == plain: {errs[-1] == 0}")
    # the largest fold of the separate calls (`_fold_log_merge_kernel`):
    # an index of 2^26 rows, three quarters of them the sentinel tail,
    # every seqtag 1, against a sorted log of 2^21 (word, seqtag) rows
    w = rng.integers(0, 1 << 56, size=2 * SLAB)
    w[SLAB // 2:] = (1 << 63) - 1
    a = torch.sort(torch.from_numpy(w).to(dev)).values
    a, b = (a, torch.ones_like(a)), sorted_rows(1 << 21, 1 << 56)
    del w
    errs.append(cols_equal(merge.merge_sorted(a, b),
                           merge.merge_sorted_plain(a, b)))
    log(f"B3 merge, two columns, {2 * SLAB} + {1 << 21} (a fold: 75 % "
        f"sentinel tail): kernel == plain: {errs[-1] == 0}")
    ms_fold = time_ms(lambda: merge.merge_sorted(a, b), 5)
    log(f"B3 merge, two columns, {2 * SLAB} + {1 << 21}: {ms_fold:.4f} ms, "
        f"bound {bound(2 * 16 * (2 * SLAB + (1 << 21)), 0)['bound_ms']:.4f} "
        f"ms")
    a, b = sorted_rows(SLAB, 1 << 56), sorted_rows(1 << 21, 1 << 56)
    ms2 = time_ms(lambda: merge.merge_sorted(a, b), 10)
    log(f"B3 merge, two columns, {SLAB} + {1 << 21}: {ms2:.4f} ms, bound "
        f"{bound(2 * 16 * (SLAB + (1 << 21)), 0)['bound_ms']:.4f} ms")
    a, b = sorted_keys(SLAB, 1 << 57), sorted_keys(SLAB, 1 << 57)
    ms = time_ms(lambda: merge.merge_sorted(a, b), 10)
    plain_ms = time_ms(lambda: merge.merge_sorted_plain(a, b), 3)
    # the library's way to the same function: `torch.sort` of both runs
    cat = torch.cat([a, b])
    library_ms = time_ms(lambda: torch.sort(cat), 5)
    log(f"B3 merge {SLAB} + {SLAB}: {ms:.4f} ms, torch.sort of both "
        f"{library_ms:.4f} ms [{card}]")
    # every key read once and written once; a 64-bit compare an output
    results["merge"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        two_col_ms=ms2, fold_ms=ms_fold,
        **bound(2 * 8 * 2 * SLAB, 2 * SLAB * 2))
    del a, b, cat

    # B4: a synthetic slog of 2^26 rows (runs of ~16 rows across every
    # tile boundary and one run of 2^20 rows, a 10 % sentinel tail), at a
    # round's query tag and the join's 0xFF; also 2^26 - 4097 rows and one,
    # 2^23 rows and the 83,886,080 rows that the dynamic rounds' log
    # reaches, and 2^24 rows whose long run is 2^22 rows of queries after
    # one insert (about 1000 tiles in a row that hold no marker)
    errs = []
    round_qtag = (5 << 2) | 2
    for n, query_run in ((2 * SLAB, 0), (2 * SLAB - 4097, 0), (1, 0),
                         (1 << 23, 0), (83_886_080, 0), (1 << 24, 1 << 22)):
        keys = slog_keys(rng, n, query_run)
        label = f"n={n}" + (f", a {query_run}-row query run" if query_run
                            else "")
        for qtag in (round_qtag, 0xFF):
            got = scan.slog_scan_counts(keys, qtag)
            want = scan.slog_scan_counts_plain(keys, qtag)
            errs.append(max(max_abs_err(g, w) for g, w in zip(got, want)))
            log(f"B4 slog_scan {label} qtag={qtag:#x}: hits {int(want[0])} "
                f"live {int(want[1])}: kernel == plain: {errs[-1] == 0}")
            assert n == 1 or int(want[0]) > 0 < int(want[1])
        if n == 2 * SLAB:
            ms = time_ms(lambda: scan.slog_scan_counts(keys, round_qtag), 20)
            plain_ms = time_ms(
                lambda: scan.slog_scan_counts_plain(keys, round_qtag), 3)
        elif n > 1 << 22:
            t = time_ms(lambda: scan.slog_scan_counts(keys, round_qtag), 20)
            # one 8-byte read a row, two counters written; a few compares
            log(f"B4 slog_scan {label}: {t:.4f} ms, bound "
                f"{bound(n * 8 + 16, n * 6)['bound_ms']:.4f} ms [{card}]")
        del keys
    results["slog_scan"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(2 * SLAB * 8 + 16, 2 * SLAB * 6))

    # B5: 2^25 keys in one column (the static build's sort); 2^26 + 2^21
    # keys, three quarters of them sentinels (the largest compaction of
    # the separate calls: a fold's merged index and log); 2^21 + 2^21
    # (word, seqtag) rows (a log join's sort of log and queries) and
    # 2^22 + 2^21; 2^25 - 4097 rows, one row, a constant column, half
    # sentinels; last quads of one, two, three and four runs with a short
    # last run (4 to 7 sort tiles + 123 rows), 2^25 keys of one value and
    # 2^24 keys of three.  Against its plain version and against the
    # library sort, exact, the input kept
    def sort_case(label, keys, plain=True):
        before = [c.clone() for c in merge.as_cols(keys)]
        got = merge.sort_mergepath(keys)
        want = merge.sort_cols_plain(merge.as_cols(keys))
        err = cols_equal(merge.as_cols(got), want)
        if plain:
            err = max(err, cols_equal(
                merge.as_cols(merge.sort_mergepath_plain(keys)), want))
        err = max(err, cols_equal(merge.as_cols(keys), before))
        log(f"B5 sort {label}: kernel == plain == torch.sort, input kept: "
            f"{err == 0}")
        return err

    def rand_keys(n, hi, sent_frac=0.01):
        v = rng.integers(0, hi, size=n)
        v[rng.random(n) < sent_frac] = (1 << 63) - 1
        return torch.from_numpy(v).to(dev)

    n_join = (1 << 22) + (1 << 21)
    n_fold = 2 * SLAB + (1 << 21)
    x1 = rand_keys(SLAB, 1 << 57)
    x2 = (rand_keys(n_join, 1 << 56, 0.02), rand_keys(n_join, 1 << 23, 0))
    x3 = rand_keys(n_fold, 1 << 57, 0.75)
    x4 = (rand_keys(1 << 22, 1 << 56, 0.02), rand_keys(1 << 22, 1 << 23, 0))
    errs = [
        sort_case(f"n={SLAB} one column", x1),
        sort_case(f"n={n_fold} one column, 75 % sentinels", x3),
        sort_case(f"n={n_join} two columns", x2),
        sort_case(f"n={1 << 22} two columns", x4),
        sort_case(f"n={n_join} two columns, 50 words",
                  (rand_keys(n_join, 50, 0.02), x2[1])),
        sort_case(f"n={SLAB - 4097}", x1[: SLAB - 4097].contiguous()),
        sort_case("n=1", x1[:1].contiguous()),
        sort_case(f"n={1 << 24} constant", torch.full_like(x1[: 1 << 24], 7)),
        sort_case(f"n={1 << 24} half sentinels",
                  rand_keys(1 << 24, 1 << 57, 0.5)),
        sort_case(f"n={SLAB} of one value", torch.full_like(x1, 7),
                  plain=False),
        sort_case(f"n={1 << 24} of three values", rand_keys(1 << 24, 3, 0)),
    ]
    for c, tile in merge.SORT_TILES.items():
        for tiles in (4, 5, 6, 7):
            n = tiles * tile + 123
            keys = rand_keys(n, 1 << 20, 0.1)
            if c == 2:
                keys = (keys, rand_keys(n, 3, 0))
            errs.append(sort_case(
                f"n={n} ({tiles} tiles + 123), {c} column(s)", keys))
    merge.sort_mergepath(x1)
    planned = len(merge.mergepath_passes(SLAB, merge.SORT_TILES[1]))
    b5_passes = _build.PASSES["sort"]
    log(f"B5 sort n={SLAB} one column: {b5_passes} passes over device "
        f"memory launched, the Python schedule has {planned}")
    assert b5_passes == planned <= 9
    n_sort = LAUNCHES["sort"]
    with sort.use_sort_mode("library"):
        assert torch.equal(sort.sort_keys(x1), torch.sort(x1).values)
    assert LAUNCHES["sort"] == n_sort  # the default mode never launches B5
    ms = time_ms(lambda: merge.sort_mergepath(x1), 5)
    plain_ms = time_ms(lambda: merge.sort_mergepath_plain(x1), 2)
    library_ms = time_ms(lambda: torch.sort(x1), 5)
    log(f"B5 sort, one column, {SLAB}: {ms:.4f} ms, torch.sort "
        f"{library_ms:.4f} ms, bound "
        f"{bound(2 * 8 * SLAB, 0)['bound_ms']:.4f} ms [{card}]")
    ms2 = time_ms(lambda: merge.sort_mergepath(x2), 5)
    lib2 = time_ms(lambda: merge.sort_cols_plain(x2), 5)
    log(f"B5 sort, two columns, {n_join}: {ms2:.4f} ms, two stable "
        f"torch.sort passes {lib2:.4f} ms, bound "
        f"{bound(2 * 16 * n_join, 0)['bound_ms']:.4f} ms [{card}]")
    ms3 = time_ms(lambda: merge.sort_mergepath(x3), 3)
    lib3 = time_ms(lambda: torch.sort(x3), 3)
    log(f"B5 sort, one column, {n_fold} (75 % sentinels): {ms3:.4f} ms, "
        f"torch.sort {lib3:.4f} ms, bound "
        f"{bound(2 * 8 * n_fold, 0)['bound_ms']:.4f} ms [{card}]")
    ms4 = time_ms(lambda: merge.sort_mergepath(x4), 5)
    lib4 = time_ms(lambda: merge.sort_cols_plain(x4), 5)
    log(f"B5 sort, two columns, {1 << 22}: {ms4:.4f} ms, two stable "
        f"torch.sort passes {lib4:.4f} ms, bound "
        f"{bound(2 * 16 * (1 << 22), 0)['bound_ms']:.4f} ms [{card}]")
    # every key read once and written once; n log2 n 64-bit compares
    results["sort"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        two_col_ms=ms2, two_col_library_ms=lib2, fold_ms=ms3,
        fold_library_ms=lib3, passes=b5_passes,
        **bound(2 * 8 * SLAB, SLAB * 25 * 2))
    del x1, x2, x3, x4
    results.update(check_bitonic(rng, results["merge"]["ms"], card))

    for name, r in results.items():
        lib = r["library_ms"]
        log(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library call {'none' if lib is None else f'{lib:.4f} ms'}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} [{card}]")
        if r["err"] != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return results


def check_bitonic(rng, b3_ms: float, card: str) -> dict:
    """B6 and B7 against their plain versions and against `torch.sort`,
    exact, at the shapes the set-algebra path gives them; `b3_ms` is
    kernel B3's time for 2^25 + 2^25 keys, printed beside B7's."""
    import torch

    from cbl_tpu_torch.ops import LAUNCHES, _build, bitonic, merge, sort

    dev = torch.device(DEVICE)
    pad = (1 << 63) - 1

    def rand_keys(n, hi, sent_frac=0.01):
        v = rng.integers(0, hi, size=n)
        v[rng.random(n) < sent_frac] = pad
        return torch.from_numpy(v).to(dev)

    # B6: 2^24 keys (a `_dedup` of one operand, a build's sort) and 2^25
    # (a tagged sort of both operands, the compaction of a result with
    # holes), the latter with three quarters sentinels too; 2^22 + 2^21
    # (word, seqtag) rows (a log join); one row; a length that is neither
    # a power of two nor a multiple of the tile; constant keys; P / 2 + 1
    # and P - 1 rows for P = 2^24; one row more than a tile.  The plain
    # versions are the pass-by-pass one and the step-by-step network
    def sort_case(label, keys, plain=True):
        before = [c.clone() for c in merge.as_cols(keys)]
        got = bitonic.bitonic_sort(keys)
        torch.cuda.synchronize()
        want = merge.sort_cols_plain(merge.as_cols(keys))
        err = cols_equal(merge.as_cols(got), want)
        if plain:
            for fn in (bitonic.bitonic_sort_passes_plain,
                       bitonic.bitonic_sort_plain):
                err = max(err, cols_equal(merge.as_cols(fn(keys)), want))
            torch.cuda.synchronize()
        err = max(err, cols_equal(merge.as_cols(keys), before))
        log(f"B6 bitonic sort {label}: kernel == plain == torch.sort, input "
            f"kept: {err == 0}")
        return err

    n_join = (1 << 22) + (1 << 21)
    x24, x25 = rand_keys(1 << 24, 1 << 57), rand_keys(SLAB, 1 << 57)
    x2 = (rand_keys(n_join, 1 << 56, 0.02), rand_keys(n_join, 1 << 23, 0))
    n0 = LAUNCHES["bitonic_sort"]
    errs = [
        sort_case(f"n={1 << 24} one column", x24),
        sort_case(f"n={SLAB} one column", x25),
        sort_case(f"n={SLAB} one column, 75 % sentinels",
                  rand_keys(SLAB, 1 << 57, 0.75), plain=False),
        sort_case(f"n={n_join} two columns", x2),
        sort_case(f"n={n_join} two columns, 50 words",
                  (rand_keys(n_join, 50, 0.02), x2[1]), plain=False),
        sort_case(f"n={(1 << 24) - 4097}",
                  x24[: (1 << 24) - 4097].contiguous(), plain=False),
        sort_case("n=1000003", x24[:1_000_003].contiguous()),
        sort_case("n=4097, two columns",
                  (x2[0][:4097].contiguous(), x2[1][:4097].contiguous())),
        sort_case("n=1", x24[:1].contiguous()),
        sort_case(f"n={1 << 22} constant", torch.full_like(x24[: 1 << 22], 7)),
        sort_case(f"n={(1 << 23) + 1} (P / 2 + 1)",
                  x24[: (1 << 23) + 1].contiguous()),
        sort_case(f"n={(1 << 24) - 1} (P - 1)",
                  x24[: (1 << 24) - 1].contiguous(), plain=False),
        sort_case(f"n={(1 << 22) + 1}, two columns (P / 2 + 1)",
                  (x2[0][: (1 << 22) + 1].contiguous(),
                   x2[1][: (1 << 22) + 1].contiguous()), plain=False),
        sort_case(f"n={bitonic.TILES[1] + 1} (a tile + 1)",
                  x24[: bitonic.TILES[1] + 1].contiguous()),
        sort_case(f"n={bitonic.TILES[2] + 1}, two columns (a tile + 1)",
                  (x2[0][: bitonic.TILES[2] + 1].contiguous(),
                   x2[1][: bitonic.TILES[2] + 1].contiguous())),
    ]
    bitonic.bitonic_sort(x25)
    n0 += 1
    planned = len(bitonic.network_passes(
        SLAB, bitonic.TILES[1], bitonic.fuse_log(bitonic.TILES[1])))
    b6_passes = _build.PASSES["bitonic_sort"]
    log(f"B6 bitonic sort n={SLAB} one column: {b6_passes} passes over "
        f"device memory launched, the Python schedule has {planned}")
    assert b6_passes == planned <= 32
    assert LAUNCHES["bitonic_sort"] == n0 + len(errs) - 1  # one row: none
    with sort.use_sort_mode("bitonic"):
        assert torch.equal(sort.sort_keys(x24), torch.sort(x24).values)
    assert LAUNCHES["bitonic_sort"] == n0 + len(errs)
    ms24 = time_ms(lambda: bitonic.bitonic_sort(x24), 3)
    lib24 = time_ms(lambda: torch.sort(x24), 5)
    ms = time_ms(lambda: bitonic.bitonic_sort(x25), 3)
    plain_ms = time_ms(lambda: bitonic.bitonic_sort_passes_plain(x25), 1)
    library_ms = time_ms(lambda: torch.sort(x25), 5)
    ms2 = time_ms(lambda: bitonic.bitonic_sort(x2), 3)
    lib2 = time_ms(lambda: merge.sort_cols_plain(x2), 5)
    log(f"B6 bitonic sort, one column, {SLAB}: {ms:.4f} ms, torch.sort "
        f"{library_ms:.4f} ms, bound "
        f"{bound(2 * 8 * SLAB, 0)['bound_ms']:.4f} ms [{card}]")
    log(f"B6 bitonic sort, one column, {1 << 24}: {ms24:.4f} ms, torch.sort "
        f"{lib24:.4f} ms, bound {bound(2 * 8 * (1 << 24), 0)['bound_ms']:.4f}"
        f" ms [{card}]")
    log(f"B6 bitonic sort, two columns, {n_join}: {ms2:.4f} ms, two stable "
        f"torch.sort passes {lib2:.4f} ms, bound "
        f"{bound(2 * 16 * n_join, 0)['bound_ms']:.4f} ms [{card}]")
    # every key read once and written once; n log2 n 64-bit compares
    out = {"bitonic_sort": dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        ms_2_24=ms24, library_ms_2_24=lib24, two_col_ms=ms2,
        two_col_library_ms=lib2, passes=b6_passes,
        **bound(2 * 8 * SLAB, SLAB * 25 * 2))}
    del x2, x25

    # B7: 2^24 + 2^24 (a set operation of the two operands), 2^25 + 2^24
    # (a chained operation on a union), 2^24 + 1000, an empty side, one
    # row, 2^25 + 2^21 (word, seqtag) rows (a fold over an index), and B3's
    # shapes of the largest fold (2^26 + 2^21 rows, 75 % sentinels) and of
    # a log join (2^22 + 2^21 rows).  The plain versions are the tiled one
    # (always) and the step-by-step network over 2 M rows (with `plain`)
    def sorted_keys(n, hi, sent_frac=0.01):
        return torch.sort(rand_keys(n, hi, sent_frac)).values

    def sorted_rows(n, hi):
        return merge.sort_cols_plain((rand_keys(n, hi, 0.02),
                                      rand_keys(n, 1 << 23, 0)))

    def merge_case(label, a, b, plain=True):
        before = [c.clone() for c in merge.as_cols(a) + merge.as_cols(b)]
        got = bitonic.bitonic_merge(a, b)
        torch.cuda.synchronize()
        want = merge.sort_cols_plain(tuple(
            torch.cat([x, y])
            for x, y in zip(merge.as_cols(a), merge.as_cols(b))))
        err = cols_equal(merge.as_cols(got), want)
        fns = (bitonic.bitonic_merge_tiled_plain,) + (
            (bitonic.bitonic_merge_plain,) if plain else ())
        for fn in fns:
            err = max(err, cols_equal(merge.as_cols(fn(a, b)), want))
        torch.cuda.synchronize()
        err = max(err, cols_equal(merge.as_cols(a) + merge.as_cols(b),
                                  before))
        log(f"B7 bitonic merge {label}: kernel == plain == torch.sort of "
            f"both, inputs kept: {err == 0}")
        return err

    half = 1 << 24
    a24, b24 = sorted_keys(half, 1 << 57), sorted_keys(half, 1 << 57)
    a25 = sorted_keys(SLAB, 1 << 57)
    empty = a24[:0]
    # the fold: an index of 2^26 rows, three quarters the sentinel tail,
    # every seqtag 1, against a sorted log of 2^21 (word, seqtag) rows
    w = rand_keys(2 * SLAB, 1 << 56, 0)
    w[SLAB // 2:] = pad
    w = torch.sort(w).values
    fold = ((w, torch.ones_like(w)), sorted_rows(1 << 21, 1 << 56))
    join = (sorted_rows(1 << 22, 1 << 56), sorted_rows(1 << 21, 1 << 56))
    del w
    tile = bitonic.MERGE_TILES[1]
    n0 = LAUNCHES["bitonic_merge"]
    errs = [
        merge_case(f"{half} + {half}", a24, b24),
        merge_case(f"{SLAB} + {half}", a25, b24),
        merge_case(f"{half} + {SLAB}", b24, a25, plain=False),
        merge_case(f"{half} + 1000", a24, b24[:1000].contiguous()),
        merge_case(f"{half} + 0", a24, empty),
        merge_case(f"0 + {half}", empty, a24, plain=False),
        merge_case("1 + 0", a24[:1].contiguous(), empty),
        merge_case("12345 + 777, keys < 5", sorted_keys(12_345, 5, 0.1),
                   sorted_keys(777, 5, 0.1)),
        merge_case(f"{half} + {half}, heavy duplicates",
                   sorted_keys(half, 1 << 12, 0.05),
                   sorted_keys(half, 1 << 12, 0.05), plain=False),
        merge_case(f"{SLAB} + {1 << 21}, two columns",
                   sorted_rows(SLAB, 1 << 56), sorted_rows(1 << 21, 1 << 56)),
        merge_case("3000 + 5000, two columns, 3 words",
                   sorted_rows(3000, 3), sorted_rows(5000, 3)),
        merge_case(f"{2 * SLAB} + {1 << 21}, two columns (a fold: 75 % "
                   f"sentinel tail)", *fold, plain=False),
        merge_case(f"{1 << 22} + {1 << 21}, two columns (a log join)",
                   *join),
        merge_case(f"{tile * 3 + 1} + {tile - 2}, keys < 3 (tile edges)",
                   sorted_keys(tile * 3 + 1, 3, 0.3),
                   sorted_keys(tile - 2, 3, 0.3)),
    ]
    assert LAUNCHES["bitonic_merge"] == n0 + len(errs)
    bitonic.bitonic_merge(a24, b24)
    b7_passes = _build.PASSES["bitonic_merge"]
    planned = len(bitonic.merge_passes(2 * half, tile))
    log(f"B7 bitonic merge {half} + {half}: {b7_passes} pass over device "
        f"memory launched, the Python schedule has {planned}")
    assert b7_passes == planned == 1
    ms = time_ms(lambda: bitonic.bitonic_merge(a24, b24), 5)
    plain_ms = time_ms(
        lambda: bitonic.bitonic_merge_tiled_plain(a24, b24), 2)
    cat = torch.cat([a24, b24])
    library_ms = time_ms(lambda: torch.sort(cat), 5)
    b3_here = time_ms(lambda: merge.merge_sorted(a24, b24), 10)
    ms3 = time_ms(lambda: bitonic.bitonic_merge(a25, b24), 5)
    b3_3 = time_ms(lambda: merge.merge_sorted(a25, b24), 10)
    log(f"B7 bitonic merge {half} + {half}: {ms:.4f} ms, torch.sort of both "
        f"{library_ms:.4f} ms, kernel B3 {b3_here:.4f} ms (B3 at {SLAB} + "
        f"{SLAB}: {b3_ms:.4f} ms) [{card}]")
    log(f"B7 bitonic merge {SLAB} + {half}: {ms3:.4f} ms, kernel B3 "
        f"{b3_3:.4f} ms, bound "
        f"{bound(2 * 8 * (SLAB + half), 0)['bound_ms']:.4f} ms [{card}]")
    extra = {}
    for label, (a, b) in (("fold", fold), ("join", join)):
        n = a[0].shape[0] + b[0].shape[0]
        extra[f"{label}_ms"] = time_ms(lambda: bitonic.bitonic_merge(a, b),
                                       5)
        extra[f"{label}_b3_ms"] = time_ms(lambda: merge.merge_sorted(a, b),
                                          5)
        extra[f"{label}_bound_ms"] = bound(2 * 16 * n, 0)["bound_ms"]
        log(f"B7 bitonic merge, two columns, {a[0].shape[0]} + "
            f"{b[0].shape[0]} ({label}): {extra[f'{label}_ms']:.4f} ms, "
            f"kernel B3 {extra[f'{label}_b3_ms']:.4f} ms, bound "
            f"{extra[f'{label}_bound_ms']:.4f} ms [{card}]")
    # every key read once and written once; a 64-bit compare an output
    out["bitonic_merge"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        b3_ms=b3_here, ms_2_25_2_24=ms3, b3_ms_2_25_2_24=b3_3,
        passes=b7_passes, **extra, **bound(2 * 8 * 2 * half, 2 * half * 2))
    return out


def slog_keys(rng, n: int, query_run: int = 0):
    """Sorted slog keys (`cbl_tpu_torch.wordset.slog_key`) on the card:
    words of runs of ~16 rows and one run of min(n / 64, 2^20) rows, tags
    (seq << 2) | typ of seqs 0-7 (insert twice as often as query or
    remove), 5 % 0xFF join queries, a 10 % sentinel tail.  With
    `query_run`, the long run has `query_run` rows instead: one insert,
    then queries only, so that no row after its first is a marker and the
    liveness must cross query_run / SLOG_TILE tiles unchanged."""
    import torch

    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.wordset import slog_key

    dev = torch.device(DEVICE)
    words = rng.integers(0, max(n // 16, 1), size=n) * 977 + (1 << 40)
    words[: query_run or min(n // 64, 1 << 20)] = 12345
    tags = (rng.integers(0, 8, size=n) << 2) | rng.choice([1, 1, 2, 3], n)
    tags[rng.random(n) < 0.05] = 0xFF
    if query_run:
        tags[:query_run] = np.where(tags[:query_run] == 0xFF, 0xFF,
                                    (tags[:query_run] & ~3) | 2)
        tags[0] = 1  # seq 0's insert sorts first in the run
    keys = slog_key(torch.from_numpy(words).to(dev),
                    torch.from_numpy(tags).to(dev))
    keys[n - n // 10:] = SENTINEL
    return torch.sort(keys).values


# --- phase 3 and 4: the static path ------------------------------------------


def build_baseline() -> str:
    from cbl_tpu_torch.ops._build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = BUILD_DIR / "baseline"
    subprocess.run(
        ["g++", "-O3", "-std=c++17",
         os.path.join(REPO, "bench", "baseline.cpp"), "-o", str(exe)],
        check=True,
    )
    return str(exe)


def run_baseline(exe: str, codes: np.ndarray, mode: str | None) -> dict:
    """`bench/baseline.cpp` on `codes`; mode None (static), "canonical" or
    "dynamic"."""
    from cbl_tpu_torch.ops._build import BUILD_DIR

    path = BUILD_DIR / "codes.bin"
    codes.tofile(path)
    cmd = [exe, str(path)] + ([mode] if mode else [])
    out = subprocess.run(cmd, capture_output=True, check=True, timeout=600)
    path.unlink()
    return json.loads(out.stdout)


def static_run(codes: np.ndarray, offsets: np.ndarray, canonical: bool):
    """One build+query of the stream: (index, stream, result dict)."""
    import torch

    from cbl_tpu_torch import CBL

    torch.cuda.synchronize()
    idx = CBL(k=K, canonical=canonical, device=DEVICE)
    t_s = time.perf_counter()
    ps = idx.pack_stream(codes, offsets)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t_s
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    idx.insert_codes_stream(ps)
    n_dev = idx.count_device()
    ev[1].record()
    total_dev, pos_dev = idx.query_codes_stream(ps, lazy=True)
    ev[2].record()
    distinct, total, positive = torch.stack(
        [n_dev.long(), total_dev.long(), pos_dev.long()]
    ).tolist()
    wall_s = time.perf_counter() - t0
    return idx, ps, dict(
        distinct=distinct, total=total, positive=positive, stage_s=stage_s,
        wall_s=wall_s, insert_ms=ev[0].elapsed_time(ev[1]),
        query_ms=ev[1].elapsed_time(ev[2]),
    )


# --- phase 5: the dynamic path ------------------------------------------------


def dynamic_run(codes: np.ndarray, timed: bool):
    """`bench.py --mode dynamic` on the port: SEGS rounds of
    `dynamic_round(segs[i], segs[max(i-1, 0)], halves[i], lazy=True)`,
    one sync for the distinct count and the summed positives.  With
    `timed`, the launch counters are set to 0 after staging and read
    after the sync.  -> (index, segs, result dict)."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES

    sb = len(codes) // SEGS
    off1 = np.array([0, sb], dtype=np.int64)
    off_h = np.array([0, sb // 2], dtype=np.int64)
    torch.cuda.synchronize()
    idx = CBL(k=K, device=DEVICE)
    t0 = time.perf_counter()  # bench.py's t0: staging is inside the wall
    segs = [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
            for i in range(SEGS)]
    halves = [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
              for i in range(SEGS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if timed:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    pos_dev = None
    ops = 0
    for i in range(SEGS):
        _, p = idx.dynamic_round(segs[i], segs[i - 1 if i else 0], halves[i],
                                 lazy=True)
        pos_dev = p if pos_dev is None else pos_dev + p
        ops += 2 * (sb - K + 1) + sb // 2 - K + 1
    n_dev = idx.count_device()
    ev[1].record()
    distinct, positive = torch.stack([n_dev, pos_dev]).tolist()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES) if timed else None
    ws = idx.wordset
    return idx, segs, dict(
        ops=ops, distinct=distinct, positive=positive,
        wall_s=t2 - t0, stage_s=t1 - t0, rounds_s=t2 - t1,
        rounds_ms=ev[0].elapsed_time(ev[1]), launches=launches,
        log_rows=ws._slog.shape[0], log_real=ws._slog_real,
        seq=ws._slog_seq,
    )


# --- phase 6: the separate calls -------------------------------------------------


def separate_run(codes: np.ndarray, sort_mode: str, log_at_query: bool):
    """`dynamic_round`'s fallback on the port, under sort mode `sort_mode`:
    SEGS rounds of `insert_codes_stream(segs[i])`,
    `query_codes_stream(segs[max(i-1, 0)], lazy=True)`,
    `remove_codes_stream(halves[i])`, then `count_device()` and one sync
    for the distinct count and the summed positives.  `log_at_query` says
    whether the inserts fit the pending log (then every query after round
    0 joins index and log) or exceed it (then every query sees an empty
    log); either way the removes stay in the log.  The launch counters
    are set to 0 after staging and read after the sync.
    -> (index, segs, result dict)."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES
    from cbl_tpu_torch.ops.sort import use_sort_mode

    sb = len(codes) // SEGS
    off1 = np.array([0, sb], dtype=np.int64)
    off_h = np.array([0, sb // 2], dtype=np.int64)
    torch.cuda.synchronize()
    with use_sort_mode(sort_mode):
        idx = CBL(k=K, device=DEVICE)
        ws = idx.wordset
        t0 = time.perf_counter()
        segs = [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
                for i in range(SEGS)]
        halves = [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
                  for i in range(SEGS)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        pos_dev = None
        ops = 0
        for i in range(SEGS):
            idx.insert_codes_stream(segs[i])
            assert (ws.n_pending > 0) == (log_at_query and i > 0), (
                i, ws.n_pending)
            _, p = idx.query_codes_stream(segs[i - 1 if i else 0], lazy=True)
            idx.remove_codes_stream(halves[i])
            assert ws.n_pending > 0 and ws._pending_rm, i
            pos_dev = p if pos_dev is None else pos_dev + p
            ops += 2 * (sb - K + 1) + sb // 2 - K + 1
        n_dev = idx.count_device()
        ev[1].record()
        distinct, positive = torch.stack([n_dev, pos_dev]).tolist()
        t2 = time.perf_counter()
    return idx, segs, dict(
        mode=sort_mode, ops=ops, distinct=distinct, positive=positive,
        wall_s=t2 - t0, stage_s=t1 - t0, calls_s=t2 - t1,
        calls_ms=ev[0].elapsed_time(ev[1]), launches=dict(LAUNCHES),
        index_rows=ws.data.shape[0], n_upper=ws._n_upper,
    )


def separate_launches(sort_mode: str, log_at_query: bool) -> dict:
    """The launches of one `separate_run`, derived from the code.

    Every stream runs the word pipeline once (B1, B2): 2 a round.  Round
    0 sorts its segment into the empty index, joins it with one merge and
    appends its removes.  Every later round folds the logged removes at
    its insert (a sort of the log, a two-column merge with the index, a
    compaction sort), sorts its segment, joins with one merge, and
    - run A (inserts exceed the log): merges the segment into the index;
    - run B (inserts fit the log): sorts log and queries for the join,
      and at the remove, which does not fit beside the inserts, sorts and
      merges the logged inserts into the index.
    `count_device()` folds the last removes (two sorts, one merge).  The
    default mode does the same sorts with `torch.sort`."""
    later = SEGS - 1
    sorts = 1 + later * (5 if log_at_query else 3) + 2
    return {**NO_LAUNCHES, "necklace": 2 * SEGS, "blank": 2 * SEGS,
            "merge": 1 + later * 3 + 1,
            "sort": sorts if sort_mode == "mergepath" else 0}


def np_kmers(codes: np.ndarray) -> np.ndarray:
    """The k-mers of one record as packed uint64 (first base most
    significant)."""
    nk = len(codes) - K + 1
    v = np.zeros(nk, dtype=np.uint64)
    for j in range(K):
        v = (v << np.uint64(2)) | codes[j:j + nk].astype(np.uint64)
    return v


def point_ops_check(idx, seg_codes: np.ndarray) -> str:
    """`insert_kmers`, `remove_kmers` and `contains_kmers` of a few
    thousand k-mers on a built index, no fold in between, against a
    Python oracle: the last logged op of a k-mer decides, else whether
    the indexed stream holds it."""
    rng = np.random.default_rng(6)
    ws = idx.wordset
    idx.flush()
    data = ws.data
    base = np_kmers(seg_codes)
    inside = [int(v) for v in base[rng.integers(0, len(base), size=3000)]]
    outside = [int(v) for v in rng.integers(0, 1 << (2 * K), size=3000)]
    last = {}
    idx.remove_kmers(inside[:1000])
    last.update((v, False) for v in inside[:1000])
    idx.insert_kmers(outside[:2000])
    last.update((v, True) for v in outside[:2000])
    idx.remove_kmers(outside[500:1000] + inside[2000:2200])
    last.update((v, False) for v in outside[500:1000] + inside[2000:2200])
    idx.insert_kmers(inside[:300])
    last.update((v, True) for v in inside[:300])
    probe = inside + outside
    in_base = np.isin(np.array(probe, dtype=np.uint64), base)
    want = [last.get(v, bool(b)) for v, b in zip(probe, in_base)]
    got = idx.contains_kmers(probe)
    assert got.tolist() == want, "point operations disagree with the oracle"
    assert ws.data is data and ws.n_pending == 1000 + 2000 + 700 + 300
    return (f"point operations: {len(probe)} k-mers probed after 4000 "
            f"logged ops, {int(got.sum())} present, no fold "
            f"(n_pending {ws.n_pending}): masks == oracle")


def multi_slab_round_check(codes: np.ndarray) -> str:
    """One `dynamic_round` whose insert stream has two slabs takes the
    separate calls; the same three calls on a second index agree."""
    from cbl_tpu_torch import CBL

    one = lambda c: (c, np.array([0, len(c)], dtype=np.int64))
    base, ins = one(codes[:1_000_000]), codes[500_000:2_000_000]
    qry, rm = one(codes[:2_500_000]), one(codes[1_000_000:1_800_000])
    a, b = CBL(k=K, device=DEVICE), CBL(k=K, device=DEVICE)
    a.insert_codes_stream(*base)
    b.insert_codes_stream(*base)
    ps = a.pack_stream(*one(ins), slab=1 << 20)
    assert len(ps.slabs) == 2
    got = a.dynamic_round(ps, qry, rm)
    assert a.wordset._slog is None and a.wordset.n_pending > 0
    b.insert_codes_stream(*one(ins))
    want = b.query_codes_stream(*qry)
    b.remove_codes_stream(*rm)
    assert got == want and 0 < got[1] < got[0], (got, want)
    assert a.count() == b.count() > 0
    return (f"two-slab round: slabs {[s[0] for s in ps.slabs]}, (total, "
            f"positive) {got} == the separate calls, count {a.count()}")


# --- phase 7: set algebra ---------------------------------------------------------

ALGEBRA_OPS = (("union", lambda a, b: a | b), ("inter", lambda a, b: a & b),
               ("diff", lambda a, b: a - b), ("symdiff", lambda a, b: a ^ b))
ALGEBRA_MODES = (("bitonic", "bitonic"), ("sort", "bitonic"),
                 ("mergepath", "library"))  # (merge mode, sort mode)


def algebra_run(codes: np.ndarray, merge_mode: str, sort_mode: str):
    """`bench.py --mode algebra` on the port without its serde round-trip,
    under one (merge mode, sort mode) pair: `a` from the first half of
    `codes`, `b` from the second (one record each), then `a | b`,
    `a & b`, `a - b`, `a ^ b`, each followed by `count()`.  The operands
    are built anew, so the run pays what a first pass pays (two dedup
    sorts at `a & b`).  The launch counters are set to 0 before the
    builds and read after the last count; the device events and the host
    clock bracket the four operations.
    -> ((a, b), {name: result index}, result dict)."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES
    from cbl_tpu_torch.ops.sort import use_merge_mode, use_sort_mode

    half = len(codes) // 2
    torch.cuda.synchronize()
    with use_merge_mode(merge_mode), use_sort_mode(sort_mode):
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        a, b = CBL(k=K, device=DEVICE), CBL(k=K, device=DEVICE)
        a.insert_codes_stream(codes[:half], np.array([0, half]))
        b.insert_codes_stream(codes[half:], np.array([0, len(codes) - half]))
        counts = {"a": a.count(), "b": b.count()}
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(ALGEBRA_OPS) + 1)]
        out, host_ms = {}, {}
        ev[0].record()
        for i, (name, op) in enumerate(ALGEBRA_OPS):
            t0 = time.perf_counter()
            out[name] = op(a, b)
            counts[name] = out[name].count()
            host_ms[name] = (time.perf_counter() - t0) * 1e3
            ev[i + 1].record()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        counts["a after"], counts["b after"] = a.count(), b.count()
    return (a, b), out, dict(
        modes=(merge_mode, sort_mode), counts=counts, host_ms=host_ms,
        device_ms={name: ev[i].elapsed_time(ev[i + 1])
                   for i, (name, _) in enumerate(ALGEBRA_OPS)},
        ops_ms=ev[0].elapsed_time(ev[-1]), launches=launches,
        holes={n: r.wordset._holes for n, r in out.items()},
        rows={n: r.wordset.data.shape[0] for n, r in out.items()})


def algebra_launches(merge_mode: str, sort_mode: str) -> dict:
    """The launches of one `algebra_run`, derived from the code.

    The two builds run the word pipeline once each (B1, B2) and sort
    their slab.  Under a merge kernel each operation is one merge of the
    two operands, and `a & b` first sorts each operand once to drop its
    duplicates (`a ^ b` finds them gone).  In the "sort" merge mode there
    is no merge: the union is a sort of both and a compaction sort, each
    marking operation a tagged sort of both and a compaction sort, and
    `a & b` pays the same two dedup sorts."""
    merges = len(ALGEBRA_OPS) if merge_mode != "sort" else 0
    sorts = 2 + 2 + (0 if merges else 2 * len(ALGEBRA_OPS))
    return {**NO_LAUNCHES, "necklace": 2, "blank": 2,
            "merge": merges if merge_mode == "mergepath" else 0,
            "bitonic_merge": merges if merge_mode == "bitonic" else 0,
            "sort": sorts if sort_mode == "mergepath" else 0,
            "bitonic_sort": sorts if sort_mode == "bitonic" else 0}


def index_keys(idx):
    """The keys of an index, ascending, as a tensor on the card (the
    index is compacted and its duplicates dropped first)."""
    ws = idx.wordset
    ws.flush()
    ws._compact()
    ws._dedup()
    return ws.data[: ws.n]


def algebra_check(codes: np.ndarray) -> dict:
    """Phase 7's full-size runs: one warm-up and one counted pass of
    `algebra_run` per mode pair; exact checks across the pairs."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops.sort import use_merge_mode, use_sort_mode

    runs, keys = {}, {}
    for modes in ALGEBRA_MODES:
        algebra_run(codes, *modes)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        (a, b), out, r = algebra_run(codes, *modes)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"set algebra {modes}: {r}")
        want = algebra_launches(*modes)
        assert r["launches"] == want, (r["launches"], want)
        c = r["counts"]
        assert (c["a"], c["b"]) == (c["a after"], c["b after"]), c
        assert c["union"] + c["inter"] == c["a"] + c["b"], c
        assert c["diff"] == c["a"] - c["inter"], c
        assert c["symdiff"] == c["union"] - c["inter"], c
        merged = modes[0] != "sort"
        assert r["holes"] == {"union": False, "inter": merged,
                              "diff": merged, "symdiff": merged}, r["holes"]
        with use_merge_mode(modes[0]), use_sort_mode(modes[1]):
            keys[modes] = {n: index_keys(x) for n, x in out.items()}
        for n, k in keys[modes].items():
            assert k.shape[0] == c[n], (n, k.shape, c[n])
        runs[modes] = r
        del a, b, out
    first = ALGEBRA_MODES[0]
    for modes in ALGEBRA_MODES[1:]:
        assert runs[modes]["counts"] == runs[first]["counts"]
        for n, k in keys[modes].items():
            assert torch.equal(k, keys[first][n]), (modes, n)
    del keys
    # the union's count against one build of both halves as two records
    both = CBL(k=K, device=DEVICE)
    both.insert_codes_stream(
        codes, np.array([0, len(codes) // 2, len(codes)], dtype=np.int64))
    assert both.count() == runs[first]["counts"]["union"], (
        both.count(), runs[first]["counts"])
    log(f"set algebra: three mode pairs give equal keys; counts "
        f"{runs[first]['counts']}; union == a build of both halves as two "
        f"records")
    return runs


def algebra_overlap_check(codes: np.ndarray, words: np.ndarray) -> str:
    """Set algebra with real overlap, key for key against numpy: three
    windows of `codes` (one record; `words` are its necklace words, word
    j of the k-mer at base j) as indexes a = [0, 5M), b = [3M, 8M),
    c = [2M, 6M); all eight operators, `CBL.merge` and `CBL.intersect`
    under the ("bitonic", "bitonic") modes; then the calls that follow on
    results with holes."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES
    from cbl_tpu_torch.ops.sort import use_merge_mode, use_sort_mode

    M = len(codes) // 8  # 1 Mbp on phase 4's 8 Mbp
    assert len(words) == len(codes) - K + 1

    def window(lo, hi):
        """(stream, its words) of bases [lo, hi) as one record."""
        return ((codes[lo:hi], np.array([0, hi - lo], dtype=np.int64)),
                words[lo:hi - K + 1])

    def build(lo, hi):
        stream, w = window(lo, hi)
        idx = CBL(k=K, device=DEVICE)
        idx.insert_codes_stream(*stream)
        return idx, np.unique(w)

    def same(idx, want, what):
        got = index_keys(idx).cpu().numpy().astype(np.uint64)
        assert np.array_equal(got, want), (
            f"{what}: {len(got)} keys, the oracle has {len(want)}")
        assert idx.count() == len(want) > 0, what

    n0 = {n: LAUNCHES[n] for n in ("bitonic_sort", "bitonic_merge")}
    with use_merge_mode("bitonic"), use_sort_mode("bitonic"):
        (a, wa), (b, wb), (c, wc) = (build(0, 5 * M), build(3 * M, 8 * M),
                                     build(2 * M, 6 * M))
        u1 = lambda x, y: np.union1d(x, y)
        i1 = lambda x, y: np.intersect1d(x, y, assume_unique=True)
        d1 = lambda x, y: np.setdiff1d(x, y, assume_unique=True)
        x1 = lambda x, y: np.setxor1d(x, y, assume_unique=True)
        same(a | b, u1(wa, wb), "a | b")
        same(a & b, i1(wa, wb), "a & b")
        same(a - b, d1(wa, wb), "a - b")
        same(a ^ b, x1(wa, wb), "a ^ b")
        t, wt = a | c, u1(wa, wc)
        t &= b
        wt = i1(wt, wb)
        same(t, wt, "t &= b")
        t ^= a
        wt = x1(wt, wa)
        same(t, wt, "t ^= a")
        t -= c
        wt = d1(wt, wc)
        same(t, wt, "t -= c")
        t |= b
        wt = u1(wt, wb)
        same(t, wt, "t |= b")
        same(CBL.merge([a, b, c]), u1(u1(wa, wb), wc), "merge([a, b, c])")
        same(CBL.intersect([a, b, c]), i1(i1(wa, wb), wc),
             "intersect([a, b, c])")
        for idx, w in ((a, wa), (b, wb), (c, wc)):
            assert idx.count() == len(w)  # the operands survive

        # what a caller does with a result that has holes
        h, wh = a & b, i1(wa, wb)
        assert h.wordset._holes
        q, wq = window(2 * M, 6 * M)
        assert h.query_codes_stream(*q) == (len(wq), int(np.isin(wq, wh).sum()))
        assert h.wordset._holes  # joined by one sort, not compacted
        ins, wi = window(6 * M, 7 * M)
        h.insert_codes_stream(*ins)  # fits the log
        h.flush()  # one sort of index and log, duplicates marked
        wh = u1(wh, wi)
        assert h.wordset._holes and h.count() == len(wh)
        rm, wr = window(3 * M + M // 2, 4 * M)
        h.remove_codes_stream(*rm)  # stays in the log
        wh = d1(wh, np.unique(wr))
        assert h.wordset.n_pending > 0 and h.wordset._holes
        # index with holes + log: one sort of all three
        assert h.query_codes_stream(*q) == (len(wq), int(np.isin(wq, wh).sum()))
        assert h.wordset.n_pending > 0 and h.wordset._holes
        h.flush()
        assert not h.wordset._holes
        same(h, wh, "a & b after insert, remove and folds")
        g, wg = a - b, d1(wa, wb)
        assert g.wordset._holes
        rng = np.random.default_rng(11)
        pos = rng.integers(0, len(words), size=4000)
        probe = [int(v) for v in np_kmers(codes)[pos]]
        got = g.contains_kmers(probe)  # compacts first
        assert not g.wordset._holes
        assert got.tolist() == np.isin(words[pos], wg).tolist()
        assert 0 < int(got.sum()) < len(probe)
        same(g, wg, "a - b after contains_kmers")
    launched = {n: LAUNCHES[n] - n0[n] for n in n0}
    assert all(v > 0 for v in launched.values()), launched
    return (f"set algebra with overlap: |a| {len(wa)} |b| {len(wb)} |c| "
            f"{len(wc)} |a & b| {len(i1(wa, wb))} |a ^ b| {len(x1(wa, wb))}: "
            f"eight operators, merge and intersect == numpy key for key; "
            f"query, insert, remove, log join, folds and contains_kmers on "
            f"results with holes == numpy; launches {launched}")


def profile_algebra() -> int:
    """`--profile-algebra`: the set-algebra runs under `torch.profiler`
    in the ("bitonic", "bitonic") and the default modes; prints the
    device time by kernel name and the device's idle share of the four
    operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = card_line()
    codes = np.random.default_rng(0).integers(0, 4, size=MAIN_BASES,
                                              dtype=np.uint8)
    for modes in (ALGEBRA_MODES[0], ALGEBRA_MODES[2]):
        algebra_run(codes, *modes)  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, r = algebra_run(codes, *modes)
        print_profile(prof, f"[{card}] set algebra {modes}: builds and four "
                      f"operations; the operations alone {r['ops_ms']:.2f} ms "
                      f"by device events under the profiler")
    return 0


def print_profile(prof, title: str, span_ms: float | None = None) -> None:
    """Device time by kernel name of a `torch.profiler` run, largest
    first; with `span_ms`, the device's idle share of that span."""
    import torch

    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(t for t, _, _ in rows)
    idle = "" if span_ms is None else f", idle {1 - busy / span_ms:.1%}"
    print(f"{title}, kernels {busy:.2f} ms{idle}")
    for t, count, key in rows[:14]:
        print(f"  {t:9.3f} ms  {count:5d} x  {key[:90]}")
    # the sort and merge kernels (namespace cbl) that the list above cut
    for t, count, key in rows[14:]:
        if "cbl::" in key:
            print(f"  {t:9.3f} ms  {count:5d} x  {key[:90]}")


def profile_separate() -> int:
    """`--profile`: the separate-calls workload (runs A and B) under
    `torch.profiler` in both sort modes; prints the device time by
    kernel name and the device's idle share of the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = card_line()
    codes = np.random.default_rng(0).integers(0, 4, size=MAIN_BASES,
                                              dtype=np.uint8)
    for label, n, log_at_query in (("A", MAIN_BASES, False),
                                   ("B", MAIN_BASES // 2, True)):
        for mode in ("mergepath", "library"):
            separate_run(codes[:n], mode, log_at_query)  # warm-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, _, r = separate_run(codes[:n], mode, log_at_query)
            print_profile(
                prof, f"[{card}] run {label} {mode}: calls "
                f"{r['calls_ms']:.2f} ms by device events under the "
                f"profiler, stage {r['stage_s'] * 1e3:.1f} ms", r["calls_ms"])
    return 0


def np_necklace_words(codes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Host oracle: the packed necklace words of every k-mer that lies
    inside one record (uint64 arithmetic, independent of the port)."""
    W, pos_bits = 2 * K, 6
    mask = np.uint64((1 << W) - 1)
    nk = len(codes) - K + 1
    v = np.zeros(nk, dtype=np.uint64)
    for j in range(K):
        v = (v << np.uint64(2)) | codes[j : j + nk].astype(np.uint64)
    valid = np.zeros(nk + 1, dtype=np.int64)
    for r in range(len(offsets) - 1):
        lo, hi = int(offsets[r]), int(offsets[r + 1]) - K + 1
        if hi > lo:
            valid[lo] += 1
            valid[hi] -= 1
    rot = v[np.cumsum(valid[:nk]) > 0]
    best = rot.copy()
    pos = np.zeros(len(rot), dtype=np.uint64)
    hi, better = np.empty_like(rot), np.empty(len(rot), dtype=bool)
    for p in range(1, W):
        np.right_shift(rot, np.uint64(W - 1), out=hi)
        np.left_shift(rot, np.uint64(1), out=rot)
        np.bitwise_or(rot, hi, out=rot)
        np.bitwise_and(rot, mask, out=rot)
        np.less(rot, best, out=better)
        np.copyto(best, rot, where=better)
        np.copyto(pos, np.uint64(p), where=better)
    return (best << np.uint64(pos_bits)) | pos


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES, _build
    from cbl_tpu_torch.ops.sort import use_merge_mode, use_sort_mode

    if sys.argv[1:] == ["--profile"]:
        return profile_separate()
    if sys.argv[1:] == ["--profile-algebra"]:
        return profile_algebra()
    if sys.argv[1:]:
        print(f"usage: {sys.argv[0]} [--profile | --profile-algebra]",
              file=sys.stderr)
        return 2

    # phase 1
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so, nvcc_s = _build.build()
    _build.library()
    log(f"kernels built in {nvcc_s:.2f} s (load {time.perf_counter() - t0:.2f}"
        f" s): {os.path.relpath(so, REPO)}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # phase 2
    kern = check_kernels(card)

    # phase 3
    exe = build_baseline()
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=MAIN_BASES, dtype=np.uint8)
    offsets = np.array([0, len(codes)], dtype=np.int64)
    n_kmers = MAIN_BASES - K + 1
    runs = {}
    main_launches = None
    for canonical in (False, True):
        label = "canonical" if canonical else "plain"
        base = run_baseline(exe, codes, "canonical" if canonical else None)
        static_run(codes, offsets, canonical)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        idx, ps, r = static_run(codes, offsets, canonical)
        launches = dict(LAUNCHES)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"main path {label}: {r} baseline {base} launches {launches}")
        assert r["positive"] == r["total"] == n_kmers, r
        assert r["distinct"] == base["distinct"], (r, base)
        for name in STATIC_KERNELS:
            assert launches[name] >= 1, (
                f"kernel {name} never launched on the static path")
        runs[label] = (r, base)
        if not canonical:
            main_launches = launches
        del idx, ps
    log(f"launch counters on the static path (plain): {main_launches}")

    # phase 4: a multi-record query stream that was never inserted, against
    # an index of the first quarter of the bases (the numpy oracle's time
    # goes with the index's size); half of its records are copied from the
    # indexed bases, half are fresh
    quarter = codes[: MAIN_BASES // 4]
    q_off = np.array([0, len(quarter)], dtype=np.int64)
    q_idx = CBL(k=K, device=DEVICE)
    q_idx.insert_codes_stream(quarter, q_off)
    qrng = np.random.default_rng(2)
    parts = []
    for r in range(8):
        n = MAIN_BASES // 64
        if r % 2 == 0:
            s = int(qrng.integers(0, len(quarter) - n))
            parts.append(quarter[s : s + n])
        else:
            parts.append(qrng.integers(0, 4, size=n, dtype=np.uint8))
    parts.append(qrng.integers(0, 4, size=11, dtype=np.uint8))  # short tail
    qcodes = np.concatenate(parts)
    qoff = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    n_merge = LAUNCHES["merge"]
    total, positive = q_idx.query_codes_stream(qcodes, qoff)
    assert LAUNCHES["merge"] > n_merge
    t_o = time.perf_counter()
    q_words = np_necklace_words(qcodes, qoff)
    i_words = np_necklace_words(quarter, q_off)
    want_pos = int(np.isin(q_words, i_words).sum())
    log(f"foreign query against {len(quarter) / 1e6:.0f} Mbp: total {total} "
        f"positive {positive}; numpy oracle total {len(q_words)} positive "
        f"{want_pos} ({time.perf_counter() - t_o:.1f} s)")
    assert (total, positive) == (len(q_words), want_pos)
    assert 0 < positive < total
    del q_idx, q_words

    codes2 = np.random.default_rng(3).integers(
        0, 4, size=SLAB + SLAB // 32 + K - 1, dtype=np.uint8)
    off2 = np.array([0, len(codes2)], dtype=np.int64)
    n_merge = LAUNCHES["merge"]
    idx2, ps2, r2 = static_run(codes2, off2, canonical=False)
    base2 = run_baseline(exe, codes2, None)
    log(f"two-slab build: slabs {[s[0] for s in ps2.slabs]} {r2} "
        f"baseline distinct {base2['distinct']} merge launches "
        f"{LAUNCHES['merge'] - n_merge}")
    assert len(ps2.slabs) == 2
    assert r2["positive"] == r2["total"] == len(codes2) - K + 1, r2
    assert r2["distinct"] == base2["distinct"], (r2, base2)
    # one merge folds slab 2 into the index, two join the two slabs
    assert LAUNCHES["merge"] - n_merge == 3
    del idx2, ps2

    # phase 5: the dynamic workload at full size
    base_dyn = run_baseline(exe, codes, "dynamic")
    dynamic_run(codes, timed=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    idx, segs, dyn = dynamic_run(codes, timed=True)
    dyn["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"dynamic path: {dyn} baseline {base_dyn}")
    assert dyn["ops"] == base_dyn["ops"], (dyn, base_dyn)
    assert dyn["distinct"] == base_dyn["distinct"], (dyn, base_dyn)
    assert dyn["positive"] == base_dyn["positive"], (dyn, base_dyn)
    dyn_launches = dyn["launches"]
    # 3 merges a round, 2 in the first (there is no log to merge into yet,
    # as in cbl_tpu); one scan a round
    assert dyn_launches["merge"] == 3 * SEGS - 1, dyn_launches
    assert dyn_launches["slog_scan"] == SEGS, dyn_launches
    for name in ROUND_KERNELS:
        assert dyn_launches[name] >= 1, (
            f"kernel {name} never launched on the dynamic path")
    assert dyn_launches["sort"] == 0, dyn_launches  # the default sort mode
    n_m, n_s = LAUNCHES["merge"], LAUNCHES["slog_scan"]
    t_j = time.perf_counter()
    joined = idx.query_codes_stream(segs[SEGS - 1])  # B3 + B4 on the log
    t_j = time.perf_counter() - t_j
    assert (LAUNCHES["merge"] - n_m, LAUNCHES["slog_scan"] - n_s) == (1, 1)
    t_f = time.perf_counter()
    idx.flush()
    folded_n = idx.count()
    t_f = time.perf_counter() - t_f
    static = idx.query_codes_stream(segs[SEGS - 1])
    log(f"query of segment {SEGS - 1}: against the log {joined} "
        f"({t_j * 1e3:.1f} ms), after flush() {static}; flush + count "
        f"{t_f * 1e3:.1f} ms, count {folded_n}")
    sb = MAIN_BASES // SEGS
    assert joined == static and joined[0] == sb - K + 1, (joined, static)
    assert 0 < joined[1] < joined[0]
    assert folded_n == dyn["distinct"]
    del idx, segs
    # the same rounds with every merge on kernel B7
    with use_merge_mode("bitonic"):
        dynamic_run(codes, timed=False)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        _, _, dyn_b7 = dynamic_run(codes, timed=True)
    dyn_b7["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"dynamic path, merge mode bitonic: {dyn_b7}")
    assert dyn_b7["distinct"] == base_dyn["distinct"], (dyn_b7, base_dyn)
    assert dyn_b7["positive"] == base_dyn["positive"], (dyn_b7, base_dyn)
    b7_launches = dyn_b7["launches"]
    assert b7_launches["bitonic_merge"] == 3 * SEGS - 1, b7_launches
    assert b7_launches["merge"] == 0, b7_launches
    assert b7_launches["slog_scan"] == SEGS, b7_launches

    # phase 6: the separate calls, every sort through B5 ("mergepath"),
    # then run A once more in the default mode
    half_codes = codes[: MAIN_BASES // 2]
    base_b = run_baseline(exe, half_codes, "dynamic")
    sep = {}
    for label, run_codes, mode, log_at_query, base in (
            ("A", codes, "mergepath", False, base_dyn),
            ("B", half_codes, "mergepath", True, base_b),
            ("A default", codes, "library", False, base_dyn)):
        separate_run(run_codes, mode, log_at_query)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        idx, segs, r = separate_run(run_codes, mode, log_at_query)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"separate calls, run {label}: {r} baseline {base}")
        assert r["ops"] == base["ops"], (r, base)
        assert r["distinct"] == base["distinct"], (r, base)
        assert r["positive"] == base["positive"], (r, base)
        want = separate_launches(mode, log_at_query)
        assert r["launches"] == want, (r["launches"], want)
        sep[label] = r
        del idx, segs
    assert sep["A"]["distinct"] == dyn["distinct"]
    assert sep["A"]["positive"] == dyn["positive"]
    for name in STATIC_KERNELS + ("sort",):
        assert sep["A"]["launches"][name] > 0 < sep["B"]["launches"][name]
    assert sep["A default"]["launches"]["sort"] == 0
    for name in STATIC_KERNELS:
        assert sep["A default"]["launches"][name] > 0
    with use_sort_mode("mergepath"):
        idx = CBL(k=K, device=DEVICE)
        seg0 = codes[: MAIN_BASES // SEGS]
        idx.insert_codes_stream(seg0, np.array([0, len(seg0)]))
        n_sort = LAUNCHES["sort"]
        log(point_ops_check(idx, seg0))
        assert LAUNCHES["sort"] > n_sort  # the log's override sorts
        del idx
    log(multi_slab_round_check(codes))

    # phase 7: set algebra at full size under three mode pairs, then with
    # real overlap against numpy over phase 4's oracle words
    alg = algebra_check(codes)
    alg_launches = alg[ALGEBRA_MODES[0]]["launches"]
    for name in ALGEBRA_KERNELS:
        assert alg_launches[name] >= 1, (
            f"kernel {name} never launched on the set-algebra path")
    assert alg[ALGEBRA_MODES[1]]["launches"]["bitonic_sort"] >= 1
    default = alg[ALGEBRA_MODES[2]]["launches"]
    assert default["bitonic_sort"] == default["bitonic_merge"] == 0
    assert default["merge"] >= 1
    log(algebra_overlap_check(quarter, i_words))
    del i_words

    # phase 8
    for name in STATIC_KERNELS:
        assert main_launches[name] >= 1, name
    for label, (r, base) in runs.items():
        rate = 2 * n_kmers / r["wall_s"]
        base_rate = 2 * n_kmers / (base["insert_s"] + base["query_s"])
        log(f"[{card}] K={K} {MAIN_BASES / 1e6:.0f} Mbp {label}: "
            f"stage {r['stage_s'] * 1e3:.1f} ms, insert {r['insert_ms']:.2f}"
            f" ms, query {r['query_ms']:.2f} ms (device events), combined "
            f"wall {r['wall_s'] * 1e3:.2f} ms = {rate:.4g} k-mers/s; peak "
            f"device memory {r['peak_gib']:.2f} GiB; baseline.cpp 1 core "
            f"{base_rate:.4g} k-mers/s")
    log(f"[{card}] K={K} {MAIN_BASES / 1e6:.0f} Mbp dynamic, {SEGS} rounds, "
        f"{dyn['ops']} ops: wall with staging {dyn['wall_s'] * 1e3:.2f} ms "
        f"= {dyn['ops'] / dyn['wall_s']:.4g} ops/s (stage "
        f"{dyn['stage_s'] * 1e3:.1f} ms); device rounds "
        f"{dyn['rounds_s'] * 1e3:.2f} ms = {dyn['ops'] / dyn['rounds_s']:.4g}"
        f" ops/s ({dyn['rounds_ms']:.2f} ms by device events); peak device "
        f"memory {dyn['peak_gib']:.2f} GiB; final log {dyn['log_rows']} rows "
        f"({dyn['log_real']} real bound, seq {dyn['seq']}); baseline.cpp "
        f"1 core {base_dyn['ops_per_s']:.4g} ops/s")
    log(f"[{card}] K={K} {MAIN_BASES / 1e6:.0f} Mbp dynamic, merge mode "
        f"bitonic (B7): device rounds {dyn_b7['rounds_s'] * 1e3:.2f} ms "
        f"({dyn_b7['rounds_ms']:.2f} ms by device events; default mode "
        f"{dyn['rounds_ms']:.2f}); peak device memory "
        f"{dyn_b7['peak_gib']:.2f} GiB (default mode "
        f"{dyn['peak_gib']:.2f})")

    for label, r in sep.items():
        log(f"[{card}] K={K} separate calls run {label} "
            f"({len(codes if label != 'B' else half_codes) / 1e6:.0f} Mbp, "
            f"{SEGS} rounds, {r['ops']} ops, sort mode {r['mode']}): device "
            f"calls {r['calls_s'] * 1e3:.2f} ms = "
            f"{r['ops'] / r['calls_s']:.4g} ops/s ({r['calls_ms']:.2f} ms by "
            f"device events); with staging {r['wall_s'] * 1e3:.2f} ms = "
            f"{r['ops'] / r['wall_s']:.4g} ops/s (stage "
            f"{r['stage_s'] * 1e3:.1f} ms); peak device memory "
            f"{r['peak_gib']:.2f} GiB; launches {r['launches']}")
    n_rows = sum(alg[ALGEBRA_MODES[0]]["counts"][n] for n in ("a", "b"))
    for modes, r in alg.items():
        per_op = ", ".join(
            f"{n} {r['device_ms'][n]:.2f} ms (host {r['host_ms'][n]:.2f})"
            for n, _ in ALGEBRA_OPS)
        log(f"[{card}] K={K} set algebra, 2 x {MAIN_BASES / 2e6:.0f} Mbp, "
            f"merge mode {modes[0]}, sort mode {modes[1]}, operands built "
            f"anew: four operations with their counts {r['ops_ms']:.2f} ms "
            f"by device events = {4 * n_rows / r['ops_ms'] * 1e3:.4g} operand "
            f"rows/s; {per_op}; peak device memory {r['peak_gib']:.2f} GiB; "
            f"launches {r['launches']}")

    src = {
        "necklace": ("cbl_tpu_torch/csrc/necklace.cu",
                     "cbl_tpu/ops/necklace_pallas.py:102"),
        "blank": ("cbl_tpu_torch/csrc/scan.cu",
                  "cbl_tpu/ops/scan_pallas.py:293"),
        "merge": ("cbl_tpu_torch/csrc/merge.cu",
                  "cbl_tpu/ops/merge_pallas.py:355"),
        "slog_scan": ("cbl_tpu_torch/csrc/slog_scan.cu",
                      "cbl_tpu/ops/scan_pallas.py:202"),
        "sort": ("cbl_tpu_torch/csrc/sort.cu",
                 "cbl_tpu/ops/merge_pallas.py:426"),
        "bitonic_sort": ("cbl_tpu_torch/csrc/bitonic_sort.cu",
                         "cbl_tpu/ops/sort_pallas.py:269"),
        "bitonic_merge": ("cbl_tpu_torch/csrc/bitonic_merge.cu",
                          "cbl_tpu/ops/sort_pallas.py:302"),
    }
    # launches: the counted runs of the static path (plain), the dynamic
    # rounds (in the default mode and under "bitonic"), the separate calls
    # (runs A and B under "mergepath") and set algebra (under ("bitonic",
    # "bitonic") and ("sort", "bitonic")), each counted from 0
    paths = (main_launches, dyn_launches, b7_launches, sep["A"]["launches"],
             sep["B"]["launches"], alg_launches,
             alg[ALGEBRA_MODES[1]]["launches"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1],
         "launches": sum(p[name] for p in paths),
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         **({"passes": kern[name]["passes"]} if "passes" in kern[name]
            else {})}
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
