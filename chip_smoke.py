#!/usr/bin/env python3
"""Drive the PyTorch port's static, dynamic-round, separate-call,
set-algebra, ordered-membership, export, wide-K and sharded paths, its
CLI, its benchmark and its flagship forward step, on one NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card, `nvcc` and
`g++`:

    python3 chip_smoke.py            # every phase, ~8 minutes
    python3 chip_smoke.py --profile  # only a `torch.profiler` table of
                                     # the separate-calls workload
    python3 chip_smoke.py --profile-algebra  # the same of the set algebra

Phases (any failure raises and the script exits non-zero):
1. print the card, its power limit and the versions; build the CUDA
   kernels of `cbl_tpu_torch` from `cbl_tpu_torch/csrc/` (one nvcc per
   source, in parallel) and the native FASTA/Q decoder and packer from
   `cbl_tpu_torch/io/native/fastx.cpp` (g++);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (exact equality; B5, B6 and B7 also against
   `torch.sort`, their inputs unchanged, and the number of passes over
   device memory that B5, B6 and B7 launch against the Python
   schedule's, with the device time of each sort by kernel name; B5 and
   B6 at one and two columns also at the edges of their tiles, of B5's
   groups of 16 runs and of B6's chunks, and on six kinds of rows (with
   duplicates, wide, all equal, sorted, reversed, a small column 0);
   B7 also at B3's shapes of a fold and a log join, timed
   beside B3; B3, B6 and B7 also at the sort-join's shapes: 2^25 index
   rows (word, 2^25) against 2^25 (word, position) queries, with
   realistic words and with heavy duplicates; B1 from the packed stream
   (the word pipeline's one kernel) at 2^25 rows of 150-base reads, W = 50
   and 118, plain and canonical, against the plain chain and its launch
   counted; at wide K, B1 on two-column
   k-mers of W = 118 and 66 bits at 2^25, and B3, B5, B6 and B7 at three
   columns at the K=59 sort-join's shapes and their tile edges; B4 on a
   log with a tag column, C = 2 and 3, at 2^26 rows, the dynamic rounds'
   83,886,080, a 2^22-row query run and a run whose liveness flips
   across tiles before a sentinel tail from a tile edge),
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
   numbers derived from the code; run A again under the "library" sort
   mode (`torch.sort`, no B5 launch) must give the same counts; then point
   operations against a Python oracle with no fold in between, and a
   round over a two-slab stream (the fallback) against the same three
   calls on a second index;
7. run set algebra as `bench.py --mode algebra` does (BASELINE config 4):
   `a` from the first 16 Mbp, `b` from the second, then `a | b`, `a & b`,
   `a - b`, `a ^ b`, each followed by `count()`, then the serde
   round-trip of `a` (`save_to_file`, `load_from_file`, `count()`), one
   warm-up and one counted pass, under three pairs of
   (merge mode, sort mode): ("bitonic", "bitonic") (merges on kernel B7,
   sorts on B6), ("sort", "bitonic") (no merge kernel, every tagged and
   compaction sort on B6) and (B3, `torch.sort`); the three
   must give equal keys, the counts must obey the set identities and
   equal a build of both halves as two records, the operands must keep
   their counts and the launches must equal the numbers derived from the
   code; then, on two overlapping 5 Mbp windows of phase 4's 8 Mbp (and a
   third), all eight operators, `CBL.merge` and `CBL.intersect` key for
   key against numpy's set functions over phase 4's oracle words, and the
   calls that follow on results with holes (query, insert, remove, log
   join, fold, `contains_kmers`) against the same sets;
8. ordered membership on a rebuild of phase 3's plain index:
   `contains_codes_stream` of a 32 Mbp foreign stream of 17 records (one
   2^25 slab against the 2^25-row index: B1, B2 and a sort-join on B3;
   records copied from the index, fresh ones, and copies with a point
   mutation every 20 to 40 bases, whose answers change every few
   k-mers), masks element for element against numpy (membership of the
   stream's necklace words at its valid starts), staging, the device
   work and the mask's copy timed inside the counted call, the
   self-query all True, then
   the same masks under (merge, sort) modes ("bitonic", "bitonic") (B7,
   B6), an index with holes (`a - b` of two overlapping 16 Mbp windows)
   against numpy and against its answer after `_compact()`, without a
   compaction before it, short records below the sort-join threshold
   (`contains_seqs`, `contains_all`), the pieces of the call timed apart
   (the word pipeline, the sort-join's sorted rows, the sort-join, with
   its data rows' answers stored to one slot, and as one sort), and `insert_seqs` / `remove_seqs` of 8 Mbp in records of
   mixed length against numpy and against the stream calls;
9. export and checkpoints on phase 8's index, counted from 0: in each
   sort mode (`library`, `mergepath`: B5, `bitonic`: B6) a fresh build's
   `words_array` (its dedup sort, the limbs laid out on the card and the
   copy timed apart) against numpy's sorted unique words, the count against
   `bench/baseline.cpp`'s; then `iter_words_chunks(2^22)`,
   `kmers_limbs` against numpy's sorted unique k-mers, the six stats and
   `shard_balance` against numpy, `save_to_file` -> `load_from_file`
   (the file's words against numpy) and the loaded index's self-query
   (B1, B2, B3), `save_reference` at full size, `load_reference` of the
   first 2 Mbp's index (its bucket headers are a Python loop) back to
   the same words and the same bytes, and the first 2^20 rows of
   `iter_nucs` against an ASCII decode of the k-mers;
10. wide K: BASELINE config 3 (K=59, prefix 28, 32 Mbp, one record),
   plain and canonical: the build, `count()` against numpy's distinct
   k-mers ((first 32 bases, last 27) pairs), `kmers_limbs` as a set
   against numpy's, the words of the first 2^20 k-mers against a numpy
   necklace, the self-query (every k-mer present) and a 4 Mbp foreign
   stream with point-mutated copies against numpy; then K=31 (prefix 24):
   `insert_seqs` / `remove_seqs` of 8 Mbp under the "mergepath" sort mode
   (B5 at three columns), point operations on the pending log, the four
   set operations under phase 7's three mode pairs, a 2 Mbp
   `contains_codes_stream` mask (B3, and B6 + B7 under "bitonic", at
   three columns), a checkpoint and a `.cbl` file at a 2 Mbp cut, all
   against numpy; each path's launches are counted from 0 just before
   it and read just after (config 3's timed build and self-query: B1
   wide, B2 and three-column B3 once each; at K=31 the sequence calls,
   the set operations of each mode pair and each mask), and each must
   have launched its three-column kernel; config 3 is also timed as
   `bench.py --mode largek` times it (build from the bases, then
   `kmers_limbs`);
11. dynamic rounds at wide K: phase 5's 8 rounds on the same 32 Mbp at
   K=59 (prefix 28; the log is two word columns and a tag column, C = 3)
   and K=27 (prefix 24; one word column and a tag column, C = 2), one
   warm-up and one timed run each; `distinct` and the summed `positive`
   must equal a numpy oracle (one sort of every k-mer start, first held
   to `bench/baseline.cpp dynamic` at K=25), a query of the active log
   must equal the same query after `flush()`, and each timed run must
   launch B4's tag-column kernel once a round and B1 (the wide kernel at
   K=59, the one-column kernel at K=27); then K=59 under merge mode
   "bitonic" (B7 at three columns, no B3), with the same counts;
12. the CLI on `bench.py --mode genome`'s corpus (`make_genome_corpus`,
   32 Mbp, seed 0): its 3,125 insert records written as FASTA (80
   columns), its 15,625 query records as FASTQ gzip (level 1); both
   parsed back by `cbl_tpu_torch.io` (the native decoder and the Python
   parser) to the corpus's codes and offsets; the native packer (built in
   phase 1 from `cbl_tpu_torch/io/native/fastx.cpp` into
   `cbl_tpu_torch/_build/`) against numpy, both timed; then
   `python -m cbl_tpu_torch` as a user runs it, a subprocess a command
   (the timed build and query alone, the others in two waves at once):
   `build` plain and `-c` (counts against `bench/baseline.cpp records`),
   `query` of the FASTQ gzip (queries and positives against the
   baseline, plain and canonical), an index of the query stream (under
   `--trace`, whose Chrome trace must name B1 and B2), `merge` / `inter` /
   `diff` / `sym-diff` (words against numpy's set functions over numpy's
   words, counts by the set identities), `insert` equal to `merge` and
   `remove` to `diff`, `count`, `list` (numpy's distinct k-mers),
   `export-ref` -> `import-ref` (the same words), `repartition` (its
   stderr equal to the report of the loaded index in this process), and
   at K=59 (prefix 28) `build` + `list` of the first 4 Mbp against
   numpy; the examples `build_from_fastx` (its count the CLI's) and
   `dynamic_rounds` as subprocesses; then in this process, launches
   counted from 0 and device time by `torch.profiler`: `build`, `query`
   and `inter` (B1, B2, B3), K=59 `build` and `query` (B1 wide, B3 at
   three columns), each `np_pack_stream` on the native packer, and the
   example `bench_necklace_throughput` (two launches of B1);
13. the sharded index (`cbl_tpu_torch.parallel.ShardedCBL`): BASELINE
   config 5 (`bench.py --mode sharded-dynamic`, `run_tpu_sharded_dynamic`:
   phase 5's 8 rounds of `pack_stream`ed segments, lazy, on
   `make_mesh()[:1]`, D = 1), one warm-up and one timed run, `distinct`
   and the summed `positive` against `bench/baseline.cpp dynamic`, its
   ops/s beside phase 5's single index; the bulk build and self-query of
   the 32 Mbp at D = 1 against `bench/baseline.cpp` (launches counted
   from 0: B1, B2, B3 in the build and query, B4 once a round); then 4
   shards on the one card: the build's words against a single index's,
   the query, a remove of the first half against a single index's, a
   checkpoint round trip, config 5's rounds against the baseline, the
   four set operations of the two 16 Mbp halves against phase 7's
   counts, an 8 Mbp insert under boundaries that send every word to
   shard 0 (recovered, every word kept) and a remove of every word from
   shard 0 (exact: count 0); then `python -m cbl_tpu_torch build
   --sharded` (D = 1 and `--shards 4`), `query --sharded` and `--shards 4
   repartition --sharded` on phase 12's corpus files against `bench/
   baseline.cpp records`, and the examples `sharded_build` and
   `repartition_recovery` (D = 1 and 4 shards) as subprocesses;
   (e) the multi-process layer (`cbl_tpu_torch.parallel.distributed`):
   the single index of the genome corpus in this process (its words
   after the build, after removing each rank's first record and after 8
   rounds: config 2's schedule over the insert records in 8 groups of
   390 or 391, round i inserting group i, querying group max(i-1, 0)
   and removing the first half of group i), then 2 ranks, each a fresh
   process with 2 shards on the card and gloo between them (and NCCL,
   one card a rank, where there are 2 cards): each rank's slice of the
   corpus (`host_record_slice`) through `multihost_insert_stream` (count
   against `bench/baseline.cpp records`), `multihost_query_stream`
   (queries and positives against it), a checkpoint round trip of one
   file a rank, a remove of each rank's first record, an intersection
   with the loaded copy, a repartition and the 8 rounds (each round's
   (total, positive) against the single index's), each step's shard rows
   against the single index's words; under gloo, after the counted run,
   an `all_to_all_single` of 64 MiB a rank on the CUDA tensors and
   through pinned host copies (equal rows, both timed); each rank's
   launches and the ms inside `_all_to_all` come back as a JSON line;
14. the port's benchmark as a user runs it, each a process of its own:
   `python -m cbl_tpu_torch.bench --repeats 2` (the static headline and
   every extra of `bench.py`'s default line: canonical, dynamic,
   sharded-dynamic, genome, algebra and serde) must exit 0 with every
   key of `bench.py`'s line non-null, every count held to
   `bench/baseline.cpp` (its stderr names each check) and B1, B2, B3 and
   B4 launched; `--mode largek --repeats 2` must exit 0 having launched B1
   wide; both lines are printed; then
   `cbl_tpu_torch.parallel.dryrun_multichip(4)`: 4 shards on the card,
   2^20 k-mers a shard of the seed-5 genome corpus, every step against a
   single index;
   (b) the flagship forward step (`cbl_tpu_torch.entry`, the counterpart
   of `__graft_entry__.entry()`): `python -m cbl_tpu_torch.entry` as a
   user runs it (the step on the reference's args, then
   `dryrun_multichip(8)`); `entry()`'s args on the card, the mask (all
   False: an index of 2^15 sentinels) against the step on the CPU, once
   more under `torch.cuda.set_sync_debug_mode("error")` (no host sync),
   exactly one B1 launch a call; then 256 windows of 16,416 codes at
   k-mer offsets that are multiples of 2^14, half from the 32 Mbp stream
   and half from phase 4's foreign stream, against the canonical index of
   the 32 Mbp (its `export_keys()`, as many rows as `bench/baseline.cpp`
   counts), every mask against numpy's canonical words and the same keys
   (one window with a band of rows not valid, which read False); the
   host clock, the device time by CUDA events and the device launches of
   one step at both index sizes;
15. require every kernel of each path to have been launched in that
   path's counted run, print the timings, the kernels' JSON line and,
   last, the device JSON line.

The script imports no JAX, nothing of `cbl_tpu` and not the root
`bench.py` (the genome corpus is `cbl_tpu_torch.bench.
make_genome_corpus`).  The kernels, the native decoder and the baselines
are built into `cbl_tpu_torch/_build/`, phase 12's files written under
it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# wide K: B1 on two-column k-mers, B3 / B5 / B6 / B7 at three columns
WIDE_KERNELS = ("necklace_wide", "merge_3col", "sort_3col",
                "bitonic_sort_3col", "bitonic_merge_3col")
# B4 over a log with a tag column: a one-column word (C = 2), two (C = 3)
TAG_KERNELS = ("slog_scan_tag", "slog_scan_tag_3col")
# B8, the probe join's search: its launches and the rows they searched
PROBE_KEYS = ("probe", "probe_rows", "probe_valid_rows")
NO_LAUNCHES = dict.fromkeys(KERNELS + WIDE_KERNELS + TAG_KERNELS
                            + PROBE_KEYS, 0)
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


def join_rows(rng, n: int, hi: int):
    """The two sides of a full-size sort-join (`wordset._sortjoin_rows`)
    as (index rows, query rows), two int64 columns each: the index's n
    sorted words below `hi` with a 5 % sentinel tail, each at position n;
    n query words at positions 0..n-1, unsorted, half of them drawn from
    the index, 3 % sentinels (blanked starts)."""
    import torch

    dev = torch.device(DEVICE)
    pad = (1 << 63) - 1
    d = torch.from_numpy(rng.integers(0, hi, size=n)).to(dev)
    d[n - n // 20:] = pad
    d = torch.sort(d).values
    q = rng.integers(0, hi, size=n)
    half = rng.random(n) < 0.5
    q[half] = d.cpu().numpy()[rng.integers(0, n - n // 20,
                                           size=int(half.sum()))]
    q[rng.random(n) < 0.03] = pad
    return ((d, torch.full_like(d, n)),
            (torch.from_numpy(q).to(dev),
             torch.arange(n, dtype=torch.int64, device=dev)))


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
    results["stream_words"] = check_stream_words(rng, K, 24, card)

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
    # the sort-join's merge at full size: 2^25 index rows (word, 2^25)
    # against 2^25 sorted (word, position) queries, words < 2^56 and with
    # heavy duplicates (< 2^20: 32 rows a word on each side)
    join_rng = np.random.default_rng(8)
    joins = {hi: join_rows(join_rng, SLAB, hi) for hi in (1 << 56, 1 << 20)}
    for hi, (d, q) in joins.items():
        q_sorted = merge.sort_cols_plain(q)
        errs.append(cols_equal(merge.merge_sorted(d, q_sorted),
                               merge.merge_sorted_plain(d, q_sorted)))
        log(f"B3 merge, two columns, {SLAB} + {SLAB} (the sort-join: words"
            f" < 2^{hi.bit_length() - 1}): kernel == plain: {errs[-1] == 0}")
    d, q_sorted = joins[1 << 56][0], merge.sort_cols_plain(joins[1 << 56][1])
    ms_join = time_ms(lambda: merge.merge_sorted(d, q_sorted), 10)
    log(f"B3 merge, two columns, {SLAB} + {SLAB} (the sort-join): "
        f"{ms_join:.4f} ms, bound "
        f"{bound(2 * 16 * 2 * SLAB, 0)['bound_ms']:.4f} ms [{card}]")
    del d, q_sorted
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
        two_col_ms=ms2, fold_ms=ms_fold, join_ms=ms_join,
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
        if n > 1 << 22:
            t = time_ms(lambda: scan.slog_scan_counts(keys, round_qtag), 20)
            # one 8-byte read a row B4 needs, two counters written; a few
            # compares a row
            b = slog_bound(keys, 1, 6)
            log(f"B4 slog_scan {label}: {t:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms [{card}]")
        if n == 2 * SLAB:
            ms, b_main = t, b
            plain_ms = time_ms(
                lambda: scan.slog_scan_counts_plain(keys, round_qtag), 3)
        del keys
    results["slog_scan"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None, **b_main)

    # B5: 2^25 keys in one column (the static build's sort); 2^26 + 2^21
    # keys, three quarters of them sentinels (the largest compaction of
    # the separate calls: a fold's merged index and log); 2^21 + 2^21
    # (word, seqtag) rows (a log join's sort of log and queries) and
    # 2^22 + 2^21; 2^25 - 4097 rows, one row, a constant column, half
    # sentinels; a first pass of 4 or 8 runs whose last run is short (4 to
    # 7 sort tiles + 123 rows), 2^25 keys of one value and
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
            if c > 1:
                keys = (keys,) + tuple(rand_keys(n, 3, 0)
                                       for _ in range(c - 1))
            errs.append(sort_case(
                f"n={n} ({tiles} tiles + 123), {c} column(s)", keys))
    merge.sort_mergepath(x1)
    planned = len(merge.mergepath_passes(SLAB, merge.SORT_TILES[1],
                                         merge.SORT_WAYS[1]))
    b5_passes = _build.PASSES["sort"]
    log(f"B5 sort n={SLAB} one column: {b5_passes} passes over device "
        f"memory launched, the Python schedule has {planned}")
    assert b5_passes == planned <= 4
    merge.sort_mergepath(x2)
    planned2 = len(merge.mergepath_passes(n_join, merge.SORT_TILES[2],
                                          merge.SORT_WAYS[2]))
    log(f"B5 sort n={n_join} two columns: {_build.PASSES['sort']} passes "
        f"over device memory launched, the Python schedule has {planned2}")
    assert _build.PASSES["sort"] == planned2 <= 4
    n_sort = LAUNCHES["sort"]
    with sort.use_sort_mode("library"):
        assert torch.equal(sort.sort_keys(x1), torch.sort(x1).values)
    assert LAUNCHES["sort"] == n_sort  # the library mode never launches B5
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
    for label, x in ((f"one column, {SLAB}", x1),
                     (f"two columns, {n_join}", x2)):
        for kname, us, count in kernel_device_us(
                lambda: merge.sort_mergepath(x)):
            log(f"  B5 sort, {label}, device time by kernel: {us:.1f} us, "
                f"{count} x {kname}")
    # every key read once and written once; n log2 n 64-bit compares
    results["sort"] = dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        two_col_ms=ms2, two_col_library_ms=lib2, fold_ms=ms3,
        fold_library_ms=lib3, passes=b5_passes,
        **bound(2 * 8 * SLAB, SLAB * 25 * 2))
    del x1, x2, x3, x4
    results.update(check_bitonic(rng, results["merge"]["ms"], card, joins))
    del joins
    edge_err = check_sort_edges(rng)
    for name in ("sort", "bitonic_sort"):
        results[name]["err"] = max(results[name]["err"], edge_err)
    results.update(check_wide_kernels(rng, card))
    results.update(check_slog_tag(rng, card))
    results["probe"] = check_probe(card)
    results["probe"]["sweep"] = join_sweep(card)

    for name, r in results.items():
        lib = r["library_ms"]
        log(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library call {'none' if lib is None else f'{lib:.4f} ms'}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} [{card}]")
        if r["err"] != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return results


def check_sort_edges(rng) -> float:
    """B5 and B6 at one and two columns at the edges of their tiles, of
    B5's groups of 16 runs and of B6's chunks, on random rows, and at a
    chunk plus a tile on six kinds of rows: kernel == `torch.sort` (one
    stable pass a column) == plain (up to a chunk plus a tile), the input
    kept, and the passes through
    device memory each kernel launched equal to its Python schedule.  ->
    the largest difference (0 when all agree)."""
    import torch

    from cbl_tpu_torch.ops import _build, bitonic, merge

    dev = torch.device(DEVICE)
    pad = (1 << 63) - 1

    def rows(n, c, kind):
        """"dups" (below 2, 5 % sentinels), "wide" (below 2^40, 5 %
        sentinels), "equal", "sorted", "reverse" or "small0" (column 0
        below 2^20)."""
        if kind == "equal":
            cols = [np.full(n, 7) for _ in range(c)]
        else:
            hi = 2 if kind == "dups" else 1 << 40
            cols = [rng.integers(0, hi, size=n) for _ in range(c)]
            sent = rng.random(n) < 0.05
            for v in cols:
                v[sent] = pad
            if kind == "small0":
                cols[0] = rng.integers(0, 1 << 20, size=n)
        x = tuple(torch.from_numpy(v).to(dev) for v in cols)
        if kind in ("sorted", "reverse"):
            x = merge.sort_cols_plain(x)
            if kind == "reverse":
                x = tuple(v.flip(0).contiguous() for v in x)
        return x[0] if c == 1 else x

    err = 0.0
    for c in (1, 2):
        st, bt, chunk = merge.SORT_TILES[c], bitonic.TILES[c], bitonic.CHUNKS[c]
        cases = [(n, "wide") for n in sorted({
            st - 1, st + 1, 2 * st + 1, 16 * st - 1, 16 * st + 1,
            32 * st + 1, 256 * st + 3, bt + 1, chunk - 1, chunk + 1,
            2 * chunk + 3})]
        cases += [(chunk + bt, kind) for kind in (
            "dups", "wide", "equal", "sorted", "reverse", "small0")]
        for n, kind in cases:
            x = rows(n, c, kind)
            before = [v.clone() for v in merge.as_cols(x)]
            want = merge.sort_cols_plain(merge.as_cols(x))
            rows_p = max(bt, 1 << (n - 1).bit_length())
            line = []
            for name, fn, plain, key, planned in (
                    ("B5", merge.sort_mergepath, merge.sort_mergepath_plain,
                     "sort", merge.mergepath_passes(n, st,
                                                    merge.SORT_WAYS[c])),
                    ("B6", bitonic.bitonic_sort,
                     bitonic.bitonic_sort_passes_plain, "bitonic_sort",
                     bitonic.network_passes(rows_p, bt, bitonic.fuse_log(bt),
                                            chunk))):
                got = fn(x)
                passes = _build.PASSES[key]
                e = max(cols_equal(merge.as_cols(got), want),
                        cols_equal(merge.as_cols(x), before))
                if n <= chunk + bt:  # the plain walks cost seconds beyond
                    e = max(e, cols_equal(merge.as_cols(plain(x)), want))
                assert passes == len(planned), (name, c, n, passes, planned)
                err = max(err, e)
                line.append(f"{name} {e == 0}, {passes} passes (schedule "
                            f"{len(planned)})")
            log(f"B5, B6 at {c} column(s), n={n} {kind}: kernel == plain == "
                f"torch.sort, input kept: {'; '.join(line)}")
    return err


def check_bitonic(rng, b3_ms: float, card: str, joins: dict) -> dict:
    """B6 and B7 against their plain versions and against `torch.sort`,
    exact, at the shapes the set-algebra path and the sort-join give
    them; `b3_ms` is kernel B3's time for 2^25 + 2^25 keys, printed
    beside B7's; `joins` maps a word bound to `join_rows`' two sides."""
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
        # the sort-join's queries: 2^25 (word, position) rows
        sort_case(f"n={SLAB} two columns (the sort-join's queries, words "
                  f"< 2^56)", joins[1 << 56][1], plain=False),
        sort_case(f"n={SLAB} two columns (the sort-join's queries, words "
                  f"< 2^20)", joins[1 << 20][1]),
    ]
    bitonic.bitonic_sort(joins[1 << 56][1])
    planned = len(bitonic.network_passes(
        SLAB, bitonic.TILES[2], bitonic.fuse_log(bitonic.TILES[2]),
        bitonic.CHUNKS[2]))
    log(f"B6 bitonic sort n={SLAB} two columns (the sort-join's queries): "
        f"{_build.PASSES['bitonic_sort']} passes over device memory "
        f"launched, the Python schedule has {planned}")
    assert _build.PASSES["bitonic_sort"] == planned <= 11
    bitonic.bitonic_sort(x25)
    n0 += 2
    planned = len(bitonic.network_passes(
        SLAB, bitonic.TILES[1], bitonic.fuse_log(bitonic.TILES[1]),
        bitonic.CHUNKS[1]))
    b6_passes = _build.PASSES["bitonic_sort"]
    log(f"B6 bitonic sort n={SLAB} one column: {b6_passes} passes over "
        f"device memory launched, the Python schedule has {planned}")
    assert b6_passes == planned <= 9
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
    q = joins[1 << 56][1]
    ms_join = time_ms(lambda: bitonic.bitonic_sort(q), 3)
    lib_join = time_ms(lambda: merge.sort_cols_plain(q), 5)
    log(f"B6 bitonic sort, two columns, {SLAB} (the sort-join's queries): "
        f"{ms_join:.4f} ms, two stable torch.sort passes {lib_join:.4f} ms,"
        f" bound {bound(2 * 16 * SLAB, 0)['bound_ms']:.4f} ms [{card}]")
    for label, x in ((f"one column, {SLAB}", x25),
                     (f"two columns, {n_join}", x2),
                     (f"two columns, {SLAB} (the sort-join's queries)", q)):
        for kname, us, count in kernel_device_us(
                lambda: bitonic.bitonic_sort(x)):
            log(f"  B6 bitonic sort, {label}, device time by kernel: "
                f"{us:.1f} us, {count} x {kname}")
    # every key read once and written once; n log2 n 64-bit compares
    out = {"bitonic_sort": dict(
        err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        ms_2_24=ms24, library_ms_2_24=lib24, two_col_ms=ms2,
        two_col_library_ms=lib2, join_ms=ms_join, join_library_ms=lib_join,
        passes=b6_passes, **bound(2 * 8 * SLAB, SLAB * 25 * 2))}
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
    # the sort-join's merge: 2^25 index rows against 2^25 sorted queries
    for hi, (d, q) in joins.items():
        errs.append(merge_case(
            f"{SLAB} + {SLAB}, two columns (the sort-join: words < "
            f"2^{hi.bit_length() - 1})", d, merge.sort_cols_plain(q),
            plain=False))
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
    sortjoin = (joins[1 << 56][0], merge.sort_cols_plain(joins[1 << 56][1]))
    for label, (a, b) in (("fold", fold), ("join", join),
                          ("sortjoin", sortjoin)):
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


def once_ms(fn):
    """(result, device ms) of one run of `fn`, by CUDA events (for the
    plain versions at full size, where a second run is not worth it)."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def check_stream_words(rng, k: int, prefix_bits: int, card: str) -> dict:
    """B1 from the packed stream (`necklace.stream_words`) at a 2^25-row
    slab of K = k: 150-base reads, so B2's mask blanks the last k - 1
    starts of every 150; against the plain chain (`stream_words_plain`:
    extract, canonicalize, necklace, pack, blank) on the card, exact,
    plain and canonical; one launch a call in `LAUNCHES`; timed beside
    its bound and the plain chain."""
    import torch

    from cbl_tpu_torch import necklace
    from cbl_tpu_torch.config import get_config
    from cbl_tpu_torch.kmer import pack_stream
    from cbl_tpu_torch.limbs import key_cols
    from cbl_tpu_torch.ops import LAUNCHES

    dev = torch.device(DEVICE)
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    W, n_cols = cfg.kmer_bits, key_cols(cfg)
    key = "necklace_wide" if W > 62 else "necklace"
    n_codes = (SLAB + k - 1 + 15) // 16 * 16
    stream = pack_stream(torch.from_numpy(
        rng.integers(0, 4, size=n_codes, dtype=np.uint8)).to(dev))
    blanked = np.arange(SLAB) % 150 > 150 - k
    blank = torch.from_numpy(blanked.astype(np.int32)).to(dev)
    errs = []
    for canonical in (False, True):
        before = LAUNCHES[key]
        got = necklace.stream_words(stream, SLAB, cfg, canonical, blank)
        torch.cuda.synchronize()
        assert LAUNCHES[key] == before + 1, "the fused B1 was not launched"
        want, chain_ms = once_ms(lambda: necklace.stream_words_plain(
            stream, SLAB, cfg, canonical, blank))
        errs.append(max_abs_err(got, want))
        log(f"B1 from the stream K={k} W={W} canonical={canonical} "
            f"n={SLAB}: kernel == plain chain: {errs[-1] == 0}")
        if not canonical:
            plain_ms = chain_ms
        del got, want
    ms = time_ms(lambda: necklace.stream_words(stream, SLAB, cfg, False,
                                               blank), 10)
    # 0.5 bytes of stream (int64 words of 16 bases) and 4 of mask read and
    # 8 a word column written a k-mer; the rotation's INT32 operations
    # (7 or 13 a step, as the value form's bounds count) on the rows the
    # mask leaves
    n_live = int((~blanked).sum())
    b = bound(SLAB * (0.5 + 4 + 8 * n_cols),
              n_live * (W - 1) * (7 if W <= 62 else 13))
    log(f"B1 from the stream K={k} W={W}: {ms:.4f} ms, plain chain "
        f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by "
        f"{b['bound_by']} ({n_live} rows rotated of {SLAB}); by bytes alone "
        f"{bound(SLAB * (0.5 + 4 + 8 * n_cols), 0)['bound_ms']:.4f} ms "
        f"[{card}]")
    return dict(err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
                **b)


def kernel_device_us(fn) -> list:
    """(kernel name, device us, launches) of one run of `fn`, by
    `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key[:90], e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]


def wide_join_rows(rng, n: int):
    """The two sides of a full-size sort-join at K=59
    (`wordset._sortjoin_rows` on two-column words): (index rows, query
    rows), three int64 columns each (word column 0 below 2^62, column 1
    below 2^63, then the position): the index's n sorted words with a
    5 % sentinel tail, each at position n; n query words at positions
    0..n-1, unsorted, half of them drawn from the index, 3 % sentinels."""
    import torch

    from cbl_tpu_torch.ops import merge

    dev = torch.device(DEVICE)
    pad = (1 << 63) - 1
    hi = rng.integers(0, 1 << 62, size=n)
    lo = rng.integers(0, 1 << 63, size=n)
    hi[n - n // 20:] = pad
    lo[n - n // 20:] = pad
    d = merge.sort_cols_plain((torch.from_numpy(hi).to(dev),
                               torch.from_numpy(lo).to(dev)))
    dh, dl = d[0].cpu().numpy(), d[1].cpu().numpy()
    qh = rng.integers(0, 1 << 62, size=n)
    ql = rng.integers(0, 1 << 63, size=n)
    half = rng.random(n) < 0.5
    at = rng.integers(0, n - n // 20, size=int(half.sum()))
    qh[half], ql[half] = dh[at], dl[at]
    sent = rng.random(n) < 0.03
    qh[sent], ql[sent] = pad, pad
    return ((d[0], d[1], torch.full_like(d[0], n)),
            (torch.from_numpy(qh).to(dev), torch.from_numpy(ql).to(dev),
             torch.arange(n, dtype=torch.int64, device=dev)))


def check_wide_kernels(rng, card: str) -> dict:
    """Phase 2 at wide K: B1 on two-column k-mers (W = 118 and 66) at
    2^25 k-mers, and B3, B5, B6 and B7 at three columns at the K=59
    sort-join's full-size shapes (2^25 index rows against 2^25 queries),
    each against its plain version, exact; timed beside three stable
    `torch.sort` passes, the library's way to the same sort."""
    import torch

    from cbl_tpu_torch.ops import _build, bitonic, merge, necklace

    dev = torch.device(DEVICE)
    results = {}
    errs = []
    for W in (118, 66):
        x = torch.stack([
            torch.from_numpy(rng.integers(0, 1 << (W - 63), size=SLAB)),
            torch.from_numpy(rng.integers(0, 1 << 63, size=SLAB))]).to(dev)
        x[:, 0] = 0  # poly-A
        x[0, 1] = (1 << (W - 63)) - 1  # poly-T: all ones
        x[1, 1] = (1 << 63) - 1
        got = necklace.necklace_pos(x, W)
        want, plain_ms = once_ms(lambda: necklace.necklace_pos_plain(x, W))
        errs.append(max(max_abs_err(got[0], want[0]),
                        max_abs_err(got[1].long(), want[1].long())))
        log(f"B1 necklace, two columns, W={W} n={SLAB}: kernel == plain: "
            f"{errs[-1] == 0}")
        if W == 118:
            ms = time_ms(lambda: necklace.necklace_pos(x, W), 10)
            x118_plain_ms = plain_ms
        del x, got, want
    # 16 bytes read, 16 + 4 written a k-mer.  Operations: W - 1 candidate
    # rotations of a value held in four 32-bit registers, each at least
    # thirteen 32-bit integer instructions (four funnel shifts form it from
    # the one before, four compares order it against the best, five
    # selects keep the best's four words and its position); the kernel
    # also carries the top bit round and masks, about 23 a step in its
    # SASS
    b1 = bound(SLAB * 36, SLAB * (118 - 1) * 13)
    log(f"B1 necklace, two columns, W=118: {ms:.4f} ms, plain "
        f"{x118_plain_ms:.4f} ms, bound {b1['bound_ms']:.4f} ms by "
        f"{b1['bound_by']} ({117 * 13} INT32 operations a k-mer); by bytes "
        f"alone {bound(SLAB * 36, 0)['bound_ms']:.4f} ms [{card}]")
    results["necklace_wide"] = dict(err=max(errs), ms=ms,
                                    plain_ms=x118_plain_ms, library_ms=None,
                                    **b1)
    results["stream_words_wide"] = check_stream_words(rng, 59, 28, card)

    # three columns at the K=59 sort-join's shapes
    d, q = wide_join_rows(np.random.default_rng(12), SLAB)
    before = [c.clone() for c in q]
    want_sorted = merge.sort_cols_plain(q)
    lib_sort_ms = time_ms(lambda: merge.sort_cols_plain(q), 3)
    n3 = SLAB
    sort_bound = bound(2 * 24 * n3, n3 * 25 * 3)
    rows3 = max(bitonic.TILES[3], 1 << (n3 - 1).bit_length())
    schedules = {
        "sort_3col": ("sort", merge.mergepath_passes(
            n3, merge.SORT_TILES[3], merge.SORT_WAYS[3])),
        "bitonic_sort_3col": ("bitonic_sort", bitonic.network_passes(
            rows3, bitonic.TILES[3], bitonic.fuse_log(bitonic.TILES[3]),
            bitonic.CHUNKS[3]))}
    for name, kernel, plain in (
            ("sort_3col", merge.sort_mergepath, merge.sort_mergepath_plain),
            ("bitonic_sort_3col", bitonic.bitonic_sort,
             bitonic.bitonic_sort_passes_plain)):
        got = kernel(q)
        key, planned = schedules[name]
        passes = _build.PASSES[key]
        err = cols_equal(got, want_sorted)
        plain_got, plain_ms = once_ms(lambda: plain(q))
        err = max(err, cols_equal(plain_got, want_sorted),
                  cols_equal(q, tuple(before)))
        del got, plain_got
        ms = time_ms(lambda: kernel(q), 5)
        label = "B5 sort" if name == "sort_3col" else "B6 bitonic sort"
        log(f"{label}, three columns, {n3} (the K=59 sort-join's queries):"
            f" kernel == plain == torch.sort, input kept: {err == 0}; "
            f"{passes} passes through device memory launched, the Python "
            f"schedule has {len(planned)}; {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, three stable torch.sort passes "
            f"{lib_sort_ms:.4f} ms, bound {sort_bound['bound_ms']:.4f} ms, "
            f"the schedule's floor {len(planned) * sort_bound['bound_ms']:.4f}"
            f" ms [{card}]")
        assert passes == len(planned), (name, passes, planned)
        for kname, us, count in kernel_device_us(lambda: kernel(q)):
            log(f"  {label} device time by kernel: {us:.1f} us, {count} x "
                f"{kname}")
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_sort_ms, passes=passes,
                             **sort_bound)
    del before
    qs = want_sorted
    cat = tuple(torch.cat([x, y]) for x, y in zip(d, q))
    want_merged = merge.sort_cols_plain(cat)
    lib_merge_ms = time_ms(lambda: merge.sort_cols_plain(cat), 3)
    del cat
    merge_bound = bound(2 * 24 * 2 * n3, 2 * n3 * 3)
    for name, kernel, plain in (
            ("merge_3col", merge.merge_sorted, merge.merge_sorted_plain),
            ("bitonic_merge_3col", bitonic.bitonic_merge,
             bitonic.bitonic_merge_tiled_plain)):
        err = cols_equal(kernel(d, qs), want_merged)
        plain_got, plain_ms = once_ms(lambda: plain(d, qs))
        err = max(err, cols_equal(plain_got, want_merged))
        del plain_got
        ms = time_ms(lambda: kernel(d, qs), 10)
        label = "B3 merge" if name == "merge_3col" else "B7 bitonic merge"
        log(f"{label}, three columns, {n3} + {n3} (the K=59 sort-join): "
            f"kernel == plain: {err == 0}; {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, three stable torch.sort passes of both "
            f"{lib_merge_ms:.4f} ms, bound {merge_bound['bound_ms']:.4f} ms "
            f"[{card}]")
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_merge_ms, **merge_bound)
    # the tile edges of each kernel at three columns
    def rows3(n, hi):
        return tuple(torch.from_numpy(rng.integers(0, hi, size=n)).to(dev)
                     for _ in range(3))

    edge = []
    tile, chunk = merge.SORT_TILES[3], bitonic.CHUNKS[3]
    group = tile * 2 * merge.SORT_WAYS[3]  # runs after a pass of 2, then 16
    for n in (1, 2, bitonic.TILES[3] - 1, bitonic.TILES[3],
              bitonic.TILES[3] + 1, 4 * tile + 123, 7 * tile + 123,
              2 * tile + 1, group - 1, group + 1, chunk - 1, chunk + 1,
              chunk + tile, (1 << 21) + 3):
        x = rows3(n, 1 << 20)
        want = merge.sort_cols_plain(x)
        edge.append(cols_equal(merge.sort_mergepath(x), want))
        edge.append(cols_equal(bitonic.bitonic_sort(x), want))
    # skewed rows at a chunk plus a tile: every row equal, sorted,
    # reverse-sorted, column 0 below 2^20 (as necklace words are)
    n = chunk + tile
    x = rows3(n, 1 << 40)
    srt = merge.sort_cols_plain(x)
    skewed = {"equal": tuple(torch.full_like(c, 7) for c in x),
              "sorted": srt,
              "reverse": tuple(c.flip(0).contiguous() for c in srt),
              "small0": (torch.from_numpy(rng.integers(0, 1 << 20, size=n))
                         .to(dev),) + x[1:]}
    for label, x in skewed.items():
        want = merge.sort_cols_plain(x)
        got = (cols_equal(merge.sort_mergepath(x), want),
               cols_equal(bitonic.bitonic_sort(x), want))
        log(f"B5, B6 at three columns, {n} rows {label}: kernel == "
            f"torch.sort: {got[0] == 0}, {got[1] == 0}")
        edge.extend(got)
    t = bitonic.MERGE_TILES[3]
    for na, nb in ((0, 5), (t - 1, 1), (t, t), (3 * t + 1, t - 1),
                   (merge.MERGE_TILE + 1, 3), (5, 0)):
        a = merge.sort_cols_plain(rows3(na, 5))
        b = merge.sort_cols_plain(rows3(nb, 5))
        want = merge.merge_sorted_plain(a, b)
        edge.append(cols_equal(merge.merge_sorted(a, b), want))
        edge.append(cols_equal(bitonic.bitonic_merge(a, b), want))
    log(f"B3, B5, B6, B7 at three columns at their tile edges: kernel == "
        f"plain: {max(edge) == 0}")
    for name in ("sort_3col", "bitonic_sort_3col", "merge_3col",
                 "bitonic_merge_3col"):
        results[name]["err"] = max(results[name]["err"], max(edge))
    return results


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


def slog_bound(col0, n_cols: int, ops_a_row: int) -> dict:
    """B4's bound on this log (`bound`): the rows it must read, 8 bytes a
    column each, two counters written, `ops_a_row` operations a row.  A
    tile whose first row is a sentinel holds only sentinels (the log is
    sorted) and needs that one 8-byte load of column 0 and no more
    (csrc/slog_scan.cu stops it there); every other tile needs all its
    rows.  `col0` is the packed keys or the log's word column 0."""
    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.ops import scan

    n, T = col0.shape[0], scan.SLOG_TILE
    n_skip = int((col0[::T] == SENTINEL).sum())
    rows = min(n, (-(-n // T) - n_skip) * T)
    return bound(rows * 8 * n_cols + n_skip * 8 + 16, rows * ops_a_row)


def slog_tag_cols(rng, n: int, n_cols: int, query_run: int = 0,
                  flip: bool = False, tail: int | None = None):
    """A sorted slog with a tag column on the card, as a tuple of n_cols
    int64 columns (one or two word columns, then the tag): words of runs
    of ~16 rows and one run of min(n / 64, 2^20) rows, tags (seq << 2) |
    typ of seqs 0-79 (above 0xFF from seq 64; insert twice as often as
    query or remove), 5 % join queries (`SENTINEL`), the last n / 10 rows
    (or n - `tail`) sentinels.  With `query_run`, the long run has that
    many rows: one insert, then queries only, so that the liveness must
    cross query_run / SLOG_TILE tiles with no marker; with `flip`, one
    word over every row: an insert at row 0, a remove at row 2n/3, the
    rest queries (of seq 5 before the remove, of seq 70 after)."""
    import torch

    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.ops.merge import sort_cols_plain

    dev = torch.device(DEVICE)
    w = rng.integers(0, max(n // 16, 1), size=n)
    w[: query_run or min(n // 64, 1 << 20)] = n  # a word of no other row
    tags = (rng.integers(0, 80, size=n) << 2) | rng.choice([1, 1, 2, 3], n)
    tags[rng.random(n) < 0.05] = SENTINEL
    if flip:  # queries of seq 5 before the remove, of seq 70 after it
        w[:] = n
        tags = np.where(np.arange(n) < 2 * n // 3, (5 << 2) | 2,
                        (70 << 2) | 2)
        tags[0], tags[2 * n // 3] = 1, (6 << 2) | 3
    elif query_run:
        tags[:query_run] = np.where(tags[:query_run] == SENTINEL, SENTINEL,
                                    (tags[:query_run] & ~3) | 2)
        tags[0] = 1  # seq 0's insert sorts first in the run
    words = [w * 977 + 5] if n_cols == 2 else [w // 7 + 1, w % 7 * 977 + 5]
    cols = [torch.from_numpy(c).to(dev) for c in (*words, tags)]
    for c in cols:
        c[n - n // 10 if tail is None else tail:] = SENTINEL
    return sort_cols_plain(tuple(cols))


def check_slog_tag(rng, card: str) -> dict:
    """B4 on a log with a tag column (C = 2 and 3) against its plain
    version, exact: 2^26 rows, 2^26 - 4097 rows and one row, the
    83,886,080 rows the 32 Mbp dynamic rounds' log reaches, 2^24 rows
    whose long run is 2^22 rows of queries after one insert, and one word
    over 300 tiles whose liveness flips two thirds in, its sentinel tail
    from a tile edge; at a round's query tag, a tag above 0xFF (seq 70)
    and the join's; timed with CUDA events at 2^26 rows beside the
    plain version and the bound (8 * C bytes a row it needs,
    `slog_bound`)."""
    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.ops import scan

    T = scan.SLOG_TILE
    results = {}
    for n_cols in (2, 3):
        name = "slog_scan_tag" + ("_3col" if n_cols == 3 else "")
        errs = []
        for n, kw in ((2 * SLAB, {}), (2 * SLAB - 4097, {}), (1, {}),
                      (83_886_080, {}), (1 << 24, {"query_run": 1 << 22}),
                      (300 * T + 5, {"flip": True, "tail": 250 * T})):
            cols = slog_tag_cols(rng, n, n_cols, **kw)
            label = f"C={n_cols} n={n} {kw or ''}"
            hits = []
            for qtag in ((5 << 2) | 2, (70 << 2) | 2, SENTINEL):
                got = scan.slog_scan_tag_counts(cols, qtag)
                want = scan.slog_scan_counts_plain(cols, qtag)
                errs.append(max(max_abs_err(g, w) for g, w in zip(got, want)))
                hits.append(int(want[0]))
                log(f"B4 tag {label} qtag={qtag:#x}: hits {int(want[0])} "
                    f"live {int(want[1])}: kernel == plain: {errs[-1] == 0}")
            assert n == 1 or hits[0] > 0, label
            if "flip" in kw:  # live before the remove, dead after it
                assert hits[:2] == [2 * n // 3 - 1, 0], hits
            if n > 1 << 22:
                t = time_ms(lambda: scan.slog_scan_tag_counts(
                    cols, (5 << 2) | 2), 20)
                # every column of a row B4 needs read once, two counters
                # written; a compare or two a column and a few bit
                # operations a row
                b = slog_bound(cols[0], n_cols, 2 * n_cols + 4)
                log(f"B4 tag {label}: {t:.4f} ms, bound "
                    f"{b['bound_ms']:.4f} ms [{card}]")
            if n == 2 * SLAB:
                ms, b_main = t, b
                plain_ms = time_ms(lambda: scan.slog_scan_counts_plain(
                    cols, (5 << 2) | 2), 3)
            del cols
        results[name] = dict(
            err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None, **b_main)
    return results


# the host screen's batch: 2^24 rows, 14,092,848 of them valid k-mers of
# 150-base reads, the rest blanked (SENTINEL); its index of the human
# genome holds 3,120,562,176 rows, duplicates kept
SCREEN_ROWS = 1 << 24
SCREEN_VALID = 14_092_848
SCREEN_INDEX = 3_120_562_176
# B8's two-column check: an index past 2^31 rows (34.4 GB)
WIDE_PROBE_INDEX = (1 << 31) + (1 << 20)
# the join sweep's index sizes, log2 rows
SWEEP_LOGS = (16, 18, 20, 22, 23, 24, 26, 28, 29)


def probe_queries(cols: tuple, gen) -> tuple:
    """The host screen's batch from query columns of SCREEN_ROWS rows:
    SCREEN_ROWS - SCREEN_VALID rows at random places blanked (SENTINEL
    in every column), then sorted as the join hands them over."""
    import torch

    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.ops import merge

    blank = torch.randperm(SCREEN_ROWS, device=cols[0].device,
                           generator=gen)[: SCREEN_ROWS - SCREEN_VALID]
    for c in cols:
        c[blank] = SENTINEL
    return merge.sort_cols_plain(cols)


def check_probe(card: str) -> dict:
    """B8 (`ops.probe.probe_hits`) at the host screen's shape against its
    plain route (`probe_hits_plain`, `torch.searchsorted`) and against
    the count the index's pattern gives, exact: the screen's batch
    (`probe_queries`) against an index past 2^31 rows built from a cheap
    pattern.  One column: SCREEN_INDEX rows, 2 * (i // 2) at row i (each
    even number twice); a query hits when it is even and below the rows.
    Two columns: WIDE_PROBE_INDEX rows, (i // 4, 2 * (i % 4)) at row i; a
    query (a, b) hits when b is even and 4a + b / 2 is below the rows.
    Timed with CUDA events beside the plain route; the bound is every
    query row read once and one 32-byte sector of each column a valid
    row (`kmerbench/metrics/probe_roofline.py`'s floor)."""
    import torch

    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.ops import probe

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(24)
    errs, out = [], {}
    for n_cols, n in ((1, SCREEN_INDEX), (2, WIDE_PROBE_INDEX)):
        torch.cuda.empty_cache()
        rows = torch.arange(n, dtype=torch.int64, device=dev)
        if n_cols == 1:
            data = (rows.bitwise_and_(~1),)
            q = torch.randint(0, n + n // 8, (SCREEN_ROWS,), device=dev,
                              generator=gen)
            q = probe_queries((q,), gen)
            want = ((q[0] % 2 == 0) & (q[0] < n)).sum()
        else:
            data = (rows >> 2, rows.bitwise_and_(3).mul_(2))
            a = torch.randint(0, n // 4 + n // 32, (SCREEN_ROWS,),
                              device=dev, generator=gen)
            b = torch.randint(0, 8, (SCREEN_ROWS,), device=dev,
                              generator=gen)
            q = probe_queries((a, b), gen)
            want = ((q[0] != SENTINEL) & (q[1] % 2 == 0)
                    & (4 * q[0] + q[1] // 2 < n)).sum()
        del rows
        sample, s = probe.search_layout(data)

        def b8():
            return probe.probe_hits(data, sample, s, q, SCREEN_VALID)

        def plain():
            return probe.probe_hits_plain(data, q)

        got, ref = b8(), plain()
        errs += [max_abs_err(got, want), max_abs_err(ref, want)]
        log(f"B8 probe, {n_cols} column(s), {SCREEN_ROWS} sorted queries "
            f"({SCREEN_VALID} valid) against {n} rows: hits {int(want)}, "
            f"kernel == plain == the pattern's count: {max(errs[-2:]) == 0}")
        assert 0 < int(want) < SCREEN_VALID
        ms = time_ms(b8, 20)
        plain_ms = time_ms(plain, 3)
        b = bound(SCREEN_ROWS * 8 * n_cols + SCREEN_VALID * 32 * n_cols, 0)
        log(f"B8 probe, {n_cols} column(s), against {n} rows: {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"[{card}]")
        out[n_cols] = dict(ms=ms, plain_ms=plain_ms, **b)
        del data, sample, q
    one = out[1]
    return dict(err=max(errs), ms=one["ms"], plain_ms=one["plain_ms"],
                library_ms=one["plain_ms"], bound_ms=one["bound_ms"],
                bound_by=one["bound_by"], two_col_ms=out[2]["ms"],
                two_col_plain_ms=out[2]["plain_ms"],
                two_col_bound_ms=out[2]["bound_ms"])


def join_sweep(card: str) -> dict:
    """The two joins of a clean index, one column, at a batch of the host
    screen's shape (`probe_queries`) against indexes of 2^16 to 2^29 rows
    (2 * (i // 2) at row i; queries drawn below 9/8 of the rows): device
    ms of the merge join (`wordset._count_hits_merge_sorted_kernel`: tag,
    B3, hit scan) and of the probe join (`_count_hits_probe_kernel`: B8;
    its layout built once, outside the time), both on sorted queries,
    their answers equal, beside the join `_probe_cheaper` picks.
    -> {index rows: (merge ms, probe ms, picked)}."""
    import torch

    from cbl_tpu_torch import wordset
    from cbl_tpu_torch.ops import probe

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for log_n in SWEEP_LOGS:
        n = 1 << log_n
        data = torch.arange(n, dtype=torch.int64,
                            device=dev).bitwise_and_(~1)
        q = torch.randint(0, n + n // 8, (SCREEN_ROWS,), device=dev,
                          generator=gen)
        (q,) = probe_queries((q,), gen)
        (sample,), s = probe.search_layout((data,))

        def merge_join():
            return wordset._count_hits_merge_sorted_kernel(data, q)

        def probe_join():
            return wordset._count_hits_probe_kernel(data, (sample,), s, q,
                                                    True)

        assert int(merge_join()) == int(probe_join()) > 0, n
        reps = 20 if log_n <= 24 else 5
        m_ms, p_ms = time_ms(merge_join, reps), time_ms(probe_join, reps)
        picked = ("probe" if wordset._probe_cheaper(n, SCREEN_ROWS)
                  else "merge")
        log(f"join sweep: index 2^{log_n} rows, batch {SCREEN_ROWS} rows: "
            f"merge join {m_ms:.4f} ms, probe join {p_ms:.4f} ms, the rule "
            f"picks the {picked} join [{card}]")
        out[n] = (m_ms, p_ms, picked)
        del data, q, sample
    return out


# --- phase 3 and 4: the static path ------------------------------------------


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


def dynamic_run(codes: np.ndarray, timed: bool, k: int = K,
                prefix_bits: int = 24, profiled: bool = False):
    """`bench.py --mode dynamic` on the port at K=k: SEGS rounds of
    `dynamic_round(segs[i], segs[max(i-1, 0)], halves[i], lazy=True)`,
    one sync for the distinct count and the summed positives.  With
    `timed`, the launch counters are set to 0 after staging and read
    after the sync; with `profiled`, the rounds (not the staging) run
    under `torch.profiler` (`prof` in the result).  -> (index, segs,
    result dict)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES

    sb = len(codes) // SEGS
    off1 = np.array([0, sb], dtype=np.int64)
    off_h = np.array([0, sb // 2], dtype=np.int64)
    torch.cuda.synchronize()
    idx = CBL(k=k, prefix_bits=prefix_bits, device=DEVICE)
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
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if profiled else contextlib.nullcontext()) as prof:
        ev[0].record()
        pos_dev = None
        ops = 0
        for i in range(SEGS):
            _, p = idx.dynamic_round(segs[i], segs[i - 1 if i else 0],
                                     halves[i], lazy=True)
            pos_dev = p if pos_dev is None else pos_dev + p
            ops += 2 * (sb - k + 1) + sb // 2 - k + 1
        n_dev = idx.count_device()
        ev[1].record()
        distinct, positive = torch.stack([n_dev, pos_dev]).tolist()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES) if timed else None
    slog = idx.wordset.slog
    log = slog.keys[0]
    return idx, segs, dict(
        ops=ops, distinct=distinct, positive=positive,
        wall_s=t2 - t0, stage_s=t1 - t0, rounds_s=t2 - t1,
        rounds_ms=ev[0].elapsed_time(ev[1]), launches=launches,
        log_rows=log.shape[-1],
        log_cols=1 if log.dim() == 1 else log.shape[0],
        log_real=slog.real,
        seq=slog.seq, prof=prof,
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
    are set to 0 after staging and read after the sync; `joins` holds, a
    query, the rows of the index it meets and of its slab, and whether
    the index is clean (no log, no holes).
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
        joins = []
        for i in range(SEGS):
            idx.insert_codes_stream(segs[i])
            assert (ws.n_pending > 0) == (log_at_query and i > 0), (
                i, ws.n_pending)
            q = segs[i - 1 if i else 0]
            joins.append((ws._live().shape[-1], q.slabs[0][0],
                          not (ws.n_pending or ws._holes
                               or ws.slog.keys is not None)))
            _, p = idx.query_codes_stream(q, lazy=True)
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
        index_rows=ws.data.shape[0], n_upper=ws._n_upper, joins=joins,
    )


def separate_launches(sort_mode: str, log_at_query: bool, joins: list,
                      seg_bases: int) -> dict:
    """The launches of one `separate_run` over segments of `seg_bases`
    bases, derived from the code and from the sizes of its joins
    (`joins`: a query, the index rows it meets, its slab rows, whether the
    index is clean).

    Every stream runs the word pipeline once (B1, B2): 2 a round.  Round
    0 sorts its segment into the empty index, joins it and appends its
    removes.  A join of a clean index is the probe join (B8, one launch)
    where `wordset._probe_cheaper` says so for its sizes, else one merge;
    a join of index and log is a merge.  Every later round folds the logged removes at
    its insert (a sort of the log, a two-column merge with the index, a
    compaction sort), sorts its segment, joins with one merge, and
    - run A (inserts exceed the log): merges the segment into the index;
    - run B (inserts fit the log): sorts log and queries for the join,
      and at the remove, which does not fit beside the inserts, sorts and
      merges the logged inserts into the index.
    `count_device()` folds the last removes (two sorts, one merge).  The
    "library" mode does the same sorts with `torch.sort`.  Each query
    segment is one record, so its valid rows are its k-mers."""
    from cbl_tpu_torch.wordset import _probe_cheaper

    later = SEGS - 1
    sorts = 1 + later * (5 if log_at_query else 3) + 2
    probes = [q for n, q, clean in joins if clean and _probe_cheaper(n, q)]
    return {**NO_LAUNCHES, "necklace": 2 * SEGS, "blank": 2 * SEGS,
            "merge": 1 + later * 3 + 1 - len(probes),
            "sort": sorts if sort_mode == "mergepath" else 0,
            "probe": len(probes), "probe_rows": sum(probes),
            "probe_valid_rows": len(probes) * (seg_bases - K + 1)}


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
    in_base = np_isin_sorted(np.array(probe, dtype=np.uint64),
                             np_unique(base))
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
    assert a.wordset.slog.keys is None and a.wordset.n_pending > 0
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
    """`bench.py --mode algebra` on the port under one (merge mode, sort
    mode) pair: `a` from the first half of `codes`, `b` from the second
    (one record each), then `a | b`, `a & b`, `a - b`, `a ^ b`, each
    followed by `count()`, then the serde round-trip of `a`
    (`save_to_file`, `load_from_file`, `count()`, timed by the host
    clock).  The operands are built anew, so the run pays what a first
    pass pays (two dedup sorts at `a & b`).  The launch counters are set
    to 0 before the builds and read after the last count of the
    operations; the device events and the host clock bracket the four
    operations.  -> ((a, b), {name: result index}, result dict)."""
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
        # bench.py's serde round-trip of `a`: save, load, count
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bench_a.cblx.npz")
            t0 = time.perf_counter()
            a.save_to_file(path)
            a2 = CBL.load_from_file(path)
            assert a2.count() == counts["a"]
            serde_s = time.perf_counter() - t0
            assert int(a2.count_device()) == counts["a"]
            serde_bytes = os.path.getsize(path)
        del a2
    return (a, b), out, dict(
        serde_s=serde_s, serde_bytes=serde_bytes,
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
        return idx, np_unique(w)

    def same(idx, want, what):
        got = index_keys(idx).cpu().numpy().astype(np.uint64)
        assert np.array_equal(got, want), (
            f"{what}: {len(got)} keys, the oracle has {len(want)}")
        assert idx.count() == len(want) > 0, what

    n0 = {n: LAUNCHES[n] for n in ("bitonic_sort", "bitonic_merge")}
    with use_merge_mode("bitonic"), use_sort_mode("bitonic"):
        (a, wa), (b, wb), (c, wc) = (build(0, 5 * M), build(3 * M, 8 * M),
                                     build(2 * M, 6 * M))
        u1 = lambda x, y: np_unique(np.concatenate([x, y]))
        i1 = lambda x, y: np.intersect1d(x, y, assume_unique=True)
        d1 = np_setdiff
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
        assert h.query_codes_stream(*q) == (len(wq),
                                            int(np_isin_sorted(wq, wh).sum()))
        assert h.wordset._holes  # joined by one sort, not compacted
        ins, wi = window(6 * M, 7 * M)
        h.insert_codes_stream(*ins)  # fits the log
        h.flush()  # one sort of index and log, duplicates marked
        wh = u1(wh, wi)
        assert h.wordset._holes and h.count() == len(wh)
        rm, wr = window(3 * M + M // 2, 4 * M)
        h.remove_codes_stream(*rm)  # stays in the log
        wh = d1(wh, np_unique(wr))
        assert h.wordset.n_pending > 0 and h.wordset._holes
        # index with holes + log: one sort of all three
        assert h.query_codes_stream(*q) == (len(wq),
                                            int(np_isin_sorted(wq, wh).sum()))
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
        assert got.tolist() == np_isin_sorted(words[pos], wg).tolist()
        assert 0 < int(got.sum()) < len(probe)
        same(g, wg, "a - b after contains_kmers")
    launched = {n: LAUNCHES[n] - n0[n] for n in n0}
    assert all(v > 0 for v in launched.values()), launched
    return (f"set algebra with overlap: |a| {len(wa)} |b| {len(wb)} |c| "
            f"{len(wc)} |a & b| {len(i1(wa, wb))} |a ^ b| {len(x1(wa, wb))}: "
            f"eight operators, merge and intersect == numpy key for key; "
            f"query, insert, remove, log join, folds and contains_kmers on "
            f"results with holes == numpy; launches {launched}")


# --- phase 8: ordered membership -----------------------------------------------


def foreign_stream(codes: np.ndarray, words: np.ndarray, seed: int):
    """(codes, offsets, record words, mutated record numbers) of a
    multi-record stream as long as `codes` (one record; `words` its
    numpy words): 16 records, then an 11-base tail (shorter than K, no
    k-mer).  Records 0, 2, 4, ... are copied from random places of
    `codes` (their words are a slice of `words`), 1, 5, 9, 13 are fresh,
    and 3, 7, 11, 15 are copies with a point mutation every 20 to 40
    bases, so that their masks change between present and absent every
    few k-mers."""
    rng = np.random.default_rng(seed)
    n = len(codes) // 16
    parts, rec_words, mutated = [], [], []
    for r in range(16):
        if r % 4 == 1:
            parts.append(rng.integers(0, 4, size=n, dtype=np.uint8))
        else:
            s = int(rng.integers(0, len(codes) - n))
            parts.append(codes[s : s + n])
        if r % 4 == 3:
            at = np.cumsum(rng.integers(20, 41, size=n // 20))
            at = at[at < n]
            parts[-1] = parts[-1].copy()
            parts[-1][at] = (parts[-1][at] + rng.integers(
                1, 4, size=len(at), dtype=np.uint8)) % 4
            mutated.append(r)
        if r % 2 == 0:
            rec_words.append(words[s : s + n - K + 1])
        else:
            rec_words.append(
                np_stream_words(parts[-1], np.array([0, n]))[0])
    parts.append(rng.integers(0, 4, size=11, dtype=np.uint8))
    rec_words.append(words[:0])
    return (np.concatenate(parts),
            np.concatenate([[0], np.cumsum([len(p) for p in parts])]),
            rec_words, mutated)


def masks_equal(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), (what, len(got), len(want))
    for r, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.bool_ and np.array_equal(g, w), (
            f"{what}: record {r} has {int((g != w).sum())} wrong k-mers")


def contains_run(idx, codes: np.ndarray, offsets: np.ndarray):
    """One `contains_codes_stream` of a one-slab stream with the launch
    counters set to 0 before it and read after it: (masks, result dict).
    The host clock brackets the call.  Inside the same call the host
    clock times staging (`pack_stream`, to a sync after it), CUDA events
    the slab's word pipeline and sort-join (`_fused_contains`), and the
    host clock what follows the device work (a sync after the events:
    the mask's copy to the host and its split into records).  The syncs
    wait for work that the call's own copy to the host waits for."""
    import torch

    from cbl_tpu_torch import cbl as cmod
    from cbl_tpu_torch.ops import LAUNCHES

    pack, fused = idx.pack_stream, cmod._fused_contains
    marks = {"slabs": 0}

    def timed_pack(*args):
        t = time.perf_counter()
        ps = pack(*args)
        torch.cuda.synchronize()
        marks["stage_s"] = time.perf_counter() - t
        return ps

    def timed_fused(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        mask = fused(*args)
        ev[1].record()
        torch.cuda.synchronize()
        marks.update(events=ev, done=time.perf_counter(),
                     slabs=marks["slabs"] + 1)
        return mask

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    idx.pack_stream, cmod._fused_contains = timed_pack, timed_fused
    try:
        t0 = time.perf_counter()
        masks = idx.contains_codes_stream(codes, offsets)
        t1 = time.perf_counter()
    finally:
        del idx.pack_stream
        cmod._fused_contains = fused
    assert marks["slabs"] == 1, marks
    ev = marks["events"]
    return masks, dict(
        wall_s=t1 - t0, stage_ms=marks["stage_s"] * 1e3,
        device_ms=ev[0].elapsed_time(ev[1]),
        copy_ms=(t1 - marks["done"]) * 1e3, launches=dict(LAUNCHES),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def contains_breakdown(idx, codes: np.ndarray, offsets: np.ndarray) -> dict:
    """The pieces of `_contains_flat`'s slab path for a one-slab stream,
    each timed alone by `time_ms` in the sort and merge modes in force:
    the word pipeline (`_device_words`); the join's sorted rows
    (`_sortjoin_rows`: a sort of the queries and a merge, the form for a
    contiguous index); the whole sort-join (`_contains_sortjoin_kernel`);
    the same with its data rows' answers all stored to one spare slot
    (`_SORTJOIN_SPILL` at 1) in place of 2^16; and the whole join as one
    sort of both sides (the form for an index with holes)."""
    import torch

    from cbl_tpu_torch import wordset as wmod
    from cbl_tpu_torch.cbl import _device_words

    ws = idx.wordset
    ws.flush()
    assert not ws._holes
    data = ws._live()
    ps = idx.pack_stream(codes, offsets)
    assert len(ps.slabs) == 1
    nk_pad, stream, s_arr, e_arr, _ = ps.slabs[0]
    args = (stream, s_arr, e_arr, nk_pad, idx.cfg, idx.canonical)
    words, _ = _device_words(*args)
    join = wmod._contains_sortjoin_kernel(data, words, False)
    spill = wmod._SORTJOIN_SPILL
    wmod._SORTJOIN_SPILL = 1
    try:
        assert torch.equal(
            wmod._contains_sortjoin_kernel(data, words, False), join)
        one_slot_ms = time_ms(
            lambda: wmod._contains_sortjoin_kernel(data, words, False), 5)
    finally:
        wmod._SORTJOIN_SPILL = spill
    return dict(
        data_rows=data.shape[0], queries=nk_pad,
        pipeline_ms=time_ms(lambda: _device_words(*args), 5),
        rows_ms=time_ms(lambda: wmod._sortjoin_rows(data, words, False), 5),
        join_ms=time_ms(
            lambda: wmod._contains_sortjoin_kernel(data, words, False), 5),
        one_slot_ms=one_slot_ms,
        one_sort_ms=time_ms(
            lambda: wmod._contains_sortjoin_kernel(data, words, True), 5))


def seq_pipeline_check(codes: np.ndarray, words: np.ndarray):
    """The chunked pipeline at full chunk size: `insert_seqs` of the
    first quarter of `codes` in records of mixed length (8 Mbp of the
    32: 16 chunks of 2^19 k-mers, so the 2^21-row log folds), then
    `remove_seqs` of every
    third record, then `count()`; against numpy (`words`: the necklace
    words of `codes` as one record) and against `insert_codes_stream` /
    `remove_codes_stream` of the same records.  -> result dict with the
    launches of the counted calls."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops import LAUNCHES

    rng = np.random.default_rng(9)
    n = len(codes) // 4
    lens = list(rng.integers(1, n // 50, size=200)) + [5, K - 1, K, 3]
    rng.shuffle(lens)
    off = np.cumsum([0] + lens)
    off = np.append(off[off < n], n)
    recs = [codes[lo:hi] for lo, hi in zip(off[:-1], off[1:])]
    rm = set(range(0, len(recs), 3))

    def rec_words(which):
        return np.concatenate([words[off[i]:off[i + 1] - K + 1]
                               for i in which if off[i + 1] - off[i] >= K])

    want = np_setdiff(np_unique(rec_words(range(len(recs)))),
                      np_unique(rec_words(sorted(rm))))
    idx = CBL(k=K, device=DEVICE)
    torch.cuda.synchronize()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    idx.insert_seqs(recs)
    n_pending = idx.wordset.n_pending
    idx.remove_seqs([recs[i] for i in sorted(rm)])
    count = idx.count()
    wall_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    keys = index_keys(idx).cpu().numpy().astype(np.uint64)
    assert count == len(want) and np.array_equal(keys, want), (
        count, len(want))
    other = CBL(k=K, device=DEVICE)
    other.insert_codes_stream(codes[:n], off)
    rm_recs = [recs[i] for i in sorted(rm)]
    other.remove_codes_stream(
        np.concatenate(rm_recs),
        np.cumsum([0] + [len(r) for r in rm_recs]))
    assert torch.equal(index_keys(other).cpu(), index_keys(idx).cpu())
    n_kmers = sum(max(len(r) - K + 1, 0) for r in recs)
    return dict(records=len(recs), removed=len(rm), kmers=n_kmers,
                count=count, wall_s=wall_s, launches=launches,
                n_pending_after_insert=n_pending)


def ordered_membership_check(idx, codes: np.ndarray, offsets: np.ndarray,
                             words: np.ndarray, keys: np.ndarray) -> dict:
    """Phase 8 on `idx` (phase 3's plain 32 Mbp build of `codes`, one
    record; `words` its numpy words, `keys` their sorted unique values).
    Every check raises."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.ops.sort import use_merge_mode, use_sort_mode

    t_o = time.perf_counter()
    qcodes, qoff, qw, mutated = foreign_stream(codes, words, seed=4)
    want = [np_isin_sorted(w, keys) for w in qw]
    oracle_s = time.perf_counter() - t_o
    nk = len(qcodes) - K + 1
    out = {"oracle_s": oracle_s, "kmers": nk}
    for r in mutated:  # the answer changes every few k-mers
        flips = int(np.count_nonzero(want[r][1:] != want[r][:-1]))
        assert flips > len(want[r]) // 60, (r, flips)
    out["mutated_flips"] = flips

    idx.contains_codes_stream(qcodes, qoff)  # warm-up
    masks, out["default"] = contains_run(idx, qcodes, qoff)
    masks_equal(masks, want, "foreign stream")
    n_pos = int(sum(m.sum() for m in masks))
    assert 0 < n_pos < nk and len(masks[-1]) == 0
    out["positive"] = n_pos
    out["breakdown"] = contains_breakdown(idx, qcodes, qoff)
    self_masks = idx.contains_codes_stream(codes, offsets)
    assert len(self_masks) == 1 and len(self_masks[0]) == len(codes) - K + 1
    assert self_masks[0].all()
    with use_merge_mode("bitonic"), use_sort_mode("bitonic"):
        idx.contains_codes_stream(qcodes, qoff)  # warm-up
        masks_b, out["bitonic"] = contains_run(idx, qcodes, qoff)
        out["bitonic_breakdown"] = contains_breakdown(idx, qcodes, qoff)
    masks_equal(masks_b, want, "foreign stream, (bitonic, bitonic)")
    del masks_b, self_masks

    # an index with holes: a - b of two overlapping 16 Mbp windows
    M = len(codes) // 4
    a, b = CBL(k=K, device=DEVICE), CBL(k=K, device=DEVICE)
    a.insert_codes_stream(codes[:2 * M], np.array([0, 2 * M]))
    b.insert_codes_stream(codes[M:3 * M], np.array([0, 2 * M]))
    h = a - b
    del a, b
    assert h.wordset._holes
    diff = np_setdiff(np_unique(words[:2 * M - K + 1]),
                      np_unique(words[M:3 * M - K + 1]))
    want_h = [np_isin_sorted(w, diff) for w in qw]
    got_h, out["holes"] = contains_run(h, qcodes, qoff)
    assert h.wordset._holes, "the contains call compacted the index"
    masks_equal(got_h, want_h, "index with holes")
    h.wordset._compact()
    masks_equal(h.contains_codes_stream(qcodes, qoff), got_h,
                "after _compact()")
    out["holes_positive"] = int(sum(m.sum() for m in got_h))
    del h, got_h, want_h

    # below the threshold: the chunked pipeline and the binary search
    rng = np.random.default_rng(5)
    fresh = rng.integers(0, 4, size=4_000, dtype=np.uint8)
    p = len(codes) // 8
    seqs = [codes[p:p + 4_000], fresh[:3_000],
            np.concatenate([codes[2 * p:2 * p + 1_000], fresh[3_000:]]),
            codes[3 * p:3 * p + K]]
    got = idx.contains_seqs(seqs)
    for g, s in zip(got, seqs):
        w, _ = np_stream_words(s, np.array([0, len(s)]))
        assert np.array_equal(g, np_isin_sorted(w, keys)), "contains_seqs"
    assert got[0].all() and not got[1].any() and got[3].all()
    assert 0 < got[2].sum() < len(got[2])
    assert idx.contains_all(seqs[0]) and not idx.contains_all(seqs[2])
    assert idx.contains_seq(codes[:100_000]).all()
    del qw, want, masks
    out["seqs"] = seq_pipeline_check(codes, words)
    return out


# --- phase 9: export and checkpoints ----------------------------------------

EXPORT_MODES = ("library", "mergepath", "bitonic")  # sort modes
REF_CUT = 2_000_000  # bases of the index whose .cbl file is read back


def np_limbs(words: np.ndarray) -> np.ndarray:
    """[n, 2] uint32 big-endian limbs of uint64 words (numpy)."""
    return np.stack([words >> np.uint64(32),
                     words & np.uint64(0xFFFFFFFF)], axis=1).astype(np.uint32)


def export_split(idx):
    """`words_array` of `idx` taken apart: the preamble (flush, compact,
    and on a fresh build the dedup sort) and the limbs laid out on the
    card by CUDA events, the copy to the host by the host clock.
    -> (words [n, 2] uint32, dict)."""
    import torch

    from cbl_tpu_torch.limbs import keys_to_limbs

    ws = idx.wordset
    dups = ws._dups
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    keys = ws.export_keys()
    ev[1].record()
    limbs = keys_to_limbs(keys, 2)
    ev[2].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    words = limbs.cpu().numpy().view(np.uint32)
    t2 = time.perf_counter()
    return words, dict(
        dedup=dups, rows=len(words), wall_ms=(t2 - t0) * 1e3,
        preamble_ms=ev[0].elapsed_time(ev[1]),
        layout_ms=ev[1].elapsed_time(ev[2]), copy_ms=(t2 - t1) * 1e3)


def np_stats(words: np.ndarray) -> dict:
    """The stats of sorted unique uint64 words at PREFIX_BITS 24 (suffix
    32 bits) by numpy; every bucket is a Vec (at most 1024 words) here,
    so its node count is its size."""
    from collections import Counter

    pref = words >> np.uint64(32)  # sorted, as the words are
    starts = np.flatnonzero(np.r_[True, pref[1:] != pref[:-1]])
    prefixes, sizes = pref[starts], np.diff(np.r_[starts, len(pref)])
    assert sizes.max() <= 1024
    pairs = list(zip(prefixes.tolist(), sizes.tolist()))
    sc = dict(sorted(Counter(sizes.tolist()).items()))
    total = sum(s * c for s, c in sc.items())
    return {"prefix_load": len(prefixes) / float(1 << 24),
            "buckets_sizes": pairs, "buckets_size_count": sc,
            "buckets_load_repartition": {s: (s * c) / total
                                         for s, c in sc.items()},
            "buckets_nodes": pairs, "buckets_node_count": sc,
            "shard_balance": np.bincount(
                (prefixes >> np.uint64(21)).astype(np.int64),
                weights=sizes, minlength=8).astype(np.int64).tolist()}


def export_check(idx, codes: np.ndarray, offsets: np.ndarray,
                 keys: np.ndarray, distinct: int) -> dict:
    """Phase 9 on `idx` (phase 8's rebuild of the plain 32 Mbp index;
    `keys` its sorted unique numpy words, `distinct` the baseline's
    count), with the launch counters set to 0 before it and read after:
    `words_array` of a fresh build in each sort mode, then on `idx`
    `iter_words_chunks`, `kmers_limbs`, the stats, `save_to_file` ->
    `load_from_file` and the loaded index's self-query, `save_reference`
    at full size, `load_reference` at a cut and `iter_nucs`; every result
    against numpy, exact.  -> result dict."""
    import itertools

    import torch

    from cbl_tpu_torch import CBL, interop, stats
    from cbl_tpu_torch.limbs import from_limbs
    from cbl_tpu_torch.ops import LAUNCHES
    from cbl_tpu_torch.ops.sort import use_sort_mode

    want = np_limbs(keys)
    assert len(keys) == distinct, (len(keys), distinct)
    out = {"words": len(keys)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ps = idx.pack_stream(codes, offsets)
    for mode in EXPORT_MODES:
        with use_sort_mode(mode):
            fresh = CBL(k=K, device=DEVICE)
            fresh.insert_codes_stream(ps)
            words, out[mode] = export_split(fresh)
        assert out[mode]["dedup"], mode
        assert words.dtype == np.uint32 and np.array_equal(words, want), mode
        del fresh, words
    del ps
    out["mode_launches"] = {n: LAUNCHES[n] for n in ("sort", "bitonic_sort")}

    ws = idx.wordset
    t0 = time.perf_counter()
    words = ws.words_array()
    out["words_array_s"] = time.perf_counter() - t0
    assert np.array_equal(words, want)
    t0 = time.perf_counter()
    chunks = np.concatenate(list(ws.iter_words_chunks(1 << 22)))
    out["chunks_s"] = time.perf_counter() - t0  # every chunk held
    assert np.array_equal(chunks, words)
    del chunks
    rows = 0
    t0 = time.perf_counter()
    for block in ws.iter_words_chunks(1 << 22):  # one chunk at a time
        rows += block.shape[0]
    out["chunks_streamed_s"] = time.perf_counter() - t0
    assert rows == len(words)
    t0 = time.perf_counter()
    kmers = idx.kmers_limbs()
    out["kmers_s"] = time.perf_counter() - t0
    packed = (kmers[:, 0].astype(np.uint64) << np.uint64(32)) | kmers[:, 1]
    assert np.array_equal(np.sort(packed), np_unique(np_kmers(codes)))

    stats_s, got = {}, {}
    for name in ("prefix_load", "buckets_sizes", "buckets_size_count",
                 "buckets_load_repartition", "buckets_nodes",
                 "buckets_node_count"):
        t0 = time.perf_counter()
        got[name] = getattr(idx, name)()
        stats_s[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got["shard_balance"] = stats.shard_balance(idx, 8).tolist()
    stats_s["shard_balance"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = np_stats(keys)
    out["stats_oracle_s"] = time.perf_counter() - t0
    for name, value in oracle.items():
        assert got[name] == value, name
    out["stats_s"], out["buckets"] = stats_s, len(got["buckets_sizes"])
    del got, oracle

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.cblx.npz")
        t0 = time.perf_counter()
        idx.save_to_file(path)
        out["save_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        with np.load(path) as z:
            assert np.array_equal(z["words"], want)
        t0 = time.perf_counter()
        loaded = CBL.load_from_file(path)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        # load_s taken apart on the host: the file's read, the keys
        t0 = time.perf_counter()
        with np.load(path) as z:
            file_words = z["words"]
        out["npz_read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert len(from_limbs(file_words)) == len(keys)
        out["from_limbs_s"] = time.perf_counter() - t0
        del file_words
        assert loaded.device.type == "cuda" and loaded.count() == len(keys)
        assert int(loaded.count_device()) == len(keys)
        n_kmers = len(codes) - K + 1
        t0 = time.perf_counter()
        total, positive = loaded.query_codes_stream(codes, offsets)
        out["loaded_query_s"] = time.perf_counter() - t0
        assert total == positive == n_kmers, (total, positive)
        del loaded

        path = os.path.join(tmp, "index.cbl")
        t0 = time.perf_counter()
        interop.save_reference(idx, path)
        out["save_ref_s"] = time.perf_counter() - t0
        out["ref_bytes"] = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(6)
        assert head[0] == 0 and head[1] == 0xFC  # plain; a u32 bucket count
        assert int.from_bytes(head[2:6], "little") == out["buckets"]
        # the reader's bucket headers are a Python loop: read at a cut
        cut = CBL(k=K, device=DEVICE)
        cut.insert_codes_stream(codes[:REF_CUT], np.array([0, REF_CUT]))
        cut_words = cut.wordset.words_array()
        t0 = time.perf_counter()
        interop.save_reference(cut, path)
        out["cut_save_ref_s"] = time.perf_counter() - t0
        out["cut_ref_bytes"] = os.path.getsize(path)
        with open(path, "rb") as f:
            first = f.read()
        t0 = time.perf_counter()
        back = interop.load_reference(path, k=K)
        torch.cuda.synchronize()
        out["cut_load_ref_s"] = time.perf_counter() - t0
        assert back.device.type == "cuda"
        assert np.array_equal(back.wordset.words_array(), cut_words)
        interop.save_reference(back, path)
        with open(path, "rb") as f:
            assert f.read() == first
        out["cut_words"] = len(cut_words)
        del cut, back, first

    rows = 1 << 20
    t0 = time.perf_counter()
    nucs = list(itertools.islice(idx.iter_nucs(), rows))
    out["iter_nucs_s"] = time.perf_counter() - t0
    shifts = np.arange(2 * (K - 1), -1, -2, dtype=np.uint64)
    codes_ = ((packed[:rows, None] >> shifts) & np.uint64(3)).astype(np.uint8)
    ascii_ = np.frombuffer(b"ACTG", dtype=np.uint8)[codes_]
    assert nucs == [r.tobytes() for r in ascii_]
    out["launches"] = dict(LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


# --- phase 10: wide K ----------------------------------------------------------

WIDE_K, WIDE_PREFIX = 59, 28  # BASELINE config 3 (bench.py --mode largek)
K31 = 31  # the k most genomics tools default to
K31_BASES = 8_000_000
WIDE_FOREIGN = 4_000_000  # bases of config 3's foreign query stream


def _np_rolling(codes: np.ndarray, first: int, width: int,
                nk: int) -> np.ndarray:
    """[nk] uint64: bases [i + first, i + first + width) of `codes` as a
    2-bit big-endian value (width <= 32), in eight threads."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(nk, dtype=np.uint64)
    edges = np.linspace(0, nk, 9).astype(np.int64)

    def piece(i):
        lo, hi = edges[i], edges[i + 1]
        v = np.zeros(hi - lo, dtype=np.uint64)
        for j in range(width):
            v <<= np.uint64(2)
            v |= codes[lo + first + j : hi + first + j]
        out[lo:hi] = v

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(piece, range(8)))
    return out


def _np_parity(*xs) -> np.ndarray:
    """Parity of the summed popcounts of uint64 arrays."""
    total = 0
    for x in xs:
        if hasattr(np, "bitwise_count"):
            total = total + np.bitwise_count(x)
        else:
            lut = np.array([bin(i).count("1") for i in range(256)],
                           dtype=np.uint8)
            total = total + lut[x.view(np.uint8)].reshape(-1, 8).sum(1)
    return (np.asarray(total) & 1).astype(bool)


def np_kmer_pairs(codes: np.ndarray, k: int, canonical: bool):
    """(hi, lo) uint64 of every k-mer start of `codes` for k > 32: hi its
    first 32 bases, lo the other k - 32 (one to one with the k-mer, and
    ordered as the k-mer is); with `canonical`, of the even-popcount one
    of the k-mer and its reverse complement."""
    nk = len(codes) - k + 1
    hi = _np_rolling(codes, 0, 32, nk)
    lo = _np_rolling(codes, 32, k - 32, nk)
    if canonical:
        rc = (codes ^ np.uint8(2))[::-1].copy()
        rh = _np_rolling(rc, 0, 32, nk)[::-1]
        rl = _np_rolling(rc, 32, k - 32, nk)[::-1]
        odd = _np_parity(hi, lo)
        hi, lo = np.where(odd, rh, hi), np.where(odd, rl, lo)
    return hi, lo


def _np_argsort_threads(x: np.ndarray) -> np.ndarray:
    """`np.argsort` of uint64 values in eight threads: the rows bucketed
    by their top three bits (a stable sort of a small key), each bucket
    sorted in a thread of its own (numpy releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    bucket = (x >> np.uint64(61)).astype(np.uint8)
    idx = np.argsort(bucket, kind="stable")
    edges = np.concatenate([[0], np.cumsum(np.bincount(bucket,
                                                       minlength=8))])
    out = np.empty_like(idx)

    def piece(b):
        sub = idx[edges[b]:edges[b + 1]]
        out[edges[b]:edges[b + 1]] = sub[np.argsort(x[sub])]

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(piece, range(8)))
    return out


def np_unique_pairs(hi: np.ndarray, lo: np.ndarray):
    """The sorted unique (hi, lo) pairs: one sort by hi, then the rare
    runs of one hi sorted by lo."""
    o = _np_argsort_threads(hi)
    h, l = hi[o], lo[o]
    dup = np.flatnonzero(h[1:] == h[:-1])
    if dup.size:
        rows = np.unique(np.concatenate([dup, dup + 1]))
        sub = np.lexsort((l[rows], h[rows]))
        h[rows], l[rows] = h[rows][sub], l[rows][sub]
    keep = np.ones(len(h), dtype=bool)
    keep[1:] = (h[1:] != h[:-1]) | (l[1:] != l[:-1])
    return h[keep], l[keep]


def np_pairs_in(qh, ql, uh, ul) -> np.ndarray:
    """Which query pairs are among the sorted unique pairs (uh, ul).  The
    queries are searched in sorted order (numpy's binary search starts
    from the last key's place when the keys ascend; in a random order
    every search misses the cache)."""
    o = _np_argsort_threads(qh)
    qh, ql = qh[o], ql[o]
    i = np.searchsorted(uh, qh, "left")
    j = np.searchsorted(uh, qh, "right")
    hit = np.zeros(len(qh), dtype=bool)
    one = j - i == 1
    hit[one] = ul[i[one]] == ql[one]
    for r in np.flatnonzero(j - i > 1):
        seg = ul[i[r]:j[r]]
        at = int(np.searchsorted(seg, ql[r]))
        hit[r] = at < len(seg) and seg[at] == ql[r]
    out = np.empty_like(hit)
    out[o] = hit
    return out


def limbs_to_pairs(limbs: np.ndarray, k: int):
    """[n, 4] uint32 k-mer limbs (`kmers_limbs`) -> the (hi, lo) pairs of
    `np_kmer_pairs`."""
    u = limbs.astype(np.uint64)
    sh = 2 * (k - 32) - 32  # bits of limb 2 that belong to lo
    hi = ((u[:, 0] << np.uint64(64 - sh)) | (u[:, 1] << np.uint64(32 - sh))
          | (u[:, 2] >> np.uint64(sh)))
    lo = ((u[:, 2] & np.uint64((1 << sh) - 1)) << np.uint64(32)) | u[:, 3]
    return hi, lo


def np_wide_word_limbs(hi: np.ndarray, lo: np.ndarray, k: int):
    """[n, 4] uint32 limbs of the packed words of k-mer pairs
    (`_np_wide_words` in eight threads over pieces of the rows)."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty((len(hi), 4), dtype=np.uint32)
    edges = np.linspace(0, len(hi), 9).astype(np.int64)

    def piece(i):
        a, b = edges[i], edges[i + 1]
        out[a:b] = _np_wide_words(hi[a:b], lo[a:b], k)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(piece, range(8)))
    return out


def _np_wide_words(hi: np.ndarray, lo: np.ndarray, k: int):
    """[n, 4] uint32 limbs of the packed words (necklace << pos_bits |
    pos) of k-mer pairs, k > 32: the W - 1 one-bit rotations of the
    128-bit value in two uint64 halves (independent of the port)."""
    W = 2 * k
    pb = (W - 1).bit_length()
    lbits = 2 * (k - 32)
    h = hi >> np.uint64(64 - lbits)
    l = (hi << np.uint64(lbits)) | lo
    hm, top = np.uint64((1 << (W - 64)) - 1), np.uint64(W - 65)
    one, s63 = np.uint64(1), np.uint64(63)
    bh, bl = h.copy(), l.copy()
    pos = np.zeros(len(h), dtype=np.uint64)
    for p in range(1, W):
        msb = (h >> top) & one
        h = ((h << one) | (l >> s63)) & hm
        l = (l << one) | msb
        better = (h < bh) | ((h == bh) & (l < bl))
        np.copyto(bh, h, where=better)
        np.copyto(bl, l, where=better)
        np.copyto(pos, np.uint64(p), where=better)
    wh = (bh << np.uint64(pb)) | (bl >> np.uint64(64 - pb))
    wl = (bl << np.uint64(pb)) | pos
    m = np.uint64(0xFFFFFFFF)
    return np.stack([wh >> np.uint64(32), wh & m, wl >> np.uint64(32),
                     wl & m], axis=1).astype(np.uint32)


def wide_foreign_stream(codes: np.ndarray, n_bases: int, seed: int):
    """(codes, offsets) of 16 records of n_bases / 16 and an 11-base
    tail: records 0, 2, 4, ... copied from `codes`, 1, 5, 9, 13 fresh,
    3, 7, 11, 15 copies with a point mutation every 20 to 40 bases (as
    phase 8's `foreign_stream`)."""
    rng = np.random.default_rng(seed)
    n = n_bases // 16
    parts = []
    for r in range(16):
        if r % 4 == 1:
            parts.append(rng.integers(0, 4, size=n, dtype=np.uint8))
            continue
        s = int(rng.integers(0, len(codes) - n))
        parts.append(codes[s : s + n].copy())
        if r % 4 == 3:
            at = np.cumsum(rng.integers(20, 41, size=n // 20))
            at = at[at < n]
            parts[-1][at] = (parts[-1][at] + rng.integers(
                1, 4, size=len(at), dtype=np.uint8)) % 4
    parts.append(rng.integers(0, 4, size=11, dtype=np.uint8))
    return (np.concatenate(parts),
            np.concatenate([[0], np.cumsum([len(p) for p in parts])]))


def np_valid_starts(offsets: np.ndarray, k: int, nk: int) -> np.ndarray:
    """[nk] bool: the k-mer starting there lies inside one record."""
    valid = np.zeros(nk + 1, dtype=np.int64)
    for r in range(len(offsets) - 1):
        lo, hi = int(offsets[r]), int(offsets[r + 1]) - k + 1
        if hi > lo:
            valid[lo] += 1
            valid[hi] -= 1
    return np.cumsum(valid[:nk]) > 0


def zero_launches() -> None:
    """Set every kernel's launch count to 0."""
    from cbl_tpu_torch.ops import LAUNCHES

    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches_now() -> dict:
    """A copy of the launch counts."""
    from cbl_tpu_torch.ops import LAUNCHES

    return dict(LAUNCHES)


def config3_run(codes: np.ndarray, canonical: bool, card: str) -> dict:
    """BASELINE config 3 on the card (K=59, prefix 28, one record of
    `codes`): a timed build and self-query, its launches counted alone
    (then once more under `torch.profiler`, its device time by kernel
    printed), then `count()`, `kmers_limbs`, the words of the first 2^20
    k-mers and a foreign query, each against numpy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch import cbl as cmod
    from cbl_tpu_torch.wordset import host_limbs

    t_fn = time.perf_counter()
    offsets = np.array([0, len(codes)], dtype=np.int64)
    nk = len(codes) - WIDE_K + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    idx = CBL(k=WIDE_K, prefix_bits=WIDE_PREFIX, canonical=canonical,
              device=DEVICE)
    t_s = time.perf_counter()
    ps = idx.pack_stream(codes, offsets)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t_s
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    zero_launches()
    t0 = time.perf_counter()
    ev[0].record()
    idx.insert_codes_stream(ps)
    n_dev = idx.count_device()
    ev[1].record()
    total_dev, pos_dev = idx.query_codes_stream(ps, lazy=True)
    ev[2].record()
    distinct, total, positive = torch.stack(
        [n_dev.long(), total_dev.long(), pos_dev.long()]).tolist()
    wall_s = time.perf_counter() - t0
    r = dict(distinct=distinct, total=total, positive=positive,
             stage_s=stage_s, wall_s=wall_s,
             insert_ms=ev[0].elapsed_time(ev[1]),
             query_ms=ev[1].elapsed_time(ev[2]), launches=launches_now())
    assert total == positive == nk, r
    t_p = time.perf_counter()
    # one slab: B1 wide and B2 build it, B5 sorts its two-column words
    # (the card's default sort), B3 joins the (word, tag) rows of the
    # index and of the stream's sorted words (its memo) on three columns
    assert r["launches"] == dict(
        {n: 0 for n in r["launches"]}, necklace_wide=1, blank=1, sort=1,
        merge_3col=1), r["launches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = CBL(k=WIDE_K, prefix_bits=WIDE_PREFIX, canonical=canonical,
                    device=DEVICE)
        again.insert_codes_stream(ps)
        n_again = again.count_device()
        again.query_codes_stream(ps, lazy=True)
        torch.cuda.synchronize()
    label = "canonical" if canonical else "plain"
    print_profile(prof, f"[{card}] config 3 {label}: build + self-query "
                  f"under the profiler (timed run "
                  f"{r['insert_ms'] + r['query_ms']:.2f} ms)",
                  r["insert_ms"] + r["query_ms"])
    assert int(n_again) == distinct
    del again
    r["profile_s"] = time.perf_counter() - t_p
    # `bench.py --mode largek`'s metric: a build from the bases (staging
    # included) and `count()`, then every k-mer listed (`kmers_limbs`),
    # by the host clock: (n_kmers + distinct) / (build + list)
    listed = CBL(k=WIDE_K, prefix_bits=WIDE_PREFIX, canonical=canonical,
                 device=DEVICE)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    listed.insert_codes_stream(codes, offsets)
    assert int(listed.count_device()) == distinct
    t_k = time.perf_counter()
    kl = listed.kmers_limbs()
    r["kmers_limbs_s"] = time.perf_counter() - t_k
    r["largek_build_s"] = t_k - t_b
    r["largek_rate"] = (nk + distinct) / (time.perf_counter() - t_b)
    del listed
    n_first = min(1 << 20, nk)
    stream = ps.slabs[0][1]
    words = host_limbs(cmod._kmer_words(stream, n_first, idx.cfg, canonical),
                       idx.cfg.word_limbs)
    fcodes, foff = wide_foreign_stream(codes, WIDE_FOREIGN, 13)
    t_f = time.perf_counter()
    f_total, f_pos = idx.query_codes_stream(fcodes, foff)
    r["foreign_s"] = time.perf_counter() - t_f
    assert idx.count() == distinct
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del idx, ps, stream

    t_o = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = round(time.perf_counter() - t_o - sum(parts.values()),
                            3)

    hi, lo = np_kmer_pairs(codes, WIDE_K, canonical)
    lap("pairs")
    uh, ul = np_unique_pairs(hi, lo)
    lap("unique")
    assert distinct == len(uh), (distinct, len(uh))
    gh, gl = np_unique_pairs(*limbs_to_pairs(kl, WIDE_K))
    lap("kmers_unique")
    assert len(gh) == len(kl) == len(uh)
    assert np.array_equal(gh, uh) and np.array_equal(gl, ul)
    del kl, gh, gl
    want = np_wide_word_limbs(hi[:n_first], lo[:n_first], WIDE_K)
    lap("words")
    assert np.array_equal(words, want), "words of the first 2^20 k-mers"
    del hi, lo
    fh, fl = np_kmer_pairs(fcodes, WIDE_K, canonical)
    valid = np_valid_starts(foff, WIDE_K, len(fh))
    hits = np_pairs_in(fh[valid], fl[valid], uh, ul)
    assert (f_total, f_pos) == (int(valid.sum()), int(hits.sum())), (
        f_total, f_pos, int(valid.sum()), int(hits.sum()))
    assert 0 < f_pos < f_total
    lap("foreign")
    r.update(foreign_total=f_total, foreign_positive=f_pos,
             oracle_s=time.perf_counter() - t_o, oracle_parts_s=parts,
             fn_s=time.perf_counter() - t_fn)
    return r


def k31_check(card: str) -> dict:
    """K=31, prefix 24 on the card: words of two int64 columns, k-mers of
    one (B1 at one column).  `insert_seqs` / `remove_seqs` of 8 Mbp in
    records of mixed length through the pending log under the
    "mergepath" sort mode (B5 at three columns), point operations on the
    log, the four set operations under phase 7's three (merge, sort)
    mode pairs, a `contains_codes_stream` mask (the sort-join on three
    columns: B3, and B7 + B6 under "bitonic"), `save_to_file` ->
    `load_from_file` and `save_reference` -> `load_reference` at a 2 Mbp
    cut; everything against numpy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbl_tpu_torch import CBL, interop
    from cbl_tpu_torch.ops.sort import use_merge_mode, use_sort_mode

    k = K31
    t_o = time.perf_counter()
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, size=K31_BASES, dtype=np.uint8)
    vals = _np_rolling(codes, 0, k, len(codes) - k + 1)
    out = {"launches": {}, "parts_s": {}}

    def lap(name):
        out["parts_s"][name] = round(
            time.perf_counter() - t_o - sum(out["parts_s"].values()), 3)

    def kmer_values(idx):
        kl = idx.kmers_limbs().astype(np.uint64)
        return np.sort((kl[:, 1] << np.uint64(32)) | kl[:, 2])

    # insert_seqs / remove_seqs in records of mixed length
    lens = list(rng.integers(1, K31_BASES // 50, size=200)) + [5, k - 1, k]
    rng.shuffle(lens)
    off = np.cumsum([0] + lens)
    off = np.append(off[off < K31_BASES], K31_BASES)
    recs = [codes[a:b] for a, b in zip(off[:-1], off[1:])]
    rm = sorted(range(0, len(recs), 3))

    def rec_vals(which):
        return np.concatenate([vals[off[i]:off[i + 1] - k + 1] for i in which
                               if off[i + 1] - off[i] >= k])

    want = np_setdiff(np_unique(rec_vals(range(len(recs)))),
                      np_unique(rec_vals(rm)))
    lap("oracle")
    with use_sort_mode("mergepath"):
        idx = CBL(k=k, device=DEVICE)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        idx.insert_seqs(recs)
        idx.remove_seqs([recs[i] for i in rm])
        count = idx.count()
        out["seqs_s"] = time.perf_counter() - t0
        seqs = out["launches"]["seqs"] = launches_now()
        # B1 at one column; the log's folds sort (word, seqtag) rows on
        # three columns with B5
        assert seqs["necklace"] >= 1 and seqs["sort_3col"] >= 1, seqs
        assert seqs["necklace_wide"] == 0, seqs  # 62-bit k-mers
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            again = CBL(k=k, device=DEVICE)
            again.insert_seqs(recs)
            again.remove_seqs([recs[i] for i in rm])
            assert again.count() == count
        print_profile(prof, f"[{card}] K=31 insert_seqs + remove_seqs + "
                      f"count under the profiler (timed run "
                      f"{out['seqs_s'] * 1e3:.1f} ms by the host clock)",
                      out["seqs_s"] * 1e3)
        del again
        assert count == len(want), (count, len(want))
        assert np.array_equal(kmer_values(idx), want)
        # point operations on the pending log, against a Python set
        present = [int(v) for v in want[:: max(len(want) // 500, 1)][:500]]
        absent = [int(v) for v in np_setdiff(np_unique(
            rng.integers(0, 1 << (2 * k), size=2000, dtype=np.uint64)),
            want)[:500]]
        assert idx.contains_kmers(present).all()
        assert not idx.contains_kmers(absent).any()
        idx.remove_kmers(present[:250])
        idx.insert_kmers(absent[:250])
        assert idx.wordset.n_pending == 500
        got = idx.contains_kmers(present + absent)
        assert got.tolist() == [False] * 250 + [True] * 500 + [False] * 250
        assert idx.count() == len(want)
    out["seqs_count"] = count
    del idx
    lap("seqs")

    # set algebra of two overlapping 4 Mbp windows (2 Mbp shared), under
    # phase 7's three mode pairs
    half, quarter = K31_BASES // 2, K31_BASES // 4
    wa, wb = codes[:half], codes[quarter:quarter + half]
    ua = np_unique(vals[: half - k + 1])
    ub = np_unique(vals[quarter: quarter + half - k + 1])
    inter = np.intersect1d(ua, ub, assume_unique=True)
    want_n = dict(union=len(ua) + len(ub) - len(inter), inter=len(inter),
                  diff=len(ua) - len(inter),
                  symdiff=len(ua) + len(ub) - 2 * len(inter))
    out["algebra_ms"] = {}
    for merge_mode, sort_mode in ALGEBRA_MODES:
        with use_merge_mode(merge_mode), use_sort_mode(sort_mode):
            a = CBL(k=k, device=DEVICE)
            a.insert_codes_stream(wa, np.array([0, len(wa)]))
            b = CBL(k=k, device=DEVICE)
            b.insert_codes_stream(wb, np.array([0, len(wb)]))
            assert (a.count(), b.count()) == (len(ua), len(ub))
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            zero_launches()
            e0.record()
            got = {name: op(a, b).count() for name, op in ALGEBRA_OPS}
            e1.record()
            e1.synchronize()
            ops = out["launches"][f"algebra {merge_mode}/{sort_mode}"] = \
                launches_now()
            assert got == want_n, (merge_mode, sort_mode, got, want_n)
            # inter, diff and symdiff join (word, tag) rows on three
            # columns: B7's merge, B6's sort (no merge kernel) or B3's
            # merge
            kernel = {"bitonic": "bitonic_merge_3col",
                      "sort": "bitonic_sort_3col",
                      "mergepath": "merge_3col"}[merge_mode]
            assert ops[kernel] >= 1, (merge_mode, sort_mode, ops)
            assert np.array_equal(kmer_values(a & b), inter)
            out["algebra_ms"][(merge_mode, sort_mode)] = e0.elapsed_time(e1)
    # ordered membership: a mask of a 2 Mbp foreign stream (above the
    # sort-join's 2^17 k-mers) against `a`
    lap("algebra")
    fcodes, foff = wide_foreign_stream(wa, quarter, 14)
    fvals = _np_rolling(fcodes, 0, k, len(fcodes) - k + 1)
    hit = np_isin_sorted(fvals, ua)
    want_masks = [hit[int(foff[r]):max(int(foff[r + 1]) - k + 1,
                                        int(foff[r]))]
                  for r in range(len(foff) - 1)]
    for merge_mode, sort_mode in (("mergepath", "library"),
                                  ("bitonic", "bitonic")):
        with use_merge_mode(merge_mode), use_sort_mode(sort_mode):
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            got = a.contains_codes_stream(fcodes, foff)
            out[f"contains_{merge_mode}_s"] = time.perf_counter() - t0
            join = out["launches"][f"contains {merge_mode}/{sort_mode}"] = \
                launches_now()
            masks_equal(got, want_masks, f"K=31 contains ({merge_mode})")
            # the sort-join's (word, position) rows on three columns: the
            # queries sorted (torch.sort, or B6) and merged (B3, or B7)
            kernels = (("merge_3col",) if merge_mode == "mergepath" else
                       ("bitonic_sort_3col", "bitonic_merge_3col"))
            assert all(join[n] == 1 for n in kernels), (merge_mode, join)
    lap("contains")
    # checkpoints and .cbl files
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k31.cblx.npz")
        t0 = time.perf_counter()
        a.save_to_file(path)
        back = CBL.load_from_file(path, device=DEVICE)
        out["serde_s"] = time.perf_counter() - t0
        assert np.array_equal(kmer_values(back), ua)
        cut = CBL(k=k, device=DEVICE)
        cut.insert_codes_stream(codes[:REF_CUT], np.array([0, REF_CUT]))
        ref, ref2 = os.path.join(tmp, "k31.cbl"), os.path.join(tmp, "b.cbl")
        t0 = time.perf_counter()
        interop.save_reference(cut, ref)
        loaded = interop.load_reference(ref, k=k, prefix_bits=24,
                                        device=DEVICE)
        out["ref_s"] = time.perf_counter() - t0
        assert np.array_equal(loaded.wordset.words_array(),
                              cut.wordset.words_array())
        assert np.array_equal(kmer_values(loaded),
                              np_unique(vals[: REF_CUT - k + 1]))
        interop.save_reference(loaded, ref2)
        with open(ref, "rb") as f1, open(ref2, "rb") as f2:
            assert f1.read() == f2.read()
    lap("files")
    return out


def wide_k_check(card: str) -> dict:
    """Phase 10: config 3 (K=59) plain and canonical, then K=31; each
    path's launches counted alone (`launches`, by path)."""
    import torch

    codes = np.random.default_rng(0).integers(0, 4, size=MAIN_BASES,
                                              dtype=np.uint8)
    out = {"launches": {}}
    for canonical in (False, True):
        r = config3_run(codes, canonical, card)
        label = "canonical" if canonical else "plain"
        log(f"wide K, config 3 {label}: {r}")
        out[label] = r
        out["launches"][f"config 3 {label}"] = r["launches"]
    torch.cuda.reset_peak_memory_stats()
    out["k31"] = k31_check(card)
    out["k31"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"wide K, K=31: {out['k31']}")
    for path, counts in out["k31"]["launches"].items():
        out["launches"][f"K=31 {path}"] = counts
    return out


# --- phase 11: dynamic rounds at wide K -----------------------------------------

DYN_WIDE = ((WIDE_K, WIDE_PREFIX), (27, 24))  # a log of C = 3 and C = 2


def _np_group_sorted(hi: np.ndarray, lo):
    """(order, first) of values `hi` (or (hi, lo) pairs): the order that
    sorts them and, in that order, True at the first row of each
    distinct value."""
    o = _np_argsort_threads(hi)
    h = hi[o]
    if lo is None:
        first = np.concatenate([[True], h[1:] != h[:-1]])
        return o, first
    dup = np.flatnonzero(h[1:] == h[:-1])
    if dup.size:  # runs of one hi, sorted by lo
        rows = np_unique(np.concatenate([dup, dup + 1]))
        o[rows] = o[rows][np.lexsort((lo[o[rows]], h[rows]))]
    h, l = hi[o], lo[o]
    first = np.concatenate([[True], (h[1:] != h[:-1]) | (l[1:] != l[:-1])])
    return o, first


def np_dynamic_oracle(codes: np.ndarray, k: int):
    """(distinct, summed positive) of `bench.py --mode dynamic`'s rounds on
    `codes` at K=k, plain: SEGS segments, each a record of its own; round
    i inserts segment i, queries segment max(i - 1, 0) (every k-mer
    occurrence counts; it sees the inserts of rounds <= i and the removes
    of rounds < i) and removes the first half of segment i.  One sort of
    every k-mer start groups equal k-mers; each group's rounds of insert
    and of remove are bit masks, and the last event before an observer
    decides."""
    sb = len(codes) // SEGS
    nk = len(codes) - k + 1
    if 2 * k <= 64:
        hi, lo = _np_rolling(codes, 0, k, nk), None
    else:
        hi, lo = np_kmer_pairs(codes, k, False)
    off = np.arange(nk) % sb
    inside = off <= sb - k  # k-mers of one segment
    seg = (np.arange(nk) // sb)[inside]
    in_half = (off <= sb // 2 - k)[inside]
    hi = hi[inside]
    lo = None if lo is None else lo[inside]
    o, first = _np_group_sorted(hi, lo)
    starts = np.flatnonzero(first)
    bit = (np.int64(1) << seg)[o]
    ins = np.bitwise_or.reduceat(bit, starts)
    rm = np.bitwise_or.reduceat(np.where(in_half[o], bit, 0), starts)
    gid = np.empty(len(o), dtype=np.int64)
    gid[o] = np.cumsum(first) - 1
    top = np.array([m.bit_length() - 1 for m in range(1 << SEGS)])

    def present(mask_ins: np.ndarray, rm_before: int) -> np.ndarray:
        """Groups whose last insert (in `mask_ins`) has no remove after it
        among the rounds below `rm_before`."""
        j = top[mask_ins]
        since = ((1 << rm_before) - 1) & ~((1 << np.maximum(j, 0)) - 1)
        return (j >= 0) & ((rm & since) == 0)

    positive = 0
    for i in range(SEGS):
        live = present(ins & ((1 << (i + 1)) - 1), i)
        positive += int(live[gid[seg == max(i - 1, 0)]].sum())
    return int(present(ins, SEGS).sum()), positive


def wide_dynamic_check(codes: np.ndarray, base_dyn: dict, card: str) -> dict:
    """Phase 11: config 2's rounds at K=59 (prefix 28; the log's two word
    columns and a tag column) and K=27 (prefix 24; one word column and a
    tag column), one warm-up and one timed run each, against
    `np_dynamic_oracle` (first held to `bench/baseline.cpp dynamic` at
    K=25); a query of the active log against the same query after
    `flush()`; K=59 once more under merge mode "bitonic" (B7 at three
    columns, no B3).  Each timed run's launches are counted alone."""
    import torch

    from cbl_tpu_torch.ops.sort import use_merge_mode

    t0 = time.perf_counter()
    want25 = np_dynamic_oracle(codes, K)
    out = {"launches": {}, "oracle_k25_s": time.perf_counter() - t0}
    assert want25 == (base_dyn["distinct"], base_dyn["positive"]), (
        want25, base_dyn)
    sb = len(codes) // SEGS
    want = {}
    for k, pb in DYN_WIDE:
        t0 = time.perf_counter()
        want[k] = np_dynamic_oracle(codes, k)
        oracle_s = time.perf_counter() - t0
        dynamic_run(codes, timed=False, k=k, prefix_bits=pb)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        idx, segs, r = dynamic_run(codes, timed=True, k=k, prefix_bits=pb)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        r["oracle_s"] = oracle_s
        log(f"dynamic rounds, K={k} prefix {pb}: {r}; numpy oracle "
            f"(distinct, positive) {want[k]}")
        assert (r["distinct"], r["positive"]) == want[k], (k, r, want[k])
        n = r["launches"]
        tag, merge, neck = (("slog_scan_tag_3col", "merge_3col",
                             "necklace_wide") if k > 27 else
                            ("slog_scan_tag", "merge", "necklace"))
        assert n[tag] == SEGS and n["slog_scan"] == 0, n
        # three merges a round, two in the first; B1 once a segment and
        # once a half (the streams' words are kept, so a segment queried
        # in the next round is not run again)
        assert n[merge] == 3 * SEGS - 1 and n[neck] == 2 * SEGS, n
        assert n["blank"] >= 1, n
        out["launches"][f"K={k} rounds"] = n
        before = launches_now()
        t_j = time.perf_counter()
        joined = idx.query_codes_stream(segs[SEGS - 1])  # B3 + B4 tag
        r["join_s"] = time.perf_counter() - t_j
        after = launches_now()
        assert (after[merge] - before[merge], after[tag] - before[tag]) == (
            1, 1), (before, after)
        t_f = time.perf_counter()
        idx.flush()
        folded = idx.count()
        r["flush_s"] = time.perf_counter() - t_f
        static = idx.query_codes_stream(segs[SEGS - 1])
        log(f"K={k}: query of segment {SEGS - 1} against the log {joined}, "
            f"after flush() {static}; count {folded}")
        assert joined == static and joined[0] == sb - k + 1, (joined, static)
        assert 0 < joined[1] < joined[0] and folded == r["distinct"]
        out[k] = r
        del idx, segs
        # once more under the profiler: device time by kernel, idle share
        _, _, rp = dynamic_run(codes, timed=False, k=k, prefix_bits=pb,
                               profiled=True)
        assert (rp["distinct"], rp["positive"]) == want[k], rp
        print_profile(rp["prof"], f"[{card}] K={k} dynamic rounds under the "
                      f"profiler ({rp['rounds_ms']:.2f} ms by device events; "
                      f"timed run {r['rounds_ms']:.2f})", rp["rounds_ms"])
        torch.cuda.empty_cache()
    with use_merge_mode("bitonic"):
        dynamic_run(codes, timed=False, k=WIDE_K, prefix_bits=WIDE_PREFIX)
        torch.cuda.reset_peak_memory_stats()
        _, _, rb = dynamic_run(codes, timed=True, k=WIDE_K,
                               prefix_bits=WIDE_PREFIX)
    rb["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"dynamic rounds, K={WIDE_K}, merge mode bitonic: {rb}")
    assert (rb["distinct"], rb["positive"]) == want[WIDE_K], rb
    n = rb["launches"]
    assert n["bitonic_merge_3col"] == 3 * SEGS - 1, n
    assert n["merge_3col"] == 0 and n["slog_scan_tag_3col"] == SEGS, n
    out["bitonic"] = rb
    out["launches"][f"K={WIDE_K} rounds, bitonic"] = n
    torch.cuda.empty_cache()
    return out


# --- phase 12: the CLI on the genome corpus -------------------------------------

GENOME_BASES = 32_000_000  # bench.py --mode genome's corpus
K59_CLI_BASES = 4_000_000  # bases of the K=59 build + list (whole records)
FASTA_WIDTH = 80
ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)  # base codes 0-3


def write_fasta(path, codes: np.ndarray, offsets: np.ndarray) -> None:
    """The records as FASTA, FASTA_WIDTH bases a line."""
    text = ASCII[codes].tobytes()
    with open(path, "wb") as f:
        for r in range(len(offsets) - 1):
            s = text[offsets[r] : offsets[r + 1]]
            f.write(b">i%d\n" % r)
            f.write(b"\n".join(s[j : j + FASTA_WIDTH]
                               for j in range(0, len(s), FASTA_WIDTH)))
            f.write(b"\n")


def write_fastq_gz(path, codes: np.ndarray, offsets: np.ndarray) -> None:
    """The records as FASTQ, gzip at level 1."""
    import gzip

    text = ASCII[codes].tobytes()
    with gzip.open(path, "wb", compresslevel=1) as f:
        for r in range(len(offsets) - 1):
            s = text[offsets[r] : offsets[r + 1]]
            f.write(b"@q%d\n%s\n+\n%s\n" % (r, s, b"I" * len(s)))


def start_baseline_records(work, ci, oi, cq, oq) -> dict:
    """`bench/baseline.cpp records` on the corpus, plain and canonical, as
    processes that run beside the commands (the bench's
    `run_baseline_records` call, on its executable)."""
    from cbl_tpu_torch.bench import build_baseline

    exe = build_baseline()
    paths = []
    for name, arr in (("gcodes", ci), ("goff", oi), ("gqcodes", cq),
                      ("gqoff", oq)):
        paths.append(str(work / f"{name}.bin"))
        arr.tofile(paths[-1])
    return {c: subprocess.Popen(
        [exe, paths[0], "records", *paths[1:]] + (["canonical"] if c else []),
        stdout=subprocess.PIPE) for c in (False, True)}


def start_cli(argvs: list, module: str = "cbl_tpu_torch") -> list:
    """`python -m <module> ARGV` for each argv, all started at once from
    the repository root."""
    return [(a, subprocess.Popen([sys.executable, "-m", module, *map(str, a)],
                                 cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))
            for a in argvs]


def finish_cli(started: list) -> list:
    """(stdout, stderr) of each started command; raises on a non-zero
    exit."""
    out = []
    for argv, proc in started:
        so, se = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(map(str, argv))} exited "
                               f"{proc.returncode}:\n{se[-4000:]}")
        out.append((so, se))
    return out


def cli_waves(*waves: list) -> list:
    """The commands of each wave at once, the waves one after the other;
    (stdout, stderr) of every command, in order."""
    out = []
    for wave in waves:
        out += finish_cli(start_cli(wave))
    return out


def stderr_value(err: str, prefix: str) -> str:
    """The rest of the stderr line that starts with `prefix`."""
    for line in err.splitlines():
        if line.startswith(prefix):
            return line[len(prefix):]
    raise AssertionError(f"no line {prefix!r} in:\n{err}")


def meter(err: str, label: str) -> dict:
    """The `ThroughputMeter` line of `label`: k-mers, seconds, rate."""
    rest = stderr_value(err, f"{label} throughput: ")
    n, rest = rest.split(" k-mers in ")
    s, rate = rest.split("s = ")
    return dict(kmers=int(n), s=float(s), rate=float(rate[:-2].replace(",", "")))


def built_count(err: str) -> int:
    """N of the `build` line "Built in Xs (N k-mers)"."""
    return int(stderr_value(err, "Built in ").split("(")[1].split()[0])


def query_counts(err: str) -> tuple:
    total = int(stderr_value(err, "# queries: "))
    positive = int(stderr_value(err, "# positive queries: ").split()[0])
    return total, positive


def listed_kmers(path, k: int) -> np.ndarray:
    """[n, k] base codes of the lines of a `list` output file."""
    rows = np.fromfile(path, dtype=np.uint8).reshape(-1, k + 1)
    assert (rows[:, k] == ord("\n")).all()
    lut = np.full(256, 255, dtype=np.uint8)
    lut[ASCII] = np.arange(4, dtype=np.uint8)
    codes = lut[rows[:, :k]]
    assert (codes != 255).all()
    return codes


def fold_codes(codes: np.ndarray) -> np.ndarray:
    """[n, w] base codes (w <= 32) -> [n] uint64, first base most
    significant."""
    v = np.zeros(len(codes), dtype=np.uint64)
    for j in range(codes.shape[1]):
        v = (v << np.uint64(2)) | codes[:, j].astype(np.uint64)
    return v


def genome_oracles(ci, oi, cq, oq, c59, o59) -> dict:
    """numpy's distinct words of both streams, the distinct k-mers of the
    insert stream and the distinct K=59 (hi, lo) pairs of its cut."""
    t0 = time.perf_counter()
    wi = np_unique(np_necklace_words(ci, oi))
    wq = np_unique(np_necklace_words(cq, oq))
    nk = len(ci) - K + 1
    kmers = np_unique(_np_rolling(ci, 0, K, nk)[np_valid_starts(oi, K, nk)])
    nk59 = len(c59) - 59 + 1
    hi, lo = np_kmer_pairs(c59, 59, False)
    valid = np_valid_starts(o59, 59, nk59)
    uh, ul = np_unique_pairs(hi[valid], lo[valid])
    return dict(wi=wi, wq=wq, kmers=kmers, k59=(uh, ul),
                oracle_s=time.perf_counter() - t0)


def inproc_cli(argv: list, packs: list) -> dict:
    """`cli.main(["--device", "cuda", *argv])` in this process, launches
    counted from 0, under `torch.profiler`: launches, the device's busy
    time (every kernel and copy), the host clock, and whether each
    `np_pack_stream` took the native packer (appended to `packs`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbl_tpu_torch import cli
    from cbl_tpu_torch import io as tio

    native = tio.pack_stream_native

    def counted(codes):
        out = native(codes)
        packs.append(out is not None)
        return out

    torch.cuda.synchronize()
    zero_launches()
    tio.pack_stream_native = counted
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            assert cli.main(["--device", "cuda", *map(str, argv)]) == 0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        tio.pack_stream_native = native
    launches = launches_now()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(launches=launches, device_ms=busy, wall_s=wall)


def trace_kernel_names(path) -> set:
    """The names of the card's kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def index_words(path) -> np.ndarray:
    """The words of a CBLX file, loaded by the port on the card."""
    from cbl_tpu_torch import CBL

    return CBL.load_from_file(path).wordset.words_array()


def cli_genome_check() -> dict:
    """Phase 12: the genome corpus through `python -m cbl_tpu_torch`."""
    import contextlib
    import io as pyio
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from cbl_tpu_torch import cli
    from cbl_tpu_torch import io as tio
    from cbl_tpu_torch import kmer as tkmer
    from cbl_tpu_torch.bench import make_genome_corpus
    from cbl_tpu_torch.examples import bench_necklace_throughput
    from cbl_tpu_torch.ops._build import BUILD_DIR

    r = {}
    work = BUILD_DIR / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ci, oi, cq, oq = make_genome_corpus(GENOME_BASES)
    n59 = int(np.searchsorted(oi, K59_CLI_BASES, "right")) - 1
    c59, o59 = ci[: oi[n59]], oi[: n59 + 1]
    fa, fq, fa59 = work / "insert.fa", work / "query.fq.gz", work / "i59.fa"
    write_fasta(fa, ci, oi)
    write_fastq_gz(fq, cq, oq)
    write_fasta(fa59, c59, o59)
    r["files_s"] = time.perf_counter() - t0
    r["bytes"] = {p.name: p.stat().st_size for p in (fa, fq, fa59)}
    r["records"] = (len(oi) - 1, len(oq) - 1)

    # the native decoder and packer: built in phase 1 from the port's
    # source into cbl_tpu_torch/_build/, loaded here
    so = tio.native_library_path()
    assert tio._load_native() is not None and so.exists(), so
    assert so.parent == BUILD_DIR, so
    r["native_lib"] = os.path.relpath(so, REPO)
    r["parse_s"] = {}
    for label, path, codes, offsets in (("fasta", fa, ci, oi),
                                        ("fastq.gz", fq, cq, oq)):
        for backend, fn in (("native", tio.parse_fastx),
                            ("python", tio._parse_fastx_py)):
            t = time.perf_counter()
            got_c, got_o = fn(path)
            r["parse_s"][f"{label} {backend}"] = time.perf_counter() - t
            assert np.array_equal(got_c, codes), (label, backend)
            assert np.array_equal(got_o, offsets), (label, backend)
    pad = ci[: len(ci) // 16 * 16]
    t = time.perf_counter()
    packed = tio.pack_stream_native(pad)
    r["pack_native_ms"] = (time.perf_counter() - t) * 1e3
    c = pad.reshape(-1, 16).astype(np.uint32)
    t = time.perf_counter()
    want = np.zeros(len(c), dtype=np.uint32)
    for j in range(16):
        want = (want << np.uint32(2)) | c[:, j]
    r["pack_numpy_ms"] = (time.perf_counter() - t) * 1e3
    assert packed is not None and np.array_equal(packed, want)
    assert np.array_equal(tkmer.np_pack_stream(pad), want)

    idx_i, idx_ic, idx_q = work / "i.npz", work / "ic.npz", work / "q.npz"
    idx59, trace_dir = work / "i59.npz", work / "trace"
    ops = ("merge", "inter", "diff", "sym-diff")
    # the timed build and query alone; then the rest in two waves of
    # commands at once, the baseline and the numpy oracles beside them
    (_, b_err), (_, q_err) = cli_waves(
        [["build", fa, "-o", idx_i]], [["query", idx_i, fq]])
    base = start_baseline_records(work, ci, oi, cq, oq)
    pool = ThreadPoolExecutor(1)
    oracle = pool.submit(genome_oracles, ci, oi, cq, oq, c59, o59)
    wave3 = [["build", fa, "-c", "-o", idx_ic],
             ["--trace", trace_dir, "build", fq, "-o", idx_q],
             ["build", fa59, "-k", "59", "--prefix-bits", "28", "-o", idx59],
             ["count", idx_i], ["list", idx_i, "-o", work / "i.txt"],
             ["export-ref", idx_i, work / "i.cbl"], ["repartition", idx_i]]
    twins = start_cli([[fa]], "cbl_tpu_torch.examples.build_from_fastx")
    twins += start_cli([[]], "cbl_tpu_torch.examples.dynamic_rounds")
    res3 = cli_waves(wave3)
    twin_out = finish_cli(twins)
    wave4 = [["query", idx_ic, fq],
             *[[op, idx_i, idx_q, "-o", work / f"{op}.npz"] for op in ops],
             ["insert", idx_i, fq, "-o", work / "ins.npz"],
             ["remove", idx_i, fq, "-o", work / "rm.npz"],
             ["list", idx59, "-o", work / "i59.txt"],
             ["import-ref", work / "i.cbl", work / "imp.npz"]]
    t = time.perf_counter()
    res4 = cli_waves(wave4)
    r["wave4_s"] = time.perf_counter() - t
    bases = {}
    for canonical, proc in base.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0
        bases[canonical] = json.loads(out)
    orc = oracle.result()
    pool.shutdown()
    r["oracle_s"] = orc["oracle_s"]
    r["baseline"] = bases

    # counts against bench/baseline.cpp records
    r["build"], r["query"] = meter(b_err, "build"), meter(q_err, "query")
    r["build_wall_s"] = float(stderr_value(b_err, "Built in ").split("s")[0])
    r["query_wall_s"] = float(stderr_value(q_err, "Queried in ")[:-1])
    r["distinct"] = built_count(b_err)
    r["distinct_c"] = built_count(res3[0][1])
    assert r["distinct"] == bases[False]["distinct"], (r, bases)
    assert r["distinct_c"] == bases[True]["distinct"], (r, bases)
    assert int(res3[3][0]) == r["distinct"]  # `count`
    assert r["build"]["kmers"] == bases[False]["n_kmers_insert"]
    r["positive"] = query_counts(q_err)
    r["positive_c"] = query_counts(res4[0][1])
    for got, b in ((r["positive"], bases[False]),
                   (r["positive_c"], bases[True])):
        assert got == (b["n_kmers_query"], b["positive"]), (got, b)
    assert 0 < r["positive"][1] < r["positive"][0]
    # the example twin's count equals the CLI's
    assert twin_out[0][0] == f"{r['distinct']} distinct 25-mers in {fa}\n"
    r["dynamic_twin"] = twin_out[1][0].strip()

    # set operations, insert and remove against numpy's set functions
    wi, wq = orc["wi"], orc["wq"]
    assert len(wi) == r["distinct"]
    inter = wi[np_isin_sorted(wi, wq)]
    diff = np_setdiff(wi, wq)
    want = {"merge": np_unique(np.concatenate([wi, wq])), "inter": inter,
            "diff": diff,
            "sym-diff": np.sort(np.concatenate([diff, np_setdiff(wq, wi)]))}
    counts = {}
    for op in ops:
        got = index_words(work / f"{op}.npz")
        assert np.array_equal(got, np_limbs(want[op])), op
        counts[op] = len(got)
    n_q = len(wq)
    assert counts["merge"] == len(wi) + n_q - counts["inter"]
    assert counts["diff"] == len(wi) - counts["inter"]
    assert counts["sym-diff"] == counts["merge"] - counts["inter"]
    r["set_counts"] = dict(counts, i=len(wi), q=n_q)
    for name, op in (("ins", "merge"), ("rm", "diff")):
        with np.load(work / f"{name}.npz") as a, \
                np.load(work / f"{op}.npz") as b:
            assert np.array_equal(a["words"], b["words"]), (name, op)

    # list, export-ref -> import-ref, repartition, the trace
    listed = fold_codes(listed_kmers(work / "i.txt", K))
    assert len(listed) == len(orc["kmers"])
    assert np.array_equal(np_unique(listed), orc["kmers"])
    with np.load(idx_i) as a, np.load(work / "imp.npz") as b:
        assert np.array_equal(a["words"], b["words"])
        assert bool(b["canonical"]) is False
    rep = pyio.StringIO()
    with contextlib.redirect_stderr(rep):
        cli._repartition_report(cli._read_index(idx_i, "cuda"))
    rep_lines = rep.getvalue().splitlines()
    assert res3[6][1].splitlines() == rep_lines, (res3[6][1], rep_lines)
    kernels = trace_kernel_names(trace_dir / "trace.json")
    r["trace_kernels"] = len(kernels)
    assert any("necklace_pos_kernel" in name for name in kernels), kernels
    assert any("blank_lookback" in name for name in kernels), kernels
    codes59 = listed_kmers(work / "i59.txt", 59)
    uh, ul = np_unique_pairs(fold_codes(codes59[:, :32]),
                             fold_codes(codes59[:, 32:]))
    assert len(uh) == len(codes59) == len(orc["k59"][0])
    assert np.array_equal(uh, orc["k59"][0])
    assert np.array_equal(ul, orc["k59"][1])
    r["k59_distinct"] = len(uh)

    # in this process, launches counted from 0: build, query and a set
    # operation at K=25, build and query at K=59
    packs = []
    r["inproc"] = {
        "build": inproc_cli(["build", fa], packs),
        "query": inproc_cli(["query", idx_i, fq], packs),
        "inter": inproc_cli(["inter", idx_i, idx_q, "-o",
                             work / "inter2.npz"], packs),
        "build K=59": inproc_cli(["build", fa59, "-k", "59", "--prefix-bits",
                                  "28"], packs),
        "query K=59": inproc_cli(["query", idx59, fa59], packs),
    }
    assert packs and all(packs), packs  # np_pack_stream took the native packer
    r["native_packs"] = len(packs)
    launches = {n: v["launches"] for n, v in r["inproc"].items()}
    for name in ("necklace", "blank"):
        assert launches["build"][name] >= 1, launches
    for name in STATIC_KERNELS:
        assert launches["query"][name] >= 1, launches
    assert launches["inter"]["merge"] >= 1, launches
    assert launches["build K=59"]["necklace_wide"] >= 1, launches
    assert launches["query K=59"]["necklace_wide"] >= 1, launches
    assert launches["query K=59"]["merge_3col"] >= 1, launches
    zero_launches()
    line = pyio.StringIO()
    with contextlib.redirect_stdout(line):
        assert bench_necklace_throughput.main([str(SLAB), str(K)]) == 0
    r["necklace_twin"] = line.getvalue().strip()
    r["necklace_twin_launches"] = launches_now()
    assert r["necklace_twin_launches"]["necklace"] == 2
    r["launches"] = launches
    return r


# --- phase 13: the sharded index ------------------------------------------------

SHARDS = 4  # shards on the one card in phase 13's D > 1 runs


def sharded_dynamic_run(codes: np.ndarray, mesh: list, timed: bool) -> dict:
    """`bench.py --mode sharded-dynamic` (`run_tpu_sharded_dynamic`,
    BASELINE config 5) on the port's `ShardedCBL` over `mesh`: phase 5's
    SEGS rounds over `pack_stream`ed segments, lazy, one sync for the
    distinct count and the summed positives (staging inside the wall, as
    `bench.py` times it), then `count()`, which also reads the deferred
    overflow count.  With `timed`, the launch counters are set to 0 after
    staging and read after the sync."""
    import torch

    from cbl_tpu_torch.parallel import ShardedCBL

    sb = len(codes) // SEGS
    off1 = np.array([0, sb], dtype=np.int64)
    off_h = np.array([0, sb // 2], dtype=np.int64)
    torch.cuda.synchronize()
    idx = ShardedCBL(k=K, mesh=mesh)
    t0 = time.perf_counter()
    segs = [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
            for i in range(SEGS)]
    halves = [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
              for i in range(SEGS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if timed:
        zero_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    pos_dev = None
    ops = 0
    for i in range(SEGS):
        _, p = idx.dynamic_round(segs[i], segs[i - 1 if i else 0], halves[i],
                                 lazy=True)
        pos_dev = p if pos_dev is None else pos_dev + p
        ops += 2 * (sb - K + 1) + sb // 2 - K + 1
    ev[1].record()
    distinct, positive = torch.stack(
        [idx.slog.live.to(pos_dev.device), pos_dev]).tolist()
    t2 = time.perf_counter()
    launches = launches_now() if timed else None
    assert idx.count() == distinct  # the overflow check, after the clock
    return dict(ops=ops, distinct=distinct, positive=positive,
                wall_s=t2 - t0, stage_s=t1 - t0, rounds_s=t2 - t1,
                rounds_ms=ev[0].elapsed_time(ev[1]), launches=launches,
                log_rows=idx.slog.keys[0].shape[-1], log_real=idx.slog.real,
                seq=idx.slog.seq, shards=idx.D)


def sharded_bulk_run(codes: np.ndarray, offsets: np.ndarray,
                     mesh: list) -> dict:
    """`insert_codes_stream` and the self-`query_codes_stream` of the
    stream on a fresh `ShardedCBL`, launches counted from 0; the host
    clock and device events around each call (the query ends in its one
    sync)."""
    import torch

    from cbl_tpu_torch.parallel import ShardedCBL

    torch.cuda.synchronize()
    zero_launches()
    idx = ShardedCBL(k=K, mesh=mesh)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    idx.insert_codes_stream(codes, offsets)
    ev[1].record()
    total, positive = idx.query_codes_stream(codes, offsets)
    ev[2].record()
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launches_now()
    return dict(idx=idx, distinct=idx.count(), total=total,
                positive=positive, wall_s=wall_s,
                insert_ms=ev[0].elapsed_time(ev[1]),
                query_ms=ev[1].elapsed_time(ev[2]), launches=launches)


def sharded_mesh_check(codes: np.ndarray, offsets: np.ndarray, base: dict,
                       base_dyn: dict, alg_counts: dict) -> dict:
    """Phase 13 (c): SHARDS shards on the one card against single indexes
    of the same streams (every word and count), `bench/baseline.cpp` and
    phase 7's counts."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.parallel import ShardedCBL

    mesh = [torch.device(DEVICE, 0)] * SHARDS
    r = {}
    n_kmers = len(codes) - K + 1
    half = len(codes) // 2

    def one(c):
        return c, np.array([0, len(c)], dtype=np.int64)

    # the build, the self-query, a remove of the first half
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = ShardedCBL(k=K, mesh=mesh)
    x.insert_codes_stream(codes, offsets)
    r["distinct"] = x.count()
    r["build_s"] = time.perf_counter() - t0
    r["balance"] = x.shard_balance().tolist()
    t0 = time.perf_counter()
    r["query"] = x.query_codes_stream(codes, offsets)
    r["query_s"] = time.perf_counter() - t0
    assert r["distinct"] == base["distinct"], (r, base)
    assert r["query"] == (n_kmers, n_kmers), r
    assert max(r["balance"]) <= 2 * min(r["balance"]), r["balance"]
    single = CBL(k=K, device=DEVICE)
    single.insert_codes_stream(codes, offsets)
    assert np.array_equal(x.words_array(), single.wordset.words_array())
    for idx in (x, single):
        idx.remove_codes_stream(*one(codes[:half]))
    want = single.wordset.words_array()
    assert np.array_equal(x.words_array(), want)
    r["after_remove"] = len(want)
    del single

    # a checkpoint round trip of what is left
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.npz")
        t0 = time.perf_counter()
        x.save_to_file(path)
        back = ShardedCBL.load_from_file(path, mesh=mesh)
        r["serde_s"] = time.perf_counter() - t0
        r["serde_bytes"] = os.path.getsize(path)
    assert np.array_equal(back.words_array(), want)
    assert np.array_equal(back.boundaries, x.boundaries)
    del back, x, want

    # config 5's rounds on SHARDS shards
    r["rounds"] = sharded_dynamic_run(codes, mesh, timed=True)
    for key in ("distinct", "positive"):
        assert r["rounds"][key] == base_dyn[key], (r["rounds"], base_dyn)

    # the four set operations of the two halves, against phase 7's counts
    a, b = ShardedCBL(k=K, mesh=mesh), ShardedCBL(k=K, mesh=mesh)
    a.insert_codes_stream(*one(codes[:half]))
    b.insert_codes_stream(*one(codes[half:]))
    counts = {"a": a.count(), "b": b.count()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, op in ALGEBRA_OPS:
        counts[name] = op(a, b).count()
    r["algebra_s"] = time.perf_counter() - t0
    for name in ("a", "b") + tuple(n for n, _ in ALGEBRA_OPS):
        assert counts[name] == alg_counts[name], (name, counts, alg_counts)
    r["algebra"] = counts
    del a, b

    # a forced overflow: every word routed to shard 0 during an 8 Mbp
    # insert; the stream recovers with every word
    quarter = codes[: len(codes) // 4]
    single = CBL(k=K, device=DEVICE)
    single.insert_codes_stream(*one(quarter))
    want_n = single.count()
    x = ShardedCBL(k=K, mesh=mesh)
    x.boundaries = np.full_like(x.boundaries, SENTINEL)
    x._boundaries_from_data = True
    t0 = time.perf_counter()
    x.insert_codes_stream(*one(quarter))
    r["recovery_s"] = time.perf_counter() - t0
    assert x.count() == want_n and (x.boundaries != SENTINEL).all()
    r["recovered"] = (want_n, x.shard_balance().tolist())
    # a skewed remove: every word on shard 0 (`insert_words` under
    # boundaries that send every word there), then the same bases removed
    # (`cbl_tpu` loses words here silently)
    y = ShardedCBL(k=K, mesh=mesh)
    y.boundaries = np.full_like(y.boundaries, SENTINEL)
    y._boundaries_from_data = True
    y.insert_words(single.wordset.export_keys())
    assert y.shard_balance().tolist() == [want_n] + [0] * (SHARDS - 1)
    t0 = time.perf_counter()
    y.remove_codes_stream(*one(quarter))
    r["skewed_remove_s"] = time.perf_counter() - t0
    assert y.count() == 0, y.count()
    return r


def sharded_cli_check(gen: dict) -> dict:
    """Phase 13 (d): `python -m cbl_tpu_torch` with `--sharded` on phase
    12's genome corpus files, counts against `bench/baseline.cpp
    records`, and the two sharded examples, as subprocesses."""
    from cbl_tpu_torch.ops._build import BUILD_DIR

    work = BUILD_DIR / "cli"
    fa, fq, idx_i = work / "insert.fa", work / "query.fq.gz", work / "i.npz"
    sh, sh2 = work / "sharded.npz", work / "sharded2.npz"
    base = gen["baseline"][False]
    examples = start_cli([[]], "cbl_tpu_torch.examples.sharded_build")
    examples += start_cli([[], ["--shards", SHARDS]],
                          "cbl_tpu_torch.examples.repartition_recovery")
    t0 = time.perf_counter()
    (_, b_err), (_, q_err), (_, b4_err) = cli_waves(
        [["build", fa, "--sharded"], ["query", idx_i, fq, "--sharded"],
         ["--shards", SHARDS, "build", fa, "--sharded", "-o", sh]])
    (_, p_err), = cli_waves(
        [["--shards", SHARDS, "repartition", sh, "--sharded", "-o", sh2]])
    r = {"cli_s": time.perf_counter() - t0}
    ex_out = finish_cli(examples)
    for err, shards in ((b_err, 1), (b4_err, SHARDS)):
        assert (f"Sharding the prefix space across {shards} device(s)"
                in err), err
        n = int(stderr_value(err, "Built in ").split("(")[1].split()[0])
        assert n == base["distinct"], (n, base)
    r["balance"] = stderr_value(b4_err, "Built in ").split("balance ")[1][:-1]
    assert "Index sharded across 1 device(s)" in q_err, q_err
    r["query"] = query_counts(q_err)
    assert r["query"] == (base["n_kmers_query"], base["positive"]), r
    after = json.loads(stderr_value(p_err, "Shard balance after:  "))
    assert sum(after) == base["distinct"], after
    with np.load(sh2) as z:
        rows = np.concatenate([z[f"rows_{d}"] for d in range(SHARDS)])
    assert np.array_equal(rows, index_words(idx_i))
    r["repartition"] = (stderr_value(p_err, "Shard balance before: "),
                        after)
    ex_err = ex_out[0][1].splitlines()
    assert ex_err[0] == "devices: 1" and ex_err[-1] == (
        "checkpoint round-trip OK"), ex_err
    for so, _ in ex_out[1:]:
        lines = so.splitlines()
        built = int(lines[1].split()[1])
        assert f"overflow recovery: {built} k-mers (= {built} expected)" in (
            lines[4]), lines
    r["examples"] = [ex_err[1]] + [so.splitlines()[4] for so, _ in ex_out[1:]]
    return r


def sharded_summary(card: str, dyn: dict, base_dyn: dict, static_plain: dict,
                    n_kmers: int, sdyn: dict, sbulk: dict, smesh: dict,
                    scli: dict) -> None:
    """Phase 15's lines of phase 13: config 5 beside phase 5's single
    index, the D = 1 bulk path beside phase 3's, the SHARDS-shard runs and
    the CLI."""
    single_ops_s = dyn["ops"] / dyn["wall_s"]
    for label, r in (("D=1 (config 5)", sdyn),
                     (f"{SHARDS} shards on one card", smesh["rounds"])):
        log(f"[{card}] K={K} {MAIN_BASES / 1e6:.0f} Mbp sharded dynamic, "
            f"{label}, {SEGS} rounds, {r['ops']} ops: wall with staging "
            f"{r['wall_s'] * 1e3:.2f} ms = {r['ops'] / r['wall_s']:.4g} ops/s"
            f" = {r['ops'] / r['wall_s'] / single_ops_s:.3f} x phase 5's "
            f"single index in this call ({single_ops_s:.4g}); stage "
            f"{r['stage_s'] * 1e3:.1f} ms; device rounds "
            f"{r['rounds_s'] * 1e3:.2f} ms ({r['rounds_ms']:.2f} ms by device "
            f"events; phase 5: {dyn['rounds_ms']:.2f}); final log "
            f"{r['log_rows']} rows a shard ({r['log_real']} real bound, seq "
            f"{r['seq']}); baseline.cpp 1 core {base_dyn['ops_per_s']:.4g} "
            f"ops/s; launches "
            f"{ {n: c for n, c in r['launches'].items() if c} }")
    log(f"[{card}] K={K} {MAIN_BASES / 1e6:.0f} Mbp sharded bulk, D=1: "
        f"insert {sbulk['insert_ms']:.2f} ms, query {sbulk['query_ms']:.2f} "
        f"ms (device events; phase 3: {static_plain['insert_ms']:.2f} / "
        f"{static_plain['query_ms']:.2f}), wall "
        f"{sbulk['wall_s'] * 1e3:.2f} ms = "
        f"{2 * n_kmers / sbulk['wall_s']:.4g} k-mers/s (staging inside); "
        f"launches { {n: c for n, c in sbulk['launches'].items() if c} }")
    log(f"[{card}] K={K} {MAIN_BASES / 1e6:.0f} Mbp on {SHARDS} shards of "
        f"one card: build + count {smesh['build_s'] * 1e3:.1f} ms, balance "
        f"{smesh['balance']}, self-query {smesh['query_s'] * 1e3:.1f} ms; "
        f"after removing the first half {smesh['after_remove']} words, "
        f"checkpoint round-trip {smesh['serde_s']:.3f} s "
        f"({smesh['serde_bytes']} bytes); set operations of 2 x "
        f"{MAIN_BASES / 2e6:.0f} Mbp with counts {smesh['algebra']} in "
        f"{smesh['algebra_s'] * 1e3:.1f} ms; forced overflow of "
        f"{MAIN_BASES / 4e6:.0f} Mbp recovered in "
        f"{smesh['recovery_s'] * 1e3:.1f} ms {smesh['recovered']}; skewed "
        f"remove {smesh['skewed_remove_s'] * 1e3:.1f} ms to 0 words (host "
        f"clock)")
    log(f"[{card}] sharded CLI on the genome corpus: {scli}")


# --- phase 13 (e): ranks on the card ---------------------------------------------

RANKS = 2  # processes of phase 13 (e), each with RANK_SHARDS shards
RANK_SHARDS = 2
RANK_NK_SUB = 1 << 22  # k-mers a sub-slab of the ranks' bulk build and query


def rank_round_streams(ci: np.ndarray, oi: np.ndarray, i: int) -> list:
    """Round i's full (insert, query, remove) streams of phase 13 (e):
    config 2's schedule over the genome corpus's insert records cut into
    SEGS groups (390 or 391 records): insert group i, query group
    max(i-1, 0), remove the first half of group i's records."""
    from cbl_tpu_torch.parallel.distributed import slice_codes

    n = len(oi) - 1
    b = [(j * n) // SEGS for j in range(SEGS + 1)]
    return [slice_codes(ci, oi, b[i], b[i + 1]),
            slice_codes(ci, oi, b[max(i - 1, 0)], b[max(i - 1, 0) + 1]),
            slice_codes(ci, oi, b[i], b[i] + (b[i + 1] - b[i]) // 2)]


def ranks_oracle(path) -> dict:
    """The single index's answers for phase 13 (e), in this process on
    the card: the corpus's words after the build, after removing each
    rank's first record, and after SEGS rounds, and each round's (total,
    positive); the words are written to `path` for the ranks."""
    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.bench import make_genome_corpus
    from cbl_tpu_torch.parallel.distributed import (host_record_slice,
                                                    slice_codes)

    t0 = time.perf_counter()
    ci, oi, _, _ = make_genome_corpus(GENOME_BASES)
    single = CBL(k=K, device=DEVICE)
    single.insert_codes_stream(ci, oi)
    w_build = single.wordset.words_array()
    for p in range(RANKS):
        sub, so = slice_codes(ci, oi, *host_record_slice(oi, p, RANKS))
        single.remove_codes_stream(sub[: so[1]], so[:2])
    w_rm = single.wordset.words_array()
    tps = [single.dynamic_round(*rank_round_streams(ci, oi, i))
           for i in range(SEGS)]
    single.flush()
    w_rounds = single.wordset.words_array()
    np.savez(path, build=w_build, rm=w_rm, rounds=w_rounds,
             tps=np.array(tps, dtype=np.int64))
    return dict(distinct=len(w_build), after_remove=len(w_rm),
                after_rounds=len(w_rounds), tps=tps,
                oracle_s=time.perf_counter() - t0)


def rank_worker(coordinator: str, pid: int, oracle: str,
                backend: str) -> None:
    """One rank of phase 13 (e), a process of its own: RANK_SHARDS shards
    on `cuda:(pid % cards)` of a global mesh of RANKS x RANK_SHARDS,
    `backend` between the ranks.  Its slice of the genome corpus goes
    through the multi-process calls, each step held to the single
    index's words of `oracle` shard by shard (`_assert_local_shards_match`);
    prints one JSON line: its launches (counted from 0 just before the
    main path), the host clock of each part after a sync, and the time
    inside `_all_to_all` in all and in each part."""
    import torch
    import torch.distributed as dist

    from cbl_tpu_torch.bench import make_genome_corpus
    from cbl_tpu_torch.ops import _build
    from cbl_tpu_torch.parallel import distributed as d
    from cbl_tpu_torch.parallel import shard
    from cbl_tpu_torch.parallel.shard import ShardedCBL, make_mesh

    d.init_distributed(coordinator, RANKS, pid, backend=backend,
                       timeout_s=600.0, device=DEVICE)
    try:
        mesh = make_mesh([make_mesh()[0]] * RANK_SHARDS, process_group=True)
        if mesh[0].type == "cuda":
            _build.library()  # built by phase 1: loads
        ci, oi, cq, oq = make_genome_corpus(GENOME_BASES)
        want = dict(np.load(oracle))
        mine = [d.slice_codes(c, o, *d.host_record_slice(o, pid, RANKS))
                for c, o in ((ci, oi), (cq, oq))]
        icap = [1 << max(4, (len(o) + 2).bit_length()) for o in (oi, oq)]
        inner, ex = shard._all_to_all, {"s": 0.0, "calls": 0}

        def timed(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            ex["s"] += time.perf_counter() - t
            ex["calls"] += 1
            return out

        shard._all_to_all = timed
        r = {"pid": pid, "backend": dist.get_backend(),
             "device": str(mesh[0])}

        def clock(name, fn):
            """Host clock of `fn` after a sync, and its time inside
            `_all_to_all` (`<name>_ms` and `<name>_exchange_ms`)."""
            dist.barrier()
            torch.cuda.synchronize()
            t, e = time.perf_counter(), ex["s"]
            out = fn()
            torch.cuda.synchronize()
            r[name + "_ms"] = (time.perf_counter() - t) * 1e3
            r[name + "_exchange_ms"] = (ex["s"] - e) * 1e3
            return out

        zero_launches()
        idx = ShardedCBL(k=K, mesh=mesh)
        clock("build", lambda: d.multihost_insert_stream(
            idx, *mine[0], nk_sub=RANK_NK_SUB, icap=icap[0]))
        r["distinct"] = idx.count()
        r["query"] = clock("query", lambda: d.multihost_query_stream(
            idx, *mine[1], nk_sub=RANK_NK_SUB, icap=icap[1]))
        d._assert_local_shards_match(idx, want["build"], "build")
        r["balance"] = idx.shard_balance().tolist()
        ck = os.path.join(os.path.dirname(oracle), "ranks_ck.npz")
        idx.save_to_file(ck)
        back = ShardedCBL.load_from_file(ck, mesh=mesh)
        d._assert_local_shards_match(back, want["build"], "checkpoint")
        os.remove(ShardedCBL._shard_file(ck, pid, RANKS))
        codes_l, off_l = mine[0]
        d.multihost_remove_stream(idx, codes_l[: off_l[1]], off_l[:2].copy(),
                                  nk_sub=RANK_NK_SUB)
        r["after_remove"] = idx.count()
        d._assert_local_shards_match(idx, want["rm"], "remove")
        inter = idx & back
        d._assert_local_shards_match(inter, want["rm"], "intersect")
        del back, inter
        clock("repartition", idx.repartition)
        d._assert_local_shards_match(idx, want["rm"], "repartition")
        r["balance_after_repartition"] = idx.shard_balance().tolist()
        rounds = [[d.slice_codes(c, o, *d.host_record_slice(o, pid, RANKS))
                   for c, o in rank_round_streams(ci, oi, i)]
                  for i in range(SEGS)]

        def stage():
            return [[d.multihost_pack_stream(idx, *s) for s in streams]
                    for streams in rounds]

        staged = clock("stage", stage)
        r["tps"] = clock("rounds", lambda: [
            list(d.multihost_dynamic_round(idx, *s)) for s in staged])
        assert r["tps"] == want["tps"].tolist(), (r["tps"], want["tps"])
        idx.flush()
        d._assert_local_shards_match(idx, want["rounds"], "rounds")
        r["after_rounds"] = idx.count()
        r["launches"] = launches_now()
        r["exchange_ms"] = ex["s"] * 1e3
        r["exchanges"] = ex["calls"]
        if backend == "gloo":
            r["transport"] = gloo_transport(mesh[0])
        dist.barrier()
        print("RANK_RESULT " + json.dumps(r), flush=True)
    finally:
        dist.destroy_process_group()


def gloo_transport(device, reps: int = 3) -> dict:
    """One rank's part of phase 13 (e)'s transport check: an
    `all_to_all_single` of 64 MiB a rank over gloo on CUDA tensors as they
    are, and the same through explicit copies to and from pinned host
    buffers, `reps` times each in turn (host clock after a barrier and a
    sync); both must deliver the same rows."""
    import torch
    import torch.distributed as dist

    n = 8 << 20  # int64 rows: 64 MiB
    x = torch.arange(n, dtype=torch.int64, device=device) * (dist.get_rank()
                                                             + 1)
    got = {"cuda": torch.empty_like(x), "pinned": torch.empty_like(x)}
    hx = torch.empty(n, dtype=torch.int64, pin_memory=True)
    hy = torch.empty_like(hx)
    out = {"cuda_ms": [], "pinned_ms": []}
    for _ in range(reps):
        for name in ("cuda", "pinned"):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "cuda":
                dist.all_to_all_single(got[name], x)
            else:
                hx.copy_(x)
                dist.all_to_all_single(hy, hx)
                got[name].copy_(hy)
            torch.cuda.synchronize()
            out[name + "_ms"].append((time.perf_counter() - t) * 1e3)
    assert torch.equal(got["cuda"], got["pinned"])
    return out


def ranks_check(gen: dict) -> dict:
    """Phase 13 (e): RANKS processes x RANK_SHARDS shards on the card over
    gloo (and, where there are RANKS cards, one card a rank over NCCL),
    each rank's slice of the genome corpus against `bench/baseline.cpp
    records` and the single index of `ranks_oracle`."""
    import torch

    from cbl_tpu_torch.ops._build import BUILD_DIR
    from cbl_tpu_torch.parallel.distributed import launch

    work = BUILD_DIR / "ranks"
    work.mkdir(parents=True, exist_ok=True)
    oracle = work / "oracle.npz"
    out = {"oracle": ranks_oracle(oracle)}
    base = gen["baseline"][False]
    assert out["oracle"]["distinct"] == base["distinct"], (out, base)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card
    backends = ["gloo"]
    if torch.cuda.device_count() >= RANKS:
        backends.append("nccl")
    else:
        log(f"nccl: not run ({torch.cuda.device_count()} card)")
    for backend in backends:
        t0 = time.perf_counter()
        outs = launch(f"import chip_smoke as c; c.rank_worker("
                      f"'{{coordinator}}', {{pid}}, {str(oracle)!r}, "
                      f"{backend!r})", RANKS, timeout=900)
        ranks = [json.loads(next(line for line in o.splitlines()
                                 if line.startswith("RANK_RESULT "))[12:])
                 for o in outs]
        for r in ranks:
            assert r["distinct"] == base["distinct"], (r, base)
            assert tuple(r["query"]) == (base["n_kmers_query"],
                                         base["positive"]), (r, base)
            assert r["after_remove"] == out["oracle"]["after_remove"], r
            assert r["after_rounds"] == out["oracle"]["after_rounds"], r
        launches = {n: sum(r["launches"][n] for r in ranks)
                    for n in ranks[0]["launches"]}
        for name in ROUND_KERNELS:
            assert launches[name] >= 1, (backend, launches)
        out[backend] = dict(ranks=ranks, launches=launches,
                            wall_s=time.perf_counter() - t0)
    oracle.unlink()
    return out


def ex_share(r: dict) -> float:
    """The share (%) of a rank's clocked build, query, repartition and
    rounds spent inside their own calls of `_all_to_all`."""
    parts = ("build", "query", "repartition", "rounds")
    return (100 * sum(r[p + "_exchange_ms"] for p in parts)
            / sum(r[p + "_ms"] for p in parts))


def ranks_summary(card: str, rk: dict) -> None:
    """Phase 15's lines of phase 13 (e)."""
    o = rk["oracle"]
    for backend in ("gloo", "nccl"):
        if backend not in rk:
            continue
        for r in rk[backend]["ranks"]:
            log(f"[{card}] K={K} genome corpus ({GENOME_BASES / 1e6:.0f} "
                f"Mbp) on {RANKS} ranks x {RANK_SHARDS} shards, {backend}, "
                f"rank {r['pid']} on {r['device']}: "
                + ", ".join(f"{p} {r[p + '_ms']:.1f} ms "
                            f"({r[p + '_exchange_ms']:.1f} "
                            "inside _all_to_all)" for p in
                            ("build", "query", "repartition", "stage",
                             "rounds"))
                + f" (host clock after a sync; {SEGS} rounds); inside "
                f"_all_to_all {r['exchange_ms']:.1f} ms over "
                f"{r['exchanges']} exchanges, {ex_share(r):.1f} % of build + "
                f"query + repartition + rounds inside their exchanges; "
                f"distinct {r['distinct']}, "
                f"query {r['query']}, balance {r['balance']} -> "
                f"{r['balance_after_repartition']}; launches "
                f"{ {n: c for n, c in r['launches'].items() if c} }")
            if "transport" in r:
                t = r["transport"]
                log(f"[{card}] rank {r['pid']}: gloo all_to_all_single of "
                    f"64 MiB a rank: CUDA tensors "
                    f"{', '.join(f'{v:.2f}' for v in t['cuda_ms'])} ms, "
                    f"through pinned host copies "
                    f"{', '.join(f'{v:.2f}' for v in t['pinned_ms'])} ms")
        log(f"[{card}] {backend} ranks' wall {rk[backend]['wall_s']:.1f} s "
            f"(spawn to exit); single index oracle {o['oracle_s']:.1f} s, "
            f"rounds' (total, positive) {o['tps']}")


# --- phase 14: the benchmark and the multi-device dryrun ----------------------

BENCH_REPEATS = 2


def bench_run(argv: list) -> tuple:
    """`python -m cbl_tpu_torch.bench ARGV` as a user runs it, a process
    of its own; it must exit 0.  -> (its last line, the count checks it
    reported, its peak memory lines, seconds)."""
    t0 = time.perf_counter()
    (out, err), = finish_cli(start_cli([argv], module="cbl_tpu_torch.bench"))
    line = json.loads(out.splitlines()[-1])
    checks = {ln[len("check: "):].split(" equals ")[0].rsplit(" ", 1)[0]
              for ln in err.splitlines() if ln.startswith("check: ")}
    peaks = [ln for ln in err.splitlines() if "peak device memory" in ln]
    return line, checks, peaks, time.perf_counter() - t0


def bench_check(card: str) -> dict:
    """Phase 14: the port's benchmark in its default run (every extra)
    and `--mode largek`, then `parallel.dryrun_multichip(SHARDS)` on the
    card at 2^20 k-mers a shard, launches counted from 0."""
    import torch

    from cbl_tpu_torch.bench import DEFAULT_CHECKS, DEFAULT_KEYS, RATE_KEYS
    from cbl_tpu_torch.parallel import dryrun_multichip

    torch.cuda.empty_cache()  # the bench processes share the card
    r = {}
    line, checks, peaks, secs = bench_run(["--repeats", BENCH_REPEATS])
    keys = (*DEFAULT_KEYS, "device", "launches",
            *(f"{k}_repeats" for k in RATE_KEYS))
    missing = [k for k in keys if line.get(k) is None]
    assert not missing, (missing, line)
    assert checks == DEFAULT_CHECKS, sorted(checks ^ DEFAULT_CHECKS)
    assert line["device"]["name"] + ", " + line["device"]["power_limit"] \
        == card, (line["device"], card)
    for name in ROUND_KERNELS:
        assert line["launches"][name] >= 1, (
            f"kernel {name} never launched by the bench's default run")
    for key in RATE_KEYS:
        assert len(line[f"{key}_repeats"]) == BENCH_REPEATS, key
    r["default"] = dict(line=line, peaks=peaks, s=secs)
    line, checks, peaks, secs = bench_run(["--mode", "largek", "--repeats",
                                           BENCH_REPEATS])
    assert all(line.get(k) is not None for k in ("metric", "value", "unit",
                                                 "value_repeats")), line
    assert line["launches"]["necklace_wide"] >= 1, line["launches"]
    r["largek"] = dict(line=line, peaks=peaks, s=secs)
    for name, v in r.items():
        log(f"bench {name} ({v['s']:.1f} s): {json.dumps(v['line'])}")
        for p in v["peaks"]:
            log(f"  bench {name}: {p}")
    zero_launches()
    t0 = time.perf_counter()
    r["dryrun"] = dryrun_multichip(SHARDS)
    r["dryrun_s"] = time.perf_counter() - t0
    r["dryrun_launches"] = launches_now()
    for name in ROUND_KERNELS:
        assert r["dryrun_launches"][name] >= 1, r["dryrun_launches"]
    log(f"dryrun_multichip({SHARDS}) on the card: {r['dryrun']} in "
        f"{r['dryrun_s']:.1f} s; launches "
        f"{ {n: c for n, c in r['dryrun_launches'].items() if c} }")
    return r


# --- phase 14 (b): the flagship forward step ----------------------------------

ENTRY_WINDOWS = 256  # forward steps against the 32 Mbp index, half inserted
ENTRY_REPS = 200  # forward steps a timing by the host clock
# steps a batch queued behind one sleep kernel: ~190 launches a step, and
# a stream's queue holds about a thousand before the host blocks
ENTRY_QUEUED = 4
ENTRY_BATCHES = 25
SLEEP_CYCLES_S = 2e9  # SM cycles a second at most (H100 SXM boost 1.98 GHz)


def forward_times(fwd, args) -> dict:
    """One forward step's times on the card: the host clock a call (a
    sync before and after ENTRY_REPS calls); the device time a call by
    CUDA events around ENTRY_QUEUED calls enqueued behind a sleep kernel
    that outlasts their enqueue, so that the device runs them back to
    back (the median of ENTRY_BATCHES batches; `covered`: in every batch
    the first event had not been reached when the enqueue ended); the
    device's work a call by `torch.profiler` (kernels, copies, fills:
    count and busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fwd(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENTRY_REPS):
        fwd(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / ENTRY_REPS
    sleep = int(4 * host_ms * 1e-3 * ENTRY_QUEUED * SLEEP_CYCLES_S)
    device, covered = [], True
    for _ in range(ENTRY_BATCHES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        e0.record()
        for _ in range(ENTRY_QUEUED):
            fwd(*args)
        e1.record()
        covered &= not e0.query()
        e1.synchronize()
        device.append(e0.elapsed_time(e1) / ENTRY_QUEUED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fwd(*args)
        torch.cuda.synchronize()
    work = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(host_ms=host_ms, device_ms=float(np.median(device)),
                device_ms_range=(min(device), max(device)), covered=covered,
                device_launches=sum(e.count for e in work) / 10,
                busy_ms=sum(e.self_device_time_total for e in work) / 1e4)


def entry_check(codes: np.ndarray, qcodes: np.ndarray,
                distinct: int) -> dict:
    """Phase 14 (b): `cbl_tpu_torch.entry`, the flagship forward step.
    `python -m cbl_tpu_torch.entry` as a user runs it (forward on the
    reference's args, then `dryrun_multichip(8)`); `entry()`'s args on
    the card, the mask against the CPU's (all False: an index of
    sentinels), once more under `set_sync_debug_mode("error")`, one B1
    launch a call; then ENTRY_WINDOWS windows of STREAM_LEN codes at
    k-mer offsets that are multiples of CHUNK, half from the 32 Mbp
    stream `codes` and half from phase 4's foreign stream `qcodes`,
    against the canonical index of `codes` (`export_keys()`, its rows
    `distinct`, `bench/baseline.cpp`'s canonical count), each mask
    against numpy's canonical words and the same keys (one window with a
    band of `valid` False); then the times of one step at both index
    sizes."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch import entry as tentry

    r = {}
    t0 = time.perf_counter()
    (out, _), = finish_cli(start_cli([[]], module="cbl_tpu_torch.entry"))
    r["cli_s"] = time.perf_counter() - t0
    r["cli"] = out.strip().splitlines()
    assert r["cli"][0].startswith("entry() runs on cuda") and r["cli"][0] \
        .endswith(", 0 hits"), r["cli"]
    assert r["cli"][-1].startswith("dryrun_multichip(8) on cuda"), r["cli"]

    fwd, args = tentry.entry()
    assert all(a.device.type == "cuda" for a in args), args
    want = fwd(*(a.cpu() for a in args))
    fwd(*args)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    got = fwd(*args)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fwd(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    r["launches"] = launches_now()
    assert {n: c for n, c in r["launches"].items() if c} == {"necklace": 2}
    assert got.dtype == torch.bool and got.shape == (tentry.CHUNK,)
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)
    assert not want.any()

    S, C, half = tentry.STREAM_LEN, tentry.CHUNK, ENTRY_WINDOWS // 2
    idx = CBL(k=K, prefix_bits=24, canonical=True, device=DEVICE)
    idx.insert_codes_stream(codes, np.array([0, len(codes)]))
    keys = idx.wordset.export_keys()
    r["index_rows"] = keys.shape[0]
    assert r["index_rows"] == distinct, (r["index_rows"], distinct)
    rng = np.random.default_rng(7)
    starts = [rng.choice((len(c) - S) // C + 1, half, replace=False) * C
              for c in (codes, qcodes)]
    win = np.stack([c[s : s + S] for c, ss in zip((codes, qcodes), starts)
                    for s in ss])
    valid = np.ones((ENTRY_WINDOWS, C), dtype=bool)
    valid[0, C // 4 : C // 2] = False  # a band of an inserted window
    win_t = torch.from_numpy(win).to(DEVICE)
    valid_t = torch.from_numpy(valid).to(DEVICE)
    torch.cuda.synchronize()
    zero_launches()
    masks = torch.stack([fwd(win_t[w], valid_t[w], keys)
                         for w in range(ENTRY_WINDOWS)]).cpu().numpy()
    r["windows_launches"] = launches_now()
    assert {n: c for n, c in r["windows_launches"].items() if c} == {
        "necklace": ENTRY_WINDOWS}, r["windows_launches"]
    t0 = time.perf_counter()
    words, _ = np_stream_words(win.reshape(-1), np.array([0, win.size]),
                               canonical=True)
    at = np.arange(ENTRY_WINDOWS)[:, None] * S + np.arange(C)
    oracle = np_isin_sorted(words[at.reshape(-1)].astype(np.int64),
                            keys.cpu().numpy()).reshape(ENTRY_WINDOWS, C)
    r["oracle_s"] = time.perf_counter() - t0
    assert np.array_equal(masks, oracle & valid)
    assert masks[:half][valid[:half]].all() and not masks[~valid].any()
    r["foreign_hits"] = int(masks[half:].sum())
    assert 0 < r["foreign_hits"] < half * C, r["foreign_hits"]

    r["small"] = forward_times(fwd, args)
    r["large"] = forward_times(fwd, (win_t[1], valid_t[1], keys))
    del idx, keys
    return r


def profile_algebra() -> int:
    """`--profile-algebra`: the set-algebra runs under `torch.profiler`
    in the ("bitonic", "bitonic") and ("mergepath", "library") modes;
    prints the device time by kernel name and the device's idle share of
    the four operations."""
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


def _np_record_words(codes: np.ndarray, canonical: bool = False):
    """The packed necklace words of every k-mer start of `codes` (uint64
    arithmetic: min rotation << pos_bits | pos, independent of the
    port); `canonical`: of the even-popcount one of each k-mer and its
    reverse complement (bases reversed, each XOR 0b10)."""
    W, pos_bits = 2 * K, 6
    mask = np.uint64((1 << W) - 1)
    nk = len(codes) - K + 1
    rot = np.zeros(nk, dtype=np.uint64)
    for j in range(K):
        rot = (rot << np.uint64(2)) | codes[j : j + nk].astype(np.uint64)
    if canonical:
        rc = np.zeros(nk, dtype=np.uint64)
        for j in range(K):
            rc |= (codes[j : j + nk] ^ 2).astype(np.uint64) << np.uint64(2 * j)
        par = rot.copy()
        for sh in (32, 16, 8, 4, 2, 1):
            par ^= par >> np.uint64(sh)
        rot = np.where((par & np.uint64(1)) == 0, rot, rc)
    best = rot.copy()
    pos = np.zeros(nk, dtype=np.uint64)
    hi, better = np.empty_like(rot), np.empty(nk, dtype=bool)
    for p in range(1, W):
        np.right_shift(rot, np.uint64(W - 1), out=hi)
        np.left_shift(rot, np.uint64(1), out=rot)
        np.bitwise_or(rot, hi, out=rot)
        np.bitwise_and(rot, mask, out=rot)
        np.less(rot, best, out=better)
        np.copyto(best, rot, where=better)
        np.copyto(pos, np.uint64(p), where=better)
    return (best << np.uint64(pos_bits)) | pos


def np_stream_words(codes: np.ndarray, offsets: np.ndarray,
                    canonical: bool = False):
    """Host oracle: (words [nk] uint64 of every k-mer start of the
    stream, valid [nk]: the k-mer lies inside one record), the words
    computed in eight threads over pieces of the stream (numpy releases
    the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    nk = len(codes) - K + 1
    valid = np.zeros(nk + 1, dtype=np.int64)
    for r in range(len(offsets) - 1):
        lo, hi = int(offsets[r]), int(offsets[r + 1]) - K + 1
        if hi > lo:
            valid[lo] += 1
            valid[hi] -= 1
    words = np.empty(nk, dtype=np.uint64)
    edges = np.linspace(0, nk, 9).astype(np.int64)

    def piece(i):
        lo, hi = edges[i], edges[i + 1]
        words[lo:hi] = _np_record_words(codes[lo : hi + K - 1], canonical)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(piece, range(8)))
    return words, np.cumsum(valid[:nk]) > 0


def np_necklace_words(codes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The words of every k-mer that lies inside one record."""
    words, valid = np_stream_words(codes, offsets)
    return words[valid]


def np_unique(x: np.ndarray) -> np.ndarray:
    """The sorted unique values of a 1-D array, by a sort and a compare of
    neighbours.  (`np.unique` of numpy 2.3 hashes integers first, and so
    do `np.isin` and the set routines without `assume_unique`: on the
    H100 machine's host that took 87.6 of 145.6 s of phase 10 under
    cProfile, 5.5 s a call.)"""
    x = np.sort(x)
    keep = np.ones(len(x), dtype=bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def np_setdiff(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """`np.setdiff1d(x, y)` for sorted unique x and y."""
    return x[~np_isin_sorted(x, y)]


def np_isin_sorted(x: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """`np.isin(x, keys)` for sorted unique `keys`, by binary search in
    eight threads."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(len(x), dtype=bool)
    edges = np.linspace(0, len(x), 9).astype(np.int64)

    def piece(i):
        v = x[edges[i]:edges[i + 1]]
        at = np.minimum(np.searchsorted(keys, v), max(len(keys) - 1, 0))
        out[edges[i]:edges[i + 1]] = keys[at] == v if len(keys) else False

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(piece, range(8)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.bench import run_baseline, run_baseline_dynamic
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

    t_main = time.perf_counter()

    def stamp(phase: int) -> None:
        log(f"phase {phase} starts at {time.perf_counter() - t_main:.1f} s")

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
    from cbl_tpu_torch import io as tio

    fx = tio.native_library_path()
    fresh = not fx.exists()
    t0 = time.perf_counter()
    assert tio._build_native() == fx and tio._load_native() is not None
    log(f"native fastx decoder and packer {'built' if fresh else 'found'} "
        f"in {time.perf_counter() - t0:.2f} s: {os.path.relpath(fx, REPO)}")

    stamp(2)
    # phase 2
    kern = check_kernels(card)

    stamp(3)
    # phase 3
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=MAIN_BASES, dtype=np.uint8)
    offsets = np.array([0, len(codes)], dtype=np.int64)
    n_kmers = MAIN_BASES - K + 1
    runs = {}
    main_launches = None
    for canonical in (False, True):
        label = "canonical" if canonical else "plain"
        base = run_baseline(codes, canonical)
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

    stamp(4)
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
    n_join = LAUNCHES["merge"] + LAUNCHES["probe"]
    total, positive = q_idx.query_codes_stream(qcodes, qoff)
    # a join a slab: the merge join (B3) or, for a batch much smaller than
    # the index, the probe join (B8; `wordset._probe_cheaper`)
    assert LAUNCHES["merge"] + LAUNCHES["probe"] > n_join
    t_o = time.perf_counter()
    q_words = np_necklace_words(qcodes, qoff)
    i_words = np_necklace_words(quarter, q_off)
    want_pos = int(np_isin_sorted(q_words, np_unique(i_words)).sum())
    log(f"foreign query against {len(quarter) / 1e6:.0f} Mbp: total {total} "
        f"positive {positive}; numpy oracle total {len(q_words)} positive "
        f"{want_pos} ({time.perf_counter() - t_o:.1f} s)")
    assert (total, positive) == (len(q_words), want_pos)
    assert 0 < positive < total
    del q_idx, q_words

    codes2 = np.random.default_rng(3).integers(
        0, 4, size=SLAB + SLAB // 32 + K - 1, dtype=np.uint8)
    off2 = np.array([0, len(codes2)], dtype=np.int64)
    n_merge, n_probe = LAUNCHES["merge"], LAUNCHES["probe"]
    idx2, ps2, r2 = static_run(codes2, off2, canonical=False)
    base2 = run_baseline(codes2)
    log(f"two-slab build: slabs {[s[0] for s in ps2.slabs]} {r2} "
        f"baseline distinct {base2['distinct']} merge launches "
        f"{LAUNCHES['merge'] - n_merge}, probe launches "
        f"{LAUNCHES['probe'] - n_probe}")
    assert len(ps2.slabs) == 2
    assert r2["positive"] == r2["total"] == len(codes2) - K + 1, r2
    assert r2["distinct"] == base2["distinct"], (r2, base2)
    # one merge folds slab 2 into the index; slab 1 (2^25 rows) joins by
    # a merge, slab 2 (2^20 rows against 2^25 + 2^20) by the probe
    assert (LAUNCHES["merge"] - n_merge, LAUNCHES["probe"] - n_probe) \
        == (2, 1)
    del idx2, ps2

    stamp(5)
    # phase 5: the dynamic workload at full size
    base_dyn = run_baseline_dynamic(codes)
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
    # the default sort mode on the card is B5: each round sorts its new
    # insert and remove streams (the query stream is the last round's)
    assert dyn_launches["sort"] >= 2 * SEGS, dyn_launches
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

    stamp(6)
    # phase 6: the separate calls, every sort through B5 ("mergepath"),
    # then run A once more under the "library" sort mode
    half_codes = codes[: MAIN_BASES // 2]
    base_b = run_baseline_dynamic(half_codes)
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
        want = separate_launches(mode, log_at_query, r["joins"],
                                 len(run_codes) // SEGS)
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

    stamp(7)
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

    stamp(8)
    # phase 8: ordered membership against phase 3's plain build, rebuilt
    words, _ = np_stream_words(codes, offsets)
    keys = np_unique(words)
    om_idx = CBL(k=K, device=DEVICE)
    om_idx.insert_codes_stream(codes, offsets)
    om = ordered_membership_check(om_idx, codes, offsets, words, keys)
    del words
    log(f"ordered membership: {om}")
    for name in STATIC_KERNELS:
        assert om["default"]["launches"][name] == 1, om["default"]
    b67 = om["bitonic"]["launches"]
    assert b67["bitonic_sort"] >= 1 and b67["bitonic_merge"] == 1, b67
    assert b67["merge"] == 0, b67
    seq_launches = om["seqs"]["launches"]
    assert seq_launches["necklace"] >= 16 and seq_launches["merge"] >= 1
    assert seq_launches["blank"] == 0, seq_launches  # validity from the host

    stamp(9)
    # phase 9: export and checkpoints on phase 8's index
    ex = export_check(om_idx, codes, offsets, keys, runs["plain"][1]["distinct"])
    del om_idx, keys
    log(f"export and checkpoints: {ex}")
    ex_launches = ex["launches"]
    for name in STATIC_KERNELS:
        assert ex_launches[name] >= 1, ex_launches
    # each fresh build sorts once and its export once more; the exports
    # after them run in the default sort mode, B5 on the card
    assert ex["mode_launches"] == {"sort": 2, "bitonic_sort": 2}, ex
    assert ex_launches["bitonic_sort"] == 2 < ex_launches["sort"], (
        ex_launches)

    stamp(10)
    # phase 10: wide K (config 3, K=31)
    wide = wide_k_check(card)

    stamp(11)
    # phase 11: config 2's rounds at K=59 and K=27 against numpy
    wdyn = wide_dynamic_check(codes, base_dyn, card)

    stamp(12)
    # phase 12: the genome corpus through the CLI
    gen = cli_genome_check()

    stamp(13)
    # phase 13: the sharded index: BASELINE config 5 (D = 1), the bulk
    # path at D = 1, SHARDS shards on the one card, the CLI's --sharded
    # and the sharded examples
    from cbl_tpu_torch.parallel import make_mesh

    mesh1 = make_mesh()[:1]  # bench.py's sharded-dynamic mesh: D = 1
    sharded_dynamic_run(codes, mesh1, timed=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    sdyn = sharded_dynamic_run(codes, mesh1, timed=True)
    sdyn["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"sharded dynamic path (config 5, D=1): "
        f"{ {n: v for n, v in sdyn.items() if n != 'launches'} } baseline "
        f"{base_dyn}")
    assert sdyn["ops"] == base_dyn["ops"], (sdyn, base_dyn)
    assert sdyn["distinct"] == base_dyn["distinct"], (sdyn, base_dyn)
    assert sdyn["positive"] == base_dyn["positive"], (sdyn, base_dyn)
    sdyn_launches = sdyn["launches"]
    # a round merges three times (the first into the index's rows too)
    # and scans once; each of the 2 SEGS staged streams runs its word
    # pipeline once (the memo)
    assert sdyn_launches["merge"] == 3 * SEGS, sdyn_launches
    assert sdyn_launches["slog_scan"] == SEGS, sdyn_launches
    assert sdyn_launches["necklace"] == sdyn_launches["blank"] == 2 * SEGS
    static_plain, base_static = runs["plain"]
    sbulk = sharded_bulk_run(codes, offsets, mesh1)
    sbulk.pop("idx")
    log(f"sharded bulk path (D=1): "
        f"{ {n: v for n, v in sbulk.items() if n != 'launches'} }")
    assert sbulk["distinct"] == base_static["distinct"], sbulk
    assert sbulk["total"] == sbulk["positive"] == n_kmers, sbulk
    sbulk_launches = sbulk["launches"]
    for name in STATIC_KERNELS:
        assert sbulk_launches[name] >= 1, (
            f"kernel {name} never launched on the sharded bulk path")
    smesh = sharded_mesh_check(codes, offsets, base_static, base_dyn,
                               alg[ALGEBRA_MODES[2]]["counts"])
    log(f"{SHARDS} shards on one card: "
        f"{ {n: v for n, v in smesh.items() if n != 'rounds'} }")
    mesh_launches = smesh["rounds"]["launches"]
    assert mesh_launches["slog_scan"] == SEGS * SHARDS, mesh_launches
    for name in ROUND_KERNELS:
        assert mesh_launches[name] >= 1, mesh_launches
    scli = sharded_cli_check(gen)
    log(f"sharded CLI and examples: {scli}")
    # phase 13 (e): RANKS processes on the card, the multi-process layer
    t0 = time.perf_counter()
    rk = ranks_check(gen)
    log(f"phase 13 (e), {RANKS} ranks: {time.perf_counter() - t0:.1f} s; "
        f"launches { {b: rk[b]['launches'] for b in ('gloo', 'nccl') if b in rk} }")

    stamp(14)
    # phase 14: python -m cbl_tpu_torch.bench (the default run and largek)
    # as a user runs it, then the multi-device dryrun on the card
    t0 = time.perf_counter()
    bch = bench_check(card)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    # phase 14 (b): the flagship forward step (cbl_tpu_torch.entry) on the
    # reference's args, then on windows against the canonical 32 Mbp index
    t0 = time.perf_counter()
    ent = entry_check(codes, qcodes, runs["canonical"][1]["distinct"])
    log(f"phase 14 (b): {time.perf_counter() - t0:.1f} s; python -m "
        f"cbl_tpu_torch.entry {ent['cli_s']:.1f} s: {ent['cli'][0]}; "
        f"{ent['index_rows']} index rows, foreign hits "
        f"{ent['foreign_hits']}; numpy oracle {ent['oracle_s']:.1f} s")

    stamp(15)
    # phase 15
    for name in STATIC_KERNELS:
        assert main_launches[name] >= 1, name
    for launches in (ent["launches"], ent["windows_launches"]):
        assert launches["necklace"] >= 1, (
            "kernel necklace never launched on the forward step's path")
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

    nk, bd, d = om["kmers"], om["breakdown"], om["default"]
    b6, b7 = kern["bitonic_sort"], kern["bitonic_merge"]
    log(f"[{card}] K={K} ordered membership, contains_codes_stream of a "
        f"{len(codes) / 1e6:.0f} Mbp foreign stream of 17 records ({nk} "
        f"k-mers, {om['positive']} present) against the "
        f"{MAIN_BASES / 1e6:.0f} Mbp index ({bd['data_rows']} rows): wall "
        f"{d['wall_s'] * 1e3:.2f} ms = {nk / d['wall_s']:.4g} k-mers/s; in "
        f"the same call: staging {d['stage_ms']:.2f} ms (host clock), word "
        f"pipeline + sort-join {d['device_ms']:.3f} ms by device events "
        f"({nk / d['device_ms'] * 1e3:.4g} k-mers/s; the device idles at "
        f"least {100 * (1 - d['device_ms'] / (d['wall_s'] * 1e3)):.1f} % "
        f"of the wall), the mask's copy to the host and its split "
        f"{d['copy_ms']:.3f} ms; peak device memory {d['peak_gib']:.2f} "
        f"GiB; alone: word pipeline {bd['pipeline_ms']:.3f} ms, sort-join "
        f"of {bd['queries']} queries {bd['join_ms']:.3f} ms (its sorted "
        f"rows by a sort and a merge {bd['rows_ms']:.3f}; data rows' "
        f"answers to one slot in place of 2^16: {bd['one_slot_ms']:.3f}), "
        f"by one sort of both sides {bd['one_sort_ms']:.3f} ms; phase 2 at "
        f"the join's shape: two stable torch.sort passes of the queries "
        f"{b6['join_library_ms']:.3f} ms, B3's merge "
        f"{kern['merge']['join_ms']:.3f} ms; index with holes wall "
        f"{om['holes']['wall_s'] * 1e3:.2f} ms (staging "
        f"{om['holes']['stage_ms']:.2f}, device "
        f"{om['holes']['device_ms']:.3f}), peak "
        f"{om['holes']['peak_gib']:.2f} GiB; numpy oracle "
        f"{om['oracle_s']:.1f} s")
    bb, b = om["bitonic_breakdown"], om["bitonic"]
    log(f"[{card}] K={K} ordered membership under (merge, sort) modes "
        f"(bitonic, bitonic): wall {b['wall_s'] * 1e3:.2f} ms; in the same "
        f"call staging {b['stage_ms']:.2f} ms, word pipeline + sort-join "
        f"{b['device_ms']:.3f} ms by device events, the mask's copy "
        f"{b['copy_ms']:.3f} ms; alone: sort-join {bb['join_ms']:.3f} ms "
        f"(its sorted rows {bb['rows_ms']:.3f}; data rows to one slot "
        f"{bb['one_slot_ms']:.3f}), by one sort {bb['one_sort_ms']:.3f} "
        f"ms; phase 2 at the join's shape: B6's sort of the queries "
        f"{b6['join_ms']:.3f} ms, B7's merge {b7['sortjoin_ms']:.3f} ms; "
        f"peak device memory {b['peak_gib']:.2f} GiB")
    sq = om["seqs"]
    log(f"[{card}] K={K} insert_seqs of {sq['records']} records "
        f"({sq['kmers']} k-mers), remove_seqs of {sq['removed']}, count "
        f"{sq['count']}: {sq['wall_s'] * 1e3:.2f} ms by the host clock = "
        f"{sq['kmers'] / sq['wall_s']:.4g} k-mers/s; launches "
        f"{sq['launches']}")

    for mode in EXPORT_MODES:
        r = ex[mode]
        log(f"[{card}] K={K} words_array of a fresh {MAIN_BASES / 1e6:.0f} "
            f"Mbp build, sort mode {mode}: {r['rows']} rows, "
            f"{r['wall_ms']:.2f} ms by the host clock: preamble (flush, "
            f"the dedup sort) {r['preamble_ms']:.3f} ms and limbs laid out "
            f"on the card {r['layout_ms']:.3f} ms by device events, copy "
            f"to the host {r['copy_ms']:.2f} ms")
    st = ", ".join(f"{n} {v:.3f}" for n, v in ex["stats_s"].items())
    log(f"[{card}] K={K} export of the {MAIN_BASES / 1e6:.0f} Mbp index "
        f"({ex['words']} words, {ex['buckets']} buckets): words_array "
        f"{ex['words_array_s'] * 1e3:.2f} ms, iter_words_chunks(2^22) "
        f"{ex['chunks_s'] * 1e3:.2f} ms with every chunk kept, "
        f"{ex['chunks_streamed_s'] * 1e3:.2f} ms one at a time, kmers_limbs "
        f"{ex['kmers_s'] * 1e3:.2f} ms, iter_nucs first 2^20 rows "
        f"{ex['iter_nucs_s'] * 1e3:.1f} ms; stats s: {st} (numpy oracle "
        f"{ex['stats_oracle_s']:.2f} s); save_to_file {ex['save_s']:.3f} s "
        f"({ex['file_bytes']} bytes), load_from_file {ex['load_s']:.3f} s "
        f"(alone: np.load of the words {ex['npz_read_s']:.3f} s, "
        f"from_limbs {ex['from_limbs_s']:.3f} s), "
        f"the loaded index's self-query with staging "
        f"{ex['loaded_query_s'] * 1e3:.1f} ms; save_reference "
        f"{ex['save_ref_s']:.3f} s ({ex['ref_bytes']} bytes); at the "
        f"{REF_CUT / 1e6:.0f} Mbp cut ({ex['cut_words']} words): "
        f"save_reference {ex['cut_save_ref_s']:.3f} s ({ex['cut_ref_bytes']}"
        f" bytes), load_reference {ex['cut_load_ref_s']:.3f} s; peak device "
        f"memory {ex['peak_gib']:.2f} GiB; launches {ex_launches}")
    for modes, r in alg.items():
        log(f"[{card}] K={K} set algebra {modes}: serde round-trip of a "
            f"({r['counts']['a']} words) {r['serde_s']:.3f} s, "
            f"{r['serde_bytes']} bytes")
    for label in ("plain", "canonical"):
        r = wide[label]
        n_wide = MAIN_BASES - WIDE_K + 1
        log(f"[{card}] K={WIDE_K} prefix {WIDE_PREFIX} (config 3) "
            f"{MAIN_BASES / 1e6:.0f} Mbp {label}: distinct {r['distinct']}"
            f" (numpy's), stage {r['stage_s'] * 1e3:.1f} ms, insert "
            f"{r['insert_ms']:.2f} ms, query {r['query_ms']:.2f} ms (device "
            f"events), combined wall {r['wall_s'] * 1e3:.2f} ms = "
            f"{2 * n_wide / r['wall_s']:.4g} k-mers/s; bench.py --mode "
            f"largek's metric: build from the bases with staging "
            f"{r['largek_build_s'] * 1e3:.1f} ms + kmers_limbs "
            f"{r['kmers_limbs_s'] * 1e3:.1f} ms = {r['largek_rate']:.4g} "
            f"(k-mers + distinct)/s; foreign query of "
            f"{WIDE_FOREIGN / 1e6:.0f} Mbp {r['foreign_s'] * 1e3:.1f} ms "
            f"with staging ({r['foreign_positive']} of "
            f"{r['foreign_total']} present); peak device memory "
            f"{r['peak_gib']:.2f} GiB; numpy oracle {r['oracle_s']:.1f} s")
    r = wide["k31"]
    alg31 = ", ".join(f"{m}: {v:.2f} ms" for m, v in r["algebra_ms"].items())
    log(f"[{card}] K={K31} prefix 24: insert_seqs + remove_seqs + count of "
        f"{K31_BASES / 1e6:.0f} Mbp (sort mode mergepath) "
        f"{r['seqs_s'] * 1e3:.1f} ms, count {r['seqs_count']}; four set "
        f"operations with counts of 2 x 4 Mbp by device events {alg31}; "
        f"contains_codes_stream of 2 Mbp {r['contains_mergepath_s'] * 1e3:.1f}"
        f" ms (bitonic: {r['contains_bitonic_s'] * 1e3:.1f} ms); checkpoint "
        f"round-trip {r['serde_s']:.3f} s; .cbl round-trip at the "
        f"{REF_CUT / 1e6:.0f} Mbp cut {r['ref_s']:.3f} s; peak device "
        f"memory {r['peak_gib']:.2f} GiB; host clock by part {r['parts_s']}")
    for path, counts in wide["launches"].items():
        log(f"[{card}] wide-K launches, {path}: "
            f"{ {n: c for n, c in counts.items() if c} }")
    runs = [(f"K={k} prefix {pb}", wdyn[k]) for k, pb in DYN_WIDE]
    for label, r in runs + [(f"K={WIDE_K} prefix {WIDE_PREFIX}, merge mode "
                             "bitonic (B7)", wdyn["bitonic"])]:
        extra = (f"; query of the active log {r['join_s'] * 1e3:.1f} ms, "
                 f"flush + count {r['flush_s'] * 1e3:.1f} ms; numpy oracle "
                 f"{r['oracle_s']:.1f} s" if "join_s" in r else "")
        log(f"[{card}] {label} {MAIN_BASES / 1e6:.0f} Mbp dynamic, {SEGS} "
            f"rounds, {r['ops']} ops: wall with staging "
            f"{r['wall_s'] * 1e3:.2f} ms = {r['ops'] / r['wall_s']:.4g} ops/s"
            f" (stage {r['stage_s'] * 1e3:.1f} ms); device rounds "
            f"{r['rounds_s'] * 1e3:.2f} ms = {r['ops'] / r['rounds_s']:.4g} "
            f"ops/s ({r['rounds_ms']:.2f} ms by device events); peak device "
            f"memory {r['peak_gib']:.2f} GiB; final log {r['log_rows']} rows"
            f" x {r['log_cols']} columns ({r['log_real']} real bound, seq "
            f"{r['seq']}){extra}; launches "
            f"{ {n: c for n, c in r['launches'].items() if c} }")
    log(f"[{card}] phase 11's oracle held to bench/baseline.cpp at K={K}: "
        f"{wdyn['oracle_k25_s']:.1f} s")

    ps, b, q = gen["parse_s"], gen["build"], gen["query"]
    log(f"[{card}] K={K} genome corpus ({GENOME_BASES / 1e6:.0f} Mbp, "
        f"{gen['records'][0]} insert records as FASTA, "
        f"{gen['bytes']['insert.fa']} bytes; {gen['records'][1]} query "
        f"records as FASTQ gzip at level 1, {gen['bytes']['query.fq.gz']} "
        f"bytes) through python -m "
        f"cbl_tpu_torch: parse (host) FASTA native "
        f"{ps['fasta native'] * 1e3:.1f} ms, python "
        f"{ps['fasta python'] * 1e3:.1f} ms; FASTQ gzip native "
        f"{ps['fastq.gz native'] * 1e3:.1f} ms, python "
        f"{ps['fastq.gz python'] * 1e3:.1f} ms; pack of 32 Mbp (host) "
        f"native {gen['pack_native_ms']:.2f} ms, numpy "
        f"{gen['pack_numpy_ms']:.2f} ms ({gen['native_packs']} native "
        f"packs in the in-process commands, {gen['native_lib']})")
    log(f"[{card}] K={K} genome CLI build: distinct {gen['distinct']} "
        f"(canonical {gen['distinct_c']}; baseline.cpp records "
        f"{gen['baseline'][False]['distinct']} / "
        f"{gen['baseline'][True]['distinct']}), 'Built in' "
        f"{gen['build_wall_s']:.2f} s, meter {b['kmers']} k-mers in "
        f"{b['s']:.2f} s = {b['rate']:.4g} k-mers/s (parse, build, flush, "
        f"count); query: {gen['positive'][1]} of {gen['positive'][0]} "
        f"positive (canonical {gen['positive_c'][1]}; baseline "
        f"{gen['baseline'][False]['positive']} / "
        f"{gen['baseline'][True]['positive']}), 'Queried in' "
        f"{gen['query_wall_s']:.2f} s, meter {q['rate']:.4g} k-mers/s "
        f"(the query call alone, after the parse); each a process of "
        f"its own, started cold")
    for name, v in gen["inproc"].items():
        log(f"[{card}] genome CLI in-process {name}: device busy "
            f"{v['device_ms']:.2f} ms (profiler, kernels and copies), host "
            f"clock {v['wall_s'] * 1e3:.1f} ms under the profiler, idle "
            f"{1 - v['device_ms'] / (v['wall_s'] * 1e3):.1%}; launches "
            f"{ {n: c for n, c in v['launches'].items() if c} }")
    log(f"[{card}] genome CLI set operations {gen['set_counts']} (numpy's "
        f"words); K=59 build + list of {K59_CLI_BASES / 1e6:.0f} Mbp: "
        f"{gen['k59_distinct']} distinct (numpy's); trace of the query "
        f"stream's build: {gen['trace_kernels']} kernel names; the second "
        f"wave of commands (11 at once) {gen['wave4_s']:.1f} s; numpy "
        f"oracles {gen['oracle_s']:.1f} s; corpus files written in "
        f"{gen['files_s']:.1f} s")
    log(f"[{card}] examples: {gen['dynamic_twin']}; {gen['necklace_twin']} "
        f"(launches {gen['necklace_twin_launches']['necklace']} of B1)")
    sharded_summary(card, dyn, base_dyn, static_plain, n_kmers, sdyn, sbulk,
                    smesh, scli)
    ranks_summary(card, rk)
    for size, rows in (("small", "2^15 sentinel"),
                       ("large", f"{ent['index_rows']} canonical")):
        t = ent[size]
        log(f"[{card}] K={K} entry() forward step, 2^14 k-mers against "
            f"{rows} index rows: host clock {t['host_ms']:.4f} ms a call, "
            f"device {t['device_ms']:.4f} ms a call by CUDA events (median "
            f"of {ENTRY_BATCHES} batches of {ENTRY_QUEUED} calls queued "
            f"behind a sleep, {t['device_ms_range'][0]:.4f}-"
            f"{t['device_ms_range'][1]:.4f}; covered: {t['covered']}), "
            f"profiler "
            f"{t['device_launches']:.1f} device launches and "
            f"{t['busy_ms']:.4f} ms busy a call; B1 once a call")

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
    for name in WIDE_KERNELS + TAG_KERNELS:
        src[name] = src[name.replace("_wide", "").replace("_3col", "")
                        .replace("_tag", "")]
    src["probe"] = ("cbl_tpu_torch/csrc/probe.cu",
                    "none: cbl_tpu merges each batch with the whole index")
    # launches: the counted runs of the static path (plain), the dynamic
    # rounds (in the default mode and under "bitonic"), the separate calls
    # (runs A and B under "mergepath"), set algebra (under ("bitonic",
    # "bitonic") and ("sort", "bitonic")) and ordered membership (the
    # foreign stream in the default modes and under ("bitonic",
    # "bitonic"), the index with holes, the sequence calls), export
    # (three fresh builds' exports, checkpoints, .cbl files) and wide K
    # (config 3's timed build and self-query in each mode; at K=31 the
    # sequence calls, the set operations in each mode pair and the
    # contains mask in two) and the rounds at wide K (K=59 and 27, and
    # K=59 under "bitonic"), the CLI in this process, the necklace
    # example, the sharded index (config 5's rounds at D = 1, the bulk
    # build and query at D = 1, the rounds on SHARDS shards) and the
    # ranks of phase 13 (e) (each rank's whole run, summed), the
    # bench's default run and largek run (phase 14) and the forward step
    # (phase 14 (b): two calls on the reference's args, ENTRY_WINDOWS
    # windows), each counted from 0
    paths = (main_launches, dyn_launches, b7_launches, sep["A"]["launches"],
             sep["B"]["launches"], alg_launches,
             alg[ALGEBRA_MODES[1]]["launches"], om["default"]["launches"],
             om["bitonic"]["launches"], om["holes"]["launches"],
             seq_launches, ex_launches, *wide["launches"].values(),
             *wdyn["launches"].values(), *gen["launches"].values(),
             gen["necklace_twin_launches"], sdyn_launches, sbulk_launches,
             mesh_launches,
             *(rk[b]["launches"] for b in ("gloo", "nccl") if b in rk),
             bch["default"]["line"]["launches"],
             bch["largek"]["line"]["launches"], ent["launches"],
             ent["windows_launches"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1],
         "launches": sum(p.get(name, 0) for p in paths),
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         **({"passes": kern[name]["passes"]} if "passes" in kern[name]
            else {})}
        for name in KERNELS + WIDE_KERNELS + TAG_KERNELS + ("probe",)
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
