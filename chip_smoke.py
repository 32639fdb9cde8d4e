#!/usr/bin/env python3
"""Drive the PyTorch port's static and dynamic-round paths on one NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card, `nvcc` and
`g++`:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. print the card, its power limit and the versions; build the four CUDA
   kernels of `cbl_tpu_torch` from `cbl_tpu_torch/csrc/` (one nvcc per
   source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (exact equality) and time both with CUDA events;
3. run the static path at full size: 32,000,000 random bases (one
   record) at K=25, `pack_stream` -> `insert_codes_stream` ->
   `count_device` -> `query_codes_stream(lazy=True)` with one sync, plain
   and canonical; `distinct` must equal `bench/baseline.cpp`'s count and
   every k-mer must be found;
4. query a multi-record stream that was never inserted (its `positive`
   must equal a numpy oracle) and build a stream of two slabs;
5. run the dynamic path at full size (`bench.py --mode dynamic`): the same
   32 Mbp in 8 segments, round i = `dynamic_round(segs[i],
   segs[max(i-1, 0)], halves[i])`, one warm-up and one timed run;
   `distinct` and the summed `positive` must equal `bench/baseline.cpp
   dynamic`'s; then a query of the active log must equal the same query
   after `flush()`;
6. require every kernel of each path to have been launched in that
   path's timed run, and print the timings;
7. print the kernels' JSON line and, last, the device JSON line.

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
KERNELS = STATIC_KERNELS + ("slog_scan",)  # all run on the dynamic path


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


# --- phase 2: each kernel against its plain version -------------------------


def check_kernels(card: str) -> dict:
    import torch

    from cbl_tpu_torch import cbl as cmod
    from cbl_tpu_torch.ops import merge, necklace, scan

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
    results["necklace"] = dict(err=max(errs), ms=ms, plain_ms=plain_ms)

    # B2: the delta array of a 2^25 slab with many records and a short
    # trailing record
    lens = rng.integers(K, 4096, size=SLAB // 4096)
    # fill the first slab, then end on a short trailing record (< K)
    lens = np.append(lens, [max(SLAB + 5000 - int(lens.sum()), K), 10])
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = rng.integers(0, 4, size=int(offsets[-1]), dtype=np.uint8)
    idx = cmod.CBL(k=K, device=dev)
    ps = idx.pack_stream(codes, offsets)
    nk_pad, _, s_arr, e_arr, _ = ps.slabs[0]
    assert nk_pad == SLAB, nk_pad
    delta = cmod.blank_delta(s_arr, e_arr, nk_pad)
    got = scan.blank_mask(delta)
    want = scan.blank_mask_plain(delta)
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    n_blank = int(want[0].sum())
    log(f"B2 blank n={nk_pad} records={len(lens)} blanked={n_blank} "
        f"n_valid={int(want[1])}: kernel == plain: {err == 0}")
    assert 0 < n_blank < nk_pad
    ms = time_ms(lambda: scan.blank_mask(delta), 20)
    plain_ms = time_ms(lambda: scan.blank_mask_plain(delta), 5)
    results["blank"] = dict(err=err, ms=ms, plain_ms=plain_ms)

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
    a, b = sorted_keys(SLAB, 1 << 57), sorted_keys(SLAB, 1 << 57)
    ms = time_ms(lambda: merge.merge_sorted(a, b), 10)
    plain_ms = time_ms(lambda: merge.merge_sorted_plain(a, b), 3)
    results["merge"] = dict(err=max(errs), ms=ms, plain_ms=plain_ms)
    del a, b

    # B4: a synthetic slog of 2^26 rows (runs of ~16 rows across every
    # tile boundary and one run of 2^20 rows, a 10 % sentinel tail), at a
    # round's query tag and the join's 0xFF; also 2^26 - 4097 rows and one
    errs = []
    round_qtag = (5 << 2) | 2
    for n in (2 * SLAB, 2 * SLAB - 4097, 1):
        keys = slog_keys(rng, n)
        for qtag in (round_qtag, 0xFF):
            got = scan.slog_scan_counts(keys, qtag)
            want = scan.slog_scan_counts_plain(keys, qtag)
            errs.append(max(max_abs_err(g, w) for g, w in zip(got, want)))
            log(f"B4 slog_scan n={n} qtag={qtag:#x}: hits {int(want[0])} "
                f"live {int(want[1])}: kernel == plain: {errs[-1] == 0}")
            assert n == 1 or int(want[0]) > 0 < int(want[1])
        if n == 2 * SLAB:
            ms = time_ms(lambda: scan.slog_scan_counts(keys, round_qtag), 20)
            plain_ms = time_ms(
                lambda: scan.slog_scan_counts_plain(keys, round_qtag), 3)
    results["slog_scan"] = dict(err=max(errs), ms=ms, plain_ms=plain_ms)
    del keys

    for name, r in results.items():
        log(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"[{card}]")
        if r["err"] != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version (max abs err {r['err']})")
    return results


def slog_keys(rng, n: int):
    """Sorted slog keys (`cbl_tpu_torch.wordset.slog_key`) on the card:
    words of runs of ~16 rows and one run of min(n / 64, 2^20) rows, tags
    (seq << 2) | typ of seqs 0-7 (insert twice as often as query or
    remove), 5 % 0xFF join queries, a 10 % sentinel tail."""
    import torch

    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.wordset import slog_key

    dev = torch.device(DEVICE)
    words = rng.integers(0, max(n // 16, 1), size=n) * 977 + (1 << 40)
    words[: min(n // 64, 1 << 20)] = 12345
    tags = (rng.integers(0, 8, size=n) << 2) | rng.choice([1, 1, 2, 3], n)
    tags[rng.random(n) < 0.05] = 0xFF
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
    from cbl_tpu_torch.ops import LAUNCHES, _build

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
            main_launches, plain_idx = launches, idx
        del idx, ps
    log(f"launch counters on the static path (plain): {main_launches}")

    # phase 4: a multi-record query stream that was never inserted (half of
    # its records copied from the inserted stream, half fresh bases)
    qrng = np.random.default_rng(2)
    parts = []
    for r in range(8):
        n = MAIN_BASES // 64
        if r % 2 == 0:
            s = int(qrng.integers(0, MAIN_BASES - n))
            parts.append(codes[s : s + n])
        else:
            parts.append(qrng.integers(0, 4, size=n, dtype=np.uint8))
    parts.append(qrng.integers(0, 4, size=11, dtype=np.uint8))  # short tail
    qcodes = np.concatenate(parts)
    qoff = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    n_merge = LAUNCHES["merge"]
    total, positive = plain_idx.query_codes_stream(qcodes, qoff)
    assert LAUNCHES["merge"] > n_merge
    t_o = time.perf_counter()
    q_words = np_necklace_words(qcodes, qoff)
    i_words = np_necklace_words(codes, offsets)
    want_pos = int(np.isin(q_words, i_words).sum())
    log(f"foreign query: total {total} positive {positive}; numpy oracle "
        f"total {len(q_words)} positive {want_pos} "
        f"({time.perf_counter() - t_o:.1f} s)")
    assert (total, positive) == (len(q_words), want_pos)
    assert 0 < positive < total
    del plain_idx

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
    for name in KERNELS:
        assert dyn_launches[name] >= 1, (
            f"kernel {name} never launched on the dynamic path")
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

    # phase 6
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

    # phase 7
    src = {
        "necklace": ("cbl_tpu_torch/csrc/necklace.cu",
                     "cbl_tpu/ops/necklace_pallas.py:102"),
        "blank": ("cbl_tpu_torch/csrc/scan.cu",
                  "cbl_tpu/ops/scan_pallas.py:293"),
        "merge": ("cbl_tpu_torch/csrc/merge.cu",
                  "cbl_tpu/ops/merge_pallas.py:355"),
        "slog_scan": ("cbl_tpu_torch/csrc/slog_scan.cu",
                      "cbl_tpu/ops/scan_pallas.py:202"),
    }
    # launches: the static path's timed run (plain) plus the dynamic
    # path's timed run, each counted from 0
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1],
         "launches": main_launches[name] + dyn_launches[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]}
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
