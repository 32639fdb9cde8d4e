"""The port's benchmark: `python -m cbl_tpu_torch.bench` prints ONE JSON line.

Counterpart of the repository's `bench.py`, function by function, on the
port's public API: the same six workloads (`--mode static`, the default
and BASELINE config 1; `dynamic`, config 2; `largek`, config 3;
`algebra`, config 4; `genome`, config 1 on repeat-rich records;
`sharded-dynamic`, config 5), the same data (`default_rng(0)` bases,
`make_genome_corpus`), the same timing windows and the same checks: every
count against `bench/baseline.cpp`, which is compiled with `bench.py`'s
flags into `cbl_tpu_torch/_build/` (once a host), so that `vs_baseline`
means the same in both lines.  The default run adds the same extras to the static
headline (canonical, dynamic, sharded-dynamic, genome, algebra and
serde), and `value` is the best repeat's rate, as in `bench.py`.

    python -m cbl_tpu_torch.bench                    # every extra, on the card
    python -m cbl_tpu_torch.bench --mode largek --repeats 2
    python -m cbl_tpu_torch.bench --device cpu --bases 200000

Differences from `bench.py`:
- `--device` (default cuda; without a card the run exits 2, and only
  `--device cpu` runs the plain tensor path) in place of `--platform`;
- a workload that fails raises, and the run exits non-zero with no line
  (`bench.py` writes `*_error` keys and goes on);
- the four set operations' counts are checked against the baseline too,
  and the dynamic op count;
- the line adds `device` (the card's name and power limit as
  `nvidia-smi` reads them, and the device count), `launches` (each
  kernel's count in `ops.LAUNCHES` over the run) and, for each rate, its
  value in every repeat under `<key>_repeats`.
Progress, every count check and each workload's peak device memory go to
stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .cbl import CBL
from .ops import LAUNCHES
from .wordset import resolve_device

BASELINE_SRC = Path(__file__).resolve().parent.parent / "bench" / "baseline.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
K = 25
SEGS = 8  # dynamic-mode segments (must match bench/baseline.cpp run_dynamic)
MODES = ("static", "dynamic", "largek", "algebra", "genome",
         "sharded-dynamic")
# `bench.py`'s default line, key for key; the rates whose value in every
# repeat the port's line adds under "<key>_repeats"; and the counts that
# the default run holds to `bench/baseline.cpp` (its "check:" lines)
DEFAULT_KEYS = ("metric", "value", "unit", "vs_baseline",
                "canonical_kmers_per_s", "canonical_vs_baseline",
                "dynamic_ops_per_s", "dynamic_vs_local",
                "sharded_dynamic_ops_per_s", "sharded_dynamic_ratio",
                "genome_kmers_per_s", "genome_vs_baseline", "algebra_ms",
                "serde_s")
RATE_KEYS = ("value", "canonical_kmers_per_s", "dynamic_ops_per_s",
             "sharded_dynamic_ops_per_s", "genome_kmers_per_s")
DEFAULT_CHECKS = frozenset({
    "static distinct", "static canonical distinct",
    *(f"{m} {c}" for m in ("dynamic", "sharded-dynamic")
      for c in ("ops", "distinct", "positive")),
    "genome distinct", "genome positive", "algebra |a|", "algebra |b|",
    *(f"algebra {n}" for n in ("union", "inter", "diff", "symdiff"))})


def _eprint(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(ok: bool, what) -> None:
    """`bench.py`'s asserts, kept under `python -O`."""
    if not ok:
        raise AssertionError(what)


def check_count(what: str, ours: int, base: int) -> None:
    """A count of the port against the baseline's, reported on stderr."""
    check(ours == base, f"COUNT MISMATCH {what}: ours={ours} baseline={base}")
    _eprint(f"check: {what} {ours} equals bench/baseline.cpp")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _peak_memory(label: str, device: torch.device):
    """Report the workload's peak device memory on stderr."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    yield
    if device.type == "cuda":
        gib = torch.cuda.max_memory_allocated(device) / 2**30
        _eprint(f"{label}: peak device memory {gib:.3f} GiB")


def device_info(device: torch.device) -> dict:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, and the device count.
    The card is found by its UUID: under CUDA_VISIBLE_DEVICES torch's
    index is not nvidia-smi's."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None,
                "count": 1}
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()
    for line in lines:
        card, rest = (f.strip() for f in line.split(",", 1))
        if card.removeprefix("GPU-") == uuid.removeprefix("GPU-"):
            name, power = (f.strip() for f in rest.rsplit(",", 1))
            return {"platform": "gpu", "name": name, "power_limit": power,
                    "count": torch.cuda.device_count()}
    raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid}")


# --- bench/baseline.cpp ------------------------------------------------------


BASELINE_FLAGS = ["-O3", "-march=native", "-std=c++17"]  # bench.py's


def build_baseline() -> str:
    """Compile `bench/baseline.cpp` with `bench.py`'s flags into
    `BUILD_DIR`, once; -> the executable.  Its name carries a hash of the
    source, the flags and the host's name: `-march=native` code is built
    for this host's CPU and may not run on another's."""
    h = hashlib.sha256(BASELINE_SRC.read_bytes())
    h.update(" ".join(BASELINE_FLAGS + [platform.node()]).encode())
    exe = BUILD_DIR / f"bench_baseline_{h.hexdigest()[:16]}"
    if not exe.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_name(f"{exe.name}.tmp{os.getpid()}")
        subprocess.run(["g++", *BASELINE_FLAGS, str(BASELINE_SRC), "-o",
                        str(tmp)], check=True)
        os.replace(tmp, exe)
    return str(exe)


def _baseline(arrays: dict, argv: list, timeout: int) -> dict:
    """Run the baseline with `arrays` written to files of a fresh temporary
    directory; a name of `arrays` in `argv` stands for its file."""
    exe = build_baseline()
    with tempfile.TemporaryDirectory(prefix="cbl_bench_") as tmp:
        paths = {}
        for name, arr in arrays.items():
            paths[name] = os.path.join(tmp, f"{name}.bin")
            arr.tofile(paths[name])
        out = subprocess.run([exe] + [paths.get(a, a) for a in argv],
                             capture_output=True, check=True,
                             timeout=timeout).stdout
    return json.loads(out)


def run_baseline(codes: np.ndarray, canonical: bool = False) -> dict:
    return _baseline({"codes": codes},
                     ["codes"] + (["canonical"] if canonical else []), 600)


def run_baseline_records(codes_i, off_i, codes_q, off_q,
                         canonical: bool = False) -> dict:
    return _baseline(
        {"gcodes": codes_i, "goff": off_i, "gqcodes": codes_q,
         "gqoff": off_q},
        ["gcodes", "records", "goff", "gqcodes", "gqoff"]
        + (["canonical"] if canonical else []), 1200)


def run_baseline_dynamic(codes: np.ndarray) -> dict:
    return _baseline({"codes": codes}, ["codes", "dynamic"], 600)


# --- the data ------------------------------------------------------------------


def make_genome_corpus(bases: int, seed: int = 0, read_len: int = 10240,
                       qread_len: int = 2048):
    """Repeat-rich synthetic corpus with a ~50% query hit rate (BASELINE
    config 1's "E. coli reads" stand-in), array for array `bench.py`'s.

    - genome: mutated copies (0.5% point mutations) from a 12-unit repeat
      pool, joined by short unique linkers -> heavy k-mer duplication and
      a skewed prefix/bucket distribution (unlike uniform-random bases);
    - insert stream: the genome cut into `read_len`-base records;
    - query stream: alternating windows sampled inside single insert
      records (all k-mers present) and uniform-random records (~0 hits).

    Returns (codes_i, off_i, codes_q, off_q).
    """
    rng = np.random.default_rng(seed)
    units = [
        rng.integers(0, 4, size=int(n), dtype=np.uint8)
        for n in rng.integers(300, 4000, size=12)
    ]
    parts, total = [], 0
    while total < bases:
        u = units[int(rng.integers(0, len(units)))].copy()
        mut = rng.random(len(u)) < 0.005
        u[mut] = (u[mut] + rng.integers(1, 4, size=int(mut.sum()))
                  .astype(np.uint8)) % 4
        linker = rng.integers(
            0, 4, size=int(rng.integers(20, 200)), dtype=np.uint8
        )
        parts += [u, linker]
        total += len(u) + len(linker)
    genome = np.concatenate(parts)[:bases]
    off_i = np.append(
        np.arange(0, bases, read_len, dtype=np.int64), np.int64(bases)
    )
    n_q = bases // qread_len
    q_parts = []
    for i in range(n_q):
        if i % 2 == 0:  # hit window inside ONE insert record
            rec = int(rng.integers(0, len(off_i) - 1))
            lo, hi = int(off_i[rec]), int(off_i[rec + 1])
            if hi - lo < qread_len:
                rec = 0
                lo, hi = 0, int(off_i[1])
            start = int(rng.integers(lo, hi - qread_len + 1))
            q_parts.append(genome[start : start + qread_len])
        else:  # random record: ~0 hits in a 2^50 word space
            q_parts.append(rng.integers(0, 4, size=qread_len, dtype=np.uint8))
    codes_q = np.concatenate(q_parts)
    off_q = np.arange(0, len(codes_q) + 1, qread_len, dtype=np.int64)
    return genome, off_i, codes_q, off_q


def _n_kmers(offsets: np.ndarray) -> int:
    return int(np.maximum(np.diff(offsets) - (K - 1), 0).sum())


def _rates(n: int, seconds: list) -> list:
    return [round(n / s, 1) for s in seconds]


def _ratio(x):
    return round(x, 3) if x is not None else None


# --- static build + query (config 1) and the genome records --------------------


def _build_query(label: str, codes_i, off_i, codes_q, off_q, chunk: int,
                 pending_cap: int, repeats: int, canonical: bool, device):
    """Insert stream i into a fresh index and count-query stream q (stream
    i itself when `codes_q` is None: one PackedStream, as `bench.py`'s
    `run_tpu` stages one), each repeat; -> the best repeat's counts and
    times, with every repeat's combined seconds under "repeats_s"."""
    best, walls = None, []
    for r_i in range(repeats):
        idx = CBL(k=K, chunk_size=chunk, pending_cap=pending_cap,
                  canonical=canonical, device=device)
        # Stage the input in device memory BEFORE the timers, mirroring
        # the baseline's accounting (it reads the codes into RAM before
        # its timers); staging is reported apart.
        t_s = time.perf_counter()
        psi = idx.pack_stream(codes_i, off_i)
        psq = psi if codes_q is None else idx.pack_stream(codes_q, off_q)
        _sync(idx.device)
        stage_s = time.perf_counter() - t_s
        # One sync: enqueue insert, count, query, then ONE host read of the
        # three scalars; the split at t1 is enqueue time only.
        t0 = time.perf_counter()
        idx.insert_codes_stream(psi)
        n_dev = idx.count_device()
        t1 = time.perf_counter()
        total_dev, pos_dev = idx.query_codes_stream(psq, lazy=True)
        distinct, total, positive = torch.stack(
            [n_dev.long(), total_dev.long(), pos_dev.long()]).tolist()
        t2 = time.perf_counter()
        del idx, psi, psq, n_dev, total_dev, pos_dev
        r = {"distinct": distinct, "total": total, "positive": positive,
             "insert_s": t1 - t0, "query_s": t2 - t1}
        walls.append(t2 - t0)
        hits = (f" hit-rate {positive / max(total, 1):.3f}"
                if codes_q is not None else "")
        _eprint(f"  {label}repeat {r_i}: stage {stage_s:.3f}s combined "
                f"{t2 - t0:.3f}s (enqueue split {r['insert_s']:.3f}/"
                f"{r['query_s']:.3f}){hits}")
        if best is None or t2 - t0 < best["insert_s"] + best["query_s"]:
            best = r
    best["repeats_s"] = walls
    return best


def run_static(codes: np.ndarray, chunk: int, pending_cap: int,
               repeats: int = 2, canonical: bool = False, device="cuda"):
    """`bench.py`'s `run_tpu`: one record of `codes` at K=25, built and
    self-queried; the first repeat pays for the library load and the
    allocator's warm-up, so the best is kept."""
    offsets = np.array([0, len(codes)], dtype=np.int64)
    return _build_query("", codes, offsets, None, None, chunk, pending_cap,
                        repeats, canonical, device)


def run_tpu_records(codes_i, off_i, codes_q, off_q, chunk: int,
                    pending_cap: int, repeats: int, canonical: bool = False,
                    device="cuda"):
    return _build_query("genome ", codes_i, off_i, codes_q, off_q, chunk,
                        pending_cap, repeats, canonical, device)


def collect_static(args, codes, canonical: bool = False) -> dict:
    n_kmers = args.bases - K + 1
    base = None
    label = " canonical" if canonical else ""
    with _peak_memory(f"static{label}", args.device):
        if not args.skip_baseline:
            base = run_baseline(codes, canonical=canonical)
            _eprint(f"baseline{label} (1 CPU core): {base}")
        ours = run_static(codes, args.chunk, args.pending_cap, args.repeats,
                          canonical=canonical, device=args.device)
    _eprint(f"cbl_tpu_torch{label}: {ours}")
    if base is not None:
        check_count(f"static{label} distinct", ours["distinct"],
                    base["distinct"])
    check(ours["positive"] == ours["total"] == n_kmers,
          f"query mismatch: {ours}")
    combined = 2 * n_kmers / (ours["insert_s"] + ours["query_s"])
    vs = None
    if base is not None:
        vs = combined / (2 * n_kmers / (base["insert_s"] + base["query_s"]))
    return {"kmers_per_s": combined, "vs_baseline": vs,
            "repeats": _rates(2 * n_kmers, ours["repeats_s"])}


def collect_genome(args, canonical: bool = False) -> dict:
    codes_i, off_i, codes_q, off_q = make_genome_corpus(args.bases)
    nk_i, nk_q = _n_kmers(off_i), _n_kmers(off_q)
    base = None
    label = " canonical" if canonical else ""
    with _peak_memory(f"genome{label}", args.device):
        if not args.skip_baseline:
            base = run_baseline_records(codes_i, off_i, codes_q, off_q,
                                        canonical=canonical)
            _eprint(f"baseline genome (1 CPU core): {base}")
        ours = run_tpu_records(codes_i, off_i, codes_q, off_q, args.chunk,
                               args.pending_cap, args.repeats,
                               canonical=canonical, device=args.device)
    _eprint(f"cbl_tpu_torch genome: {ours}")
    check(ours["total"] == nk_q, (ours["total"], nk_q))
    check(0 < ours["positive"] < ours["total"], ours)  # real misses
    rate = (nk_i + nk_q) / (ours["insert_s"] + ours["query_s"])
    vs = None
    if base is not None:
        check_count(f"genome{label} distinct", ours["distinct"],
                    base["distinct"])
        check_count(f"genome{label} positive", ours["positive"],
                    base["positive"])
        vs = rate / ((nk_i + nk_q) / (base["insert_s"] + base["query_s"]))
    return {"kmers_per_s": rate, "vs_baseline": vs,
            "repeats": _rates(nk_i + nk_q, ours["repeats_s"])}


def mode_genome(args) -> dict:
    g = collect_genome(args, canonical=args.canonical)
    canon = ", canonical" if args.canonical else ""
    return {
        "metric": "insert_seq+contains_seq k-mers/s per chip (K=25"
        f"{canon}, {args.bases/1e6:.0f}Mbp repeat-rich genome records, "
        "~50% query hit rate)",
        "value": round(g["kmers_per_s"], 1),
        "unit": "kmers/s",
        "vs_baseline": _ratio(g["vs_baseline"]),
        "value_repeats": g["repeats"],
    }


# --- interleaved rounds (config 2) and on a one-shard mesh (config 5) ----------


def _rounds(idx, codes: np.ndarray):
    """`SEGS` rounds of `bench.py`'s op stream on `idx` (a CBL or a
    ShardedCBL): round i inserts segment i, queries segment max(i-1, 0)
    and removes the first half of segment i; staging is inside the wall.
    -> (ops, device positive sum, t0)."""
    sb = len(codes) // SEGS
    t0 = time.perf_counter()
    off1 = np.array([0, sb], dtype=np.int64)
    off_h = np.array([0, sb // 2], dtype=np.int64)
    segs = [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
            for i in range(SEGS)]
    halves = [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
              for i in range(SEGS)]
    ops, pos_dev = 0, None
    for i in range(SEGS):
        _, p = idx.dynamic_round(segs[i], segs[i - 1 if i else 0], halves[i],
                                 lazy=True)
        pos_dev = p if pos_dev is None else pos_dev + p
        ops += 2 * (sb - K + 1) + sb // 2 - K + 1
    return ops, pos_dev, t0


def _best_rounds(label: str, make_index, live_of, codes, repeats: int):
    best, walls = None, []
    for r_i in range(repeats):
        idx = make_index()
        ops, pos_dev, t0 = _rounds(idx, codes)
        # one sync: the distinct count (the last scan's) and the positives
        n, positive = torch.stack(
            [live_of(idx).long(), pos_dev.long()]).tolist()
        total_s = time.perf_counter() - t0
        del idx, pos_dev
        walls.append(total_s)
        r = {"ops": ops, "distinct": n, "positive": positive,
             "total_s": total_s}
        _eprint(f"  {label} repeat {r_i}: {total_s:.3f}s")
        if best is None or total_s < best["total_s"]:
            best = r
    best["repeats_s"] = walls
    return best


def run_tpu_dynamic(codes: np.ndarray, repeats: int, device="cuda"):
    """Interleaved insert/query/remove rounds (BASELINE config 2); the
    workload matches bench/baseline.cpp run_dynamic exactly."""
    return _best_rounds("dynamic", lambda: CBL(k=K, device=device),
                        lambda idx: idx.count_device(), codes, repeats)


def run_tpu_sharded_dynamic(codes: np.ndarray, repeats: int, device="cuda"):
    """The dynamic workload on a `ShardedCBL` of ONE shard on `device`
    (config 5): the sharded sorted-log rounds, the same op stream."""
    from .parallel import ShardedCBL, make_mesh

    mesh = make_mesh([torch.device(device)])
    return _best_rounds("sharded-dynamic (D=1)",
                        lambda: ShardedCBL(k=K, mesh=mesh),
                        lambda idx: idx.slog.live, codes, repeats)


def _collect_rounds(args, codes, base, label: str, run) -> dict:
    with _peak_memory(label, args.device):
        if base is None and not args.skip_baseline:
            base = run_baseline_dynamic(codes)
            _eprint(f"baseline dynamic: {base}")
        ours = run(codes, args.repeats, device=args.device)
    _eprint(f"cbl_tpu_torch {label}: {ours}")
    vs = None
    if base is not None:
        check_count(f"{label} ops", ours["ops"], base["ops"])
        check_count(f"{label} distinct", ours["distinct"], base["distinct"])
        check_count(f"{label} positive", ours["positive"], base["positive"])
        vs = (ours["ops"] / ours["total_s"]) / base["ops_per_s"]
    return {"ops_per_s": ours["ops"] / ours["total_s"], "vs_local": vs,
            "base": base, "repeats": _rates(ours["ops"], ours["repeats_s"])}


def collect_dynamic(args, codes, base=None) -> dict:
    return _collect_rounds(args, codes, base, "dynamic", run_tpu_dynamic)


def collect_sharded_dynamic(args, codes, base=None) -> dict:
    return _collect_rounds(args, codes, base, "sharded-dynamic",
                           run_tpu_sharded_dynamic)


def mode_dynamic(args, codes) -> dict:
    r = collect_dynamic(args, codes)
    return {
        "metric": "interleaved insert/remove/query ops/s (K=25, "
        f"{args.bases/1e6:.0f}Mbp, {SEGS} rounds)",
        "value": round(r["ops_per_s"], 1),
        "unit": "kmer-ops/s",
        "vs_baseline": _ratio(r["vs_local"]),
        "value_repeats": r["repeats"],
    }


def mode_sharded_dynamic(args, codes) -> dict:
    r = collect_sharded_dynamic(args, codes)
    return {
        "metric": "SHARDED (D=1 mesh) interleaved insert/remove/query "
        f"ops/s (K=25, {args.bases/1e6:.0f}Mbp, {SEGS} rounds)",
        "value": round(r["ops_per_s"], 1),
        "unit": "kmer-ops/s",
        "vs_baseline": _ratio(r["vs_local"]),
        "value_repeats": r["repeats"],
    }


# --- K=59 build + list (config 3) ------------------------------------------------


def mode_largek(args, codes) -> dict:
    """BASELINE config 3: K=59 build + full enumeration (list); the list's
    copy to the host is inside the window, as the metric defines it."""
    k = 59
    offsets = np.array([0, len(codes)], dtype=np.int64)
    nk = len(codes) - k + 1
    best, rates = None, []
    with _peak_memory("largek", args.device):
        for r_i in range(args.repeats):
            idx = CBL(k=k, prefix_bits=28, device=args.device)
            t0 = time.perf_counter()
            idx.insert_codes_stream(codes, offsets)
            n = int(idx.count_device())  # single scalar sync
            t1 = time.perf_counter()
            lst = idx.kmers_limbs()
            t2 = time.perf_counter()
            check(lst.shape[0] == n, (lst.shape, n))
            del idx, lst
            r = {"distinct": n, "build_s": t1 - t0, "list_s": t2 - t1}
            rates.append(round((nk + n) / (t2 - t0), 1))
            _eprint(f"  largek repeat {r_i}: {r}")
            if best is None or r["build_s"] + r["list_s"] < (
                    best["build_s"] + best["list_s"]):
                best = r
    return {
        "metric": f"K=59 build+list k-mers/s ({args.bases/1e6:.0f}Mbp)",
        "value": round((nk + best["distinct"]) /
                       (best["build_s"] + best["list_s"]), 1),
        "unit": "kmers/s",
        "vs_baseline": None,
        "value_repeats": rates,
    }


# --- set algebra + serde (config 4) ---------------------------------------------

ALGEBRA_OPS = (("union", lambda a, b: a | b), ("inter", lambda a, b: a & b),
               ("diff", lambda a, b: a - b), ("symdiff", lambda a, b: a ^ b))


def algebra_baseline(codes: np.ndarray) -> dict:
    """The four results' counts from the baseline: |a| and |b| are its
    counts of the two halves, |a ∪ b| its `records` count of both halves
    as two records (no k-mer spans the cut), the rest by the identities."""
    half = len(codes) // 2
    na = run_baseline(codes[:half])["distinct"]
    nb = run_baseline(codes[half:])["distinct"]
    both = np.array([0, half, len(codes)], dtype=np.int64)
    one = np.array([0, K], dtype=np.int64)
    union = run_baseline_records(codes, both, codes[:K], one)["distinct"]
    inter = na + nb - union
    return {"na": na, "nb": nb, "union": union, "inter": inter,
            "diff": na - inter, "symdiff": union - inter}


def collect_algebra(args, codes) -> dict:
    """BASELINE config 4: two-index union/inter/diff/symdiff + serde."""
    half = len(codes) // 2
    base = None
    if not args.skip_baseline:
        base = algebra_baseline(codes)
        _eprint(f"baseline algebra counts: {base}")
    dev = args.device
    rows, counts = {}, {}
    with _peak_memory("algebra", dev):
        a = CBL(k=K, device=dev)
        a.insert_codes_stream(codes[:half],
                              np.array([0, half], dtype=np.int64))
        b = CBL(k=K, device=dev)
        b.insert_codes_stream(codes[half:], np.array([0, len(codes) - half],
                                                     dtype=np.int64))
        na, nb = a.count(), b.count()
        for name, op in ALGEBRA_OPS:
            ts = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                c = op(a, b)
                counts[name] = c.count()
                ts.append(time.perf_counter() - t0)
                del c
            rows[name] = ts
            _eprint(f"  {name}: {min(ts)*1e3:.0f}ms")
        del b
        with tempfile.TemporaryDirectory(prefix="cbl_bench_") as tmp:
            path = os.path.join(tmp, "bench_a.cblx.npz")
            t0 = time.perf_counter()
            a.save_to_file(path)
            a2 = CBL.load_from_file(path, device=dev)
            check(a2.count() == na, (a2.count(), na))
            serde_s = time.perf_counter() - t0
        del a, a2
    _eprint(f"  serde round-trip: {serde_s:.2f}s ({na} kmers)")
    if base is not None:
        check_count("algebra |a|", na, base["na"])
        check_count("algebra |b|", nb, base["nb"])
        for name, _ in ALGEBRA_OPS:
            check_count(f"algebra {name}", counts[name], base[name])
    return {"times_s": rows, "serde_s": serde_s, "na": na, "nb": nb}


def mode_algebra(args, codes) -> dict:
    r = collect_algebra(args, codes)
    total_rows = 4 * (r["na"] + r["nb"])
    per_repeat = [sum(ts) for ts in zip(*r["times_s"].values())]
    return {
        "metric": "set-algebra rows/s over 4 ops "
        f"(2x{r['na']/1e6:.1f}M kmers) + serde",
        "value": round(total_rows / sum(min(ts) for ts in
                                        r["times_s"].values()), 1),
        "unit": "rows/s",
        "vs_baseline": None,
        "value_repeats": _rates(total_rows, per_repeat),
    }


# --- the command line -----------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cbl_tpu_torch.bench",
        description="cbl_tpu_torch benchmark: one JSON line on stdout")
    ap.add_argument("--bases", type=int, default=32_000_000)
    ap.add_argument("--chunk", type=int, default=1 << 19)
    ap.add_argument("--pending-cap", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; there is no CPU "
                    "fallback, --device cpu runs the plain tensor path)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--canonical", action="store_true",
                    help="canonical (strand-folded) k-mers for static/"
                    "genome modes; counts cross-checked against the "
                    "baseline's min(kmer, revcomp) oracle")
    ap.add_argument("--headline-only", action="store_true",
                    help="default mode: print only the static headline "
                    "(skip the dynamic/genome/algebra/canonical extra "
                    "keys measured in the same run)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the benched "
                    "workload into DIR/trace.json (cbl_tpu_torch.profiling)")
    ap.add_argument(
        "--mode", default="static", choices=MODES,
        help="static = BASELINE config 1 (the headline); dynamic/largek/"
        "algebra = configs 2-4; genome = config 1 on repeat-rich "
        "multi-record data with ~50%% query hit rate; sharded-dynamic = "
        "config 5 (config 2 on a one-shard ShardedCBL)",
    )
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        _eprint(f"cbl_tpu_torch.bench: {e} (on the command line: "
                "--device cpu)")
        return 2
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    if args.trace:
        from .profiling import trace

        _eprint(f"tracing into {args.trace}")
        with trace(args.trace):
            out = _run_mode(args)
    else:
        out = _run_mode(args)
    out["device"] = device_info(args.device)
    out["launches"] = dict(LAUNCHES)
    print(json.dumps(out), flush=True)
    return 0


def _run_mode(args) -> dict:
    if args.mode == "genome":
        return mode_genome(args)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.bases, dtype=np.uint8)
    if args.mode == "dynamic":
        return mode_dynamic(args, codes)
    if args.mode == "sharded-dynamic":
        return mode_sharded_dynamic(args, codes)
    if args.mode == "largek":
        return mode_largek(args, codes)
    if args.mode == "algebra":
        return mode_algebra(args, codes)
    st = collect_static(args, codes, canonical=args.canonical)
    canon = ", canonical" if args.canonical else ""
    out = {
        "metric": "insert_seq+contains_seq k-mers/s per chip (K=25"
        f"{canon}, {args.bases/1e6:.0f}Mbp synthetic)",
        "value": round(st["kmers_per_s"], 1),
        "unit": "kmers/s",
        "vs_baseline": _ratio(st["vs_baseline"]),
        "value_repeats": st["repeats"],
    }
    if args.headline_only or args.canonical:
        return out
    # The same-run extras: every north-star number in ONE line, each count
    # checked against bench/baseline.cpp as the headline's is; an extra
    # that fails raises.
    c = collect_static(args, codes, canonical=True)
    out.update(canonical_kmers_per_s=round(c["kmers_per_s"], 1),
               canonical_vs_baseline=_ratio(c["vs_baseline"]),
               canonical_kmers_per_s_repeats=c["repeats"])
    d = collect_dynamic(args, codes)
    out.update(dynamic_ops_per_s=round(d["ops_per_s"], 1),
               dynamic_vs_local=_ratio(d["vs_local"]),
               dynamic_ops_per_s_repeats=d["repeats"])
    s = collect_sharded_dynamic(args, codes, base=d["base"])
    out.update(sharded_dynamic_ops_per_s=round(s["ops_per_s"], 1),
               sharded_dynamic_ratio=round(s["ops_per_s"] / d["ops_per_s"],
                                           3),
               sharded_dynamic_ops_per_s_repeats=s["repeats"])
    g = collect_genome(args)
    out.update(genome_kmers_per_s=round(g["kmers_per_s"], 1),
               genome_vs_baseline=_ratio(g["vs_baseline"]),
               genome_kmers_per_s_repeats=g["repeats"])
    a = collect_algebra(args, codes)
    out.update(
        algebra_ms={n: round(min(ts) * 1e3, 1)
                    for n, ts in a["times_s"].items()},
        algebra_ms_repeats={n: [round(t * 1e3, 1) for t in ts]
                            for n, ts in a["times_s"].items()},
        serde_s=round(a["serde_s"], 3))
    return out


if __name__ == "__main__":
    sys.exit(main())
