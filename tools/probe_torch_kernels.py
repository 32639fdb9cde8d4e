#!/usr/bin/env python3
"""Compare the scan, merge and sort kernels (B2, B3, B4, B5, B6, B7) of
several versions of `cbl_tpu_torch` on one CUDA card, in one run.

    python3 tools/probe_torch_kernels.py [--scans | --sorts | --merges | --wide] PATH [PATH ...]

Each PATH is a directory that holds a `cbl_tpu_torch/` package (`.` for
this checkout, or a copy of another commit's package unpacked under a
git-ignored directory).  The versions run in the order given, each in a
process of its own, so `old new new old` brackets the change.  Per
version it prints
- B2's time for a 2^25 delta array of many records (the static path's
  slab) and a 2^22 one of one record (a dynamic round's), and B4's for
  slogs of 2^26, 2^23 and 83,886,080 rows (`chip_smoke.slog_keys`) and
  of 2^24 rows with a 2^22-row query run (about 1000 tiles that hold no
  marker): CUDA events, three means of 20 launches, and the device time
  by kernel name (`torch.profiler`, mean of 5); then twice the device
  time of `chip_smoke.py`'s phase 5 (32 Mbp, 8 dynamic rounds, staging
  included) under the profiler: every kernel, and B2 and B4 alone;
- B3's time for 2^25 + 2^25, 2^24 + 2^24 and 2^25 + 2^22 one-column keys
  (CUDA events, three means of 20 launches);
- where the version has B5, and where it has B6: the time of one sort
  (CUDA events, three means of 5), the passes through device memory it
  launched, whether it equals `torch.sort`, and the device time by kernel
  name (`torch.profiler`, mean of 5) for 2^25 and 2^24 one-column keys, a
  fold's 2^26 + 2^21 keys with 75 % sentinels, 2^22 + 2^21 two-column
  rows and the sort-join's 2^25 two-column (word, position) rows
  (`chip_smoke.join_rows`), and `torch.sort`'s time for the same inputs
  (one stable pass a column); where it has B7: the same for one merge of
  2^24 + 2^24 one-column keys;
- registers of, and the count of load, store and barrier operations in
  the machine code of, the merge and sort kernels (`nvcc`'s log and
  `cuobjdump -sass`).
With `--scans` it runs only the B2 and B4 cases and their kernels' lines;
with `--sorts` only the one- and two-column sorts (B5, B6, `torch.sort`)
and the sort kernels' lines.
With `--merges` it runs only the merges of two sorted runs: B3 and B7 on
2^24 + 2^24 and 2^25 + 2^24 one-column keys, on a fold's 2^26 + 2^21
(word, seqtag) rows (three quarters of the index a sentinel tail) and on
2^22 + 2^21 (word, seqtag) rows (a log join), and `torch.sort` of both
runs at 2^25 + 2^25 and 2^24 + 2^24: CUDA events, three means of 20
launches, B7 held equal to B3, and B7's device time by kernel name
(`torch.profiler`, mean of 5); then the merge kernels' lines.
With `--wide` it runs only the three-column sorts and merges: B5 and B6
on 2^25 rows of `chip_smoke.wide_join_rows` queries (the K=59
sort-join's) beside three stable `torch.sort` passes (CUDA events, three
means of 5 sorts; the passes through device memory each launched; device
time by kernel name, mean of 3), then B3 and B7 on the sort-join's
2^25 + 2^25 rows (three means of 10); then the sort kernels' lines.
Last it prints the card's name and power limit.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from pathlib import Path


SCAN_KERNELS = ("lookback", "tile_sums", "apply", "slog_tile_max",
                "slog_count")
# B2 and B4 in the profiler's kernel names, old and new
SCAN_NAMES = ("::apply(", "tile_sums(", "slog_tile_max(", "slog_scan_tiles(",
              "slog_count(", "_lookback(")
SORT_KERNELS = ("merge_tiles", "merge_quads", "partition", "tile_sort",
                "cross_pass", "cross_fused", "intile_pass", "first_pass",
                "merge_multi", "keyed_cross", "keyed_intile")  # old and new
MERGE_KERNELS = ("merge_tiles", "partition", "cross_fused", "intile_pass",
                 "first_pass", "merge_small", "merge_tile", "tile_coranks")


def probe(path: str, only: str | None) -> None:
    sys.path.insert(0, path)
    # `time_ms` is chip_smoke.py's, at the root of this checkout
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.append(os.path.dirname(here))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MAIN_BASES, dynamic_run, slog_keys, time_ms

    from cbl_tpu_torch.ops import _build, merge, scan

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    def device_us(fn, label):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                print(f"{path}: {label}: {e.self_device_time_total / 5:9.1f}"
                      f" us a call, {e.count // 5:3d} x {e.key[:70]}")

    if only == "--merges":
        probe_merges(path, rng, device_us)
        print_kernels(path, MERGE_KERNELS)
        return
    if only == "--wide":
        probe_wide(path, device_us)
        print_kernels(path, SORT_KERNELS)
        return
    if only == "--sorts":
        probe_sorts(path, rng, device_us)
        print_kernels(path, SORT_KERNELS)
        return

    def blank_delta(n, n_records):
        """+1 / -1 interval deltas: `n_records` blanked halos of 24 rows,
        then the padded tail from row n - n / 32 on."""
        d = np.zeros(n + 1, dtype=np.int32)
        starts = np.sort(rng.choice(n - n // 32 - 24, n_records - 1,
                                    replace=False))
        np.add.at(d, starts, 1)
        np.add.at(d, starts + 24, -1)
        d[n - n // 32] += 1
        return torch.from_numpy(d[:n]).to(dev)

    scan_inputs = [
        ("B2 2^25, 8192 records", scan.blank_mask,
         (blank_delta(1 << 25, 8192),)),
        ("B2 2^22, one record", scan.blank_mask, (blank_delta(1 << 22, 1),)),
    ]
    for n, run in ((1 << 26, 0), (1 << 23, 0), (83_886_080, 0),
                   (1 << 24, 1 << 22)):
        scan_inputs.append((
            f"B4 {n}" + (f", a {run}-row query run" if run else ""),
            scan.slog_scan_counts, (slog_keys(rng, n, run), (5 << 2) | 2)))
    for label, fn, args in scan_inputs:
        ms = [round(time_ms(lambda: fn(*args), 20), 4) for _ in range(3)]
        print(f"{path}: {label} ms: {ms}")
        device_us(lambda: fn(*args), label)
    del scan_inputs
    # chip_smoke.py's main-path codes (default_rng(0)) in the 8 rounds
    codes = np.random.default_rng(0).integers(0, 4, size=MAIN_BASES,
                                              dtype=np.uint8)
    dynamic_run(codes, timed=False)  # warm-up
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dynamic_run(codes, timed=False)
            torch.cuda.synchronize()
        kernels = scans = 0.0
        for e in prof.key_averages():
            us = e.self_device_time_total
            if us > 0 and not e.key.startswith("Memcpy"):
                kernels += us
                scan = any(w in e.key for w in SCAN_NAMES)
                scans += us if scan else 0.0
                if scan or e.key.startswith("Memset"):
                    print(f"{path}: dynamic rounds: {us:9.1f} us, "
                          f"{e.count:3d} x {e.key[:60]}")
        print(f"{path}: dynamic rounds, 32 Mbp: kernels {kernels / 1e3:.3f}"
              f" ms, of which B2 and B4 {scans / 1e3:.3f} ms")
    if only == "--scans":
        print_kernels(path, SCAN_KERNELS)
        return

    def keys(n, hi=1 << 57):
        return torch.from_numpy(rng.integers(0, hi, size=n)).to(dev)

    for na, nb in ((1 << 25, 1 << 25), (1 << 24, 1 << 24),
                   (1 << 25, 1 << 22)):
        a, b = torch.sort(keys(na)).values, torch.sort(keys(nb)).values
        ms = [round(time_ms(lambda: merge.merge_sorted(a, b), 20), 4)
              for _ in range(3)]
        print(f"{path}: B3 {na} + {nb} ms: {ms}")
    probe_sorts(path, rng, device_us)
    print_kernels(path, SCAN_KERNELS + SORT_KERNELS)


def probe_sorts(path: str, rng, device_us) -> None:
    """B5 and B6 at one and two columns beside `torch.sort`, and B7 on
    2^24 + 2^24 keys, where the version has them."""
    import numpy as np
    import torch

    from chip_smoke import join_rows, time_ms

    from cbl_tpu_torch.ops import _build, merge

    dev = torch.device("cuda")

    def keys(n, hi=1 << 57):
        return torch.from_numpy(rng.integers(0, hi, size=n)).to(dev)

    n = (1 << 22) + (1 << 21)
    fold = keys((1 << 26) + (1 << 21))
    fold[torch.from_numpy(rng.random(fold.shape[0]) < 0.75).to(dev)] = (
        (1 << 63) - 1)
    _, q = join_rows(np.random.default_rng(7), 1 << 25, 1 << 56)
    sort_inputs = (("one column 2^25", (keys(1 << 25),)),
                   ("one column 2^24", (keys(1 << 24),)),
                   ("one column 2^26 + 2^21, 75 % sentinels", (fold,)),
                   ("two columns 2^22 + 2^21",
                    ((keys(n, 1 << 56), keys(n, 1 << 32)),)),
                   ("two columns 2^25, the sort-join's queries", (q,)))
    for label, (x,) in sort_inputs:
        ms = [round(time_ms(lambda: merge.sort_cols_plain(merge.as_cols(x)),
                            5), 4) for _ in range(2)]
        print(f"{path}: torch.sort {label}: {ms} ms")
    half = torch.sort(keys(1 << 24)).values
    cases = []  # (kernel, function, passes key, ((label, arguments), ...))
    if hasattr(merge, "sort_mergepath"):
        cases.append(("B5", merge.sort_mergepath, "sort", sort_inputs))
    try:
        from cbl_tpu_torch.ops import bitonic
    except ImportError:  # a version from before B6 and B7
        pass
    else:
        cases.append(("B6", bitonic.bitonic_sort, "bitonic_sort",
                      sort_inputs))
        cases.append(("B7", bitonic.bitonic_merge, "bitonic_merge",
                      (("2^24 + 2^24", (half, half + 1)),)))
    for kernel, fn, key, inputs in cases:
        for label, args in inputs:
            got = merge.as_cols(fn(*args))
            want = merge.as_cols(merge.sort_cols_plain(merge.as_cols(
                torch.cat(args) if kernel == "B7" else args[0])))
            same = all(torch.equal(a, b)
                       for a, b in zip(got, want, strict=True))
            passes = _build.PASSES.get(key)
            del got, want
            ms = [round(time_ms(lambda: fn(*args), 5), 4) for _ in range(3)]
            print(f"{path}: {kernel} {label}: {ms} ms, {passes} passes "
                  f"through device memory, == torch.sort: {same}")
            device_us(lambda: fn(*args), f"{kernel} {label}")


def probe_merges(path: str, rng, device_us) -> None:
    """B3 and B7 at the merge shapes of `--merges`."""
    import torch

    from chip_smoke import time_ms

    from cbl_tpu_torch.ops import bitonic, merge

    dev = torch.device("cuda")
    pad = (1 << 63) - 1

    def keys(n, hi=1 << 57):
        return torch.from_numpy(rng.integers(0, hi, size=n)).to(dev)

    def rows(n):
        return merge.sort_cols_plain((keys(n, 1 << 56), keys(n, 1 << 23)))

    for n in (1 << 25, 1 << 24):
        cat = keys(2 * n)
        ms = [round(time_ms(lambda: torch.sort(cat), 20), 4)
              for _ in range(3)]
        print(f"{path}: torch.sort of both runs, {n} + {n} ms: {ms}")
    del cat
    words = keys(1 << 26, 1 << 56)
    words[1 << 24:] = pad
    words = torch.sort(words).values
    cases = (
        ("2^24 + 2^24", torch.sort(keys(1 << 24)).values,
         torch.sort(keys(1 << 24)).values),
        ("2^25 + 2^24", torch.sort(keys(1 << 25)).values,
         torch.sort(keys(1 << 24)).values),
        ("two columns 2^26 + 2^21, a fold",
         (words, torch.ones_like(words)), rows(1 << 21)),
        ("two columns 2^22 + 2^21, a log join", rows(1 << 22),
         rows(1 << 21)),
    )
    del words
    for label, a, b in cases:
        same = all(torch.equal(x, y) for x, y in zip(
            merge.as_cols(bitonic.bitonic_merge(a, b)),
            merge.as_cols(merge.merge_sorted(a, b)), strict=True))
        for kernel, fn in (("B3", merge.merge_sorted),
                           ("B7", bitonic.bitonic_merge)):
            ms = [round(time_ms(lambda: fn(a, b), 20), 4) for _ in range(3)]
            print(f"{path}: {kernel} {label} ms: {ms}")
        print(f"{path}: B7 {label} == B3: {same}")
        device_us(lambda: bitonic.bitonic_merge(a, b), f"B7 {label}")


def probe_wide(path: str, device_us) -> None:
    """B5 and B6 at three columns on 2^25 rows, beside three stable
    `torch.sort` passes; B3 and B7 at three columns on 2^25 + 2^25."""
    import numpy as np
    import torch

    from chip_smoke import time_ms, wide_join_rows

    from cbl_tpu_torch.ops import _build, bitonic, merge

    d, q = wide_join_rows(np.random.default_rng(12), 1 << 25)
    want = merge.sort_cols_plain(q)
    ms = [round(time_ms(lambda: merge.sort_cols_plain(q), 3), 4)
          for _ in range(2)]
    print(f"{path}: three stable torch.sort passes, three columns 2^25 ms: "
          f"{ms}")
    for kernel, fn, key in (("B5", merge.sort_mergepath, "sort"),
                            ("B6", bitonic.bitonic_sort, "bitonic_sort")):
        same = all(torch.equal(a, b)
                   for a, b in zip(fn(q), want, strict=True))
        passes = _build.PASSES[key]
        ms = [round(time_ms(lambda: fn(q), 5), 4) for _ in range(3)]
        print(f"{path}: {kernel} three columns 2^25 ms: {ms}, {passes} "
              f"passes through device memory, == torch.sort: {same}")
        device_us(lambda: fn(q), f"{kernel} three columns 2^25")
    for kernel, fn in (("B3", merge.merge_sorted),
                       ("B7", bitonic.bitonic_merge)):
        ms = [round(time_ms(lambda: fn(d, want), 10), 4) for _ in range(3)]
        print(f"{path}: {kernel} three columns 2^25 + 2^25 ms: {ms}")


def print_kernels(path: str, wanted: tuple) -> None:
    """Registers and spills (`nvcc`'s log) and load, store and barrier
    counts (the machine code) of the kernels whose names hold one of
    `wanted`."""
    from cbl_tpu_torch.ops import _build

    so, _ = _build.build()
    name = None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif (("registers" in line or "spill" in line) and name
              and any(w in name for w in wanted)):
            print(f"{path}: {name[-50:]}: {line.strip()}")
    # cuobjdump lies beside the nvcc that built the library
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True)
    counts: dict = collections.defaultdict(collections.Counter)
    fn = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)",
                      line)
        if m and fn:
            op = m.group(1).split(".")[0]
            counts[fn]["total"] += 1
            if op in ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL",
                      "BAR"):
                counts[fn][op] += 1
    for fn, c in counts.items():
        if any(w in fn for w in wanted):
            print(f"{path}: {fn[-50:]}: {dict(c)}")


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        probe(args[-1], only=args[1] if len(args) == 3 else None)
        return 0
    only = (args[:1] if args[:1] in (["--scans"], ["--sorts"], ["--merges"],
                                     ["--wide"]) else [])
    paths = args[len(only):]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for path in paths:
        subprocess.run([sys.executable, __file__, "--one", *only, path],
                       check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
