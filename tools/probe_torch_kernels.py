#!/usr/bin/env python3
"""Compare the merge and sort kernels (B3, B5, B6, B7) of several versions of
`cbl_tpu_torch` on one CUDA card, in one run.

    python3 tools/probe_torch_kernels.py PATH [PATH ...]

Each PATH is a directory that holds a `cbl_tpu_torch/` package (`.` for
this checkout, or a copy of another commit's package unpacked under a
git-ignored directory).  The versions run in the order given, each in a
process of its own, so `old new new old` brackets the change.  Per
version it prints
- B3's time for 2^25 + 2^25 and 2^25 + 2^22 one-column keys (CUDA events,
  three means of 20 launches);
- where the version has B5, and where it has B6: device time by kernel
  name for one sort of 2^25 one-column keys and of 2^22 + 2^21
  two-column rows (`torch.profiler`, mean of 5); where it has B7: the
  same for one merge of 2^24 + 2^24 one-column keys;
- registers of, and the count of load, store and barrier operations in
  the machine code of, the merge and sort kernels (`nvcc`'s log and
  `cuobjdump -sass`).
Last it prints the card's name and power limit.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from pathlib import Path


def probe(path: str) -> None:
    sys.path.insert(0, path)
    # `time_ms` is chip_smoke.py's, at the root of this checkout
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.append(os.path.dirname(here))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import time_ms

    from cbl_tpu_torch.ops import _build, merge

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    def keys(n, hi=1 << 57):
        return torch.from_numpy(rng.integers(0, hi, size=n)).to(dev)

    for na, nb in ((1 << 25, 1 << 25), (1 << 25, 1 << 22)):
        a, b = torch.sort(keys(na)).values, torch.sort(keys(nb)).values
        ms = [round(time_ms(lambda: merge.merge_sorted(a, b), 20), 4)
              for _ in range(3)]
        print(f"{path}: B3 {na} + {nb} ms: {ms}")
    n = (1 << 22) + (1 << 21)
    sort_inputs = (("one column 2^25", (keys(1 << 25),)),
                   ("two columns 2^22 + 2^21",
                    ((keys(n, 1 << 56), keys(n, 1 << 32)),)))
    half = torch.sort(keys(1 << 24)).values
    cases = []  # (kernel, function, ((label, arguments), ...))
    if hasattr(merge, "sort_mergepath"):
        cases.append(("B5", merge.sort_mergepath, sort_inputs))
    try:
        from cbl_tpu_torch.ops import bitonic
    except ImportError:  # a version from before B6 and B7
        pass
    else:
        cases.append(("B6", bitonic.bitonic_sort, sort_inputs))
        cases.append(("B7", bitonic.bitonic_merge,
                      (("2^24 + 2^24", (half, half + 1)),)))
    for kernel, fn, inputs in cases:
        for label, args in inputs:
            fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn(*args)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.self_device_time_total > 0:
                    print(f"{path}: {kernel} {label}: "
                          f"{e.self_device_time_total / 5:9.1f} us a call, "
                          f"{e.count // 5:3d} x {e.key[:70]}")

    so, _ = _build.build()
    wanted = ("merge_tiles", "partition", "tile_sort", "cross_pass",
              "intile_pass", "first_pass")
    name = None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and name and any(w in name for w in wanted):
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
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        probe(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for path in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", path], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
