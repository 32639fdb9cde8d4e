#!/usr/bin/env python3
"""Compare the host staging of `chip_smoke.py`'s phases 3, 5, 6 and 8
across versions of `cbl_tpu_torch` on one CUDA card, in one run.

    python3 tools/probe_staging.py PATH [PATH ...]

Each PATH is a directory that holds a `cbl_tpu_torch/` package (`.` for
this checkout, or a copy of another commit's package unpacked under a
git-ignored directory).  The versions run in the order given, each in a
process of its own, so `old new new old` brackets a change.  Per
version, on `chip_smoke.py`'s 32 Mbp (`default_rng(0)`, K=25), one
warm-up and one timed run of each of its run functions:
- phase 3 (`static_run`, plain): the staging (`pack_stream` of one
  record, to a sync), the insert and the query by CUDA events;
- phase 5 (`dynamic_run`): the staging of the 8 rounds' 16 streams and
  the device rounds by CUDA events;
- phase 6 (`separate_run`, run A under `mergepath`): the staging and the
  calls by CUDA events;
- phase 8 (`contains_run`): `contains_codes_stream` of the 32 Mbp
  against its own index: the staging inside the call, the word pipeline
  and sort-join by CUDA events, and the call's wall.
Last it prints the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(path: str) -> None:
    sys.path.insert(0, os.path.abspath(path))
    sys.path.append(REPO)
    import numpy as np

    import cbl_tpu_torch
    from cbl_tpu_torch import CBL
    from chip_smoke import (MAIN_BASES, contains_run, dynamic_run,
                            separate_run, static_run)

    native = os.path.exists(os.path.join(
        os.path.dirname(cbl_tpu_torch.__file__), "io", "native", "fastx.cpp"))
    print(f"{path}: {cbl_tpu_torch.__file__} (native packer: {native})",
          flush=True)
    codes = np.random.default_rng(0).integers(0, 4, size=MAIN_BASES,
                                              dtype=np.uint8)
    offsets = np.array([0, len(codes)], dtype=np.int64)
    for _ in range(2):  # the second run is the one printed
        _, _, r3 = static_run(codes, offsets, canonical=False)
        _, _, r5 = dynamic_run(codes, timed=True)
        _, _, r6 = separate_run(codes, "mergepath", log_at_query=False)
        idx = CBL(k=25, device="cuda")
        idx.insert_codes_stream(codes, offsets)
        masks, r8 = contains_run(idx, codes, offsets)
        assert all(m.all() for m in masks)
        del idx, masks
    print(f"  phase 3 static plain: stage {r3['stage_s'] * 1e3:.2f} ms, "
          f"insert {r3['insert_ms']:.3f} ms, query {r3['query_ms']:.3f} ms "
          f"(device events)")
    print(f"  phase 5 dynamic rounds: stage {r5['stage_s'] * 1e3:.2f} ms, "
          f"device rounds {r5['rounds_ms']:.3f} ms (device events), wall "
          f"with staging {r5['wall_s'] * 1e3:.2f} ms")
    print(f"  phase 6 separate calls run A (mergepath): stage "
          f"{r6['stage_s'] * 1e3:.2f} ms, calls {r6['calls_ms']:.3f} ms "
          f"(device events), wall with staging {r6['wall_s'] * 1e3:.2f} ms")
    print(f"  phase 8 contains_codes_stream (self): staging "
          f"{r8['stage_ms']:.2f} ms, word pipeline + sort-join "
          f"{r8['device_ms']:.3f} ms (device events), wall "
          f"{r8['wall_s'] * 1e3:.2f} ms", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        probe(sys.argv[2])
        return 0
    if not sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    for path in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        path], cwd=REPO, check=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
