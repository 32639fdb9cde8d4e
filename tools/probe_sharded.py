#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 13 (a)-(c) alone on one CUDA card, then
profile the sharded paths.

    python3 tools/probe_sharded.py

On `chip_smoke.py`'s 32 Mbp (`default_rng(0)`, K=25), after building the
kernels and `bench/baseline.cpp`:
1. phase 5's single-index rounds (`dynamic_run`, one warm-up and one
   timed run) beside BASELINE config 5 on a one-shard mesh
   (`sharded_dynamic_run`), their ops/s ratio; the D = 1 bulk build and
   query (`sharded_bulk_run`); the 4-shard checks (`sharded_mesh_check`),
   each held to `bench/baseline.cpp` as in the phase;
2. `torch.profiler` tables (device time by kernel, host clock, device
   busy and idle share) of the D = 1 bulk insert and query (twice: the
   first is the process's first sharded call) and of config 5's 8
   rounds on 1 and on 4 shards of the card.
It prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def show(prof, title: str, wall_s: float) -> None:
    import torch

    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"== {title}: host clock {wall_s * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms, idle {1 - busy / (wall_s * 1e3):.1%}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=14, max_name_column_width=60),
          flush=True)


def checks(cs, codes: np.ndarray, offsets: np.ndarray) -> None:
    """Phase 13 (a)-(c) with the phase's baselines."""
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.parallel import make_mesh

    exe = cs.build_baseline()
    base = cs.run_baseline(exe, codes, None)
    base_dyn = cs.run_baseline(exe, codes, "dynamic")
    print("baselines", base, base_dyn, flush=True)
    cs.dynamic_run(codes, timed=False)
    _, _, dyn = cs.dynamic_run(codes, timed=True)
    print("phase 5, single index",
          {k: v for k, v in dyn.items() if k not in ("launches", "prof")},
          flush=True)
    mesh1 = make_mesh()[:1]
    cs.sharded_dynamic_run(codes, mesh1, timed=False)
    sdyn = cs.sharded_dynamic_run(codes, mesh1, timed=True)
    ratio = (sdyn["ops"] / sdyn["wall_s"]) / (dyn["ops"] / dyn["wall_s"])
    print("config 5, D = 1", sdyn, "ratio to the single index", ratio,
          flush=True)
    assert (sdyn["distinct"], sdyn["positive"]) == (
        base_dyn["distinct"], base_dyn["positive"])
    bulk = cs.sharded_bulk_run(codes, offsets, mesh1)
    bulk.pop("idx")
    print("bulk, D = 1", bulk, flush=True)
    assert bulk["distinct"] == base["distinct"]
    half = len(codes) // 2
    a, b = CBL(k=cs.K), CBL(k=cs.K)
    a.insert_codes_stream(codes[:half], np.array([0, half]))
    b.insert_codes_stream(codes[half:], np.array([0, len(codes) - half]))
    alg = {"a": a.count(), "b": b.count()}
    for name, op in cs.ALGEBRA_OPS:
        alg[name] = op(a, b).count()
    del a, b
    mesh = cs.sharded_mesh_check(codes, offsets, base, base_dyn, alg)
    print(f"{cs.SHARDS} shards", mesh, flush=True)
    print(f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def profiles(cs, codes: np.ndarray, offsets: np.ndarray) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cbl_tpu_torch.parallel import ShardedCBL, make_mesh

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mesh1 = make_mesh()[:1]
    for rep in range(2):
        idx = ShardedCBL(k=cs.K, mesh=mesh1)
        torch.cuda.synchronize()
        with profile(activities=acts) as p_ins:
            t0 = time.perf_counter()
            idx.insert_codes_stream(codes, offsets)
            torch.cuda.synchronize()
            t_ins = time.perf_counter() - t0
        with profile(activities=acts) as p_qry:
            t0 = time.perf_counter()
            r = idx.query_codes_stream(codes, offsets)
            t_qry = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(idx._sub_slab_groups(codes, offsets))
        t_pack = time.perf_counter() - t0
        print(f"repeat {rep}: insert {t_ins * 1e3:.1f} ms, query "
              f"{t_qry * 1e3:.1f} ms {r}; the host's packing of the groups "
              f"alone {t_pack * 1e3:.1f} ms", flush=True)
    show(p_ins, "D = 1 bulk insert", t_ins)
    show(p_qry, "D = 1 bulk query", t_qry)
    sb = len(codes) // cs.SEGS
    off1, off_h = np.array([0, sb]), np.array([0, sb // 2])
    for shards in (1, cs.SHARDS):
        mesh = [torch.device("cuda", 0)] * shards
        cs.sharded_dynamic_run(codes, mesh, timed=False)  # warm-up
        idx = ShardedCBL(k=cs.K, mesh=mesh)
        segs = [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
                for i in range(cs.SEGS)]
        halves = [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
                  for i in range(cs.SEGS)]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(cs.SEGS):
                idx.dynamic_round(segs[i], segs[max(i - 1, 0)], halves[i],
                                  lazy=True)
            n = idx.count()
            t = time.perf_counter() - t0
        show(prof, f"config 5's rounds on {shards} shard(s), count {n}", t)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sharded: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cbl_tpu_torch.ops import _build

    print(cs.card_line(), flush=True)
    _build.build()
    _build.library()
    codes = np.random.default_rng(0).integers(0, 4, size=cs.MAIN_BASES,
                                              dtype=np.uint8)
    offsets = np.array([0, len(codes)], dtype=np.int64)
    checks(cs, codes, offsets)
    profiles(cs, codes, offsets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
