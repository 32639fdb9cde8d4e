"""Run one cell of `BENCHMARK.json` once and print one JSON line.

    python -m kmerbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, in order:
1. refuses to start where a CBL_TORCH_* variable is set (the cell measures
   the port's defaults), and where no CUDA card, or fewer than the cell
   asks for, is present: there is no CPU fallback;
2. set-up: generates the cell's traffic from the seed on the host, stages
   it on the card and warms every shape the window uses (the mix's loop
   kind, `loops/<kind>.py`);
   `setup_s` runs from the start of the process to the first timed batch;
3. the window: the loop kind's drive, a closed loop of `--seconds` by
   default (`drive`); with `--trace 1` under `torch.profiler` and with
   the program's span recording on (`trace.profiled`), which the
   `--trace 0` run, whose numbers are the end-to-end metrics, never
   turns on;
4. reads the peak device memory, then what the program holds (counts,
   exported k-mers), frees the program's state, works every answer out
   again with the plain reference and compares (`checks`: counts of
   disagreements, each held to its limit, 0);
5. fails where any module of `jax`, `jaxlib`, `flax` or `cbl_tpu` (whole
   top-level names) was loaded, or where the window launched none of a
   kernel group that the cell's mix names;
6. prints the numbers compared beside their limits as the last lines of
   stderr, and the result as the last line of stdout: `correct`,
   `attempted`, `failed` (window batches answered wrong), `metrics` (the
   cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
   `device`, with `--trace 1` `breakdown`, and `checks` last; with
   `--trace 1` the window's split by the program's spans
   (`program_spans.report`) goes to stderr before the checks.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cbl_tpu")
ENV_PREFIX = "CBL_TORCH_"


def process_age_s() -> float:
    """Seconds since this process started (`/proc`, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    top = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN_MODULES))


def _eprint(*msg) -> None:
    print(*msg, file=sys.stderr, flush=True)


def _p95(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             system=None, base=None) -> dict:
    """One run of `cell` (`spec.Cell`) on `device`; -> the result line as
    a dict.  `system` replaces the program (the control, in tests)."""
    import torch

    from . import drive, kernels, spec
    from .loop import LIMIT
    from .trace import TraceView, profiled

    _eprint(f"start: {process_age_s():.2f} s after the process started "
            "(interpreter, imports, CUDA context)")
    base = base or spec.ROOT
    spans = drive.Spans()
    mix = cell.mix
    Loop = spec.loop(mix["loop"], base)
    groups = kernels.Groups(base)
    t_gen = time.perf_counter()
    traffic = Loop.make_traffic(mix, cell.config, seed)
    t_stage = time.perf_counter()
    if system is None:
        from .system import PortSystem

        system = PortSystem(cell.config, device)
    loop = Loop(system, cell.config, mix, traffic)
    loop.setup(spans)
    _sync(device)
    launches0 = system.launches()
    counters0 = system.counters()
    spans.reset()
    setup_s = process_age_s()
    _eprint(f"set-up: {setup_s:.2f} s, of which traffic {t_stage - t_gen:.3f}"
            f" s, staging and warm-up {time.perf_counter() - t_stage:.3f} s")
    if trace:
        with profiled(spans, system) as tr:
            w = loop.drive(seconds, spans, device)
    else:
        w = loop.drive(seconds, spans, device)
    window_s = w["t1"] - w["t0"]
    launches = {k: v - launches0.get(k, 0)
                for k, v in system.launches().items()}
    counters = {k: v - counters0.get(k, 0)
                for k, v in system.counters().items()}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    done = w["done"]
    ops = sum(loop.ops(i) for i, _ in done)
    lat = w["latencies"]
    _eprint(f"window: {len(done)} batches, {ops} k-mer ops in "
            f"{window_s:.6f} s; batch_p95_ms over {len(lat)} batches")

    out = loop.outputs()
    loop.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = loop.reference(device)
    _eprint(f"reference: {time.perf_counter() - t_ref:.3f} s")
    checks = loop.checks(done, out, ref)
    if device.type == "cuda" and launches0:  # the program's kernels ran
        checks["kernel_groups_missing"] = groups.missing(launches,
                                                         mix["kernels"])
    failed = loop.wrong(loop.keyed(done), ref)

    e2e = {"kmer_ops_per_s": ops / window_s,
           "batch_p95_ms": 1e3 * _p95(lat),
           "peak_mem_gib": peak / 2**30,
           "setup_s": setup_s}
    metrics, extra = {}, {}
    if trace:
        view = TraceView.build(
            tr, w["ns"], batches=len(done), port_s=spans.port_seconds(),
            latencies_s=lat, least_bytes=loop.least_bytes(ref),
            launches=launches, groups=groups, counters=counters)
        for m in cell.per_layer:
            v = spec.reader(m["name"], base)(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": view.busy_s, "window_s": view.window_s}
        breakdown = view.breakdown()
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {
        "correct": all(v <= LIMIT for v in checks.values()),
        "attempted": len(done),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": peak,
            **extra,
        },
    }
    if trace:
        result["breakdown"] = breakdown
        result["program_spans"] = view.program_split()  # stderr, not stdout
    result["checks"] = {k: {"value": v, "limit": LIMIT}
                        for k, v in checks.items()}
    return result


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kmerbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_vars = sorted(k for k in os.environ if k.startswith(ENV_PREFIX))
    if set_vars:
        _eprint(f"refused: {set_vars} set; a cell measures the port's "
                "defaults")
        return 2
    from . import spec

    cell = spec.cell(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _eprint(f"refused: {args.workload} needs {cell.chips} CUDA "
                f"card(s); {torch.cuda.device_count()} available")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device)
    _eprint(f"card: {_power_limit()}")
    found = forbidden_modules()
    if found:
        _eprint(f"refused: modules {found} were loaded")
        return 3
    split = result.pop("program_spans", None)
    if split is not None:
        _eprint(f"program spans: {json.dumps(split)}")
    for name, c in result["checks"].items():
        _eprint(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
