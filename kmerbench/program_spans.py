"""The traced window split by the program's own spans.

    python -m kmerbench.program_spans --workload <cell> --seed <n> --seconds <s> [--record 0|1] [--profile 0|1]

runs one cell's set-up and window as `run` does, with the program's span
recording (`cbl_tpu_torch.profiling.recording`) and `torch.profiler`
(device activity only) each on or off, and prints one JSON line: the
window's rate and 95th percentile, and, under the profiler, device time
by program span, host waits and idle gaps by program span, and the
program's counters a batch.  It reads the window; it is no cell of
`BENCHMARK.json`, and `run` does not call it.

Crediting.  Each device operation carries the correlation id of the CUDA
runtime or driver call that enqueued it (`torch.profiler` keeps those
calls under device-only activity).  The operation is credited to the
innermost program span open at that call's start on the host, else to
the harness span open then (`drive.Spans`), else to "harness"; an
operation whose call was not traced is "uncredited".  Device time is the
union of the operations (`trace.TraceView.busy`), so overlapping
operations are not counted twice and the shares add up to the busy time.

Host waits, inside program spans: `sync.*` spans (the program reads a
device value), runtime or driver calls that block (`BLOCKING`), and
launch calls that take more than `SLOW_LAUNCH_NS` (a full launch queue).
An idle gap of the device is named by the innermost program span the
host was in at its middle, with the blocking call's name after a "/"
where the host was inside one.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import re
import sys
import time
import types

from .trace import merge_intervals

BLOCKING = re.compile(r"Synchronize|^cudaMemcpy$|^cuMemcpy[DH]to[DH](?:_v2)?$"
                      r"|^cudaMalloc|^cudaFree|^cuMemAlloc|^cuMemFree")
LAUNCH = re.compile(r"LaunchKernel|^cudaMemcpyAsync$|^cudaMemsetAsync$"
                    r"|^cuMemcpy.*Async|^cuMemset.*Async")
SLOW_LAUNCH_NS = 50_000
HARNESS = "harness"
UNCREDITED = "uncredited"
SPAN_METRICS = {"span_words_ms": "words", "span_sort_ms": "sort",
                "span_join_ms": "join", "span_index_ms": "index"}


class Spans:
    """Spans (name, start ns, end ns, ...) looked up by time: `at(t)` is
    the innermost span open at t.  With `nested`, the fourth field is the
    index of the span around it (-1 at the top), as the program's records
    have it; otherwise the spans do not overlap."""

    def __init__(self, records: list, nested: bool = False):
        order = sorted(range(len(records)), key=lambda i: records[i][1])
        where = {i: j for j, i in enumerate(order)}
        self.names = [records[i][0] for i in order]
        self.starts = [records[i][1] for i in order]
        # a span still open when the records were taken ends never
        self.ends = [sys.maxsize if records[i][2] is None else records[i][2]
                     for i in order]
        # a parent starts before its child; anything else is no parent
        self.parents = [where.get(records[i][3], -1) if nested else -1
                        for i in order]
        self.parents = [p if p < j else -1 for j, p in enumerate(self.parents)]

    def at(self, t: int) -> int:
        """Index of the innermost span open at t, or -1."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ends[j] < t:
            j = self.parents[j]
        return j

    def name_at(self, t: int):
        j = self.at(t)
        return self.names[j] if j >= 0 else None

    def within(self, j: int, prefix: str) -> bool:
        """True when span j or a span around it is named `prefix`...."""
        while j >= 0:
            if self.names[j].startswith(prefix):
                return True
            j = self.parents[j]
        return False


def _clip(intervals, window):
    lo, hi = window
    return [(n, max(a, lo), min(b, hi), *rest)
            for n, a, b, *rest in intervals if b > lo and a < hi]


def _owner(t, program: Spans, harness: Spans) -> str:
    return program.name_at(t) or harness.name_at(t) or HARNESS


def credit(ops: list, calls: list, program: list, harness: list,
           window: tuple, group_of=None) -> dict:
    """Device ns by owner of the enqueueing call.  `ops`: (name, start,
    end, correlation id) of device operations; `calls`: (name, start,
    end, correlation id) of runtime and driver calls; `program`: the
    program's span records; `harness`: (name, start, end) harness spans.
    -> {"busy": union by owner, "other": summed durations of ops of no
    kernel group (`group_of` None) by owner, "top_other": their names by
    owner}."""
    prog, harn = Spans(program, nested=True), Spans(harness)
    launched = {c[3]: c[1] for c in calls if c[3]}
    busy, other = collections.Counter(), collections.Counter()
    top = collections.defaultdict(collections.Counter)
    edge = window[0]
    for name, a, b, corr in sorted(_clip(ops, window), key=lambda o: o[1]):
        t = launched.get(corr)
        owner = UNCREDITED if t is None else _owner(t, prog, harn)
        busy[owner] += max(0, b - max(a, edge))
        edge = max(edge, b)
        if group_of is not None and group_of(name) is None:
            other[owner] += b - a
            top[owner][name[:80]] += b - a
    return {"busy": busy, "other": other, "top_other": top}


def host_waits(calls: list, program: list, window: tuple) -> dict:
    """Host ns and counts of waits inside program spans, by kind:
    `sync.<site>` spans, `<call>@<span>` for a blocking runtime or driver
    call outside a sync span, `launch>50us@<span>` for a slow launch."""
    prog = Spans(program, nested=True)
    ns, n = collections.Counter(), collections.Counter()
    for name, a, b, *_ in _clip(program, window):
        if name.startswith("sync."):
            ns[name] += b - a
            n[name] += 1
    for name, a, b, _ in _clip(calls, window):
        j = prog.at(a)
        if j < 0 or prog.within(j, "sync."):
            continue
        if BLOCKING.search(name):
            kind = f"{name}@{prog.names[j]}"
        elif LAUNCH.search(name) and b - a > SLOW_LAUNCH_NS:
            kind = f"launch>50us@{prog.names[j]}"
        else:
            continue
        ns[kind] += b - a
        n[kind] += 1
    return {"ns": ns, "count": n}


def idle_by_program_span(busy: list, calls: list, program: list,
                         harness: list, window: tuple) -> dict:
    """Idle ns of the device by what the host was in at each gap's
    middle: the innermost program span (with "/<call>" inside a blocking
    call or a slow launch), else the harness span, else "harness"."""
    prog, harn = Spans(program, nested=True), Spans(harness)
    waits = [c for c in calls if BLOCKING.search(c[0])
             or (LAUNCH.search(c[0]) and c[2] - c[1] > SLOW_LAUNCH_NS)]
    held = Spans(waits)
    out = collections.Counter()
    edge = window[0]
    for a, b in list(busy) + [(window[1], window[1])]:
        if a > edge:
            mid = (edge + a) // 2
            name = _owner(mid, prog, harn)
            call = held.name_at(mid)
            if call is not None and prog.at(mid) >= 0:
                name = f"{name}/{call}"
            out[name] += a - edge
        edge = max(edge, b)
    return out


def _kineto(prof) -> tuple:
    """(device ops, runtime and driver calls) of a profile, each as
    (name, start ns, end ns, correlation id)."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            ops.append(row)
        elif row[0].startswith("cu"):
            calls.append(row)
    return ops, calls


def _program():
    """`cbl_tpu_torch.profiling` where the program records spans; None in
    a program from before them."""
    from cbl_tpu_torch import profiling

    return profiling if hasattr(profiling, "recording") else None


@contextlib.contextmanager
def captured(spans, record: bool, profile: bool):
    """The program's recording and `torch.profiler` (device activity
    only), each where asked for, over the block; yields a holder with
    `.program` (span records), `.spans` (harness spans), `.ops` and
    `.calls` (`_kineto`) once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    holder = types.SimpleNamespace(program=[], spans=[], ops=[], calls=[])
    prog = _program()
    with contextlib.ExitStack() as stack:
        prof = None
        if profile:
            cuda = torch.cuda.is_available()
            prof = stack.enter_context(torch_profile(activities=[
                ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]))
            if cuda:  # the tracer starts at its first launches
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
        if record and prog is not None:
            holder.program = stack.enter_context(prog.recording())
        spans.record = []
        try:
            yield holder
        finally:
            holder.spans, spans.record = spans.record, None
    if prof is not None:
        holder.ops, holder.calls = _kineto(prof)


def counters() -> dict:
    prog = _program()
    return dict(prog.COUNTERS) if prog is not None else {}


def report(tr, window: tuple, batches: int, groups) -> dict:
    """The split of a captured window, per batch (ms) where it is a time."""
    per = 1e-6 / max(batches, 1)
    ops = _clip(tr.ops, window)
    busy = merge_intervals([(a, b) for _, a, b, _ in ops])
    busy_ns = sum(b - a for a, b in busy)
    got = credit(ops, tr.calls, tr.program, tr.spans, window,
                 groups.group_of)
    waits = host_waits(tr.calls, tr.program, window)
    idle = idle_by_program_span(busy, tr.calls, tr.program, tr.spans,
                                window)
    by_span = {k: v * per for k, v in got["busy"].most_common()}
    program_names = {r[0] for r in tr.program}
    metrics = {m: by_span.get(s, 0.0) if tr.program else None
               for m, s in SPAN_METRICS.items()}
    metrics["host_wait_ms"] = (sum(waits["ns"].values()) * per
                               if tr.program else None)
    return {
        "busy_ms": busy_ns * per,
        "credited_pct": (100.0 * (busy_ns - got["busy"][UNCREDITED])
                         / busy_ns if busy_ns else None),
        "program_pct": (100.0 * sum(v for k, v in got["busy"].items()
                                    if k in program_names) / busy_ns
                        if busy_ns else None),
        "device_by_span": by_span,
        "torch_ops_by_span": {k: v * per
                              for k, v in got["other"].most_common()},
        "top_torch_ops": {k: [[n, v * per] for n, v in c.most_common(4)]
                          for k, c in got["top_other"].items()},
        "host_wait": {k: [v * per, waits["count"][k] / max(batches, 1)]
                      for k, v in waits["ns"].most_common()},
        "idle_by_program_span": {k: v * 1e-9 for k, v in idle.most_common(12)},
        "metrics": metrics,
    }


def run(cell, seed: int, seconds: float, device, record: bool = True,
        profile: bool = True, base=None) -> dict:
    """Set-up and window of `cell` (`spec.Cell`) as `run.run_cell` makes
    them, captured as asked; -> the result as a dict."""
    import torch

    from . import drive, kernels, spec
    from .loop import LIMIT
    from .run import _p95, _sync
    from .system import PortSystem

    base = base or spec.ROOT
    spans = drive.Spans()
    Loop = spec.loop(cell.mix["loop"], base)
    groups = kernels.Groups(base)
    traffic = Loop.make_traffic(cell.mix, cell.config, seed)
    loop = Loop(PortSystem(cell.config, device), cell.config, cell.mix,
                traffic)
    loop.setup(spans)
    _sync(device)
    before = counters()
    spans.reset()
    with captured(spans, record, profile) as tr:
        w = loop.drive(seconds, spans, device)
    after = counters()
    done, lat = w["done"], w["latencies"]
    n = len(done)
    ops = sum(loop.ops(i) for i, _ in done)
    out = loop.outputs()
    loop.free()
    ref = loop.reference(device)
    checks = loop.checks(done, out, ref)
    result = {
        "workload": cell.name, "seed": seed, "record": record,
        "profile": profile, "batches": n,
        "correct": all(v <= LIMIT for v in checks.values()),
        "kmer_ops_per_s": ops / (w["t1"] - w["t0"]),
        "batch_p95_ms": 1e3 * _p95(lat),
        "counters": {k: (v - before.get(k, 0)) / max(n, 1)
                     for k, v in sorted(after.items())
                     if v != before.get(k, 0)},
        "spans_recorded": len(tr.program),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    result["folds_per_batch"] = (
        sum(v for k, v in result["counters"].items()
            if k.startswith("folds.")) if _program() is not None else None)
    if profile:
        result.update(report(tr, w["ns"], n, groups))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kmerbench.program_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = spec.cell(spec.load(), args.workload)
    t0 = time.perf_counter()
    result = run(cell, args.seed, args.seconds, device,
                 bool(args.record), bool(args.profile))
    result["run_s"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
