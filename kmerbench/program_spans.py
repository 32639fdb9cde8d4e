"""The traced window split by the program's own spans.

`run`'s traced run (`--trace 1`) records the program's spans
(`cbl_tpu_torch.profiling.recording`, through the system's `recording`)
beside `torch.profiler`'s device activity, and `report` splits that
window (`trace.TraceView`) by them: device time by program span, eager
ops by span, host waits, idle gaps by span and the program's counters a
batch.  Six per-layer metrics read it (`metrics/span_*_ms.py`,
`host_wait_ms`, `folds_per_batch`); the traced run prints the whole
split on stderr.

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

Where the program recorded no spans (the control) every metric reads
None; where it did, a span that ran no device operation reads 0.0, and
with no device operation traced at all (a CPU run) the span times read
None.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys

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


def report(view) -> dict:
    """The split of a traced window (`trace.TraceView`) by the program's
    spans, a batch (ms) where it is a time; `"metrics"` holds what the
    six metric files read."""
    n = max(view.batches, 1)
    per = 1e-6 / n
    ops = [(name, a, b, c) for name, a, b, _, c in view.ops]
    busy = view.busy()
    busy_ns = sum(b - a for a, b in busy)
    got = credit(ops, view.calls, view.program, view.spans, view.window,
                 view.groups.group_of)
    waits = host_waits(view.calls, view.program, view.window)
    idle = idle_by_program_span(busy, view.calls, view.program, view.spans,
                                view.window)
    by_span = {k: v * per for k, v in got["busy"].most_common()}
    recorded = bool(view.program)
    program_names = {r[0] for r in view.program}
    counters = {k: v / n for k, v in sorted(view.counters.items()) if v}
    metrics = {m: by_span.get(s, 0.0) if recorded and busy_ns else None
               for m, s in SPAN_METRICS.items()}
    metrics["host_wait_ms"] = (sum(waits["ns"].values()) * per
                               if recorded else None)
    metrics["folds_per_batch"] = (
        sum(v for k, v in counters.items() if k.startswith("folds."))
        if recorded else None)
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
        "top_torch_ops": {k: [[name, v * per] for name, v in c.most_common(4)]
                          for k, c in got["top_other"].items()},
        "host_wait": {k: [v * per, waits["count"][k] / n]
                      for k, v in waits["ns"].most_common()},
        "idle_by_program_span": {k: v * 1e-9 for k, v in idle.most_common()},
        "counters": counters,
        "metrics": metrics,
    }
