"""The traced window: a `torch.profiler` trace of the card and the
program's own span records, reduced in process to what the per-layer
metrics read.

`TraceView` holds the device operations (kernels, copies, fills), the
runtime and driver calls that enqueued them, the harness spans and the
program's spans of the window, all on the wall clock in ns, and the
window's host-side facts (batches completed, host seconds in the program,
batch latencies, the least bytes of a batch, the launch counters, the
program's counters).  The metric readers (`metrics/<name>.py`) read it;
the split by program span (`program_spans.report`) is worked out once a
view.  Nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import types
from dataclasses import dataclass, field

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, 80 GB HBM3


@contextlib.contextmanager
def profiled(spans, system):
    """Trace the card's activity over the block with `torch.profiler`
    (device activity only: recording every host op would slow the host
    that feeds the card), keep the harness spans (`drive.Spans`) on the
    same clock and record the program's spans (`system.recording()`,
    none under the control); yields a holder with `.ops` and `.calls`
    (`_kineto`), `.spans` and `.program` (the program's span records:
    name, start ns, end ns, parent index, call id) once the block has
    ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    holder = types.SimpleNamespace()
    spans.record = []
    try:
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            if cuda:  # the tracer starts at its first launches: not in the window
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            with system.recording() as records:
                holder.program = records
                yield holder
    finally:
        holder.spans, spans.record = spans.record, None
    holder.ops, holder.calls = _kineto(prof)


def _kineto(prof) -> tuple:
    """(device operations, runtime and driver calls) of a profile, each as
    (name, start ns, end ns, correlation id): a device operation carries
    the id of the call that enqueued it."""
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


def merge_intervals(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class TraceView:
    ops: list  # (name, start_ns, end_ns, kernel group, correlation id)
    spans: list  # (name, start_ns, end_ns) of harness spans
    batches: int
    port_s: float  # host seconds inside calls into the program
    latencies_s: list
    least_bytes: float  # per batch
    launches: dict  # ops.LAUNCHES over the window
    groups: object  # `kernels.Groups`
    window: tuple = (0, 0)  # start and end ns of the window
    calls: list = ()  # (name, start_ns, end_ns, correlation id)
    program: list = ()  # the program's span records; empty: none recorded
    counters: dict = field(default_factory=dict)  # the program's, window
    _busy: list = field(default=None, repr=False)
    _split: dict = field(default=None, repr=False)

    @classmethod
    def build(cls, trace, window: tuple, groups, **facts) -> "TraceView":
        """The view of `profiled`'s trace over `window` (start and end
        ns): device operations clipped to it and classified by `groups`
        (`kernels.Groups`)."""
        lo, hi = window
        ops = [(n, max(a, lo), min(b, hi), groups.group_of(n), c)
               for n, a, b, c in trace.ops if b > lo and a < hi]
        spans = sorted(trace.spans, key=lambda s: s[1])
        return cls(ops=ops, spans=spans, window=window, groups=groups,
                   calls=trace.calls, program=trace.program, **facts)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy(self) -> list:
        if self._busy is None:
            self._busy = merge_intervals([(a, b) for _, a, b, *_ in self.ops])
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def group_s(self, groups) -> float:
        """Device seconds in the named kernel groups.  A group whose
        launch counters say it ran but that reads no time is an error."""
        total = 0.0
        for g in groups:
            s = sum(b - a for _, a, b, og, _ in self.ops if og == g) * 1e-9
            n = self.groups.launched(self.launches, g)
            if s == 0 and n:
                raise RuntimeError(
                    f"kernel group {g} launched {n} times in the window but "
                    "no device op of that name was traced: a kernel was "
                    "renamed")
            total += s
        return total

    def other_s(self) -> float:
        """Device seconds in ops of no kernel group."""
        return sum(b - a for _, a, b, og, _ in self.ops if og is None) * 1e-9

    def program_split(self) -> dict:
        """The window split by the program's spans
        (`program_spans.report`), worked out once."""
        if self._split is None:
            from . import program_spans

            self._split = program_spans.report(self)
        return self._split

    def idle_by_span(self) -> dict:
        """Idle device seconds of the window by what the host was in at
        the middle of each gap: the innermost program span, else the
        harness span, else "harness" (`program_spans.idle_by_program_span`)."""
        return self.program_split()["idle_by_program_span"]

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for n, a, b, *_ in self.ops:
            by_op[n[:160]] += (b - a) * 1e-9
        idle = list(self.idle_by_span().items())[:top]  # longest first
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle]}
