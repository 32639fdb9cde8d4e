"""The traced window: a `torch.profiler` trace of the card, reduced in
process to what the per-layer metrics read.

`TraceView` holds the device operations (kernels, copies, fills) and the
harness spans of the window, both on the wall clock in ns, and the
window's host-side facts (batches completed, host seconds in the program,
batch latencies, the least bytes of a batch, the launch counters).  The
metric readers (`metrics/<name>.py`) read it; nothing is written to disk.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import types
from dataclasses import dataclass, field

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, 80 GB HBM3


@contextlib.contextmanager
def profiled(spans):
    """Trace the card's activity over the block with `torch.profiler`
    (device activity only: recording every host op would slow the host
    that feeds the card) and keep the harness spans (`drive.Spans`) on the
    same clock; yields a holder with `.ops` (name, start ns, end ns) of the
    device operations and `.spans` once the block has ended."""
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
            yield holder
    finally:
        holder.spans, spans.record = spans.record, None
    holder.ops = _device_ops(prof)


def _device_ops(prof) -> list:
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


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
    ops: list  # (name, start_ns, end_ns, kernel group) of device ops
    spans: list  # (name, start_ns, end_ns) of harness spans
    batches: int
    port_s: float  # host seconds inside calls into the program
    latencies_s: list
    least_bytes: float  # per batch
    launches: dict  # ops.LAUNCHES over the window
    groups: object  # `kernels.Groups`
    window: tuple = (0, 0)  # start and end ns of the window
    _busy: list = field(default=None, repr=False)

    @classmethod
    def build(cls, trace, window: tuple, groups, **facts) -> "TraceView":
        """The view of `profiled`'s trace over `window` (start and end
        ns): device operations clipped to it and classified by `groups`
        (`kernels.Groups`)."""
        lo, hi = window
        ops = [(n, max(a, lo), min(b, hi), groups.group_of(n))
               for n, a, b in trace.ops if b > lo and a < hi]
        spans = sorted(trace.spans, key=lambda s: s[1])
        return cls(ops=ops, spans=spans, window=window, groups=groups,
                   **facts)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy(self) -> list:
        if self._busy is None:
            self._busy = merge_intervals([(a, b) for _, a, b, _ in self.ops])
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def group_s(self, groups) -> float:
        """Device seconds in the named kernel groups.  A group whose
        launch counters say it ran but that reads no time is an error."""
        total = 0.0
        for g in groups:
            s = sum(b - a for _, a, b, og in self.ops if og == g) * 1e-9
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
        return sum(b - a for _, a, b, og in self.ops if og is None) * 1e-9

    def idle_by_span(self) -> dict:
        """Idle device time of the window by the harness span the host was
        in at the middle of each gap ("harness" between spans)."""
        starts = [s[1] for s in self.spans]
        out = collections.Counter()
        edge = self.window[0]
        for a, b in self.busy() + [(self.window[1], self.window[1])]:
            if a > edge:
                mid = (edge + a) // 2
                j = bisect.bisect_right(starts, mid) - 1
                name = "harness"
                if j >= 0 and self.spans[j][2] >= mid:
                    name = self.spans[j][0]
                out[name] += (a - edge) * 1e-9
            edge = max(edge, b)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for n, a, b, _ in self.ops:
            by_op[n[:160]] += (b - a) * 1e-9
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in
                              self.idle_by_span().most_common(top)]}
