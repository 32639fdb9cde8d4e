"""The closed loop that makes the measured window, and the host spans.

`closed_loop` keeps `depth` batches in flight: it submits batches while
the window is open, and once `depth` are in flight waits for the oldest.
A batch's answers are copied to pinned host memory behind its work and
an event is recorded after the copy, so waiting for one batch never waits
for the next.  A batch's latency runs from the moment the harness begins
to submit it to the moment its answers are on the host.  Submitting stops
when `seconds` have passed since the first submit; the batches still in
flight are then waited for, and the window ends with the last of them:
the rate is all the work over all the time.

`Spans` adds up the host time of every call into the program (`port.*`)
and every wait (`harness.wait`) and, while a trace is taken, keeps each
span's start and end on the wall clock in ns, the clock the profiler
gives device operations on, so that idle gaps of the device can be
named by what the host was doing.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class Spans:
    def __init__(self):
        self.totals = collections.Counter()
        self.record = None  # a list while a trace is taken

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        n0 = time.time_ns()
        yield
        self.totals[name] += time.perf_counter() - t0
        if self.record is not None:
            self.record.append((name, n0, time.time_ns()))

    def port_seconds(self) -> float:
        return sum(v for k, v in self.totals.items() if k.startswith("port."))

    def reset(self) -> None:
        self.totals.clear()
        if self.record is not None:
            self.record.clear()


class _Fence:
    """Answers of one batch on their way to the host."""

    def __init__(self, ring, slot: int, answers: torch.Tensor):
        if answers.device.type != "cuda":
            self.host, self.event = answers, None
            return
        self.host = ring[slot][: answers.numel()]
        self.host.copy_(answers, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def closed_loop(loop, depth: int, seconds: float, spans: Spans,
                device) -> dict:
    """Run `loop` for `seconds` with `depth` batches in flight; -> the
    window's start and end (perf_counter, and wall clock ns), each batch's
    latency and its answers as (i, list) pairs."""
    pin = device.type == "cuda"
    ring = [torch.empty(16, dtype=torch.int64, pin_memory=pin)
            for _ in range(depth + 1)]
    flight = collections.deque()
    latencies, done = [], []
    i = 0
    t0 = time.perf_counter()
    n0 = time.time_ns()
    t_end = t0 + seconds
    t_last = t0
    while True:
        start = time.perf_counter()
        if start < t_end:
            answers = loop.submit(i, spans)
            flight.append((i, start, _Fence(ring, i % len(ring), answers)))
            i += 1
            if len(flight) < depth:
                continue
        if not flight:
            break
        j, s, fence = flight.popleft()
        with spans("harness.wait"):
            values = fence.wait()
        t_last = time.perf_counter()
        latencies.append(t_last - s)
        done.append((j, values))
    return {"t0": t0, "t1": t_last, "ns": (n0, time.time_ns()),
            "latencies": latencies, "done": done}
