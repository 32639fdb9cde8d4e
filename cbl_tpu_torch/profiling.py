"""Profiling & observability.

Counterpart of `cbl_tpu/profiling.py`: a `torch.profiler` trace around
any region (host activity, and the card's kernels and copies where a
CUDA device is present), and a k-mers/s throughput meter used by the CLI.

The port's own phases:
- `span(name)` (`spanned(name)`, its decorator form; `sync(site)` for a
  host read of a device value) marks where the host is in the program.
  While recording is on (`recording()`, which `trace()` enters too) each
  span appends (name, start ns, end ns, parent index, call id) to the
  records, on `time.time_ns()`, the wall clock `torch.profiler` puts
  device operations on.  Spans nest; the parent is
  the index of the span around it (-1 at the top), and every span of one
  top-level call (a public method of `CBL`) shares its call id.  Off is
  the default: a span site then costs one module-global check and a
  shared no-op object.
- `COUNTERS`, always on like `ops.LAUNCHES`: `syncs.<site>` (host reads
  of a device value), `folds.slog.<cause>` (`autofold`, `seq_cap`,
  `flush`, `query`), `folds.pending`, `rounds`, `slog_rows` (the
  sorted log's real-row bound summed over rounds), `words.fused` (the
  word pipeline's calls that took B1 from the stream, one launch each)
  and `sort.<mode>` (the sorts of each mode: `mergepath` B5, `bitonic`
  B6, `library` `torch.sort`; `ops.sort.sort_keys`).

Span names: `cbl.<method>` (the public calls), `words` (the word
pipeline), `sort` (the sort seam), `join` (query joins and a round's
merges and scan), `index` (folds, builds, compaction) and `sync.<site>`
(a host wait for a device value).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

TRACE_FILE = "trace.json"

COUNTERS: dict = {}

_records = None  # the list spans append to while recording is on
_open: list = []  # indices of the open spans, innermost last
_calls = 0  # call ids handed out
_annotate = False  # inside `trace()`: spans are profiler ranges too


def count(name: str, n: int = 1) -> None:
    """Add `n` to `COUNTERS[name]`."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


class _NoSpan:
    """What a span site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "records", "open", "i", "range")

    def __init__(self, name: str, records: list):
        self.name = name
        self.records = records
        self.open = _open
        self.range = None

    def __enter__(self):
        global _calls
        if self.open:
            parent = self.open[-1]
            call = self.records[parent][4]
        else:
            parent = -1
            _calls += 1
            call = _calls
        self.i = len(self.records)
        self.open.append(self.i)
        if _annotate:
            from torch.profiler import record_function

            self.range = record_function(self.name)
            self.range.__enter__()
        self.records.append((self.name, time.time_ns(), None, parent, call))
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        name, start, _, parent, call = self.records[self.i]
        self.records[self.i] = (name, start, end, parent, call)
        if self.range is not None:
            self.range.__exit__(*exc)
        self.open.pop()
        return False


def span(name: str):
    """A context that records the block as span `name` while recording is
    on, and does nothing otherwise."""
    if _records is None:
        return _NO_SPAN
    return _Span(name, _records)


def sync(site: str):
    """`span("sync.<site>")` around a host read of a device value, counted
    in `COUNTERS["syncs.<site>"]` whether recording or not."""
    count("syncs." + site)
    return span("sync." + site)


def spanned(name: str):
    """Decorator: run the function as span `name` while recording is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _records is None:
                return fn(*args, **kwargs)
            with _Span(name, _records):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording():
    """Record spans over the block; yields the list of records, (name,
    start ns, end ns, parent index, call id), filled as spans end.  Inside
    a recording already on, yields that recording's list."""
    global _records, _open
    if _records is not None:
        yield _records
        return
    records: list = []
    _records, _open = records, []
    try:
        yield records
    finally:
        _records, _open = None, []


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace of the region and write it as a
    Chrome trace, `log_dir/trace.json` (open in chrome://tracing or
    Perfetto), the program's spans among its host ranges; yields the
    profiler."""
    global _annotate
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording():
        before, _annotate = _annotate, True
        try:
            yield prof
        finally:
            _annotate = before
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ThroughputMeter:
    """Wall-clock k-mers/s counter (stderr report)."""

    def __init__(self, label: str = "throughput"):
        self.label = label
        self.t0 = time.time()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += n

    def report(self, file=sys.stderr) -> float:
        dt = max(time.time() - self.t0, 1e-9)
        rate = self.items / dt
        print(f"{self.label}: {self.items} k-mers in {dt:.2f}s = {rate:,.0f}/s",
              file=file)
        return rate
