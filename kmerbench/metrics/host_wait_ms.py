"""Host ms a batch that the program waits inside its own spans: `sync.*`
spans (a host read of a device value), runtime or driver calls that
block, and launches that take more than 50 us (a full launch queue;
`program_spans.host_waits`).  The rounds in flight can hide a wait from
the device; `device_idle_pct` says how much of it they did not."""


def read(view):
    return view.program_split()["metrics"]["host_wait_ms"]
