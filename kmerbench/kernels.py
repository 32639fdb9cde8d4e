"""Device operations by kernel group, as the profiler names them.

Each metric file that reads kernels declares its groups (`GROUPS` in
`metrics/<name>.py`): a group's name -> `"names"`, a regular expression
over the profiler's kernel names, and `"launches"`, the group's counters
in `cbl_tpu_torch.ops.LAUNCHES` (none for library kernels).  `Groups`
takes the union over every metric file, so a kernel that a later PR adds
is classified by adding a metric file.  A device operation of no group is
an eager tensor op, a copy or a fill (`torch_ops_ms`); a group that reads
no time while its counters say it ran (a kernel renamed) is an error,
not a 0 (`trace.TraceView.group_s`).
"""

from __future__ import annotations

import re

from . import spec


class Groups:
    def __init__(self, base=spec.ROOT):
        self.patterns, self.counters = {}, {}
        for metric in spec.names("metrics", base):
            for g, d in getattr(spec.module("metrics", metric, base),
                                "GROUPS", {}).items():
                if g in self.patterns:
                    raise ValueError(f"kernel group {g} declared twice")
                self.patterns[g] = re.compile(d["names"])
                self.counters[g] = tuple(d.get("launches", ()))

    def group_of(self, name: str) -> str | None:
        """The group of a device operation's name, or None (eager ops,
        copies and fills)."""
        for g, pat in self.patterns.items():
            if pat.search(name):
                return g
        return None

    def launched(self, launches: dict, group: str) -> int:
        return sum(launches.get(key, 0) for key in self.counters[group])

    def missing(self, launches: dict, groups) -> int:
        """How many of `groups` the launch counters say never ran."""
        return sum(not self.launched(launches, g) for g in groups)
