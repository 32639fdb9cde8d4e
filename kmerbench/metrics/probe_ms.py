"""Device ms a batch in the probe join's kernel B8 (`probe_hits`), which
searches each sorted query row of a batch in an index much larger than
the batch, through a sample of the index's rows."""

GROUPS = {
    "B8": {"names": r"\bprobe_hits\b", "launches": ["probe"]},
}


def read(view):
    s = view.group_s(GROUPS)
    return 1e3 * s / view.batches if s and view.batches else None
