"""Device ms a batch credited to the program's `index` span: the index's
upkeep (`DeviceWordSet.flush`, the sorted log's folds, compaction,
dedup, merges into the index, a build's adoption and distinct count;
`program_spans.credit`)."""


def read(view):
    return view.program_split()["metrics"]["span_index_ms"]
