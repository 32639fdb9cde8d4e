"""Device ms a batch credited to the program's `join` span: a query's
join with the index (`DeviceWordSet.count_hits_device`: the merge join
on B3 or the probe join on B8, with their eager ops) and a round's
merges and scan (`cbl._fused_round_slog`: tags, B3, B4), whichever join
the program picks (`program_spans.credit`)."""


def read(view):
    return view.program_split()["metrics"]["span_join_ms"]
