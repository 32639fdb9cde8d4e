"""The program's folds a batch over the window: the sum of its `folds.*`
counters (`profiling.COUNTERS`: the sorted log's folds by cause and the
pending log's) over the batches completed.  A fold rewrites the index,
so the batches that take one set the tail (`batch_p95_ms`)."""


def read(view):
    return view.program_split()["metrics"]["folds_per_batch"]
