"""Device ms a batch in every operation of no kernel group that a metric
file declares (the port's kernels and the library sorts): eager
elementwise ops, reductions, scatters, copies and fills."""


def read(view):
    s = view.other_s()
    return 1e3 * s / view.batches if s and view.batches else None
