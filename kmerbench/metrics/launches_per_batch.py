"""Device operations a batch: kernels, copies and fills."""


def read(view):
    n = len(view.ops)
    return n / view.batches if n and view.batches else None
