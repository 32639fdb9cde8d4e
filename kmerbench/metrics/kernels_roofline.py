"""Share of the HBM roofline: the least bytes a batch must move (its
loop's `least_bytes`: packed input read once, index or live rows read
once, index rows written once) at 3.35e12 B/s, over the device-busy time
a batch.  It reads the work, not the kernels that do it, so it does not
go stale when a kernel is replaced."""

from kmerbench.trace import HBM_BYTES_PER_S


def read(view):
    busy = view.busy_s
    if not busy or not view.batches:
        return None
    return 100.0 * view.least_bytes / HBM_BYTES_PER_S / (busy / view.batches)
