"""Share of kernel B8's HBM roofline: its least bytes a batch at 3.35e12
B/s, over its device ms a batch (`probe_ms`).  The least bytes
(`least_bytes`) are what the program's counters say the window's
launches searched (`probe_rows`, `probe_valid_rows` in
`cbl_tpu_torch.ops.LAUNCHES`): every query row read once, and one
32-byte sector of the index a valid query row (its row or the one after
it, which any search has to read).  A blanked row (SENTINEL: a k-mer
start that spans two reads) reads no sector; the program counts the
valid rows on the host, from the record offsets of each slab.  The
search layout's own reads are B8's cost, not the search's, and are left
out."""

from kmerbench.metrics import probe_ms
from kmerbench.trace import HBM_BYTES_PER_S

SECTOR_BYTES = 32
ROW_BYTES = 8  # a one-column query row; the cells' K gives one column


def least_bytes(launches: dict, batches: int) -> float:
    rows = launches.get("probe_rows", 0)
    valid = launches.get("probe_valid_rows", 0)
    return (rows * ROW_BYTES + valid * SECTOR_BYTES) / batches


def read(view):
    if not view.batches:
        return None
    s = view.group_s(probe_ms.GROUPS)
    b = least_bytes(view.launches, view.batches)
    if not s or not b:
        return None
    return 100.0 * b / HBM_BYTES_PER_S / (s / view.batches)
