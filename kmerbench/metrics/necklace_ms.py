"""Device ms a batch in the word pipeline's kernels: the necklaces B1
(`necklace_pos_kernel`, `necklace_pos_wide_kernel`) and the
record-boundary blanking B2 (`blank_lookback`)."""

GROUPS = {
    "B1": {"names": r"\bnecklace_pos(?:_wide)?_kernel\b",
           "launches": ["necklace", "necklace_wide"]},
    "B2": {"names": r"\bblank_lookback\b", "launches": ["blank"]},
}


def read(view):
    s = view.group_s(GROUPS)
    return 1e3 * s / view.batches if s and view.batches else None
