"""Device ms a batch in the query join and the sorted log: the merges B3
(merge path) and B7 (bitonic) and the log scan B4."""

GROUPS = {
    "B3": {"names": r"\bcbl::.*\b(?:partition|merge_tiles)\b",
           "launches": ["merge", "merge_3col"]},
    "B7": {"names": r"\b(?:tile_coranks|merge_tile)\b",
           "launches": ["bitonic_merge", "bitonic_merge_3col"]},
    "B4": {"names": r"\bslog_(?:tag_)?lookback\b",
           "launches": ["slog_scan", "slog_scan_tag", "slog_scan_tag_3col"]},
}


def read(view):
    s = view.group_s(GROUPS)
    return 1e3 * s / view.batches if s and view.batches else None
