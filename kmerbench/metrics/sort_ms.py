"""Device ms a batch in sorts: kernels B5 and B6 and the library sorts
that `torch.sort` launches (CUB's radix sorts and PyTorch's sorts of
small segments)."""

GROUPS = {
    "B5": {"names": r"\b(?:tile_sort(?:_keyed)?|multiway_partition|"
                    r"merge_multi)\b",
           "launches": ["sort", "sort_3col"]},
    "B6": {"names": r"\bkeyed_(?:tile_sort|intile|cross)\b",
           "launches": ["bitonic_sort", "bitonic_sort_3col"]},
    "library_sort": {"names": r"(?i)radixsort|radix_sort|sortkv|sort_kv|"
                              r"sortkeyvalue|segmented_?sort|"
                              r"sort_postprocess|fill_index_and_segment"},
}


def read(view):
    s = view.group_s(GROUPS)
    return 1e3 * s / view.batches if s and view.batches else None
