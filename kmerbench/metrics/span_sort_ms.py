"""Device ms a batch credited to the program's `sort` span: the sort
seam (`ops.sort.sort_keys`, `wordset.sort_rows`: B5, B6 or `torch.sort`
and the column `cat`/`stack` around them), whichever route it takes
(`program_spans.credit`)."""


def read(view):
    return view.program_split()["metrics"]["span_sort_ms"]
