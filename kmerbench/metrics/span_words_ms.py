"""Device ms a batch credited to the program's `words` span: the word
pipeline (`cbl._device_words`: B2's delta and scan, then B1 from the
packed stream; `_pipeline_words`), its kernels and its eager ops alike.
An operation goes to the innermost program span open when the host
enqueued it (`program_spans.credit`)."""


def read(view):
    return view.program_split()["metrics"]["span_words_ms"]
