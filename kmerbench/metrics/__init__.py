"""Per-layer metric readers, one file a metric, found by the metric's
name in `BENCHMARK.json`.  Each defines `read(view)`, which takes a
`trace.TraceView` of the traced window and returns the number, or None
where it finds nothing to read (the harness then leaves the metric out).
Per-batch numbers are over the batches completed in the window."""
