"""kmerbench: the benchmark of cbl_tpu_torch on one NVIDIA H100.

    python -m kmerbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints one JSON line.  Cells,
configurations, traffic mixes, loop kinds and per-layer metrics are files
found by name (`spec`); see `run` for what a run does.
"""
