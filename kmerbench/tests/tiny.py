"""The benchmark's cells cut to sizes a CPU test run can hold: the same
loops, configurations and metrics, with a smaller genome, fewer and
smaller batches."""

from __future__ import annotations

import torch

from kmerbench import spec

GENOME_BASES = 20000
SIZES = {
    "query": {"reads": {"batches": {"count": 3, "reads": 40,
                                    "read_bases": 150, "from_genome": 0.5,
                                    "errors": 0.001}}},
    "build": {"reads": {"batches": {"count": 2, "reads": 120,
                                    "read_bases": 150, "from_genome": 1.0,
                                    "errors": 0.001}}},
    # at K=25 the log folds at seq 62 (the autofold's seq cap)
    "window": {"reads": {"inserts": {"count": 10, "reads": 20,
                                     "read_bases": 150, "from_genome": 1.0,
                                     "errors": 0.001},
                         "queries": {"count": 3, "reads": 20,
                                     "read_bases": 150, "from_genome": 0.5,
                                     "errors": 0.001}},
               "warm_rounds": 64},
}
CELLS = ("k25_p24.query_reads", "k59_p28.bulk_build",
         "k25_p24.dynamic_window", "k59_p28.dynamic_window")
SCREEN = "k25_p24_chm13.host_screen"  # its own tests: the genome's slabs
SCREEN_SIZES = {"batches": {"count": 3, "reads": 40, "read_bases": 150,
                            "from_genome": 0.9, "errors": 0.001}}
CPU = torch.device("cpu")


def tiny_cell(name: str, bench: dict | None = None, base=spec.ROOT):
    cell = spec.cell(bench or spec.load(base), name, base)
    cell.mix.update(SIZES[cell.mix["loop"]])
    cell.config["genome_bases"] = GENOME_BASES
    return cell


def tiny_screen(errors: float = 0.001):
    cell = spec.cell(spec.load(), SCREEN)
    cell.mix["reads"] = {"batches": dict(SCREEN_SIZES["batches"],
                                         errors=errors)}
    cell.config["genome_bases"] = GENOME_BASES
    return cell
