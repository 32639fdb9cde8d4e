"""The port's CPU path (`device="cpu"`: the plain versions of its kernels)
against the reference, through a whole run of each cell at a small size:
query counts, the built index's count and k-mers, each round's counts and
the live set at the end, all exact."""

import pytest

from kmerbench.run import run_cell
from kmerbench.tests.tiny import CELLS, CPU, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu_path(name, trace):
    cell = tiny_cell(name)
    r = run_cell(cell, 2**31 + 7, 0.5, trace, CPU)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # on the CPU no device op is traced: only the host-clock metric and
    # the program's own spans and counters read
    host = {"enqueue_ms", "host_wait_ms", "folds_per_batch"}
    assert set(r["metrics"]) == (want & host if trace else want)
    assert list(r)[-1] == "checks"


def test_window_folds_inside_the_run():
    import torch
    from cbl_tpu_torch import profiling

    from kmerbench import drive, spec
    from kmerbench.system import PortSystem

    cell = tiny_cell("k25_p24.dynamic_window")
    Loop = spec.loop("window")
    t = Loop.make_traffic(cell.mix, cell.config, 1)
    loop = Loop(PortSystem(cell.config, CPU), cell.config, cell.mix, t)
    before = dict(profiling.COUNTERS)
    loop.setup(drive.Spans())
    for i in range(4):
        loop.submit(i, drive.Spans())
    got = {k: v - before.get(k, 0) for k, v in profiling.COUNTERS.items()}
    assert got["rounds"] == cell.mix["warm_rounds"] + 4
    # more rounds than the log's seq holds (62): the log was folded
    assert sum(v for k, v in got.items() if k.startswith("folds.slog.")) > 0
    out = loop.outputs()
    ref = loop.reference(CPU)
    done = [(i, [0, 0]) for i in range(4)]
    checks = loop.checks(done, out, ref)
    assert checks["live_gap"] == 0 and checks["export_wrong"] == 0
    assert checks["batches_wrong"] == 4  # the made-up answers, not set-up's
    assert isinstance(ref["live_mean"], float) and torch.is_tensor(out["kmers"][0])
