"""Each cell at its own size on the card for a few seconds, through
`run`'s traced run: every device op of the window is credited to a
program span or the harness, at least 99 % of device time to the
program's spans, the shares add up to the busy time, and the six metrics
read what the split reads in the cells they list."""

import pytest
import torch

from kmerbench import program_spans as ps, spec
from kmerbench.run import run_cell
from kmerbench.tests.tiny import CELLS

pytestmark = pytest.mark.gpu
SIX = (*ps.SPAN_METRICS, "host_wait_ms", "folds_per_batch")


@pytest.mark.parametrize("name", CELLS)
def test_device_time_is_credited_to_the_program(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.cell(spec.load(), name)
    r = run_cell(cell, 4200000003, 2.0, True, torch.device("cuda", 0))
    assert r["correct"], r["checks"]
    split = r["program_spans"]
    assert split["credited_pct"] >= 99.0
    assert split["program_pct"] >= 99.0
    by_span = split["device_by_span"]
    parts = sum(split["metrics"][m] for m in ps.SPAN_METRICS) + sum(
        v for k, v in by_span.items()
        if k.startswith(("cbl.", "sync.", "port.", "harness")))
    assert parts == pytest.approx(split["busy_ms"], rel=0.01)
    listed = [m["name"] for m in cell.per_layer if m["name"] in SIX]
    assert {m: r["metrics"][m]["value"] for m in listed} == {
        m: split["metrics"][m] for m in listed}
    assert all(split["metrics"][m] > 0 for m in listed
               if m in ps.SPAN_METRICS)
    if "window" in name:
        assert split["metrics"]["folds_per_batch"] > 0
        assert split["host_wait"]["sync.n"][1] == pytest.approx(
            split["counters"]["syncs.n"])
