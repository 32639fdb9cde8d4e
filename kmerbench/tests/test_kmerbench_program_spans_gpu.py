"""Each cell at its own size on the card for a few seconds, with the
program's spans recorded: every device op of the window is credited to
a program span or the harness, and the shares add up to the busy time."""

import pytest
import torch

from kmerbench import program_spans as ps, spec
from kmerbench.tests.tiny import CELLS

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", CELLS)
def test_device_time_is_credited_to_the_program(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.cell(spec.load(), name)
    r = ps.run(cell, 4200000003, 2.0, torch.device("cuda", 0))
    assert r["correct"]
    assert r["credited_pct"] >= 99.0
    by_span = r["device_by_span"]
    parts = sum(r["metrics"][m] for m in ps.SPAN_METRICS) + sum(
        v for k, v in by_span.items()
        if k.startswith(("cbl.", "sync.", "port.", "harness")))
    assert parts == pytest.approx(r["busy_ms"], rel=0.01)
    assert r["metrics"]["span_words_ms"] > 0
    assert r["metrics"]["span_sort_ms"] > 0
    if "window" in name:
        assert r["folds_per_batch"] > 0
        assert r["host_wait"]["sync.n"][1] == pytest.approx(
            r["counters"]["syncs.n"])
