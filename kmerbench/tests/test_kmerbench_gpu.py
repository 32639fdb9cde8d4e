"""Each cell at its own size on the card, for a few seconds: correct, and
with the metrics its entry in BENCHMARK.json names."""

import pytest
import torch

from kmerbench import spec
from kmerbench.run import run_cell
from kmerbench.tests.tiny import CELLS

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.cell(spec.load(), name)
    r = run_cell(cell, 4200000001, 2.0, trace, torch.device("cuda", 0))
    assert r["correct"], r["checks"]
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
