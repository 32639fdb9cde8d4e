"""`correct` can come out false: the control and the planted faults.

- The control is the reference put in the program's place with one
  guarantee broken: k-mers kept as fingerprints, an approximate set
  (`reference.control`).  At the test size, 16-bit fingerprints collide
  as 32-bit ones do at the cells' own size (run there by the `gpu` test).
- The faults are planted in the program underneath the harness, which
  otherwise runs as in a benchmark run (the look for a card skipped):
  a step that leaves the index unchanged, half of each batch left out,
  an answer altered where it is produced.  Each patches public names of
  `cbl_tpu_torch` alone (methods of `CBL` and `DeviceWordSet`), so that
  a change inside the program cannot disarm it.  The cells run on one card, so
  there is no exchange between cards to leave out.
"""

import pytest
import torch

from kmerbench import spec
from kmerbench.reference.control import ControlSystem
from kmerbench.run import run_cell
from kmerbench.tests.tiny import CELLS, CPU, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    r = run_cell(cell, 21, 0.3, False, CPU,
                 system=ControlSystem(cell.config, CPU, bits=16))
    assert not r["correct"]
    assert r["checks"]["batches_wrong"]["value"] > 0
    assert r["checks"]["export_wrong"]["value"] > 0


def _unchanged(monkeypatch, loop):
    """A step that leaves the index as it was: a round only queries, an
    insert does nothing."""
    from cbl_tpu_torch import CBL

    if loop == "window":
        monkeypatch.setattr(
            CBL, "dynamic_round",
            lambda self, ins, qry, rm, lazy=False:
            self.query_codes_stream(qry, lazy=lazy))
    else:
        monkeypatch.setattr(CBL, "insert_codes_stream",
                            lambda self, codes, offsets=None: None)


def _half_batch(monkeypatch, loop):
    """Half of every read batch left out where it is staged: the first
    half of its records packed, the rest dropped (a genome, one record,
    stays whole)."""
    from cbl_tpu_torch import CBL

    orig = CBL.pack_stream

    def half(self, codes, offsets, slab=None):
        n = len(offsets) - 1
        if n > 1:
            offsets = offsets[: n // 2 + 1]
            codes = codes[: offsets[-1]]
        return orig(self, codes, offsets, slab)

    monkeypatch.setattr(CBL, "pack_stream", half)


def _answer_altered(monkeypatch, loop):
    """One more hit (a query, a round) or one more k-mer (a build's
    count) where the answer is produced."""
    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.wordset import DeviceWordSet

    if loop == "query":
        orig = DeviceWordSet.count_hits_device
        monkeypatch.setattr(DeviceWordSet, "count_hits_device",
                            lambda self, *a, **k: orig(self, *a, **k) + 1)
    elif loop == "build":
        orig = DeviceWordSet.count_device
        monkeypatch.setattr(DeviceWordSet, "count_device",
                            lambda self: orig(self) + 1)
    else:
        orig = CBL.dynamic_round
        monkeypatch.setattr(
            CBL, "dynamic_round",
            lambda self, *a, **k: (lambda t, p: (t, p + 1))(
                *orig(self, *a, **k)))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    fault(monkeypatch, cell.mix["loop"])
    r = run_cell(cell, 22, 0.3, False, CPU)
    assert not r["correct"], r["checks"]
    assert r["checks"]["batches_wrong"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [4100000001, 4100000002, 4100000003])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda", 0)
    cell = spec.cell(spec.load(), name)
    r = run_cell(cell, seed, 2.0, False, cuda,
                 system=ControlSystem(cell.config, cuda))
    print(f"control {name} seed {seed}: "
          f"{ {k: v['value'] for k, v in r['checks'].items()} }")
    assert not r["correct"]
