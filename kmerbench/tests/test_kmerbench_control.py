"""`correct` can come out false: the control and the planted faults.

- The control is the reference put in the program's place with one
  guarantee broken: k-mers kept as fingerprints, an approximate set
  (`reference.control`).  At the test size, 16-bit fingerprints collide
  as 32-bit ones do at the cells' own size (run there by the `gpu` test).
- The faults are planted in the program underneath the harness, which
  otherwise runs as in a benchmark run (the look for a card skipped):
  a step that leaves the index unchanged, half of each batch left out,
  an answer altered where it is produced.  The cells run on one card, so
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
    import cbl_tpu_torch.cbl as cbl

    if loop == "window":
        orig = cbl._round_into_log

        def stale(a, b, qtag, out_cap):
            merged, positive, live = orig(a, b, qtag, out_cap)
            return (cbl._fit(a, out_cap) if a.shape[-1] else merged,
                    positive, live)

        monkeypatch.setattr(cbl, "_round_into_log", stale)
    else:
        monkeypatch.setattr(cbl.CBL, "insert_codes_stream",
                            lambda self, codes, offsets=None: None)


def _half_batch(monkeypatch, loop):
    import cbl_tpu_torch.cbl as cbl

    orig = cbl._device_words

    def half(stream, starts, ends, nk_pad, cfg, canonical):
        words, n_valid = orig(stream, starts, ends, nk_pad, cfg, canonical)
        words = words.clone()
        words[..., words.shape[-1] // 2:] = cbl.SENTINEL
        return words, n_valid

    monkeypatch.setattr(cbl, "_device_words", half)


def _answer_altered(monkeypatch, loop):
    import cbl_tpu_torch.cbl as cbl
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
        orig = cbl.slog_counts
        monkeypatch.setattr(cbl, "slog_counts",
                            lambda *a: (lambda p, n: (p + 1, n))(*orig(*a)))


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
