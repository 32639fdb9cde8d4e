"""The host screen (`loops/screen.py`, `reference/screen.py`) at sizes a
CPU test run holds: the genome built over several slabs that merge into
the index as at the cell's own size, reads from both strands, the probe
join on every batch, the reference worked in blocks against the query
loop's unblocked one, and the control not correct."""

import numpy as np
import pytest
import torch

from kmerbench import drive, spec
from kmerbench.reference import screen as ref_screen
from kmerbench.reference.control import ControlSystem
from kmerbench.reference.kmers import kmer_cols, rows_differ
from kmerbench.run import run_cell
from kmerbench.system import PortSystem
from kmerbench.tests.tiny import CPU, SCREEN as CELL, tiny_screen

SLAB = 4096  # k-mers a slab: the genome takes five
PENDING = 1024  # rows of the pending log: every later slab merges in


@pytest.fixture
def slabs(monkeypatch):
    """The cell's shape at a small size: slabs of 4096 k-mers, and a
    pending log smaller than a slab, so that the genome's later slabs
    merge into the index (`DeviceWordSet._merge_into`) as the cell's
    2^25-k-mer slabs do past the log's 2^21 rows."""
    import cbl_tpu_torch.cbl as cbl

    monkeypatch.setattr(cbl, "_FUSED_SLAB", SLAB)

    def new_index(self):
        return self.api.CBL(k=self.k, prefix_bits=self.prefix_bits,
                            canonical=self.canonical, device=self.device,
                            pending_cap=PENDING)

    monkeypatch.setattr(PortSystem, "new_index", new_index)


@pytest.mark.parametrize("trace", [False, True])
def test_screen_runs_correct_with_a_probe_a_batch(slabs, monkeypatch, trace):
    from cbl_tpu_torch import profiling
    from cbl_tpu_torch.wordset import DeviceWordSet

    merges = []
    orig = DeviceWordSet._merge_into
    monkeypatch.setattr(DeviceWordSet, "_merge_into",
                        lambda self, *a, **k: merges.append(1)
                        or orig(self, *a, **k))
    before = dict(profiling.COUNTERS)
    cell = tiny_screen()
    r = run_cell(cell, 2**31 + 11, 0.5, trace, CPU)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"batches_wrong", "distinct_gap",
                                "export_wrong"}
    assert len(merges) == 4  # the genome's slabs after the first
    d = {k: v - before.get(k, 0) for k, v in profiling.COUNTERS.items()}
    calls = r["attempted"] + 3  # the window's and set-up's batches
    assert d.get("join.probe") == 2 * calls  # two slabs a batch
    assert d.get("join.merge", 0) == 0
    assert d.get("index.search_layout") == 1  # built once for the index
    assert d.get("probe_rows") == 2 * calls * SLAB


def test_reads_come_from_both_strands():
    cell = tiny_screen(errors=0.0)
    cell.mix["reads"]["batches"]["from_genome"] = 1.0
    Loop = spec.loop("screen")
    t = Loop.make_traffic(cell.mix, cell.config, 5)
    genome = t["genome"][0]
    fwd = genome.tobytes()
    rev = (genome[::-1] ^ 2).tobytes()
    for codes, off in t["batches"]:
        reads = [codes[a:b].tobytes() for a, b in zip(off[:-1], off[1:])]
        assert all(x in fwd for x in reads[0::2])
        assert all(x in rev and x not in fwd for x in reads[1::2])
    # the general generator's draws, with no draw of its own
    plain = spec.loop("query").make_traffic(cell.mix, cell.config, 5)
    assert np.array_equal(plain["genome"][0], genome)
    for (a, _), (b, off) in zip(plain["batches"], t["batches"]):
        ra, rb = a.reshape(len(off) - 1, -1), b.reshape(len(off) - 1, -1)
        assert np.array_equal(ra[0::2], rb[0::2])
        assert np.array_equal(ra[1::2], rb[1::2, ::-1] ^ 2)


@pytest.mark.parametrize("parts,groups,block", [(32, 2, 1 << 26),
                                                (8, 3, 1000), (1, 1, 777)])
def test_blocked_reference_equals_the_query_reference(parts, groups, block):
    cell = tiny_screen()
    t = spec.loop("screen").make_traffic(cell.mix, cell.config, 9)
    whole = spec.loop("query")(None, cell.config, cell.mix, t).reference(CPU)
    got = ref_screen.screen_reference(t["genome"], t["batches"], 25, True,
                                      CPU, parts, groups, block)
    assert got["answers"] == whole["answers"]
    assert got["distinct"] == whole["distinct"]
    rows = tuple(torch.cat(c) for c in zip(*got["kmer_parts"]))
    assert rows_differ(rows, whole["kmers"]) == 0
    hits = [a[1] for a in got["answers"]]
    assert all(0 < h < n for h, (n, _) in zip(hits, got["answers"]))


@pytest.mark.parametrize("k", [5, 25, 59])
def test_blocks_of_a_stream_give_its_kmers(k):
    rng = np.random.default_rng(k)
    lens = [300, k - 1, 2 * k + 3, 1000]
    codes = rng.integers(0, 4, sum(lens), dtype=np.uint8)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    want = kmer_cols(codes, off, k, True)
    for block in (1, 37, 1000, 5000):
        parts = [kmer_cols(*b, k, True)
                 for b in ref_screen.stream_blocks((codes, off), k, block)]
        got = tuple(torch.cat(c) for c in zip(*parts))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_export_wrong_counts_missing_and_extra_rows():
    keys = [(torch.tensor([1, 5, 9]),), (torch.tensor([40]),)]
    same = [[(torch.tensor([9, 1]),), (torch.tensor([5]),)],
            [(torch.tensor([40]),)]]
    assert ref_screen.export_wrong(same, keys, 25) == 0
    off = [[(torch.tensor([9, 1, 1]),)], []]
    assert ref_screen.export_wrong(off, keys, 25) == 3  # extra 1, no 5, 40


def test_probe_roofline_floor_reads_rows_and_valid_sectors():
    """`probe_roofline`'s least bytes: every query row read once, one
    32-byte index sector a valid row, nothing for the search layout."""
    from kmerbench.metrics import probe_roofline

    launches = {"probe": 8, "probe_rows": 8 << 24,
                "probe_valid_rows": 8 * 14_092_848}
    assert probe_roofline.least_bytes(launches, 8) == \
        (1 << 24) * 8 + 14_092_848 * 32
    # a program without the valid rows' counter: the rows alone
    assert probe_roofline.least_bytes({"probe_rows": 4096}, 2) == 4096 * 4


def test_control_is_not_correct(slabs):
    cell = tiny_screen()
    r = run_cell(cell, 21, 0.3, False, CPU,
                 system=ControlSystem(cell.config, CPU, bits=16))
    assert not r["correct"]
    assert r["checks"]["batches_wrong"]["value"] > 0
    assert r["checks"]["export_wrong"]["value"] > 0


def test_the_window_makes_no_tensor_of_the_index_length(slabs):
    """Each window batch allocates nothing that outlives it: the tensors
    alive after a batch are those alive before it (CPU tensors, counted
    by the allocator's live storages)."""
    import gc

    cell = tiny_screen()
    Loop = spec.loop("screen")
    t = Loop.make_traffic(cell.mix, cell.config, 3)
    loop = Loop(PortSystem(cell.config, CPU), cell.config, cell.mix, t)
    loop.setup(drive.Spans())
    loop.submit(0, drive.Spans())
    gc.collect()
    live = loop.index.wordset._live()
    n0 = sum(x.numel() for x in gc.get_objects()
             if torch.is_tensor(x) and x.numel() >= live.shape[-1])
    for i in range(1, 4):
        loop.submit(i, drive.Spans())
    gc.collect()
    n1 = sum(x.numel() for x in gc.get_objects()
             if torch.is_tensor(x) and x.numel() >= live.shape[-1])
    assert n1 == n0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [4200000011, 4200000012, 4200000013])
def test_control_is_not_correct_on_the_card(seed):
    """The control on the card: the cell's batches against a genome of
    2^27 bases.  At the cell's own 3.1e9 bases the control cannot hold
    the genome's fingerprints (its `stage` makes every k-mer's int64
    codes at once, 25 GB a tensor) and fails in set-up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda", 0)
    cell = spec.cell(spec.load(), CELL)
    cell.config["genome_bases"] = 1 << 27
    r = run_cell(cell, seed, 2.0, False, cuda,
                 system=ControlSystem(cell.config, cuda))
    print(f"control {CELL} (2^27 bases) seed {seed}: "
          f"{ {k: v['value'] for k, v in r['checks'].items()} }")
    assert not r["correct"]
