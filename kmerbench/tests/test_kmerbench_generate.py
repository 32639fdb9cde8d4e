"""The traffic generator: one seed gives the same arrays, every seed the
same sizes, and reads are what the mix says they are."""

import numpy as np
import pytest

from kmerbench import generate
from kmerbench.tests.tiny import CELLS, tiny_cell


def _flat(traffic: dict) -> list:
    out = []
    for v in traffic.values():
        streams = v if isinstance(v, list) else [v]
        for codes, off in streams:
            out += [codes, off]
    return out


def _traffic(cell, seed):
    return generate.make_traffic(cell.mix, cell.config, seed)


@pytest.mark.parametrize("name", CELLS)
def test_one_seed_repeats_and_seeds_share_sizes(name):
    cell = tiny_cell(name)
    a = _flat(_traffic(cell, 2**31 + 11))
    b = _flat(_traffic(cell, 2**31 + 11))
    c = _flat(_traffic(cell, 5))
    assert all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_negative_seed_refused():
    with pytest.raises(ValueError):
        generate.rng_of(-1)


def test_reads_come_from_the_genome_with_the_errors_asked_for():
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=50000, dtype=np.uint8)
    codes, off = generate.read_batch(rng, genome, 400, 150, 0.5, 0.0)
    assert np.array_equal(off, np.arange(0, 400 * 150 + 1, 150))
    g = genome.tobytes()
    reads = [codes[off[i]:off[i + 1]].tobytes() for i in range(400)]
    assert all(r in g for r in reads[:200])
    assert not any(r in g for r in reads[200:])
    rng = np.random.default_rng(3)
    rng.integers(0, 4, size=50000, dtype=np.uint8)  # the same draws again
    err, _ = generate.read_batch(rng, genome, 400, 150, 0.5, 0.001)
    changed = int((err != codes).sum())
    assert 58 <= changed <= 60  # 60 placed; one may land twice on a base


def test_genome_is_one_record_of_the_configurations_size():
    cell = tiny_cell("k25_p24.query_reads")
    codes, off = _traffic(cell, 1)["genome"]
    assert len(codes) == cell.config["genome_bases"]
    assert off.tolist() == [0, len(codes)]
