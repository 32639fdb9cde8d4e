"""Parity of the port's record blanking (kernel B2's module) with `cbl_tpu`.

`cbl_tpu_torch.ops.scan.blank_mask` (CPU dispatch) and its plain version
against the Pallas kernel `blank_mask_pallas` in interpret mode and the
numpy cumsum form; `cbl_tpu_torch.cbl._device_words` against
`cbl_tpu.cbl._device_words` with the blanking kernel forced on
(`CBL_TPU_SLOG_SCAN=pallas-force`).  Inputs come from
numpy.random.default_rng; every comparison is exact integer equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cbl_tpu.cbl as jcbl
from cbl_tpu.ops.scan_pallas import blank_mask_pallas
from cbl_tpu_torch import cbl as tcbl
from cbl_tpu_torch.limbs import from_limbs
from cbl_tpu_torch.ops import scan

torch.set_num_threads(2)


def _random_delta(n, seed):
    rng = np.random.default_rng(seed)
    n_iv = 37
    starts = rng.integers(0, n, size=n_iv)
    lens = rng.integers(1, max(n // 8, 2), size=n_iv)
    ends = np.minimum(starts + lens, n)
    delta = np.zeros(n + 1, np.int32)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    return delta[:n]


@pytest.mark.parametrize("n", [1024, 4096, 16384])
def test_blank_mask_matches_pallas_and_cumsum(n):
    delta = _random_delta(n, seed=n)
    want = np.cumsum(delta) > 0
    mask_p, nv_p = blank_mask_pallas(jnp.asarray(delta), interpret=True)
    for fn in (scan.blank_mask, scan.blank_mask_plain):
        mask, nv = fn(torch.from_numpy(delta))
        assert mask.dtype == torch.int32 and nv.dtype == torch.int32
        np.testing.assert_array_equal(mask.numpy(), want.astype(np.int32))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_p))
        assert int(nv) == int((~want).sum()) == int(nv_p)
    assert want.any() and not want.all()


CASES = {
    # record boundaries, a record shorter than K, a short trailing record
    "records": (9_000, [0, 1_000, 1_024, 5_000, 8_990, 9_000]),
    # one record, with a padded tail in the slab
    "one_record": (5_000, [0, 5_000]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [13, 25])
def test_device_words_matches_jax(monkeypatch, k, canonical, case):
    n_bases, offsets = CASES[case]
    offsets = np.asarray(offsets, dtype=np.int64)
    codes = np.random.default_rng(77 + k).integers(0, 4, size=n_bases,
                                                   dtype=np.uint8)
    jidx = jcbl.CBL(k=k, canonical=canonical)
    jps = jidx.pack_stream(codes, offsets)
    assert len(jps.slabs) == 1
    nk_pad, stream, s_arr, e_arr, n_here = jps.slabs[0]
    assert n_here < nk_pad  # the slab has a padded tail to blank
    monkeypatch.setenv("CBL_TPU_SLOG_SCAN", "pallas-force")
    jax.clear_caches()
    jcbl._fused_words_fn.cache_clear()
    try:
        w, nv = jcbl._fused_words_fn(jidx.cfg, canonical, nk_pad)(
            stream, s_arr, e_arr)
        want_words, want_nv = from_limbs(np.asarray(w)), int(nv)
    finally:
        jcbl._fused_words_fn.cache_clear()
        jax.clear_caches()

    tidx = tcbl.CBL(k=k, canonical=canonical, device="cpu")
    tps = tidx.pack_stream(codes, offsets)
    t_pad, t_stream, t_s, t_e, t_here = tps.slabs[0]
    assert (t_pad, t_here) == (nk_pad, n_here)
    words, n_valid = tcbl._device_words(t_stream, t_s, t_e, t_pad, tidx.cfg,
                                        canonical)
    np.testing.assert_array_equal(words.numpy(), want_words)
    assert int(n_valid) == want_nv
    assert 0 < want_nv < nk_pad


def _tile_edge_delta(rng, n, tile, kind):
    """Interval deltas of n rows: random intervals, or intervals from one
    tile edge to another (the running sum returns to 0 exactly there)."""
    delta = np.zeros(n + 1, np.int32)
    if n == 0:
        return delta[:0]
    if kind == "intervals":
        starts = rng.integers(0, n, size=max(n // 40, 1))
        ends = np.minimum(starts + rng.integers(1, 3 * tile, len(starts)), n)
    else:
        edges = np.arange(0, n + 1, tile)
        starts = rng.choice(edges, size=max(len(edges) // 4, 1))
        ends = np.minimum(starts + tile * rng.integers(1, 4, len(starts)), n)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    return delta[:n]


@pytest.mark.parametrize("kind", ["intervals", "zero at tile edges"])
@pytest.mark.parametrize("tile", [4, 16, 64])
def test_blank_tiled_matches_plain_at_tile_edges(tile, kind):
    """Kernel B2's tile protocol (`blank_mask_tiled`) against the plain
    version and numpy at n = k * tile - 1, k * tile, k * tile + 1, 1 and 0,
    over chains of hundreds of tiles that all publish their sums before
    any looks back (the longest walks), and in waves of 5 tiles."""
    rng = np.random.default_rng(tile)
    k = 300 if tile < 64 else 40
    for n in (k * tile - 1, k * tile, k * tile + 1, 1, 0):
        delta = _tile_edge_delta(rng, n, tile, kind)
        want = np.cumsum(delta) > 0
        t = torch.from_numpy(delta)
        plain = scan.blank_mask_plain(t)
        for wave in (None, 5):
            mask, nv = scan.blank_mask_tiled(t, tile, wave)
            assert mask.dtype == torch.int32 and nv.dtype == torch.int32
            np.testing.assert_array_equal(mask.numpy(), want.astype(np.int32))
            assert torch.equal(mask, plain[0])
            assert int(nv) == int((~want).sum()) == int(plain[1])


@pytest.mark.parametrize("tile", [4, 32, 64])
def test_blank_tiled_matches_pallas(tile):
    n = 2048
    delta = _random_delta(n, seed=tile)
    mask_p, nv_p = blank_mask_pallas(jnp.asarray(delta), interpret=True)
    mask, nv = scan.blank_mask_tiled(torch.from_numpy(delta), tile)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_p))
    assert int(nv) == int(nv_p)


def test_scan_tile_constants_match_sources():
    """`BLANK_TILE` and `SLOG_TILE` are the tiles of the kernels' sources,
    and `LOOKBACK_WINDOW` the statuses their look-back reads a step."""
    b2 = (scan._build.SRC_DIR / "scan.cu").read_text()
    b4 = (scan._build.SRC_DIR / "slog_scan.cu").read_text()
    assert "kTile = kWarps * kWarpRows;  // 8192, = ops/scan.py BLANK_TILE" in b2
    assert "kTile = kThreads * kItems;  // 4096, = ops/scan.py SLOG_TILE" in b4
    assert (scan.BLANK_TILE, scan.SLOG_TILE) == (8192, 4096)
    for src in (b2, b4):
        assert "for (int hi = t - 1;; hi -= 32) {" in src
        assert "const int i = hi - lane;" in src
    assert scan.LOOKBACK_WINDOW == 32
