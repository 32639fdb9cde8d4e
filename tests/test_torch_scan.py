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
