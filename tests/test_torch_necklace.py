"""Parity of the port's k-mer and necklace modules with `cbl_tpu`.

`cbl_tpu_torch.kmer` (extract_kmers, revcomp, canonicalize) and
`cbl_tpu_torch.necklace` (necklace_pos, the plain version of kernel B1,
its CPU dispatch necklace_pos_auto, pack_word, unpack_word) against
`cbl_tpu.kmer` / `cbl_tpu.necklace` on the JAX CPU backend, against the
Pallas kernel `necklace_pos_pallas` in interpret mode, and against the
pure-python oracle `py_necklace_pos`.  Inputs come from
numpy.random.default_rng; every comparison is exact integer equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbl_tpu import kmer as jkmer
from cbl_tpu import necklace as jneck
from cbl_tpu.config import get_config
from cbl_tpu.ops.necklace_pallas import necklace_pos_pallas
from cbl_tpu_torch import kmer as tkmer
from cbl_tpu_torch import necklace as tneck
from cbl_tpu_torch.config import get_config as t_get_config
from cbl_tpu_torch.limbs import from_limbs

torch.set_num_threads(2)

# (k, prefix_bits): K=7 packs 18-bit words, so its prefix must stay small
CONFIGS = [(7, 10), (13, 24), (25, 24), (27, 24)]


def _random_kmers(cfg, n, seed):
    """[n, L] uint32 limbs of uniformly random W-bit k-mers."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << cfg.kmer_bits, size=n, dtype=np.uint64)
    out = np.empty((n, cfg.word_limbs), dtype=np.uint32)
    for l in range(cfg.word_limbs):
        sh = np.uint64(32 * (cfg.word_limbs - 1 - l))
        out[:, l] = ((vals >> sh) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def _t(keys_np):
    return torch.from_numpy(np.ascontiguousarray(keys_np, dtype=np.int64))


@pytest.mark.parametrize("n_kmers", [4096, 4001])
@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_extract_kmers_matches_jax(k, prefix_bits, n_kmers):
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    rng = np.random.default_rng(k * 100 + n_kmers)
    n_words = (n_kmers + k - 1 + 15) // 16
    stream = rng.integers(0, 1 << 32, size=n_words, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jkmer.extract_kmers(jnp.asarray(stream), n_kmers, cfg))
    got = tkmer.extract_kmers(
        torch.from_numpy(stream.astype(np.int64)), n_kmers,
        t_get_config(k=k, prefix_bits=prefix_bits),
    )
    np.testing.assert_array_equal(got.numpy(), from_limbs(want))


def test_np_pack_stream_matches_jax():
    codes = np.random.default_rng(5).integers(0, 4, size=4096, dtype=np.uint8)
    np.testing.assert_array_equal(tkmer.np_pack_stream(codes),
                                  jkmer.np_pack_stream(codes))
    assert np.array_equal(tkmer.encode_seq(b"ACGTxacgtN"),
                          jkmer.encode_seq(b"ACGTxacgtN"))


@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_canonicalize_matches_jax(k, prefix_bits):
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    km = _random_kmers(cfg, 4096, seed=k)
    want_c, want_mask = jkmer.canonicalize(jnp.asarray(km), cfg)
    want_rc = jkmer.revcomp(jnp.asarray(km), cfg)
    tcfg = t_get_config(k=k, prefix_bits=prefix_bits)
    x = _t(from_limbs(km))
    got_c, got_mask = tkmer.canonicalize(x, tcfg)
    np.testing.assert_array_equal(got_c.numpy(),
                                  from_limbs(np.asarray(want_c)))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(tkmer.revcomp(x, tcfg).numpy(),
                                  from_limbs(np.asarray(want_rc)))


@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_necklace_pos_matches_jax_and_pallas(k, prefix_bits):
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    km = _random_kmers(cfg, 2048, seed=1000 + k)
    # a few structured rows: all zero, periodic, a single set bit
    km[:4] = 0
    km[1, -1] = 1
    km[2, -1] = 0x33333333 & ((1 << min(cfg.kmer_bits, 32)) - 1)
    km[3, -1] = 5
    neck_x, pos_x = jneck.necklace_pos(jnp.asarray(km), cfg)
    neck_p, pos_p = necklace_pos_pallas(jnp.asarray(km), cfg, interpret=True)
    tcfg = t_get_config(k=k, prefix_bits=prefix_bits)
    x = _t(from_limbs(km))
    for fn in (tneck.necklace_pos, tneck.necklace_pos_auto):
        neck, pos = fn(x, tcfg)
        assert pos.dtype == torch.int32
        np.testing.assert_array_equal(neck.numpy(),
                                      from_limbs(np.asarray(neck_x)))
        np.testing.assert_array_equal(neck.numpy(),
                                      from_limbs(np.asarray(neck_p)))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_x))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_p))
    neck, pos = tneck.necklace_pos(x, tcfg)
    words = tneck.pack_word(neck, pos, tcfg)
    want_words = jneck.pack_word(neck_x, pos_x, cfg)
    np.testing.assert_array_equal(words.numpy(),
                                  from_limbs(np.asarray(want_words)))
    back_neck, back_pos = tneck.unpack_word(words, tcfg)
    assert torch.equal(back_neck, neck) and torch.equal(back_pos, pos)
    # the pure-python definition, on a subset
    for i in range(0, 2048, 41):
        b, p = tneck.py_necklace_pos(int(x[i]), cfg.kmer_bits)
        assert (b, p) == jneck.py_necklace_pos(int(x[i]), cfg.kmer_bits)
        assert (int(neck[i]), int(pos[i])) == (b, p)
