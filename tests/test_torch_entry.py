"""Parity of the port's flagship forward step with `cbl_tpu`'s.

`cbl_tpu_torch.kmer.pack_stream` against `np_pack_stream` and
`cbl_tpu.kmer.pack_stream`; `cbl_tpu_torch.entry`'s `forward` on the CPU
against `__graft_entry__.entry()`'s forward under `jax.jit` on the JAX
CPU backend (imported, not edited), on the reference's args and on an
index that holds a random half of the chunk's words with some rows not
valid; the step's words against `necklace_pos_pallas` in interpret mode
(kernel B1's reference) and `cbl_tpu.necklace.pack_word`; `entry()`
without a card; `python -m cbl_tpu_torch.entry` on the CPU.  Inputs come
from numpy.random.default_rng; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cbl_tpu import kmer as jkmer
from cbl_tpu import necklace as jneck
from cbl_tpu.config import get_config
from cbl_tpu.ops.necklace_pallas import necklace_pos_pallas
from cbl_tpu_torch import LAUNCHES
from cbl_tpu_torch import entry as tentry
from cbl_tpu_torch import kmer as tkmer
from cbl_tpu_torch.limbs import SENTINEL, from_limbs

torch.set_num_threads(2)

CFG = get_config(k=25, prefix_bits=24)


@pytest.fixture(scope="module")
def reference():
    """The reference's forward under `jax.jit` and its numpy args."""
    fwd, args = graft.entry()
    return jax.jit(fwd), args


def _ref_words(codes):
    """The chunk's words by `cbl_tpu`'s own kmer and necklace: [CHUNK, L]
    uint32 limbs."""
    stream = jkmer.pack_stream(codes)
    kmers = jkmer.extract_kmers(stream, tentry.CHUNK, CFG)
    kmers, _ = jkmer.canonicalize(kmers, CFG)
    best, pos = jneck.necklace_pos_auto(kmers, CFG)
    return jneck.pack_word(best, pos, CFG)


def _mixed_case(codes, n_rows):
    """An index of the sorted unique words of a random half of the
    chunk's k-mers, padded with all-ones rows to `n_rows` (None: no
    padding), and a `valid` with a band and scattered rows False."""
    rng = np.random.default_rng(1)
    words = np.asarray(jax.jit(_ref_words)(codes))
    held = rng.random(tentry.CHUNK) < 0.5
    rows = np.unique(words[held], axis=0)  # lexicographic = numeric
    index = np.full((n_rows or len(rows), CFG.word_limbs), 0xFFFFFFFF,
                    dtype=np.uint32)
    index[: len(rows)] = rows
    valid = rng.random(tentry.CHUNK) >= 0.05
    valid[1000:1500] = False
    return index, valid, held


@pytest.mark.parametrize("S", [0, 16, tentry.STREAM_LEN, 1 << 16] + [
    16 * int(n) for n in np.random.default_rng(16).integers(1, 4096, 4)])
def test_pack_stream_matches_numpy_and_jax(S):
    codes = np.random.default_rng(S).integers(0, 4, size=S, dtype=np.uint8)
    got = tkmer.pack_stream(torch.from_numpy(codes))
    assert got.dtype == torch.int64 and got.shape == (S // 16,)
    want = tkmer.np_pack_stream(codes).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(jkmer.pack_stream(jnp.asarray(codes)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("codes", [
    torch.zeros(17, dtype=torch.uint8),  # not a multiple of 16
    torch.zeros(8, dtype=torch.uint8),
    torch.zeros(32, dtype=torch.int64),  # not uint8
    torch.zeros(32, dtype=torch.int32),
    torch.zeros(2, 16, dtype=torch.uint8),  # not 1-D
])
def test_pack_stream_rejects_bad_input(codes):
    with pytest.raises(ValueError):
        tkmer.pack_stream(codes)


def test_entry_args_are_the_reference_args(reference):
    fwd, args = tentry.entry(device="cpu")
    assert fwd is tentry.forward
    codes, valid, index = args
    ref_codes, ref_valid, ref_index = reference[1]
    assert codes.dtype == torch.uint8 and codes.shape == (16_416,)
    assert valid.dtype == torch.bool and valid.shape == (1 << 14,)
    assert index.dtype == torch.int64 and index.shape == (1 << 15,)
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    assert ref_index.shape == (1 << 15, CFG.word_limbs)
    assert bool((index == SENTINEL).all())


def test_forward_matches_reference_on_its_args(reference):
    ref_fwd, ref_args = reference
    want = np.asarray(ref_fwd(*ref_args))
    got = tentry.forward(*tentry.entry(device="cpu")[1])
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.any()  # an index of sentinels


@pytest.mark.parametrize("n_rows", [tentry.INDEX_ROWS, None, 1 << 16])
def test_forward_matches_reference_on_a_mixed_index(reference, n_rows):
    """The reference's 2^15 rows, the words alone (an odd length) and
    2^16 rows: `forward` takes any sorted index."""
    ref_fwd, ref_args = reference
    codes = ref_args[0]
    index, valid, held = _mixed_case(codes, n_rows)
    want = np.asarray(ref_fwd(codes, valid, index))
    args = tentry.args_from_arrays(codes, valid, index, "cpu")
    got = tentry.forward(*args).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < tentry.CHUNK
    assert not got[~valid].any() and got[held & valid].all()
    assert not got[~held & valid].all()


def test_forward_words_match_pallas_b1():
    """The step's words on the first 2048 k-mers: `cbl_tpu`'s kmer steps,
    then `necklace_pos_pallas` in interpret mode, then `pack_word`."""
    codes, valid, _ = tentry.reference_arrays()
    valid[100:200] = False
    got = tentry.words(torch.from_numpy(codes), torch.from_numpy(valid))
    n = 2048
    kmers = jkmer.extract_kmers(jkmer.pack_stream(jnp.asarray(codes)), n, CFG)
    kmers, _ = jkmer.canonicalize(kmers, CFG)
    neck, pos = necklace_pos_pallas(kmers, CFG, interpret=True)
    want = from_limbs(np.asarray(jneck.pack_word(neck, pos, CFG)), 1)
    ok = valid[:n]
    np.testing.assert_array_equal(got[:n].numpy()[ok], want[ok])
    assert bool((got[:n][torch.from_numpy(~ok)] == SENTINEL).all())


def test_forward_on_the_cpu_counts_no_launches(monkeypatch):
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    tentry.forward(*tentry.entry(device="cpu")[1])
    assert not any(LAUNCHES.values())


def test_entry_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry("cuda")
    assert tentry.main(["2"]) == 2  # the default device is the card


def test_main_on_the_cpu(capsys):
    assert tentry.main(["2", "--device", "cpu", "--kmers-per-shard",
                        "8192"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("entry() runs on cpu: mask (16384,) torch.bool, "
                      "0 hits")
    assert out[-1].startswith("dryrun_multichip(2) on cpu: ")


def test_main_fails_on_a_miss(monkeypatch):
    """A hit against the all-sentinel index exits 1; a dryrun whose one
    query record is a hit fails its mixed-query check, as the
    reference's `_dryrun_at_scale` does at 2 x 4096 k-mers."""
    monkeypatch.setattr(tentry, "forward", lambda codes, valid, index:
                        torch.ones(tentry.CHUNK, dtype=torch.bool))
    assert tentry.main(["2", "--device", "cpu"]) == 1
    monkeypatch.undo()
    with pytest.raises(AssertionError):
        tentry.main(["2", "--device", "cpu", "--kmers-per-shard", "4096"])
