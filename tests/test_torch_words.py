"""The word pipeline's one kernel: B1 from the packed stream.

On a CUDA card (marked `gpu`, skipped elsewhere; decided inside the
`cuda` fixture), `necklace.stream_words` (one launch of B1 that builds
each k-mer from the stream, canonicalizes, rotates, packs and blanks)
against the plain chain `kmer.extract_kmers` -> `kmer.canonicalize` ->
`necklace_pos_plain` -> `pack_word` -> `where(mask)`, exact, at K = 11,
25, 31 (W = 62, the last one-column k-mer), 33 (W = 66, the first
two-column one) and 59; and `cbl._device_words` as B2 then B1 alone.

On the CPU: the pipeline takes the plain chain and launches nothing,
`words.fused` counts only on CUDA, the wrapper refuses what the kernel
does not take, and `_device_words` keeps its signature.  The file
imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_words.py -q
"""

import inspect

import numpy as np
import pytest
import torch

from cbl_tpu_torch import cbl, kmer, necklace
from cbl_tpu_torch.config import get_config
from cbl_tpu_torch.limbs import SENTINEL, key_cols
from cbl_tpu_torch.ops import LAUNCHES
from cbl_tpu_torch.ops import necklace as b1
from cbl_tpu_torch.ops.necklace import necklace_pos_plain
from cbl_tpu_torch.ops.scan import blank_mask
from cbl_tpu_torch.profiling import COUNTERS

# (K, prefix bits): W = 22, 50, 62 (one column), 66, 118 (two)
CONFIGS = [(11, 20), (25, 24), (31, 24), (33, 24), (59, 28)]
# the slabs: n rows, not a multiple of 16 or 32 where it can be
CASES = ["ragged", "records", "padded_tail", "all_blank", "warp_halo",
         "past_end"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chain(stream, n, cfg, canonical, blank):
    """The plain chain, written out step by step."""
    kmers = kmer.extract_kmers(stream, n, cfg)
    if canonical:
        kmers, _ = kmer.canonicalize(kmers, cfg)
    neck, pos = necklace_pos_plain(kmers, cfg.kmer_bits)
    words = necklace.pack_word(neck, pos, cfg)
    return words if blank is None else torch.where(blank.bool(), SENTINEL,
                                                   words)


def _slab(case: str, k: int, seed: int):
    """(packed stream [S/16] int64, n, blank starts, blank ends): the
    intervals of k-mer starts that the slab blanks, as `cbl` hands them
    to `blank_delta`; a stream of the fewest words n k-mers need, so the
    last rows read words past its end."""
    rng = np.random.default_rng(seed)
    n = {"ragged": 4099, "records": 5003, "padded_tail": 3001,
         "all_blank": 2053, "warp_halo": 1029, "past_end": 4096}[case]
    n_words = (n + k - 1 + 15) // 16
    codes = rng.integers(0, 4, size=16 * n_words, dtype=np.uint8)
    if case == "ragged":
        codes[:64] = 0  # poly-A, then poly-T: the all-zero and all-ones
        codes[64:256] = 2  # k-mers and their equal rotations
    stream = kmer.pack_stream(torch.from_numpy(codes))
    starts, ends = [], []
    if case == "records":  # record ends at random places, each a halo
        for end in np.sort(rng.choice(np.arange(k, n), 20, replace=False)):
            starts.append(end - k + 1)
            ends.append(end)
    elif case == "padded_tail":  # the last third is the slab's padding
        starts.append(2 * n // 3)
        ends.append(n + 1)
    elif case == "all_blank":
        starts.append(0)
        ends.append(n)
    elif case == "warp_halo":  # halos across row 32 m, one a whole warp
        for end in (64 + k // 2, 512 + 16, 800 + 32 + k - 1):
            starts.append(end - k + 1)
            ends.append(end)
        starts.append(320)
        ends.append(384)
    return stream, n, np.array(starts, dtype=np.int64), np.array(
        ends, dtype=np.int64)


def _blank(starts, ends, n, device):
    s = torch.from_numpy(starts).to(device)
    e = torch.from_numpy(ends).to(device)
    return blank_mask(cbl.blank_delta(s, e, n))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_fused_words_match_plain_chain(cuda, k, prefix_bits, canonical,
                                       case):
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    stream, n, starts, ends = _slab(case, k, seed=k * 10 + len(case))
    mask, _ = _blank(starts, ends, n, cuda)
    stream = stream.to(cuda)
    key = "necklace_wide" if cfg.kmer_bits > 62 else "necklace"
    for blank in (mask, None):
        before = LAUNCHES[key]
        got = necklace.stream_words(stream, n, cfg, canonical, blank)
        want = _chain(stream, n, cfg, canonical, blank)
        torch.cuda.synchronize()
        assert LAUNCHES[key] == before + 1
        assert got.shape == want.shape == (
            (n,) if key_cols(cfg) == 1 else (2, n))
        assert torch.equal(got, want), (k, canonical, case, blank is None)
        if case == "all_blank" and blank is not None:
            assert bool((got == SENTINEL).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k,prefix_bits", [(25, 24), (59, 28)])
def test_device_words_is_b2_then_b1(cuda, k, prefix_bits):
    """`_device_words` on the card: one B2 and one B1 launch, one
    `words.fused` count, the words and n_valid of the CPU path."""
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    stream, n, starts, ends = _slab("records", k, seed=7)
    args = (torch.from_numpy(starts), torch.from_numpy(ends), n, cfg, False)
    want, want_valid = cbl._device_words(stream, *args)
    launches, fused = dict(LAUNCHES), COUNTERS.get("words.fused", 0)
    got, n_valid = cbl._device_words(
        stream.to(cuda), *(a.to(cuda) for a in args[:2]), *args[2:])
    torch.cuda.synchronize()
    moved = {name: LAUNCHES[name] - launches[name] for name in LAUNCHES
             if LAUNCHES[name] != launches[name]}
    assert moved == {"blank": 1,
                     "necklace_wide" if k == 59 else "necklace": 1}
    assert COUNTERS["words.fused"] == fused + 1
    assert torch.equal(got.cpu(), want) and int(n_valid) == int(want_valid)


@pytest.mark.parametrize("case", ["records", "past_end"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_cpu_words_take_the_plain_chain(k, prefix_bits, canonical, case):
    """On the CPU `_kmer_words` is the plain chain (blanked rows SENTINEL),
    launches no kernel and leaves `words.fused` alone."""
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    stream, n, starts, ends = _slab(case, k, seed=k)
    mask, _ = _blank(starts, ends, n, "cpu")
    launches, fused = dict(LAUNCHES), COUNTERS.get("words.fused", 0)
    for blank in (mask, None):
        got = cbl._kmer_words(stream, n, cfg, canonical, blank)
        assert torch.equal(got, _chain(stream, n, cfg, canonical, blank))
    assert dict(LAUNCHES) == launches
    assert COUNTERS.get("words.fused", 0) == fused


@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_words_past_the_stream_read_as_zero(k, prefix_bits):
    """What the kernel relies on: the chain's words do not change when
    the stream is given more zero words than the k-mers reach."""
    cfg = get_config(k=k, prefix_bits=prefix_bits)
    stream, n, _, _ = _slab("past_end", k, seed=3)
    longer = torch.cat([stream, stream.new_zeros(9)])
    assert torch.equal(necklace.stream_words(stream, n, cfg, False),
                       necklace.stream_words(longer, n, cfg, False))


def test_device_words_signature():
    assert list(inspect.signature(cbl._device_words).parameters) == [
        "stream", "starts", "ends", "nk_pad", "cfg", "canonical"]


@pytest.mark.parametrize("bad", ["cpu_stream", "int32_stream", "mask_len",
                                 "mask_dtype", "odd_width", "one_column"])
def test_stream_words_wrapper_refuses(bad):
    """The CUDA wrapper refuses, before any launch, what the kernel does
    not take (a CPU stream too: there is no CPU fallback)."""
    stream = torch.zeros(64, dtype=torch.int64)
    blank = torch.zeros(100, dtype=torch.int32)
    args = dict(stream=stream, n=100, W=50, pos_bits=6, n_cols=1,
                canonical=False, blank=blank)
    args.update({
        "cpu_stream": {},
        "int32_stream": {"stream": stream.int()},
        "mask_len": {"blank": blank[:99]},
        "mask_dtype": {"blank": blank.bool()},
        "odd_width": {"W": 51},
        "one_column": {"W": 58},  # 64-bit words in one column
    }[bad])
    with pytest.raises(ValueError):
        b1.stream_words(**args)
