"""Parity of the port's reference `.cbl` files with `cbl_tpu.interop`.

`cbl_tpu_torch.interop.save_reference` must write the same bytes as
`cbl_tpu.interop.save_reference` for the same index (`cbl_tpu` on the
JAX CPU backend, the port with `device="cpu"`), at one limb and two,
byte-aligned and ragged suffix widths, Vec and Trie buckets, in any
chunking; a file written by either package loads in the other into the
same state.  Hand-made files (a trie bucket, branching tries beside a
Vec bucket, the reference's golden writer bytes) load the same in both,
and corrupt files or wrong constants raise the same errors.
"""

import io

import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu import interop as jinterop
from cbl_tpu import limbs as jlimbs
from cbl_tpu_torch import CBL, interop
from cbl_tpu_torch.limbs import from_limbs

torch.set_num_threads(2)

# (k, prefix_bits, canonical, bases): one limb (K=13) and two, suffixes of
# 6 bits (one byte), 7 bits, 32 bits (4 bytes), 50 bits (7 bytes; tries:
# necklace words crowd the low prefixes), 43 bits (ragged) and 54 bits
CONFIGS = {"k13-pb25": (13, 25, False, 3000), "k13-pb24": (13, 24, True, 3000),
           "k25-pb24": (25, 24, True, 4000), "k25-pb6": (25, 6, False, 8000),
           "k27-pb17": (27, 17, False, 4000), "k27-pb6": (27, 6, True, 8000)}


def _pair(k, prefix_bits, canonical=False, codes=None, words=None):
    """(cbl_tpu index, port index) of the same bases or packed words."""
    kw = dict(k=k, prefix_bits=prefix_bits, canonical=canonical)
    j, t = cbl_tpu.CBL(**kw), CBL(device="cpu", **kw)
    if codes is not None:
        off = np.array([0, len(codes)], dtype=np.int64)
        j.insert_codes_stream(codes, off)
        t.insert_codes_stream(codes, off)
    if words is not None:
        j.wordset.insert_words(jlimbs.from_py_ints(words, j.cfg.word_limbs))
        j.wordset.flush()
        t.wordset.insert_words(torch.tensor(words, dtype=torch.int64))
        t.wordset.flush()
    return j, t


def _same_loaded(jl, tl):
    """Indexes loaded from one file: the same words and state (the words
    went through the pending log and one fold in both)."""
    jw, tw = jl.wordset, tl.wordset
    assert tl.canonical == jl.canonical
    assert (tl.cfg.k, tl.cfg.prefix_bits) == (jl.cfg.k, jl.cfg.prefix_bits)
    state = ("capacity", "_n_upper", "_dups", "_holes", "n_pending")
    assert ({n: getattr(tw, n) for n in state}
            == {n: getattr(jw, n) for n in state})
    assert tl.count() == jl.count()
    np.testing.assert_array_equal(tw.data.numpy(),
                                  from_limbs(np.asarray(jw.data)))
    got, want = tw.words_array(), jw.words_array()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _load_both(path, k, prefix_bits):
    return (jinterop.load_reference(path, k=k, prefix_bits=prefix_bits),
            interop.load_reference(path, k=k, prefix_bits=prefix_bits,
                                   device="cpu"))


@pytest.mark.parametrize("k,prefix_bits,canonical,bases",
                         list(CONFIGS.values()), ids=list(CONFIGS))
def test_files_equal_byte_for_byte(tmp_path, k, prefix_bits, canonical,
                                   bases):
    codes = np.random.default_rng(k + prefix_bits).integers(
        0, 4, size=bases, dtype=np.uint8)
    j, t = _pair(k, prefix_bits, canonical, codes=codes)
    jinterop.save_reference(j, tmp_path / "ref.cbl")
    interop.save_reference(t, tmp_path / "port.cbl")
    want = (tmp_path / "ref.cbl").read_bytes()
    assert (tmp_path / "port.cbl").read_bytes() == want
    sizes = [s for _, s in t.buckets_sizes()]
    assert (max(sizes) > interop.TRIE_THRESHOLD) == (prefix_bits == 6)
    for chunk in (7, 1000) if bases < 5000 else (1000,):
        # prefix groups carried across chunks
        interop.save_reference(t, tmp_path / "c.cbl", chunk_rows=chunk)
        assert (tmp_path / "c.cbl").read_bytes() == want, chunk
    for src in ("ref", "port"):
        jl, tl = _load_both(tmp_path / f"{src}.cbl", k, prefix_bits)
        _same_loaded(jl, tl)
        assert tl.wordset.words_array().tobytes() == (
            t.wordset.words_array().tobytes())
        interop.save_reference(tl, tmp_path / "again.cbl")
        assert (tmp_path / "again.cbl").read_bytes() == want


def test_empty_index(tmp_path):
    j, t = _pair(25, 24)
    jinterop.save_reference(j, tmp_path / "ref.cbl")
    interop.save_reference(t, tmp_path / "port.cbl")
    assert (tmp_path / "port.cbl").read_bytes() == (
        tmp_path / "ref.cbl").read_bytes() == b"\x00\x00"
    jl, tl = _load_both(tmp_path / "port.cbl", 25, 24)
    assert tl.count() == jl.count() == 0


def _trie_file():
    """One Trie bucket (K=25 / PREFIX_BITS=24: 4-byte paths) holding the
    suffixes 0x01020304 and 0x01020399."""
    buf = io.BytesIO()
    buf.write(b"\x00")
    for v in (1, 7, 1):  # one bucket, prefix 7, Trie variant
        interop._write_varint(buf, v)
    for bv, children in (([0x01], 1), ([0x02], 1), ([0x03], 1),
                         ([0x04, 0x99], 0)):
        interop._write_varint(buf, len(bv))
        for i in bv:
            interop._write_varint(buf, i)
        interop._write_varint(buf, children)
    interop._write_varint(buf, 2)  # stored element count
    return buf.getvalue()


def _branching_file():
    """A Vec bucket (prefix 3) and a branching Trie bucket (prefix 9):
    paths (1,2,3,4), (1,2,3,7), (1,2,9,0), (5,0,0,255)."""
    buf = io.BytesIO()
    buf.write(b"\x00")
    for v in (2, 3, 0, 1, 4):  # two buckets; prefix 3, Vec, 1 suffix, 4 B
        interop._write_varint(buf, v)
    buf.write((0xAABBCCDD).to_bytes(4, "little"))
    interop._write_varint(buf, 9)
    interop._write_varint(buf, 1)
    for bv, children in (([1, 5], 2), ([2], 1), ([3, 9], 2), ([4, 7], 0),
                         ([0], 0), ([0], 1), ([0], 1), ([255], 0)):
        interop._write_varint(buf, len(bv))
        for i in bv:
            interop._write_varint(buf, i)
        interop._write_varint(buf, children)
    interop._write_varint(buf, 4)
    return buf.getvalue()


@pytest.mark.parametrize("make,want", [
    (_trie_file, [(7 << 32) | 0x01020304, (7 << 32) | 0x01020399]),
    (_branching_file, [(3 << 32) | 0xAABBCCDD, (9 << 32) | 0x01020304,
                       (9 << 32) | 0x01020307, (9 << 32) | 0x01020900,
                       (9 << 32) | 0x050000FF]),
], ids=["trie", "branching"])
def test_hand_made_files_load_alike(tmp_path, make, want):
    p = tmp_path / "hand.cbl"
    p.write_bytes(make())
    jl, tl = _load_both(p, 25, 24)
    _same_loaded(jl, tl)
    assert list(tl.wordset.export_keys().tolist()) == want
    # written back: Vec buckets (at most 1024 suffixes), equal bytes
    jinterop.save_reference(jl, tmp_path / "ref.cbl")
    interop.save_reference(tl, tmp_path / "port.cbl")
    assert (tmp_path / "port.cbl").read_bytes() == (
        tmp_path / "ref.cbl").read_bytes()


def test_trie_writer_bytes(tmp_path, monkeypatch):
    """Buckets above the threshold go out as tries: the real threshold
    (1030 suffixes beside a 3-suffix Vec bucket), and the golden
    branching trie with the threshold patched to 2 in both packages."""
    words = [(7 << 32) | s for s in range(1030)] + [
        (9 << 32) | s for s in (5, 17, 200)]
    j, t = _pair(25, 24, words=words)
    jinterop.save_reference(j, tmp_path / "ref.cbl")
    interop.save_reference(t, tmp_path / "port.cbl")
    raw = (tmp_path / "port.cbl").read_bytes()
    assert raw == (tmp_path / "ref.cbl").read_bytes()
    r = interop._Reader(raw)
    assert (r.take(1), r.varint(), r.varint(), r.varint()) == (b"\x00", 2, 7,
                                                               1)
    monkeypatch.setattr(interop, "TRIE_THRESHOLD", 2)
    monkeypatch.setattr(jinterop, "TRIE_THRESHOLD", 2)
    j, t = _pair(25, 24, words=[(9 << 32) | 0x01020304,
                                (9 << 32) | 0x01020307,
                                (9 << 32) | 0x01020900,
                                (9 << 32) | 0x050000FF])
    interop.save_reference(t, tmp_path / "golden.cbl")
    jinterop.save_reference(j, tmp_path / "golden-ref.cbl")
    golden = _branching_file()
    # the golden file without its Vec bucket: one bucket, the trie
    want = b"\x00\x01" + golden[golden.index(b"\x09\x01"):]
    assert (tmp_path / "golden.cbl").read_bytes() == want
    assert (tmp_path / "golden-ref.cbl").read_bytes() == want


def _errors_alike(path, k, prefix_bits=24):
    with pytest.raises(ValueError) as want:
        jinterop.load_reference(path, k=k, prefix_bits=prefix_bits)
    with pytest.raises(ValueError) as got:
        interop.load_reference(path, k=k, prefix_bits=prefix_bits,
                               device="cpu")
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_bad_files_raise_alike(tmp_path):
    codes = np.random.default_rng(1).integers(0, 4, size=400, dtype=np.uint8)
    _, t = _pair(25, 24, codes=codes)
    good = tmp_path / "good.cbl"
    interop.save_reference(t, good)
    raw = good.read_bytes()
    # wrong constants: K=27 and K=13 misread a K=25 file
    _errors_alike(good, 27)
    _errors_alike(good, 13)
    bad = tmp_path / "bad.cbl"
    # a Vec bucket of one 3-byte suffix where K=25 stores 4 bytes
    bad.write_bytes(b"\x00\x01\x05\x00\x01\x03\x01\x02\x03\x04")
    assert "suffix width 3B != expected 4B" in _errors_alike(bad, 25)
    bad.write_bytes(raw + b"\x00")
    assert "trailing bytes" in _errors_alike(bad, 25)
    bad.write_bytes(raw[:-3])
    assert "truncated" in _errors_alike(bad, 25)
    trie = bytearray(_trie_file())
    trie[-1] = 3  # stored element count 3, two leaves
    bad.write_bytes(bytes(trie))
    assert "stored element count" in _errors_alike(bad, 25)
    bad.write_bytes(b"\x00\x02\x05\x00\x00\x05\x00\x00")  # prefix 5 twice
    assert "not ascending" in _errors_alike(bad, 25)
    bad.write_bytes(b"\x00\x01\x05\x02")
    assert "unknown bucket variant" in _errors_alike(bad, 25)
    # K=31, refused until wide K was ported: a K=25 file read as K=31
    # (6-byte suffixes expected) raises alike
    assert _errors_alike(good, 31)


def test_load_reference_defaults_to_the_card(tmp_path):
    """Without a CUDA device the default raises; no CPU fallback."""
    _, t = _pair(13, 24, words=[1 << 20, 5 << 20])
    interop.save_reference(t, tmp_path / "x.cbl")
    if torch.cuda.is_available():
        got = interop.load_reference(tmp_path / "x.cbl", k=13)
        assert got.device.type == "cuda" and got.count() == 2
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.load_reference(tmp_path / "x.cbl", k=13)
