"""The port's FASTA/Q decoding and 2-bit packing (`cbl_tpu_torch.io`,
`kmer.np_pack_stream`) against `cbl_tpu`'s.

- `parse_fastx` through the port's native decoder equals `cbl_tpu`'s
  native `parse_fastx`, and the port's Python parser equals `cbl_tpu`'s
  `_parse_fastx_py` (the two backends of each package differ on a header
  with no sequence line in mid-file and on leading junk; each port
  backend matches its counterpart), on FASTA, FASTQ, gzip, multi-line
  FASTQ, CRLF, lowercase, N runs, empty records and an empty file;
- a file fed in blocks that cut record headers and `+` lines gives the
  same result;
- `np_pack_stream` takes the native packer and equals numpy's shift-or
  passes and `cbl_tpu.kmer.np_pack_stream`.
Checks are exact; random inputs come from numpy.random.default_rng.
"""

import gzip

import numpy as np
import pytest

from cbl_tpu import io as ref_io
from cbl_tpu import kmer as ref_kmer
from cbl_tpu_torch import io as tio
from cbl_tpu_torch import kmer as tkmer

FASTA = (b">read1 some description\nACGTACGTACGTACGTACGTACGTACGTACGT\n"
         b">read2\nTTTTGGGGCCCCAAAA\nacgtn\n>read3\nGATTACAGATTACAGATTACA\n")
FASTQ = (b"@r1\nACGTACGTACGTACGTACGTACGTACGTACGT\n+\n"
         b"IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n"
         b"@r2\nTTTTGGGGCCCCAAAA\n+anything\nIIIIIIIIIIIIIIII\n")
# wrapped sequence and quality, a quality line that begins with '@'
FASTQ_MULTILINE = (b"@r1 desc\nACGTACGTACGTACGT\nACGTACGTACGT\n+\n"
                   b"IIIIIIIIIIIIIIII\n@IIIIIIIIIII\n"
                   b"@r2\nTTTTGGGGCCCCAAAA\n+\nIIIIIIII\nIIIIIIII\n")
CASES = {
    "fasta": FASTA,
    "fastq": FASTQ,
    "fastq_multiline": FASTQ_MULTILINE,
    "crlf": b">a\r\nACGT\r\nAC\r\n>b\r\nGG\r\n",
    "fastq_crlf": b"@a\r\nACGT\r\n+\r\nIIII\r\n@b\r\nGG\r\n+\r\nII\r\n",
    "lowercase": b">a\nacgtACGTacgt\n>b\nggccaatt\n",
    "n_runs": b">a\nACGTNNNNNNNNACGT\nNNNN\n>b\nNNNNNNNN\n>c\nAnCnGnT\n",
    "empty_records": b">a\n\n>b\nACGT\n>c\nNNNN\n>d\nGG\n>e\n>f\n",
    "header_only_mid": b">a\n>b\nACGT\n",
    "fastq_empty_seq": b"@a\n\n+\n\n@b\nACGT\n+\nIIII\n",
    "no_final_newline": b">a\nACGT",
    "empty": b"",
    "leading_blank": b"\n\n>a\nACGT\n",
    "junk": b"hello\nACGT\n",
}


def _write(tmp_path, name, data, gz):
    p = tmp_path / (name + (".gz" if gz else ".fx"))
    p.write_bytes(gzip.compress(data) if gz else data)
    return str(p)


def _equal(got, want):
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _outcome(fn, path):
    try:
        return fn(path)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("name", list(CASES))
def test_parse_native_equals_reference(tmp_path, name, gz):
    assert tio._load_native() is not None
    assert ref_io._load_native() is not None
    path = _write(tmp_path, name, CASES[name], gz)
    _equal(tio.parse_fastx(path), ref_io.parse_fastx(path))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("name", list(CASES))
def test_parse_python_equals_reference(tmp_path, name, gz):
    path = _write(tmp_path, name, CASES[name], gz)
    got = _outcome(tio._parse_fastx_py, path)
    want = _outcome(ref_io._parse_fastx_py, path)
    if isinstance(want, str):
        assert got == want  # "...: not a FASTA/FASTQ file"
    else:
        _equal(got, want)


def test_parse_backends_agree_on_records(tmp_path):
    """Where no record is a bare header, the two backends agree."""
    for name in ("fasta", "fastq", "fastq_multiline", "crlf", "lowercase",
                 "n_runs", "empty"):
        path = _write(tmp_path, name, CASES[name], False)
        _equal(tio.parse_fastx(path), tio._parse_fastx_py(path))


@pytest.mark.parametrize("backend", ["native", "python"])
def test_parse_missing_file(tmp_path, backend):
    fn = tio.parse_fastx if backend == "native" else tio._parse_fastx_py
    with pytest.raises(FileNotFoundError):
        fn(str(tmp_path / "nope.fa"))


PLUS = b"+read"  # `+` lines repeat the name, so a block edge can cut one


def _fq(rng, n, name=b"read"):
    """One FASTQ record of n bases (N among them) on two sequence lines
    and two quality lines, the first of which begins with '@'."""
    seq = bytes(np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, n)])
    half = n // 2
    return (b"@" + name + b"\n" + seq[:half] + b"\n" + seq[half:] + b"\n"
            + PLUS + b"\n@" + b"I" * (half - 1) + b"\n" + b"I" * (n - half)
            + b"\n")


def _fq_len(n, name=b"read"):
    return len(name) + 2 + n + 2 + len(PLUS) + 1 + n + 2


def test_parse_across_block_edges(tmp_path, monkeypatch):
    """Records laid out so that the first three block edges cut a header,
    a `+` line and an '@'-led quality line."""
    block = tio.BLOCK
    rng = np.random.default_rng(5)
    n_next = 600
    seq_end = len(b"@read\n") + n_next + 2  # where the next `+` line starts
    # (bytes of the next record before its cut line, of it before the edge)
    cuts = [(0, 3), (seq_end, 2), (seq_end + len(PLUS) + 1, 4)]
    recs, size = [], 0
    for e, (before_cut, into) in enumerate(cuts):
        edge = (e + 1) * block
        while size + 4 * 900 < edge - 4000:
            n = int(rng.integers(200, 900))
            recs.append((n, b"read"))
            size += _fq_len(n)
        # a record that ends where the next must start: a name one byte
        # longer where the gap is odd (a record is 2n + even bytes)
        gap = edge - into - before_cut - size
        name = b"read" if gap % 2 == 0 else b"read1"
        n_fill = (gap - _fq_len(0, name)) // 2
        assert n_fill >= 20 and _fq_len(n_fill, name) == gap
        recs += [(n_fill, name), (n_next, b"read")]
        size += gap + _fq_len(n_next)
    data = b"".join(_fq(rng, n, name) for n, name in recs)
    assert len(data) == size > 3 * block
    assert data[block - 3 : block + 3] == b"@read\n"
    assert data[2 * block - 2 : 2 * block + 4] == PLUS + b"\n"
    assert data[3 * block - 4 : 3 * block] == b"@III"
    path = str(tmp_path / "blocks.fq")
    open(path, "wb").write(data)
    want = ref_io.parse_fastx(path)
    assert len(want[1]) - 1 == len(recs)
    _equal(tio.parse_fastx(path), want)
    gz = str(tmp_path / "blocks.fq.gz")
    open(gz, "wb").write(gzip.compress(data, compresslevel=1))
    _equal(tio.parse_fastx(gz), want)
    small = str(tmp_path / "small.fq")
    open(small, "wb").write(data[: data.index(b"\n@read", 20_000) + 1])
    # '>' and '+' inside a line are invalid bytes, not record marks
    midline = str(tmp_path / "midline.fa")
    open(midline, "wb").write(b">a\nAC>GT+AC\n>b\nGG>\n+T\n>c\nA\n")
    want_small = [ref_io.parse_fastx(p) for p in (small, midline)]
    for b in (1, 7, 4093):  # blocks from one byte up
        monkeypatch.setattr(tio, "BLOCK", b)
        for p, want in zip((small, midline), want_small):
            _equal(tio.parse_fastx(p), want)


@pytest.mark.parametrize("n", [16, 4096, 4096 + 16, (1 << 22) + 16])
def test_np_pack_stream_native(n, monkeypatch):
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    c = codes.reshape(-1, 16).astype(np.uint32)
    want = np.zeros(len(c), dtype=np.uint32)
    for j in range(16):
        want = (want << np.uint32(2)) | c[:, j]
    native = tio.pack_stream_native(codes)
    assert native is not None and native.dtype == np.uint32
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(tkmer.np_pack_stream(codes), want)
    np.testing.assert_array_equal(ref_kmer.np_pack_stream(codes), want)
    monkeypatch.setattr(tio, "_load_native", lambda: None)  # numpy route
    assert tio.pack_stream_native(codes) is None
    np.testing.assert_array_equal(tkmer.np_pack_stream(codes), want)


def test_pack_stream_native_checks_length():
    with pytest.raises(ValueError):
        tio.pack_stream_native(np.zeros(17, dtype=np.uint8))


def test_native_build_location_and_fallback(tmp_path, monkeypatch, capsys):
    so = tio.native_library_path()
    assert so.parent == tio.BUILD_DIR
    assert so.parent.parent.name == "cbl_tpu_torch"
    assert tio._build_native() == so and so.exists()
    # without a compiler: one line on stderr, then the python parser
    monkeypatch.setattr(tio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert tio._build_native() is None
    assert "native fastx build failed" in capsys.readouterr().err
    assert not list((tmp_path / "build").iterdir())


def test_iter_records(tmp_path):
    path = _write(tmp_path, "fasta", FASTA, False)
    codes, offsets = ref_io.parse_fastx(path)
    got = list(tio.iter_records(path))
    assert len(got) == len(offsets) - 1 == 3
    for i, rec in enumerate(got):
        np.testing.assert_array_equal(rec, codes[offsets[i] : offsets[i + 1]])
