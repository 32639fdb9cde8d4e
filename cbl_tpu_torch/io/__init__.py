"""Host I/O: FASTA/FASTQ decoding into 2-bit code streams, and the
native 2-bit packer.

Counterpart of `cbl_tpu/io/__init__.py`.  The parser emits one
concatenated code stream and its record offsets, the input of
`CBL.insert_codes_stream` / `query_codes_stream`.  A C++ decoder (the
port's own `native/fastx.cpp`, built with `g++` at first use into
`cbl_tpu_torch/_build/`) does the byte work: Python opens the file,
through the stdlib `gzip` module when it starts with the gzip magic, and
feeds it in blocks.  Without a C++ compiler a Python parser (the
reference's) takes over; where the two differ (a header with no sequence
line in mid-file, leading junk), each matches its counterpart in
`cbl_tpu.io`.
"""

from __future__ import annotations

import ctypes
import functools
import gzip
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from ..kmer import NUC_LOOKUP

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "fastx.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
BLOCK = 1 << 20  # bytes fed to the native parser a call


class _Result(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("n_codes", ctypes.c_uint64),
        ("offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("n_records", ctypes.c_uint64),
    ]


def native_library_path() -> Path:
    """Where the native library of this source and these flags lives (the
    name carries their hash, so an edited source rebuilds)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libfastx_{h.hexdigest()[:16]}.so"


def _build_native() -> Path | None:
    """Compile the native library unless it is built; None (and one line
    on stderr) where `g++` is missing or fails."""
    so = native_library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, str(NATIVE_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        print(f"cbl_tpu_torch: native fastx build failed ({e}); using the "
              "python parser and the numpy packer", file=sys.stderr)
        return None
    os.replace(tmp, so)  # workers that build at once publish whole files
    return so


@functools.lru_cache(maxsize=None)
def _load_native():
    """The loaded native library (built at first use), or None."""
    so = _build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.fastx_new.restype = ctypes.c_void_p
    lib.fastx_new.argtypes = []
    lib.fastx_feed.restype = None
    lib.fastx_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64]
    lib.fastx_finish.restype = ctypes.POINTER(_Result)
    lib.fastx_finish.argtypes = [ctypes.c_void_p]
    lib.fastx_free.restype = None
    lib.fastx_free.argtypes = [ctypes.c_void_p]
    lib.cbl_pack_stream.restype = None
    lib.cbl_pack_stream.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_void_p]
    return lib


def pack_stream_native(codes) -> np.ndarray | None:
    """[S] uint8 codes (S % 16 == 0) -> [S/16] uint32, 16 bases a word,
    first base most significant (`cbl_pack_stream`); None when the native
    library is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if len(codes) % 16:
        raise ValueError(f"{len(codes)} codes: not a multiple of 16")
    out = np.empty(len(codes) // 16, dtype=np.uint32)
    lib.cbl_pack_stream(codes.ctypes.data, len(codes), out.ctypes.data)
    return out


def parse_fastx(path) -> tuple[np.ndarray, np.ndarray]:
    """Decode a FASTA/FASTQ file (gzip ok) into (codes, offsets).

    codes: [total] uint8 2-bit base codes, invalid characters removed
    (reference filter_map semantics); offsets: [n_records+1] int64 record
    boundaries into codes.
    """
    path = str(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Failed to open {path}")
    lib = _load_native()
    if lib is None:
        return _parse_fastx_py(path)
    parser = lib.fastx_new()
    try:
        with _open_maybe_gzip(path) as f:
            while block := f.read(BLOCK):
                lib.fastx_feed(parser, block, len(block))
        res = lib.fastx_finish(parser).contents
        n, m = int(res.n_codes), int(res.n_records)
        codes = (np.ctypeslib.as_array(res.codes, shape=(n,)).copy() if n
                 else np.zeros(0, dtype=np.uint8))
        offsets = np.ctypeslib.as_array(res.offsets, shape=(m + 1,)).astype(
            np.int64)
        return codes, offsets
    finally:
        lib.fastx_free(parser)


def _open_maybe_gzip(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_fastx_py(path) -> tuple[np.ndarray, np.ndarray]:
    """Pure-python fallback parser (same output contract)."""
    seqs: list[np.ndarray] = []
    offsets = [0]
    total = 0

    def push(chunks):
        nonlocal total
        if not chunks:
            return
        raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        codes = NUC_LOOKUP[raw]
        codes = codes[codes != 255]
        seqs.append(codes)
        total += len(codes)
        offsets.append(total)

    with _open_maybe_gzip(path) as f:
        first = f.readline()
        if not first:
            return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
        if first.startswith(b">"):
            chunks: list[bytes] = []
            for line in f:
                if line.startswith(b">"):
                    push(chunks)
                    chunks = []
                else:
                    chunks.append(line.strip())
            push(chunks)
        elif first.startswith(b"@"):
            # multi-line FASTQ: sequence lines run until the '+' separator;
            # quality lines run until their raw length matches the sequence
            # (quality lines may begin with '@', so count, don't sniff)
            while True:
                chunks = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    chunks.append(line.strip())
                    line = f.readline()
                if not chunks:
                    break
                raw_len = sum(len(c) for c in chunks)
                push(chunks)
                got = 0
                while got < raw_len:
                    q = f.readline()
                    if not q:
                        break
                    got += len(q.strip())
                if not f.readline():  # next @header (or EOF)
                    break
        else:
            raise ValueError(f"{path}: not a FASTA/FASTQ file")
    if not seqs:
        return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
    return np.concatenate(seqs), np.asarray(offsets, dtype=np.int64)


def iter_records(path):
    """Yield per-record [len] uint8 code arrays (convenience/testing)."""
    codes, offsets = parse_fastx(path)
    for i in range(len(offsets) - 1):
        yield codes[offsets[i] : offsets[i + 1]]
