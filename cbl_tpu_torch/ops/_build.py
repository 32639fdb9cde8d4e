"""Build and load the port's CUDA kernels.

The sources in `cbl_tpu_torch/csrc/*.cu` are compiled by `nvcc` for
`sm_90a`, one process per source, all started together, and linked into
ONE shared library with a plain C interface, at first use, into
`cbl_tpu_torch/_build/` (listed in `.gitignore`).  The file name carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  The library is bound with `ctypes`.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check_error` turns a non-zero code into an
exception.  A missing `nvcc` or a failed build raises: there is no
fallback to the plain tensor versions for CUDA tensors.

`LAUNCHES` counts kernel launches per wrapper (a wrapper adds one where
it launches its kernel, and nowhere else), so a run can show that its
main path went through the kernels; B8's wrapper also adds the rows its
launch searched (`probe_rows`) and, where its caller knows them, the
valid ones among them (`probe_valid_rows`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

LAUNCHES = {"necklace": 0, "blank": 0, "merge": 0, "slog_scan": 0,
            "sort": 0, "bitonic_sort": 0, "bitonic_merge": 0,
            # wide K: B1 on two-column k-mers, the sorts and merges at
            # three columns (`ops.merge.launch_key`)
            "necklace_wide": 0, "merge_3col": 0, "sort_3col": 0,
            "bitonic_sort_3col": 0, "bitonic_merge_3col": 0,
            # B4 over a log with a tag column: C = 2 (a one-column word)
            # and C = 3 (a two-column word)
            "slog_scan_tag": 0, "slog_scan_tag_3col": 0,
            # B8, the probe join's search: launches, the query rows they
            # searched and the valid (non-SENTINEL) rows among them
            "probe": 0, "probe_rows": 0, "probe_valid_rows": 0}

# passes over device memory (kernels that read and write every row) that the
# last launch of each network, sort or scan reported
PASSES = {"sort": 0, "bitonic_sort": 0, "bitonic_merge": 0, "blank": 0,
          "slog_scan": 0, "slog_scan_tag": 0, "slog_scan_tag_3col": 0}

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # (in, necklace out, pos out, n, W, stream)
    "cbl_necklace_pos": [_P, _P, _P, _N, _I, _P],
    # (in col 0, in col 1, necklace col 0, necklace col 1, pos out, n, W,
    # stream)
    "cbl_necklace_pos_wide": [_P, _P, _P, _P, _P, _N, _I, _P],
    # (packed stream, its words, blank mask or null, word col 0, word col 1
    # or null, n, W, pos_bits, canonical, stream)
    "cbl_stream_words": [_P, _N, _P, _P, _P, _N, _I, _I, _I, _P],
    # (delta, mask out, n, scratch: n_valid out + ticket + tile statuses,
    # launches out, stream)
    "cbl_blank_mask": [_P, _P, _N, _P, _P, _P],
    # The sorts and merges take each operand as a C array of C column
    # pointers, and C (1 to 3).
    # (a cols, na, b cols, nb, out cols, C, co-rank scratch, stream)
    "cbl_merge_sorted": [_P, _N, _P, _N, _P, _I, _P, _P],
    # (in cols, out cols, tmp cols, C, n, co-rank scratch, passes out,
    # stream)
    "cbl_sort_keys": [_P, _P, _P, _I, _N, _P, _P, _P],
    # (keys, n, qtag, scratch: (hits, live) out + ticket + tile statuses,
    # launches out, stream)
    "cbl_slog_scan_counts": [_P, _N, _I, _P, _P, _P],
    # (cols: the word's columns and the tag's, C (2 or 3), n, qtag,
    # scratch as above, launches out, stream)
    "cbl_slog_scan_tag_counts": [_P, _I, _N, _N, _P, _P, _P],
    # (in cols, out cols, work cols, C, rows of work, n, passes out,
    # stream)
    "cbl_bitonic_sort": [_P, _P, _P, _I, _N, _N, _P, _P],
    # (a cols, na, b cols, nb, out cols, C, co-rank scratch, passes out,
    # stream)
    "cbl_bitonic_merge": [_P, _N, _P, _N, _P, _I, _P, _P, _P],
    # (index cols, n, sample cols, m, stride log, query cols, nq, C, hits
    # out, stream)
    "cbl_probe_hits": [_P, _N, _P, _N, _I, _P, _N, _I, _P, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels of cbl_tpu_torch cannot be built"
        )
    return path


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcbl_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet; returns (path, seconds
    spent compiling, 0.0 when it was already built)."""
    so = _library_path()
    if so.exists():
        return so, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"tmp{os.getpid()}"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [so.with_suffix(f".{s.stem}.{tmp}.o") for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        results.append((cmd, proc.returncode, out, err))
    lib = so.with_suffix(f".{tmp}.so")
    link = [nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)]
    if all(rc == 0 for _, rc, _, _ in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(
        "".join(out + err for _, _, out, err in results))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, rc, _, err in results:
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err[-4000:]}"
            )
    os.replace(lib, so)
    return so, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_cuda(*tensors: torch.Tensor) -> None:
    """Every tensor a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if dev.index != torch.cuda.current_device():
        # the C entry points launch on the current device
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed: cudaError {err}")


def check_passes(launched: int, planned: list, kernel: str) -> None:
    """A C entry point reports how many passes over device memory it
    launched; the Python schedule its plain version walks must have as
    many, so that the two cannot drift apart unseen."""
    if launched != len(planned):
        raise RuntimeError(
            f"CUDA kernel {kernel!r} launched {launched} passes, the "
            f"schedule has {len(planned)}: {planned}")
