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
main path went through the kernels.
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
            "sort": 0, "bitonic_sort": 0, "bitonic_merge": 0}

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # (in, necklace out, pos out, n, W, stream)
    "cbl_necklace_pos": [_P, _P, _P, _N, _I, _P],
    # (delta, mask out, n_valid out, block sums scratch, n, stream)
    "cbl_blank_mask": [_P, _P, _P, _P, _N, _P],
    # (a col 0, a col 1, na, b col 0, b col 1, nb, out col 0, out col 1,
    # co-rank scratch, stream); the col 1 pointers are null for one column
    "cbl_merge_sorted": [_P, _P, _N, _P, _P, _N, _P, _P, _P, _P],
    # (in col 0, in col 1, out col 0, out col 1, scratch col 0, scratch
    # col 1, n, co-rank scratch, stream)
    "cbl_sort_keys": [_P, _P, _P, _P, _P, _P, _N, _P, _P],
    # (keys, n, qtag, (hits, live) out, tile max scratch, stream)
    "cbl_slog_scan_counts": [_P, _N, _I, _P, _P, _P],
    # (in col 0, in col 1, out col 0, out col 1, work col 0, work col 1,
    # rows of work, n, stream)
    "cbl_bitonic_sort": [_P, _P, _P, _P, _P, _P, _N, _N, _P],
    # (a col 0, a col 1, na, b col 0, b col 1, nb, out col 0, out col 1,
    # work col 0, work col 1, rows of work, stream)
    "cbl_bitonic_merge": [_P, _P, _N, _P, _P, _N, _P, _P, _P, _P, _N, _P],
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
