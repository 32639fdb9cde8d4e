"""`cbl_tpu`'s native FASTA/Q library, loaded once before any test runs.

`cbl_tpu.io._load_native()` relinks `cbl_tpu/io/native/_fastx.so` in place
whenever it is older than `fastx.cpp`, and a fresh checkout leaves it older
by milliseconds (git writes `_fastx.so` first). Every pytest-xdist worker
whose first call saw it stale relinked it at once, straight into that
path, so a worker that loaded the file mid-write failed the load ("file
too short") and used the Python parser for the rest of its life:
`test_torch_io`'s native parity cases failed and `test_io_cli`'s native
cases skipped.

This module's body takes an exclusive `flock` on a lock file named by the
library's directory and calls `_load_native()` under it. It runs at module
level, not in `conftest.py` (the reference's, which only sets the platform):
every pytest process, each xdist worker too, collects every test module,
and the controller schedules no test until all workers have collected. So
the first lock holder relinks once before any test runs anywhere, and the
later holders find the library fresh and only load it. No test module
collected before this one calls the native library at import (a spy on
`_load_native` counted no call while the whole suite was collected).

- once collected, the library is fresh and loaded where `g++` exists;
- six processes that load a stale copy of `cbl_tpu` at once, each behind
  the guard, all load it and parse `test_torch_io`'s cases as the
  repository's library does.
Checks are exact.
"""

import fcntl
import gzip
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

if __name__ == "__main__":  # run as a script: the repository root first
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from cbl_tpu import io as ref_io


def load_native_serialised(io_mod):
    """`io_mod._load_native()` under an exclusive lock shared by every
    process that loads the same library; -> the library, or None where it
    cannot be built (no `g++`)."""
    key = hashlib.sha256(
        os.path.realpath(io_mod._NATIVE_DIR).encode()).hexdigest()[:16]
    lock = os.path.join(tempfile.gettempdir(), f"cbl_tpu_fastx_{key}.lock")
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return io_mod._load_native()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


REF_NATIVE = load_native_serialised(ref_io)

# One loader process: import a copy of `cbl_tpu` (the slow part, JAX), wait
# for the others, run this module's guard on the copy, parse every case.
LOADER = """
import os, sys, time
copy, this, cases, ready, go, out, guard = sys.argv[1:]
sys.path.insert(0, copy)
from cbl_tpu import io
assert io.__file__.startswith(copy), io.__file__
open(ready, "w").close()
while not os.path.exists(go):
    time.sleep(0.001)
if guard == "1":
    import importlib.util
    spec = importlib.util.spec_from_file_location("native_build_guard", this)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import numpy as np
res = {}
for i, name in enumerate(sorted(os.listdir(cases))):
    try:
        codes, offsets = io.parse_fastx(os.path.join(cases, name))
    except ValueError as e:
        codes, offsets = np.frombuffer(str(e).encode(), np.uint8), np.zeros(0)
    res[f"codes_{i}"], res[f"offsets_{i}"] = codes, offsets
np.savez(out, loaded=io._native is not None, **res)
"""


def stale_copy(dst):
    """A copy of `cbl_tpu` under `dst` whose `fastx.cpp` is newer than its
    `_fastx.so`; -> the directory to put first on `sys.path`."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(ref_io.__file__)))
    shutil.copytree(src, os.path.join(dst, "cbl_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    native = os.path.join(dst, "cbl_tpu", "io", "native")
    now = time.time()
    os.utime(os.path.join(native, "_fastx.so"), (now - 10, now - 10))
    os.utime(os.path.join(native, "fastx.cpp"), (now, now))
    return str(dst)


def write_cases(dst, cases):
    """Each case plain and gzipped under `dst`; -> their paths, sorted."""
    os.makedirs(dst)
    for name, data in cases.items():
        with open(os.path.join(dst, name + ".fx"), "wb") as f:
            f.write(data)
        with open(os.path.join(dst, name + ".gz"), "wb") as f:
            f.write(gzip.compress(data))
    return [os.path.join(dst, n) for n in sorted(os.listdir(dst))]


def load_at_once(copy, cases, work, n, guard=True, timeout=120):
    """Start `n` loader processes on the stale copy and release them
    together; -> [(exit code, stderr, results or None)] in start order."""
    go = os.path.join(work, "go")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CBL_TPU_PLATFORM="cpu",
               TMPDIR=work)  # the copy's lock file goes with it
    procs, outs, readies = [], [], []
    for i in range(n):
        readies.append(os.path.join(work, f"ready{i}"))
        outs.append(os.path.join(work, f"out{i}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LOADER, copy, os.path.abspath(__file__),
             cases, readies[i], go, outs[i], "1" if guard else "0"],
            cwd=work, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    try:
        while not all(map(os.path.exists, readies)):
            assert time.monotonic() < deadline, "loaders did not start"
            assert all(p.poll() is None for p in procs), "a loader died"
            time.sleep(0.01)
        open(go, "w").close()
        done = []
        for p, out in zip(procs, outs):
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            done.append((p.returncode, err,
                         dict(np.load(out)) if p.returncode == 0 else None))
        return done
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _outcome(fn, path):
    try:
        codes, offsets = fn(path)
    except ValueError as e:
        return np.frombuffer(str(e).encode(), np.uint8), np.zeros(0)
    return codes, offsets


# cases without a bare header, where the native and Python parsers agree
AGREE = ("fasta", "fastq", "fastq_multiline", "crlf", "lowercase", "n_runs",
         "empty")


def test_reference_native_is_fresh_once_collected():
    lib = ref_io._load_native()
    assert lib is REF_NATIVE
    if shutil.which("g++") is not None:
        assert lib is not None
        assert (os.path.getmtime(ref_io._NATIVE_LIB)
                >= os.path.getmtime(ref_io._NATIVE_SRC))


def test_first_loads_at_once_all_succeed(tmp_path):
    from test_torch_io import CASES

    copy = stale_copy(tmp_path / "copy")
    paths = write_cases(str(tmp_path / "cases"), CASES)
    work = tmp_path / "work"
    work.mkdir()
    native = shutil.which("g++") is not None
    want = [_outcome(ref_io.parse_fastx if native else ref_io._parse_fastx_py,
                     p) for p in paths]
    if native:
        assert REF_NATIVE is not None
        for p, w in zip(paths, want):
            if os.path.basename(p).split(".")[0] in AGREE:
                py = _outcome(ref_io._parse_fastx_py, p)
                np.testing.assert_array_equal(w[0], py[0])
                np.testing.assert_array_equal(w[1], py[1])
    done = load_at_once(copy, str(tmp_path / "cases"), str(work), 6)
    for rc, err, res in done:
        assert rc == 0, err
        assert bool(res["loaded"]) == native, err
        for i, (codes, offsets) in enumerate(want):
            np.testing.assert_array_equal(res[f"codes_{i}"], codes)
            np.testing.assert_array_equal(res[f"offsets_{i}"], offsets)
    lib = os.path.join(copy, "cbl_tpu", "io", "native")
    if native:
        assert (os.path.getmtime(os.path.join(lib, "_fastx.so"))
                >= os.path.getmtime(os.path.join(lib, "fastx.cpp")))


def main(rounds=3):
    """Print how many of 6 processes at once load a stale copy of
    `cbl_tpu`'s library without the guard and with it, `rounds` times
    each. Run from the repository root:
    `JAX_PLATFORMS=cpu python tests/test_torch_native_build.py [rounds]`."""
    from test_torch_io import CASES

    for guard in (False, True):
        loaded = total = 0
        for _ in range(rounds):
            with tempfile.TemporaryDirectory() as t:
                copy = stale_copy(os.path.join(t, "copy"))
                write_cases(os.path.join(t, "cases"), CASES)
                os.makedirs(os.path.join(t, "work"))
                for rc, _, res in load_at_once(
                        copy, os.path.join(t, "cases"),
                        os.path.join(t, "work"), 6, guard=guard):
                    total += 1
                    loaded += rc == 0 and bool(res["loaded"])
        print(f"guard={guard}: {loaded} of {total} processes loaded the "
              "native library")


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
