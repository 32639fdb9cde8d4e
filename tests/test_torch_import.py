"""The port stands alone and never falls back from CUDA to the CPU.

- `cbl_tpu_torch` imports with `jax` and `cbl_tpu` made unimportable;
- without a CUDA device, `CBL(device="cuda")` raises, and so does
  `chip_smoke.py` (with no output line), also alone in a directory;
- the kernel wrappers check their inputs, and the CPU path never bumps
  the launch counters;
- a missing `nvcc` is an error, not a fallback.
Checks are exact; inputs come from numpy.random.default_rng.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, LAUNCHES
from cbl_tpu_torch.ops import _build, merge, necklace, scan

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cbl_tpu'] = None\n"
        "import cbl_tpu_torch, cbl_tpu_torch.state, cbl_tpu_torch.cbl\n"
        "import cbl_tpu_torch.ops.sort\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cbl_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_required():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        CBL(k=25, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        CBL(k=25)  # the default device is "cuda"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    _no_cuda()
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cpu_path_never_counts_launches(monkeypatch):
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=6_000, dtype=np.uint8)
    off = np.array([0, 3_000, 6_000], dtype=np.int64)
    idx = CBL(k=25, device="cpu")
    ps = idx.pack_stream(codes, off)
    idx.insert_codes_stream(ps)
    assert idx.query_codes_stream(ps) == (2 * (3_000 - 24),) * 2
    assert idx.query_codes_stream(codes[:4000], np.array([0, 4000]))[0] > 0
    idx.dynamic_round(ps, ps, (codes[:3000], np.array([0, 3000])))
    assert idx.query_codes_stream(ps)[1] == idx.count() == 3_000 - 24
    assert LAUNCHES == {"necklace": 0, "blank": 0, "merge": 0, "slog_scan": 0}


def test_wrappers_check_inputs():
    x32 = torch.zeros(8, dtype=torch.int32)
    x64 = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        necklace.necklace_pos(x32, 50)
    with pytest.raises(ValueError):
        necklace.necklace_pos(x64, 64)
    with pytest.raises(ValueError):
        necklace.necklace_pos(x64.reshape(2, 4), 50)
    with pytest.raises(ValueError):
        scan.blank_mask(x64)
    with pytest.raises(ValueError):
        scan.slog_scan_counts(x32, 0xFF)
    with pytest.raises(ValueError):
        merge.merge_sorted(x64, x32)
    with pytest.raises(ValueError):
        _build.check_cuda(x64)  # a CPU tensor never reaches a kernel


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
