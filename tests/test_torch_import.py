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
from cbl_tpu_torch.ops import _build, bitonic, merge, necklace, scan, sort

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
        "import cbl_tpu_torch.ops.sort, cbl_tpu_torch.ops.bitonic\n"
        "import cbl_tpu_torch.io, cbl_tpu_torch.cli, cbl_tpu_torch.profiling\n"
        "import cbl_tpu_torch.examples.build_from_fastx\n"
        "import cbl_tpu_torch.examples.dynamic_rounds\n"
        "import cbl_tpu_torch.examples.bench_necklace_throughput\n"
        "import cbl_tpu_torch.parallel, cbl_tpu_torch.parallel.shard\n"
        "import cbl_tpu_torch.parallel.distributed\n"
        "import cbl_tpu_torch.examples.sharded_build\n"
        "import cbl_tpu_torch.examples.repartition_recovery\n"
        "import cbl_tpu_torch.bench, cbl_tpu_torch.parallel.dryrun\n"
        "import cbl_tpu_torch.entry\n"
        "assert cbl_tpu_torch.io._load_native() is not None\n"
        "import chip_smoke, runpy\n"
        "for mod in ('cbl_tpu_torch', 'cbl_tpu_torch.bench',\n"
        "            'cbl_tpu_torch.entry'):\n"
        "    sys.argv = [mod, '--help']\n"
        "    try:\n"
        "        runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cbl_tpu', 'bench', '__graft_entry__') and "
        "sys.modules[m] is not None]\n"
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


def test_mesh_defaults_to_the_cards():
    """`make_mesh()` (and so a `ShardedCBL` without a mesh) shards over
    the CUDA cards and raises without one; a named device does not fall
    back either."""
    from cbl_tpu_torch.parallel import ShardedCBL, make_mesh

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedCBL(k=25)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(["cuda", "cuda"])


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
    with sort.use_sort_mode("mergepath"):  # the separate calls, B5's mode
        idx.insert_codes_stream(codes[:3000], np.array([0, 3000]))
        assert idx.query_codes_stream(ps)[1] == 2 * (3_000 - 24)
        idx.remove_codes_stream(codes[3000:], np.array([0, 3000]))
        assert idx.count() == 3_000 - 24
        assert idx.contains_kmers([0, 1]).tolist() == [False, False]
    other = CBL(k=25, device="cpu")
    other.insert_codes_stream(codes[:3000], np.array([0, 3000]))
    for merge_mode, sort_mode in (("bitonic", "bitonic"),  # B7 and B6's
                                  ("sort", "bitonic"),
                                  ("mergepath", "library")):
        with sort.use_merge_mode(merge_mode), sort.use_sort_mode(sort_mode):
            both = idx & other
            assert both.count() == (idx | other).count() == 3_000 - 24
            assert (idx - other).count() == (idx ^ other).count() == 0
            assert both.query_codes_stream(ps)[1] == 3_000 - 24
            assert both.contains_kmers([0]).tolist() == [False]
    wide = CBL(k=27, device="cpu")  # a round over the log's tag column
    assert wide.dynamic_round(*[(codes, off)] * 3) == (2 * (3_000 - 26),) * 2
    assert LAUNCHES == {"necklace": 0, "blank": 0, "merge": 0, "slog_scan": 0,
                        "sort": 0, "bitonic_sort": 0, "bitonic_merge": 0,
                        "necklace_wide": 0, "merge_3col": 0, "sort_3col": 0,
                        "bitonic_sort_3col": 0, "bitonic_merge_3col": 0,
                        "slog_scan_tag": 0, "slog_scan_tag_3col": 0,
                        "probe": 0, "probe_rows": 0, "probe_valid_rows": 0}


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
        merge.sort_mergepath(x32)
    with pytest.raises(ValueError):
        merge.sort_mergepath((x64, x64[:4]))
    with pytest.raises(ValueError):
        bitonic.bitonic_sort(x32)
    with pytest.raises(ValueError):
        bitonic.bitonic_sort((x64, x64[:4]))
    with pytest.raises(ValueError):
        bitonic.bitonic_sort(x64.reshape(2, 4))
    with pytest.raises(ValueError):
        bitonic.bitonic_merge(x64, x32)
    with pytest.raises(ValueError):
        bitonic.bitonic_merge((x64, x64), x64)
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
