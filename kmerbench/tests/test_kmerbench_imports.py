"""What a run refuses: JAX or the JAX package loaded, CBL_TORCH_*
settings, no card, a checkout without the program."""

import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from kmerbench import run, spec

ROOT = str(spec.ROOT)


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        "from kmerbench.run import run_cell, forbidden_modules\n"
        "from kmerbench.tests.tiny import tiny_cell, CPU\n"
        "for name in ('k25_p24.query_reads', 'k59_p28.dynamic_window'):\n"
        "    r = run_cell(tiny_cell(name), 3, 0.2, True, CPU)\n"
        "    assert r['correct'], r\n"
        "assert 'cbl_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("cbl_tpu", ["cbl_tpu"]),
    ("cbl_tpu.ops.sort_pallas", ["cbl_tpu"]), ("cbl_tpu_torch.cbl", []),
    ("jaxtyping", []), ("cbl_tpu_other", [])])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name,
                                                         found):
    for mod in [m for m in sys.modules
                if m.split(".")[0] in run.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == found


ARGS = ["--workload", "k25_p24.query_reads", "--seed", "1", "--seconds", "1"]


def test_a_cbl_torch_setting_is_refused():
    env = dict(os.environ, CBL_TORCH_SORT="bitonic")
    out = subprocess.run([sys.executable, "-m", "kmerbench.run", *ARGS],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    assert "CBL_TORCH_SORT" in out.stderr


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "kmerbench.run", *ARGS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "kmerbench"), tmp_path / "kmerbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "kmerbench.run", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""
