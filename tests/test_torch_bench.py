"""The port's benchmark (`cbl_tpu_torch.bench`), the words memo of its
streams and `parallel.dryrun_multichip`, on the CPU.

- `make_genome_corpus` equals the root `bench.py`'s array for array;
- the counts of `run_static`, `run_tpu_records` (plain and canonical),
  `run_tpu_dynamic` and `run_tpu_sharded_dynamic` equal those of
  `bench.py`'s own functions on the JAX CPU backend;
- `main(["--device", "cpu", ...])` in each mode and the default run
  prints one line with `bench.py`'s keys plus `device`, `launches` and
  the per-repeat rates, every count checked against `bench/baseline.cpp`
  (built here into a temporary directory); `largek`'s distinct count is
  numpy's set of 59-mers;
- a baseline count that is off by one, or a workload that fails, makes
  the run raise with no line; without a card and without `--device` the
  run exits non-zero;
- every step that reads or writes a PackedStream's words memo counts as
  `cbl_tpu`'s does, and leaves every stream's memo filled;
- `dryrun_multichip` passes on 4 CPU shards, its final count that of a
  single `CBL` driven through the same steps.
Inputs come from numpy.random.default_rng; every comparison is exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import cbl_tpu
from cbl_tpu_torch import CBL
from cbl_tpu_torch import bench as tbench
from cbl_tpu_torch.parallel import dryrun_multichip

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = 1 << 16


@pytest.fixture(scope="module")
def baseline_dir(tmp_path_factory):
    """`bench/baseline.cpp` built once into this module's own directory."""
    build = tmp_path_factory.mktemp("bench_build")
    mp = pytest.MonkeyPatch()
    mp.setattr(tbench, "BUILD_DIR", build)
    tbench.build_baseline()
    mp.undo()
    return build


@pytest.fixture
def run_main(baseline_dir, monkeypatch, capsys):
    """main(argv) on the CPU -> (stdout lines, stderr)."""
    monkeypatch.setattr(tbench, "BUILD_DIR", baseline_dir)

    def run(*argv):
        assert tbench.main(["--device", "cpu", *map(str, argv)]) == 0
        out, err = capsys.readouterr()
        return out.splitlines(), err
    return run


def _codes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)


@pytest.mark.parametrize("bases,kw", [
    (1 << 18, {}),
    (1 << 19, {"seed": 5, "read_len": 65_536, "qread_len": 8_192}),
])
def test_genome_corpus_equals_bench(bases, kw):
    got, want = tbench.make_genome_corpus(bases, **kw), \
        jbench.make_genome_corpus(bases, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


COUNTS = ("distinct", "total", "positive", "ops")


def _same_counts(got, want):
    keys = [k for k in COUNTS if k in want]
    assert keys and {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("canonical", [False, True])
def test_static_counts_equal_bench(canonical):
    codes = _codes(1 << 17)
    want = jbench.run_tpu(codes, 1 << 19, 1 << 21, 1, canonical=canonical)
    got = tbench.run_static(codes, 1 << 19, 1 << 21, 1, canonical=canonical,
                            device="cpu")
    _same_counts(got, want)
    assert got["positive"] == got["total"] == (1 << 17) - 24


@pytest.mark.parametrize("canonical", [False, True])
def test_genome_counts_equal_bench(canonical):
    corpus = jbench.make_genome_corpus(1 << 17)
    want = jbench.run_tpu_records(*corpus, 1 << 19, 1 << 21, 1,
                                  canonical=canonical)
    got = tbench.run_tpu_records(*corpus, 1 << 19, 1 << 21, 1,
                                 canonical=canonical, device="cpu")
    _same_counts(got, want)
    assert 0 < got["positive"] < got["total"]


@pytest.mark.parametrize("sharded", [False, True])
def test_dynamic_counts_equal_bench(sharded):
    codes = _codes(tbench.SEGS << 14, seed=1)
    if sharded:
        want = jbench.run_tpu_sharded_dynamic(codes, 1)
        got = tbench.run_tpu_sharded_dynamic(codes, 1, device="cpu")
    else:
        want = jbench.run_tpu_dynamic(codes, 1)
        got = tbench.run_tpu_dynamic(codes, 1, device="cpu")
    _same_counts(got, want)
    assert got["ops"] == want["ops"] > 0 and 0 < got["positive"]


def _line(lines):
    assert lines, "no output line"
    return json.loads(lines[-1])


def _common_keys(out, repeats):
    assert out["device"] == {"platform": "cpu", "name": "cpu",
                             "power_limit": None, "count": 1}
    # the CPU path never launches a kernel
    assert out["launches"] and not any(out["launches"].values())
    assert len(out["value_repeats"]) == repeats
    if "set-algebra" in out["metric"]:
        # bench.py's value: the rows over the sum of each operation's best
        assert out["value"] >= max(out["value_repeats"]) > 0
    else:
        assert out["value"] == max(out["value_repeats"]) > 0


def test_default_line_has_every_key(run_main):
    lines, err = run_main("--bases", BASES, "--repeats", 2)
    assert len(lines) == 1
    out = _line(lines)
    for key in tbench.DEFAULT_KEYS:
        assert out[key] is not None, key
    assert set(out) == {*tbench.DEFAULT_KEYS, "device", "launches",
                        "algebra_ms_repeats",
                        *(f"{k}_repeats" for k in tbench.RATE_KEYS)}
    _common_keys(out, 2)
    for key in tbench.RATE_KEYS:
        reps = out[f"{key}_repeats"]
        assert len(reps) == 2 and out[key] == max(reps), key
    assert set(out["algebra_ms"]) == {"union", "inter", "diff", "symdiff"}
    assert out["algebra_ms"] == {n: min(v) for n, v in
                                 out["algebra_ms_repeats"].items()}
    checked = {line[len("check: "):].split(" equals ")[0].rsplit(" ", 1)[0]
               for line in err.splitlines() if line.startswith("check: ")}
    assert checked == tbench.DEFAULT_CHECKS


@pytest.mark.parametrize("argv", [
    ("--mode", "static", "--headline-only"),
    ("--mode", "static", "--canonical"),
    ("--mode", "dynamic"),
    ("--mode", "sharded-dynamic"),
    ("--mode", "genome"),
    ("--mode", "genome", "--canonical"),
    ("--mode", "algebra"),
    ("--mode", "static", "--skip-baseline", "--headline-only"),
])
def test_mode_lines(run_main, argv):
    lines, err = run_main("--bases", BASES, "--repeats", 2, *argv)
    out = _line(lines)
    assert len(lines) == 1
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device",
                        "launches", "value_repeats"}
    _common_keys(out, 2)
    has_baseline = "--skip-baseline" not in argv and "algebra" not in argv
    assert (out["vs_baseline"] is not None) == has_baseline
    assert ("check: " in err) == ("--skip-baseline" not in argv)


def test_largek_counts_numpy_59mers(run_main):
    lines, err = run_main("--bases", BASES, "--repeats", 1, "--mode",
                          "largek")
    out = _line(lines)
    _common_keys(out, 1)
    assert out["vs_baseline"] is None
    codes = _codes(BASES)
    windows = np.lib.stride_tricks.sliding_window_view(codes, 59)
    want = len(np.unique(windows, axis=0))
    got = [eval(line.split(": ", 1)[1])["distinct"]
           for line in err.splitlines() if "largek repeat" in line]
    assert got == [want]


def test_trace_writes_a_chrome_trace(run_main, tmp_path):
    out = _line(run_main("--bases", 20_000, "--repeats", 1, "--mode",
                         "static", "--headline-only", "--trace",
                         tmp_path)[0])
    assert out["value"] > 0
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def _off_by_one(fn, key):
    def wrapped(*a, **kw):
        r = dict(fn(*a, **kw))
        r[key] += 1
        return r
    return wrapped


@pytest.mark.parametrize("target,key", [
    ("run_baseline", "distinct"),           # the static headline
    ("run_baseline_dynamic", "positive"),   # the dynamic extras
    ("run_baseline_records", "positive"),   # the genome extra
    ("algebra_baseline", "union"),          # the set operations
])
def test_count_mismatch_raises(run_main, monkeypatch, capsys, target, key):
    monkeypatch.setattr(tbench, target,
                        _off_by_one(getattr(tbench, target), key))
    with pytest.raises(AssertionError, match="COUNT MISMATCH"):
        run_main("--bases", BASES, "--repeats", 1)
    assert not capsys.readouterr().out  # no rate printed


def test_failed_extra_raises(run_main, monkeypatch, capsys):
    def fail(*a, **kw):
        raise RuntimeError("genome workload failed")

    monkeypatch.setattr(tbench, "run_tpu_records", fail)
    with pytest.raises(RuntimeError, match="genome workload failed"):
        run_main("--bases", BASES, "--repeats", 1)
    assert not capsys.readouterr().out


def test_no_card_exits_non_zero(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert tbench.main(["--bases", "1000"]) == 2
    out, err = capsys.readouterr()
    assert not out and "--device cpu" in err
    proc = subprocess.run([sys.executable, "-m", "cbl_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and not proc.stdout
    assert "--device cpu" in proc.stderr


def _cache_steps(make, pack, codes):
    """Every memo read and write of a PackedStream: a build into an empty
    index and its self-query, a remove and a query against the pending
    log, an insert into a built index, rounds on packed streams, then a
    flush and a query.  -> (results, the streams)."""
    a, b, c = codes[:6_000], codes[6_000:12_000], codes[3_000:9_000]
    off = np.array([0, 2_000, 6_000], dtype=np.int64)
    idx = make()
    ps = [pack(idx, x, off) for x in (a, b, c)]
    out = []
    idx.insert_codes_stream(ps[0])
    out.append(idx.query_codes_stream(ps[0]))
    idx.remove_codes_stream(ps[2])
    out += [idx.query_codes_stream(ps[0]), idx.count()]
    idx.insert_codes_stream(ps[1])
    out += [idx.query_codes_stream(ps[2]), idx.count()]
    one = [pack(idx, x, np.array([0, len(x)], dtype=np.int64))
           for x in (a, b, c)]
    for r in range(3):
        out.append(idx.dynamic_round(one[r], one[(r + 1) % 3],
                                     one[(r + 2) % 3]))
        out.append(idx.count())
    idx.wordset.flush()
    out += [idx.query_codes_stream(ps[1]), idx.count()]
    return out, ps + one


def test_words_cache_switch():
    """The memo's steps count as `cbl_tpu`'s do, and every stream's memo
    is filled (the memo has no switch)."""
    codes = _codes(12_000, seed=3)

    def port_pack(idx, x, off):
        return idx.pack_stream(x, off)

    memo, streams = _cache_steps(
        lambda: CBL(k=25, device="cpu", pending_cap=1 << 14), port_pack,
        codes)
    assert all(s._words for s in streams)
    ref, _ = _cache_steps(
        lambda: cbl_tpu.CBL(k=25, pending_cap=1 << 14), port_pack, codes)
    assert memo == ref


@pytest.mark.parametrize("kmers_per_shard", [1 << 12, 1 << 16])
def test_dryrun_multichip_on_cpu_shards(kmers_per_shard):
    got = dryrun_multichip(4, ["cpu"], kmers_per_shard)
    codes, off_i, codes_q, off_q = tbench.make_genome_corpus(
        4 * kmers_per_shard + 24, seed=5, read_len=65_536, qread_len=8_192)
    # the at-scale steps' net effect: the second half's records less the
    # round's removes and the first half's records
    half = len(off_i) // 2
    start_b = int(off_i[half])
    rl = int(off_i[1])
    single = CBL(k=25, device="cpu")
    single.insert_codes_stream(codes[start_b:], off_i[half:] - start_b)
    single.remove_codes_stream(codes[rl // 2:rl + rl // 2],
                               np.array([0, rl], dtype=np.int64))
    single.remove_codes_stream(codes[:start_b], off_i[:half + 1])
    assert got["distinct"] == single.count()
    assert got["kmers"] == (len(codes) - 24) + (
        len(codes_q) - 24 * (len(off_q) - 1))
    assert got["small"] > 0
    if kmers_per_shard == 1 << 16:
        assert got["distinct"] > 0
