"""`python -m cbl_tpu_torch` against `python -m cbl_tpu`, and the port's
examples.

- Every non-sharded command, plain and canonical, run in-process through
  `cbl_tpu_torch.cli.main(["--device", "cpu", ...])` and
  `cbl_tpu.cli.main([...])` on the same small files, each package in a
  directory of its own with the same relative names: stdout byte for
  byte, stderr line for line with the times masked and the throughput
  lines left out, and the files written (CBLX words, `.cbl` bytes) equal;
- an index built by either package loads in the other with the same
  words;
- K=59 `build` + `list` against a Python set (port only: `cbl_tpu`'s
  K=59 programs take seconds each to trace);
- `--sharded` `build`, `query` and `repartition` on eight CPU shards
  against `cbl_tpu`'s on its eight virtual devices, `--trace` writes a
  Chrome trace, the module runs
  as `python -m cbl_tpu_torch`, and without a card the default device
  exits non-zero;
- the examples under `cbl_tpu_torch/examples/` at a tiny size.
Inputs come from numpy.random.default_rng; checks are exact.
"""

import gzip
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cbl_tpu import CBL as RefCBL
from cbl_tpu import cli as ref_cli
from cbl_tpu_torch import CBL, cli
from cbl_tpu_torch.examples import (bench_necklace_throughput,
                                    build_from_fastx, dynamic_rounds,
                                    repartition_recovery, sharded_build)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
MODES = {"plain": [], "canonical": ["-c"]}


def _bases(rng, n) -> bytes:
    return bytes(ACGT[rng.integers(0, 4, n)])


def _write_inputs(d):
    """a.fa: FASTA, wrapped lines, lowercase and N; b.fq.gz: FASTQ (gzip)
    whose records share k-mers with a.fa, and fresh ones."""
    rng = np.random.default_rng(11)
    recs = [_bases(rng, n) for n in (700, 450, 900)]
    recs[1] = recs[1][:200].lower() + b"NNN" + recs[1][200:]
    fa = b"".join(b">a%d desc\n" % i + r[:300] + b"\n" + r[300:] + b"\n"
                  for i, r in enumerate(recs))
    (d / "a.fa").write_bytes(fa)
    qrecs = [recs[0][100:400], _bases(rng, 350), recs[2][500:], recs[1][:60],
             _bases(rng, 10)]
    fq = b"".join(b"@q%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                  for i, r in enumerate(qrecs))
    (d / "b.fq.gz").write_bytes(gzip.compress(fq))


def _run(main, argv, capsysbinary):
    rc = main(argv)
    out, err = capsysbinary.readouterr()
    lines = [re.sub(r"\d+\.\d+s\b", "<t>s", line)
             for line in err.decode().splitlines()
             if "throughput:" not in line]
    return rc, out, lines


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """mode -> (cbl_tpu's directory, the port's): the inputs, each
    package's indexes a.npz and b.npz of them, and ref.cbl, cbl_tpu's
    `.cbl` export of a.npz (the input of `import-ref` in both)."""
    out = {}
    for mode, flags in MODES.items():
        ref = tmp_path_factory.mktemp(f"ref_{mode}")
        port = tmp_path_factory.mktemp(f"port_{mode}")
        _write_inputs(ref)
        _write_inputs(port)
        with pytest.MonkeyPatch.context() as mp:
            for d, main in ((ref, ref_cli.main), (port, _port_main)):
                mp.chdir(d)
                for name, src in (("a", "a.fa"), ("b", "b.fq.gz")):
                    assert main(["build", src, "-o", f"{name}.npz",
                                 *flags]) == 0
            mp.chdir(ref)
            assert ref_cli.main(["export-ref", "a.npz", "ref.cbl"]) == 0
        shutil.copy(ref / "ref.cbl", port / "ref.cbl")
        out[mode] = (ref, port)
    return out


def _port_main(argv):
    return cli.main(["--device", "cpu", *argv])


def _words(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# command -> (argv, files it writes); a.npz / b.npz are the fixture's
COMMANDS = {
    "build": (["build", "a.fa", "-o", "built.npz"], ["built.npz"]),
    "count": (["count", "a.npz"], []),
    "list": (["list", "a.npz"], []),
    "list-o": (["list", "b.npz", "-o", "b.txt"], ["b.txt"]),
    "query": (["query", "a.npz", "b.fq.gz"], []),
    "insert": (["insert", "a.npz", "b.fq.gz", "-o", "ins.npz"], ["ins.npz"]),
    "remove": (["remove", "a.npz", "b.fq.gz", "-o", "rm.npz"], ["rm.npz"]),
    "merge": (["merge", "a.npz", "b.npz", "-o", "merge.npz"], ["merge.npz"]),
    "inter": (["inter", "a.npz", "b.npz", "-o", "inter.npz"], ["inter.npz"]),
    "diff": (["diff", "a.npz", "b.npz", "-o", "diff.npz"], ["diff.npz"]),
    "sym-diff": (["sym-diff", "a.npz", "b.npz", "-o", "sd.npz"], ["sd.npz"]),
    "repartition": (["repartition", "a.npz"], []),
    "export-ref": (["export-ref", "a.npz", "a.cbl"], ["a.cbl"]),
    "import-ref": (["import-ref", "ref.cbl", "imp.npz", "-k", "25",
                    "--prefix-bits", "24"], ["imp.npz"]),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("command", list(COMMANDS))
def test_command_parity(dirs, mode, command, capsysbinary, monkeypatch):
    ref, port = dirs[mode]
    argv, files = COMMANDS[command]
    if command == "build":
        argv = argv + MODES[mode]
    monkeypatch.chdir(ref)
    want = _run(ref_cli.main, argv, capsysbinary)
    monkeypatch.chdir(port)
    got = _run(_port_main, argv, capsysbinary)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]  # stdout, byte for byte
    assert got[2] == want[2]  # stderr, line for line
    assert want[2], "the command reported nothing"
    for name in files:
        if name.endswith(".npz"):
            w, g = _words(ref / name), _words(port / name)
            assert sorted(w) == sorted(g)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        else:
            assert (port / name).read_bytes() == (ref / name).read_bytes()
    if command in ("count", "list"):
        assert len(got[1].splitlines()) == (1 if command == "count" else
                                            RefCBL.load_from_file(
                                                str(ref / "a.npz")).count())


def test_query_finds_shared_kmers(dirs):
    """The inputs exercise both answers: some query k-mers are in a.fa,
    some are not (the parity test compares the counts)."""
    ref, _ = dirs["plain"]
    from cbl_tpu import io as ref_io

    idx = RefCBL.load_from_file(str(ref / "a.npz"))
    codes, offsets = ref_io.parse_fastx(str(ref / "b.fq.gz"))
    total, positive = idx.query_codes_stream(codes, offsets)
    assert 0 < positive < total


@pytest.mark.parametrize("mode", list(MODES))
def test_index_files_load_in_either_package(dirs, mode):
    ref, port = dirs[mode]
    for name in ("a.npz", "b.npz"):
        ref_words = RefCBL.load_from_file(str(ref / name)).wordset.words_array()
        port_words = CBL.load_from_file(str(port / name),
                                        device="cpu").wordset.words_array()
        np.testing.assert_array_equal(port_words, ref_words)
        # each package's file in the other
        a = RefCBL.load_from_file(str(port / name))
        b = CBL.load_from_file(str(ref / name), device="cpu")
        assert a.is_canonical() == b.is_canonical() == (mode == "canonical")
        np.testing.assert_array_equal(a.wordset.words_array(), ref_words)
        np.testing.assert_array_equal(b.wordset.words_array(), ref_words)


def test_cli_large_k59(tmp_path, monkeypatch, capsysbinary):
    rng = np.random.default_rng(3)
    seq = _bases(rng, 400)
    (tmp_path / "r.fa").write_bytes(b">r\n" + seq + b"\n")
    monkeypatch.chdir(tmp_path)
    rc, _, err = _run(_port_main, ["build", "r.fa", "-o", "idx59.npz", "-k",
                                   "59", "--prefix-bits", "28"], capsysbinary)
    assert rc == 0, err
    rc, out, _ = _run(_port_main, ["list", "idx59.npz"], capsysbinary)
    assert rc == 0
    assert sorted(out.strip().split(b"\n")) == sorted(
        {seq[i : i + 59] for i in range(len(seq) - 58)})


@pytest.mark.parametrize("argv", [
    ["build", "a.fa", "--sharded"],
    ["query", "a.npz", "b.fq.gz", "--sharded"],
    ["repartition", "a.npz", "--sharded", "-o", "x"],
], ids=["build", "query", "repartition"])
def test_sharded_is_refused(dirs, argv, monkeypatch, capsysbinary):
    """`--sharded` was refused until `parallel` was ported; now each
    command runs as `cbl_tpu`'s does on its eight virtual devices, the
    port on `--shards 8` CPU shards: stderr line for line (shard balances
    included, times masked) and the checkpoints written equal.  The
    repartition reads a sharded checkpoint that each package's sharded
    build wrote under boundaries from the data."""
    ref, port = dirs["plain"]
    argv = list(argv)
    if argv[0] == "build":
        argv += ["-o", "sharded.npz"]
    files = [a for a in argv if a in ("sharded.npz", "x")]
    if argv[0] == "repartition":
        argv[1] = "sharded_in.npz"
    for d, main in ((ref, ref_cli.main), (port, _port_sharded_main)):
        monkeypatch.chdir(d)
        if argv[0] == "repartition":
            assert main(["build", "a.fa", "--sharded", "-o",
                         "sharded_in.npz"]) == 0
        capsysbinary.readouterr()
    monkeypatch.chdir(ref)
    want = _run(ref_cli.main, argv, capsysbinary)
    monkeypatch.chdir(port)
    got = _run(_port_sharded_main, argv, capsysbinary)
    assert got[0] == want[0] == 0 and got[1] == want[1] == b""
    assert got[2] == want[2] and any("8 device(s)" in line or "balance" in
                                     line for line in got[2])
    for name in files:
        w, g = _words(ref / name), _words(port / name)
        assert sorted(w) == sorted(g)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _port_sharded_main(argv):
    return cli.main(["--device", "cpu", "--shards", "8", *argv])


def test_trace_writes_chrome_trace(dirs, tmp_path, monkeypatch, capsysbinary):
    monkeypatch.chdir(dirs["plain"][1])
    trace_dir = tmp_path / "trace"
    rc, _, err = _run(cli.main, ["--trace", str(trace_dir), "--device", "cpu",
                                 "build", "a.fa"], capsysbinary)
    assert rc == 0
    assert err[0] == f"Capturing torch.profiler trace into {trace_dir}"
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_module_entry_point(dirs):
    port = dirs["plain"][1]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "cbl_tpu_torch", "--device", "cpu", "count",
         "a.npz"], cwd=port, env=env, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = CBL.load_from_file(str(port / "a.npz"), device="cpu").count()
    assert proc.stdout == b"%d\n" % n


def test_default_device_needs_a_card(dirs, monkeypatch, capsysbinary):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.chdir(dirs["plain"][1])
    rc, out, err = _run(cli.main, ["count", "a.npz"], capsysbinary)
    assert rc != 0 and out == b""
    assert len(err) == 1 and "CUDA" in err[0]


def test_example_build_from_fastx(dirs, capsys):
    port = dirs["plain"][1]
    assert build_from_fastx.main([str(port / "a.fa"), "--device", "cpu"]) == 0
    n = CBL.load_from_file(str(port / "a.npz"), device="cpu").count()
    assert capsys.readouterr().out == f"{n} distinct 25-mers in {port / 'a.fa'}\n"


def test_example_dynamic_rounds(capsys):
    """Its counts against Python sets of the same rounds."""
    rounds, seg, k = 3, 3000, 25
    assert dynamic_rounds.main([str(rounds), str(seg), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    codes = np.random.default_rng(0).integers(0, 4, size=rounds * seg,
                                              dtype=np.uint8)
    segs = [codes[i * seg : (i + 1) * seg].tobytes() for i in range(rounds)]

    def kmers(s):
        return {s[i : i + k] for i in range(len(s) - k + 1)}

    live, positive = set(), 0
    for i in range(rounds):
        live |= kmers(segs[i])
        q = segs[i - 1 if i else 0]
        positive += sum(q[j : j + k] in live for j in range(len(q) - k + 1))
        live -= kmers(segs[i][: seg // 2])
    assert f": {len(live)} distinct k-mers live, {positive} positive " in out


@pytest.mark.parametrize("k", [25, 59])
def test_example_bench_necklace_throughput(k, capsys):
    assert bench_necklace_throughput.main(
        ["2000", str(k), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"2000 necklaces (K={k}, {2 * k} bits) in ")


def test_example_sharded_build(dirs, capsys):
    """Four CPU shards on a.fa: the build's count is the single index's,
    the self-query all positive, the checkpoint round-trips."""
    port = dirs["plain"][1]
    assert sharded_build.main([str(port / "a.fa"), "--device", "cpu",
                               "--shards", "4"]) == 0
    err = capsys.readouterr().err.splitlines()
    n = CBL.load_from_file(str(port / "a.npz"), device="cpu").count()
    assert err[0] == "devices: 4"
    assert err[1].startswith(f"built {n} distinct 25-mers in ")
    assert re.fullmatch(r"self-query: (\d+)/\1 positive", err[2]), err[2]
    assert err[-1] == "checkpoint round-trip OK"


def test_example_repartition_recovery(capsys):
    """Eight CPU shards at a small size: the skewed growth is re-balanced
    and the overflowed insert recovers every word."""
    assert repartition_recovery.main(
        ["--device", "cpu", "--shards", "8", "--bases", "40000",
         "--skew", "20000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: 8 device(s)"
    built = int(re.match(r"built (\d+) k-mers", out[1]).group(1))
    after = json.loads(out[3].split("balance ")[1])
    assert sum(after) == built + 20_000 and max(after) <= 2 * min(after)
    assert f"overflow recovery: {built} k-mers (= {built} expected)" in out[4]
