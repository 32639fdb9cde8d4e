"""A cell, a configuration, a traffic mix, a loop kind and a per-layer
metric (with a kernel group of its own) are added as new files and
entries, and the harness finds them by name: no file of the benchmark is
edited."""

import json
import shutil
import textwrap

from kmerbench import kernels, spec
from kmerbench.run import run_cell
from kmerbench.tests.tiny import CPU

NEW_LOOP = textwrap.dedent('''
    """Insert a read batch into a fresh index and query the same batch."""
    import torch

    from kmerbench import loop
    from kmerbench.reference.kmers import Universe, n_kmers


    class Loop(loop.Loop):
        def setup(self, span):
            self.staged = [self.system.stage(b)
                           for b in self.traffic["batches"]]
            self.warm(len(self.staged), span)

        def submit(self, i, span):
            s = self.system
            self.index = s.new_index()
            slabs = self.staged[self.key(i)]
            with span("port.insert_codes_stream"):
                self.index.insert_codes_stream(s.stream(slabs))
            with span("port.query_codes_stream"):
                t, p = self.index.query_codes_stream(s.stream(slabs),
                                                     lazy=True)
            return loop.answers(t, p)

        def ops(self, i):
            return 2 * n_kmers(self.traffic["batches"][self.key(i)][1],
                               self.k)

        def outputs(self):
            return {}

        def reference(self, device):
            answers = []
            for b in self.traffic["batches"]:
                n = Universe([self.cols(b, device)]).sizes[0]
                answers.append((n, n))
            return {"answers": answers}

        def checks(self, done, out, ref):
            return {"batches_wrong": self.wrong(self.keyed(done)
                                                + self.checked, ref)}

        def least_bytes(self, ref):
            return len(self.traffic["batches"][0][0]) / 4
''')
NEW_METRIC = textwrap.dedent('''
    GROUPS = {"B9": {"names": r"\\bnew_kernel\\b", "launches": ["new"]}}


    def read(view):
        return 6.0 if view.batches else None
''')


def test_new_files_and_entries_are_found_by_name(tmp_path):
    pkg = tmp_path / "kmerbench"
    shutil.copytree(spec.ROOT / "kmerbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    bench = spec.load()

    (pkg / "configs" / "k31_p24.json").write_text(json.dumps(
        {"name": "k31_p24", "source": "a test", "k": 31, "prefix_bits": 24,
         "canonical": True, "genome_bases": 30000, "reduced": []}))
    (pkg / "traffic" / "self_query.json").write_text(json.dumps(
        {"loop": "insert_query",
         "reads": {"batches": {"count": 2, "reads": 30, "read_bases": 100,
                               "from_genome": 1.0, "errors": 0.01}},
         "in_flight": 3, "kernels": ["B1"]}))
    (pkg / "loops" / "insert_query.py").write_text(NEW_LOOP)
    (pkg / "metrics" / "reads_per_batch.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "k31_p24", "source": "a test",
                             "file": "kmerbench/configs/k31_p24.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "k31_p24.self_query",
                               "config": "k31_p24", "traffic": "self_query",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "reads_per_batch", "unit": "reads",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "kmer_ops_per_s",
                               "workloads": ["k31_p24.self_query"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell(spec.load(tmp_path), "k31_p24.self_query", tmp_path)
    assert cell.config["k"] == 31 and cell.mix["in_flight"] == 3
    r = run_cell(cell, 17, 0.3, True, CPU, base=tmp_path)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert r["metrics"]["reads_per_batch"] == {"value": 6.0, "unit": "reads"}
    r = run_cell(cell, 17, 0.3, False, CPU, base=tmp_path)
    assert r["correct"] and "kmer_ops_per_s" in r["metrics"]
    groups = kernels.Groups(tmp_path)
    assert groups.group_of("void cbl::new_kernel<1>(int)") == "B9"
    assert groups.launched({"new": 4}, "B9") == 4
    after = {p: p.read_bytes() for p in before}
    assert after == before
