"""Count queries of read batches against one static index of the genome.

Mix: `"reads": {"batches": ...}`, the query batches, cycled as a pool.
Set-up builds the index (`insert_codes_stream` of the genome) and queries
every batch once; a window batch is `query_codes_stream(batch, lazy=True)`.
"""

from kmerbench import loop
from kmerbench.reference.kmers import Universe, n_kmers


class Loop(loop.Loop):
    def setup(self, span) -> None:
        s = self.system
        genome = s.stage(self.traffic["genome"])
        self.staged = [s.stage(b) for b in self.traffic["batches"]]
        self.index = s.new_index()
        with span("port.insert_codes_stream"):
            self.index.insert_codes_stream(s.stream(genome))
        self.warm(len(self.staged), span)

    def submit(self, i: int, span):
        with span("port.query_codes_stream"):
            t, p = self.index.query_codes_stream(
                self.system.stream(self.staged[self.key(i)]), lazy=True)
        return loop.answers(t, p)

    def ops(self, i: int) -> int:
        return n_kmers(self.traffic["batches"][self.key(i)][1], self.k)

    def outputs(self) -> dict:
        return {"distinct": int(self.index.count_device()),
                "kmers": self.system.export(self.index)}

    def reference(self, device) -> dict:
        batches = self.traffic["batches"]
        u = Universe([self.cols(self.traffic["genome"], device)]
                     + [self.cols(b, device) for b in batches])
        present = u.empty_set()
        present[u.ids(0)] = True
        answers = [(u.sizes[j + 1], int(present[u.ids(j + 1)].sum()))
                   for j in range(len(batches))]
        return {"answers": answers, "distinct": int(present.sum()),
                "kmers": tuple(c[present] for c in u.keys)}

    def checks(self, done: list, out: dict, ref: dict) -> dict:
        return {"batches_wrong": self.wrong(self.keyed(done) + self.checked,
                                            ref),
                "distinct_gap": abs(out["distinct"] - ref["distinct"]),
                "export_wrong": loop.export_wrong(out["kmers"], ref["kmers"])}

    def least_bytes(self, ref: dict) -> float:
        """The batch's packed bases read once, the index's rows read once,
        two counters written."""
        b = self.traffic["batches"][0][0]
        return len(b) / 4 + ref["distinct"] * loop.word_bytes(self.k) + 16
