"""Build a fresh index of one read set a batch and read its count.

Mix: `"reads": {"batches": ...}`, the read sets, cycled as a pool.  A
batch drops the loop's reference to the previous batch's index (its
memory goes back to the allocator once the card is done with it), then
runs `CBL()`, `insert_codes_stream(read set)` and `count_device()`;
set-up builds every read set once.
"""

import numpy as np
import torch

from kmerbench import loop
from kmerbench.reference.kmers import Universe, n_kmers


class Loop(loop.Loop):
    def setup(self, span) -> None:
        self.staged = [self.system.stage(b) for b in self.traffic["batches"]]
        self.warm(len(self.staged), span)

    def submit(self, i: int, span):
        s = self.system
        self.index = None
        with span("port.new_index"):
            index = s.new_index()
        with span("port.insert_codes_stream"):
            index.insert_codes_stream(s.stream(self.staged[self.key(i)]))
        with span("port.count_device"):
            n = index.count_device()
        self.index, self.last = index, self.key(i)
        return n.to(torch.int64).reshape(1)

    def ops(self, i: int) -> int:
        return n_kmers(self.traffic["batches"][self.key(i)][1], self.k)

    def outputs(self) -> dict:
        return {"kmers": self.system.export(self.index)}

    def reference(self, device) -> dict:
        distinct, keys = [], None
        for j, b in enumerate(self.traffic["batches"]):
            u = Universe([self.cols(b, device)])
            distinct.append((u.n,))
            if j == self.last:
                keys = u.keys
            del u
        return {"answers": distinct, "kmers": keys,
                "distinct": float(np.mean([d[0] for d in distinct]))}

    def checks(self, done: list, out: dict, ref: dict) -> dict:
        return {"batches_wrong": self.wrong(self.keyed(done) + self.checked,
                                            ref),
                "export_wrong": loop.export_wrong(out["kmers"], ref["kmers"])}

    def least_bytes(self, ref: dict) -> float:
        """The read set's packed bases read once, the distinct rows written
        once, the count written."""
        b = self.traffic["batches"][0][0]
        return len(b) / 4 + ref["distinct"] * loop.word_bytes(self.k) + 8
