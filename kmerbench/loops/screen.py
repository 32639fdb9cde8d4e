"""Screen read batches from both strands against a canonical index of a
whole genome: `loops/query.py` at a genome whose k-mers do not fit the
device twice over.

Mix: as `query`.  `make_traffic` takes the general generator's traffic
and reverse-complements every second read of each batch (codes reversed,
each complemented: code XOR 2, the complement of the 2-bit code the
program and `reference.kmers` share), with no further random draw.
Set-up builds the index (`insert_codes_stream` of the genome, a stream
of many slabs) and queries every batch once; a window batch is
`query_codes_stream(batch, lazy=True)`.

After the window the index's k-mers are exported in blocks
(`CBL.iter_kmers_limbs`, where the program has it; else the system's
whole export) and split by value range on the device; the reference is
worked range by range (`reference.screen`).  The checks are the query
loop's, made by ranges: every batch's answers, the distinct count, the
exported k-mers.
"""

import numpy as np

from kmerbench import generate, loop
from kmerbench.loops import query
from kmerbench.reference import screen
from kmerbench.reference.kmers import n_kmers


def both_strands(stream):
    """A record stream of reads of one length with every second read
    reverse-complemented."""
    codes, offsets = stream
    lens = np.diff(offsets)
    if len(lens) == 0:
        return stream
    if (lens != lens[0]).any():
        raise ValueError("both_strands takes reads of one length")
    reads = codes.reshape(len(lens), lens[0]).copy()
    reads[1::2] = reads[1::2, ::-1] ^ 2
    return reads.reshape(-1), offsets


class Loop(query.Loop):
    @staticmethod
    def make_traffic(mix: dict, config: dict, seed: int) -> dict:
        t = generate.make_traffic(mix, config, seed)
        for name in mix["reads"]:
            t[name] = [both_strands(b) for b in t[name]]
        return t

    def outputs(self) -> dict:
        parts = [[] for _ in range(screen.PARTS)]
        blocks = getattr(self.index, "iter_kmers_limbs", None)
        if blocks is None:  # the control: its own whole export
            pieces = [self.system.export(self.index)]
        else:
            pieces = (screen.limbs_to_cols(b, self.k) for b in blocks())
        for cols in pieces:
            for p, c in screen.split(cols, self.k).items():
                if c[0].numel():
                    parts[p].append(c)
        return {"distinct": int(self.index.count_device()),
                "kmer_parts": parts}

    def reference(self, device) -> dict:
        return screen.screen_reference(
            self.traffic["genome"], self.traffic["batches"], self.k,
            self.canonical, device)

    def checks(self, done: list, out: dict, ref: dict) -> dict:
        return {"batches_wrong": self.wrong(self.keyed(done) + self.checked,
                                            ref),
                "distinct_gap": abs(out["distinct"] - ref["distinct"]),
                "export_wrong": screen.export_wrong(
                    out["kmer_parts"], ref["kmer_parts"], self.k)}

    def least_bytes(self, ref: dict) -> float:
        """The batch's packed bases read once, one 32-byte sector of the
        index a query k-mer (at most the index's bytes), two counters
        written."""
        b = self.traffic["batches"][0]
        sectors = 32 * n_kmers(b[1], self.k)
        index = ref["distinct"] * loop.word_bytes(self.k)
        return len(b[0]) / 4 + min(sectors, index) + 16
