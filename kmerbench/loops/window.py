"""A long-lived index fed by a stream of read batches: round r inserts
batch r % S, count-queries batch r % P and removes the k-mers of batch
(r - W) % S, in one `dynamic_round(..., lazy=True)`.

Mix: `"reads": {"inserts": ..., "queries": ...}` (S and P batches, cycled
as pools), `"window"` W < S, `"warm_rounds"`.  Set-up inserts batches
0 .. W-1 (`insert_codes_stream`, one a call) and runs `warm_rounds`
rounds, enough for the log to fold and every capacity it takes to be
allocated once; their answers are checked with the window's.
"""

import torch

from kmerbench import loop
from kmerbench.reference.kmers import Universe, n_kmers


class Loop(loop.Loop):
    def setup(self, span) -> None:
        s, t, W = self.system, self.traffic, self.mix["window"]
        if len(t["inserts"]) <= W:
            raise ValueError("a window needs more insert batches than it "
                             "holds")
        self.staged = [s.stage(x) for x in t["inserts"]]
        self.staged_q = [s.stage(x) for x in t["queries"]]
        self.index = s.new_index()
        for j in range(W):
            with span("port.insert_codes_stream"):
                self.index.insert_codes_stream(s.stream(self.staged[j]))
        self.first_round = W
        self.window_round = W + self.mix["warm_rounds"]
        got = [(r, self._round(r, span))
               for r in range(W, self.window_round)]
        self.checked = [(r, v.tolist()) for r, v in got]
        self.last_round = self.window_round - 1

    def _parts(self, r: int):
        S, P = len(self.traffic["inserts"]), len(self.traffic["queries"])
        return r % S, r % P, (r - self.mix["window"]) % S

    def _round(self, r: int, span) -> torch.Tensor:
        a, q, m = self._parts(r)
        s = self.system
        with span("port.dynamic_round"):
            t, p = self.index.dynamic_round(
                s.stream(self.staged[a]), s.stream(self.staged_q[q]),
                s.stream(self.staged[m]), lazy=True)
        return loop.answers(t, p)

    def key(self, i: int) -> int:
        return self.window_round + i  # a window batch's round

    def submit(self, i: int, span) -> torch.Tensor:
        self.last_round = self.key(i)
        return self._round(self.last_round, span)

    def ops(self, i: int) -> int:
        a, q, m = self._parts(self.key(i))
        t = self.traffic
        return sum(n_kmers(x[1], self.k) for x in
                   (t["inserts"][a], t["queries"][q], t["inserts"][m]))

    def free(self) -> None:
        super().free()
        self.staged_q = None

    def outputs(self) -> dict:
        return {"live": int(self.index.count_device()),
                "kmers": self.system.export(self.index)}

    def reference(self, device) -> dict:
        t, W = self.traffic, self.mix["window"]
        S = len(t["inserts"])
        u = Universe([self.cols(x, device)
                      for x in t["inserts"] + t["queries"]])
        present = u.empty_set()
        for j in range(W):
            present[u.ids(j)] = True
        answers, live = {}, []
        for r in range(self.first_round, self.last_round + 1):
            a, q, m = self._parts(r)
            present[u.ids(a)] = True
            ids = u.ids(S + q)
            answers[r] = (ids.numel(), present[ids].sum())
            live.append(present.sum())
            present[u.ids(m)] = False
        answers = {r: (n, int(p)) for r, (n, p) in answers.items()}
        return {"answers": answers, "live": int(present.sum()),
                "kmers": tuple(c[present] for c in u.keys),
                "live_mean": float(torch.stack(live).double().mean())}

    def checks(self, done: list, out: dict, ref: dict) -> dict:
        return {"batches_wrong": self.wrong(self.keyed(done) + self.checked,
                                            ref),
                "live_gap": abs(out["live"] - ref["live"]),
                "export_wrong": loop.export_wrong(out["kmers"], ref["kmers"])}

    def least_bytes(self, ref: dict) -> float:
        """The round's three batches of packed bases read once, the live
        rows read once, the inserted and removed k-mers' rows written
        once, two counters written."""
        t, wb = self.traffic, loop.word_bytes(self.k)
        ins, qry = t["inserts"][0], t["queries"][0]
        moved = 2 * len(ins[0]) + len(qry[0])
        return (moved / 4 + ref["live_mean"] * wb
                + 2 * n_kmers(ins[1], self.k) * wb + 16)
