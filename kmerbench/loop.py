"""What every loop kind shares.  A loop kind is a file of its own,
`loops/<kind>.py`, found by the `"loop"` of a traffic mix (`spec.loop`);
it defines `Loop`, a subclass of `loop.Loop`, and says what a batch is,
how set-up warms it and what its answers must be.

A loop owns the staged traffic and the program's index.  `make_traffic`
makes the host arrays from the seed (the one general generator,
`generate`); `setup` stages the pool and warms every shape the window
will use; `submit(i)` enqueues window batch i and returns its answers as
a small int64 device tensor; `ops(i)` is the k-mers the batch inserts, queries
and removes; `drive` makes the measured window (a closed loop of
`in_flight` batches).  After the window `outputs` reads what the program
holds (counts, exported k-mers), `free` drops the program's state,
`reference` works every answer out again from the codes, and `checks`
compares the two: each check is a count of disagreements whose limit is
0, since the configurations promise exact answers.  `least_bytes` is what
one batch must move at the least (`kernels_roofline`).

A loop calls the program through its index's own methods and the
system's `stage`, `stream`, `new_index` and `export` (`system`), so that
a new loop kind can call more of the program's API without an edit here.
"""

from __future__ import annotations

import torch

from . import drive, generate
from .reference.kmers import kmer_cols, n_cols, rows_differ

LIMIT = 0  # exact answers: no disagreement is allowed


def word_bytes(k: int) -> int:
    return 8 * n_cols(k)


def export_wrong(got: tuple, want: tuple) -> int:
    if len(got) != len(want):  # another layout: no row matches
        return got[0].shape[0] + want[0].shape[0]
    return rows_differ(got, want)


def answers(total, positive) -> torch.Tensor:
    return torch.stack([total.to(torch.int64), positive.to(torch.int64)])


class Loop:
    def __init__(self, system, config: dict, mix: dict, traffic: dict):
        self.system = system
        self.k = config["k"]
        self.canonical = config["canonical"]
        self.mix = mix
        self.traffic = traffic
        self.index = None
        self.staged = None
        self.checked = []  # (key, answers) of the batches set-up ran

    @staticmethod
    def make_traffic(mix: dict, config: dict, seed: int) -> dict:
        return generate.make_traffic(mix, config, seed)

    def drive(self, seconds: float, spans, device) -> dict:
        return drive.closed_loop(self, self.mix["in_flight"], seconds, spans,
                                 device)

    def cols(self, stream, device):
        return kmer_cols(*stream, self.k, self.canonical, device)

    def free(self) -> None:
        self.index = None
        self.staged = None

    def warm(self, n: int, span) -> None:
        """Submit batches 0 .. n-1 once in set-up; their answers are
        checked with the window's."""
        self.pool = n
        got = [(self.key(i), self.submit(i, span)) for i in range(n)]
        self.checked = [(key, v.tolist()) for key, v in got]

    def key(self, i: int):
        """The key of batch i's reference answer (its pool slot)."""
        return i % self.pool

    def keyed(self, done: list) -> list:
        """Window answers (i, values) -> (key, values)."""
        return [(self.key(i), v) for i, v in done]

    def wrong(self, keyed: list, ref: dict) -> int:
        """Batches whose answers differ from the reference's."""
        return sum(tuple(v) != tuple(ref["answers"][key]) for key, v in keyed)
