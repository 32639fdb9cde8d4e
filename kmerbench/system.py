"""The system under test: `cbl_tpu_torch`'s public API and nothing else.

`PortSystem` stages traffic, makes indexes and reads them out, and hands
the harness the program's launch counters, its own counters and its span
recording; the loops (`loops/<kind>.py`) call the index's own methods
(`CBL`).  The control (`reference.control.ControlSystem`) offers the
same, so that it can be put in the program's place.  Nothing here waits on the device.

The port runs with its defaults: `run` refuses to start where any
CBL_TORCH_* variable is set (sort mode, merge mode, the words memo).
"""

from __future__ import annotations

import numpy as np

from .reference.kmers import limbs_to_cols


class PortSystem:
    def __init__(self, config: dict, device):
        import cbl_tpu_torch

        self.api = cbl_tpu_torch
        self.k = config["k"]
        self.prefix_bits = config["prefix_bits"]
        self.canonical = config["canonical"]
        self.device = device
        self._stager = self.new_index()

    def launches(self) -> dict:
        """The program's kernel launch counters (`ops.LAUNCHES`)."""
        return dict(self.api.LAUNCHES)

    def counters(self) -> dict:
        """The program's counters (`profiling.COUNTERS`)."""
        from cbl_tpu_torch import profiling

        return dict(profiling.COUNTERS)

    def recording(self):
        """The program's span recording (`profiling.recording`): a context
        that yields the list its span records are appended to."""
        from cbl_tpu_torch import profiling

        return profiling.recording()

    def stage(self, stream):
        """A record stream (codes, offsets) packed and copied to the
        device once; -> its slabs."""
        codes, offsets = stream
        return self._stager.pack_stream(np.asarray(codes),
                                        np.asarray(offsets)).slabs

    def stream(self, slabs):
        """A fresh PackedStream over staged slabs: no words memo carries
        over from one use to the next."""
        return self.api.PackedStream(self._stager.cfg, self.canonical, slabs)

    def new_index(self):
        return self.api.CBL(k=self.k, prefix_bits=self.prefix_bits,
                            canonical=self.canonical, device=self.device)

    def export(self, index) -> tuple:
        """The index's k-mers (`kmers_limbs`) in the reference's layout."""
        return limbs_to_cols(index.kmers_limbs(), self.k, self.device)
