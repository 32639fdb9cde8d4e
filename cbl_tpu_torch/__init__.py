"""cbl_tpu_torch: `cbl_tpu`'s k-mer set on PyTorch, as far as it is ported.

A port of `cbl_tpu` (JAX, TPU) to PyTorch and CUDA for an NVIDIA H100:
the static build+query path, the interleaved dynamic rounds over a sorted
log, the separate insert / query / remove calls and point operations
over a pending log, set algebra with its holes state, the sequence
calls with ordered membership (`insert_seq(s)`, `remove_seq(s)`,
`contains_seq(s)`, `contains_codes_stream`, `contains_all`; see `cbl`),
and export, checkpoints and stats (`words_array`, `kmers_limbs`,
`iter_nucs`, `save_to_file` / `load_from_file` in `serialize`, the
bucket stats in `stats`, the reference's `.cbl` files in `interop`),
FASTA/Q input and the native 2-bit packer (`io`), the command line
(`python -m cbl_tpu_torch`, `cli`), `profiling`, the index
partitioned over a mesh of devices (`parallel`: `ShardedCBL`,
`make_mesh`, `dryrun_multichip`), in one process or across the ranks of
a `torch.distributed` group (`parallel.distributed`), and the benchmark
(`python -m cbl_tpu_torch.bench`, `bench.py`'s six modes and JSON line).
It imports neither JAX nor `cbl_tpu`; `cbl_tpu` stays the reference the
port is tested against.  Every odd K up to 59 is held: a word is one
int64 key for K <= 27 and two int64 columns from K=29 (see `limbs`);
the sorted log of single-slab dynamic rounds is one int64 key a row
where the word and an 8-bit tag fit one and `cbl_tpu` packs its tag too,
else the word's columns and a tag column (see `wordset`).  The kernels of
these paths (B1 necklace, also on two-column k-mers, B2 blanking scan, B3
merge, B4 slog scan, packed or with a tag column, B5 merge-path sort, B6
bitonic sort, B7 bitonic merge; B3, B5, B6 and B7 on one to three key
columns) are CUDA C++ for sm_90a under `csrc/`, built at first use by
`ops._build`.
"""

from .cbl import CBL, PackedStream
from .config import CBLConfig, get_config
from .ops import LAUNCHES

__all__ = ["CBL", "CBLConfig", "LAUNCHES", "PackedStream", "get_config"]
