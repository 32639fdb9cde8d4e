"""cbl_tpu_torch: `cbl_tpu`'s k-mer set on PyTorch, as far as it is ported.

A port of `cbl_tpu` (JAX, TPU) to PyTorch and CUDA for an NVIDIA H100:
the static build+query path, the interleaved dynamic rounds over a sorted
log, and the separate insert / query / remove calls and point operations
over a pending log (see `cbl`).  It imports neither JAX nor `cbl_tpu`;
`cbl_tpu` stays the reference the port is tested against.  Words are one
int64 key each (odd K <= 27, see `limbs`).  The five kernels of these
paths are CUDA C++ for sm_90a under `csrc/`, built at first use by
`ops._build`.
"""

from .cbl import CBL, PackedStream
from .config import CBLConfig, get_config
from .ops import LAUNCHES

__all__ = ["CBL", "CBLConfig", "LAUNCHES", "PackedStream", "get_config"]
