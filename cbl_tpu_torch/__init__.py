"""cbl_tpu_torch: the static build+query path of `cbl_tpu` on PyTorch.

A port of `cbl_tpu` (JAX, TPU) to PyTorch and CUDA for an NVIDIA H100.
It imports neither JAX nor `cbl_tpu`; `cbl_tpu` stays the reference the
port is tested against.  Words are one int64 key each (odd K <= 27, see
`limbs`).  The three kernels of the path are CUDA C++ for sm_90a under
`csrc/`, built at first use by `ops._build`.
"""

from .cbl import CBL, PackedStream
from .config import CBLConfig, get_config
from .ops import LAUNCHES

__all__ = ["CBL", "CBLConfig", "LAUNCHES", "PackedStream", "get_config"]
