"""Hopper kernels of the port and the seam where they plug in.

- `necklace`: kernel B1, the batched necklace (`csrc/necklace.cu`);
- `scan`: kernel B2, record-boundary blanking (`csrc/scan.cu`), and
  kernel B4, the liveness scan of a sorted log (`csrc/slog_scan.cu`);
- `merge`: kernel B3, the merge of two sorted key runs (`csrc/merge.cu`);
- `sort`: `torch.sort` and the merge dispatchers;
- `_build`: the nvcc build, the ctypes binding and the launch counters.

Each kernel module holds the plain tensor version beside the wrapper.  A
wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors; it never falls back from CUDA to the CPU.
"""

from ._build import LAUNCHES

__all__ = ["LAUNCHES"]
