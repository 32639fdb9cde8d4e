"""Hopper kernels of the port and the seam where they plug in.

- `necklace`: kernel B1, the batched necklace (`csrc/necklace.cu`);
- `scan`: kernel B2, record-boundary blanking (`csrc/scan.cu`), and
  kernel B4, the liveness scan of a sorted log, packed or with a tag
  column (`csrc/slog_scan.cu`);
- `merge`: kernel B3, the merge of two sorted key runs (`csrc/merge.cu`),
  and kernel B5, the merge-path sort (`csrc/sort.cu`), both on
  `csrc/merge_path.cuh`;
- `bitonic`: kernel B6, the bitonic sort (`csrc/bitonic_sort.cu`), and
  kernel B7, the bitonic merge (`csrc/bitonic_merge.cu`), both on
  `csrc/bitonic.cuh`;
- `sort`: the sort selector (`torch.sort`, B5 or B6) and the merge
  selector (B3, B7 or one sort of both sides);
- `probe`: kernel B8, the probe join's search of a sorted index through
  a sample of its rows (`csrc/probe.cu`);
- `_build`: the nvcc build, the ctypes binding and the launch counters.

Each kernel module holds the plain tensor version beside the wrapper.  A
wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors; it never falls back from CUDA to the CPU.
"""

from ._build import LAUNCHES

__all__ = ["LAUNCHES"]
