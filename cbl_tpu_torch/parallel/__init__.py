"""The index partitioned over a mesh of torch devices (`shard`).

Counterpart of `cbl_tpu/parallel` for one process: `ShardedCBL` holds a
shard of the word space on each device of the mesh, `make_mesh` lists the
devices.  The multi-process layer (`cbl_tpu/parallel/distributed.py`) is
not ported yet.
"""

from .shard import ShardedCBL, make_mesh

__all__ = ["ShardedCBL", "make_mesh"]
