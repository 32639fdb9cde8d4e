"""The index partitioned over a mesh of torch devices (`shard`), in one
process or across the ranks of a `torch.distributed` group
(`distributed`).

Counterpart of `cbl_tpu/parallel`: `ShardedCBL` holds a shard of the word
space on each device of the mesh, `make_mesh` lists the devices;
`distributed` joins processes (`init_distributed`), stages each rank's
slice of the records (`multihost_*`) and holds the reference's
two-process check (`launch_multihost_dryrun`); `dryrun_multichip` is its
check of several shards in one process (`dryrun`).
"""

from . import distributed
from .dryrun import dryrun_multichip
from .shard import ShardedCBL, make_mesh

__all__ = ["ShardedCBL", "distributed", "dryrun_multichip", "make_mesh"]
