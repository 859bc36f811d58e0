"""Row-sharded solves over a group of shards.  Counterpart of
``conjugategradient_tpu.parallel`` for the blocked-ELL front end: the
partitioner, ``sharded_cg_solve`` (CG, Jacobi PCG and MINRES; the portable
per-shard loops on every dtype and the fused ones in float32), and the
shard groups that take the place of the JAX device mesh.  The other
sharded front ends and methods are queued (ROADMAP.md section 1)."""

from .collectives import DistributedGroup, InProcessGroup, ShardGroup
from .partition import make_row_mesh, partition_csr_rows
from .sharded_cg import sharded_cg_solve

__all__ = [
    "DistributedGroup",
    "InProcessGroup",
    "ShardGroup",
    "make_row_mesh",
    "partition_csr_rows",
    "sharded_cg_solve",
]
