"""Sharded solves over a group of shards.  Counterpart of
``conjugategradient_tpu.parallel``, every name of it: the row-sharded
blocked-ELL, symmetric blocked-ELL, DIA, symmetric DIA and SELL front ends
with every single-RHS method (CG, Jacobi / general per-shard PCG, MINRES,
pipelined, s-step, BiCGStab, GMRES, deflated CG; the fused kernels on
blocked-ELL), the 2-D block decomposition, the multi-RHS (lockstep and
block CG) solves, the checkpointable state API, the x-slab sharded
stencil CG with its sharded multigrid, the sharded SA-AMG and FSAI
preconditioners, the sharded LOBPCG, their partitioners, the ring halo,
and the shard groups that take the place of the JAX device mesh.
"""

from .collectives import DistributedGroup, InProcessGroup, ShardGroup
from .local_ops import ring_halo
from .partition import (make_mesh_2d, make_row_mesh, partition_csr_blocks_2d,
                        partition_csr_rows, partition_dia_rows, partition_sell_rows,
                        partition_symbell_rows)
from .sharded_cg import (ShardedCGState, ShardedPreconditioner, shard_deflation_basis,
                         sharded_cg_init, sharded_cg_solve, sharded_cg_solve_2d,
                         sharded_cg_solve_2d_batched, sharded_cg_solve_batched,
                         sharded_dia_cg_init, sharded_dia_cg_solve,
                         sharded_dia_cg_solve_batched, sharded_dia_run_cg, sharded_run_cg,
                         sharded_sell_cg_init, sharded_sell_cg_solve,
                         sharded_sell_cg_solve_batched, sharded_sell_run_cg,
                         sharded_state_result, sharded_symbell_cg_solve,
                         sharded_symdia_cg_solve)
from .sharded_stencil import sharded_stencil_cg_solve
from .sharded_multigrid import sharded_multigrid_preconditioner
from .sharded_amg import sharded_amg_preconditioner
from .sharded_fsai import sharded_fsai_preconditioner
from .sharded_lobpcg import sharded_lobpcg_eigs

#: the JAX package's parallel names not ported: none
QUEUED = ()

__all__ = [
    "ShardedCGState",
    "ShardedPreconditioner",
    "sharded_amg_preconditioner",
    "sharded_fsai_preconditioner",
    "sharded_lobpcg_eigs",
    "sharded_cg_init",
    "sharded_run_cg",
    "sharded_dia_cg_init",
    "sharded_dia_run_cg",
    "sharded_sell_cg_init",
    "sharded_sell_run_cg",
    "sharded_state_result",
    "sharded_stencil_cg_solve",
    "sharded_multigrid_preconditioner",
    "sharded_cg_solve",
    "sharded_cg_solve_2d",
    "sharded_cg_solve_2d_batched",
    "sharded_cg_solve_batched",
    "sharded_dia_cg_solve",
    "sharded_dia_cg_solve_batched",
    "sharded_sell_cg_solve",
    "sharded_sell_cg_solve_batched",
    "make_row_mesh",
    "make_mesh_2d",
    "partition_csr_rows",
    "partition_csr_blocks_2d",
    "partition_dia_rows",
    "partition_sell_rows",
    "partition_symbell_rows",
    "sharded_symbell_cg_solve",
    "sharded_symdia_cg_solve",
    "ring_halo",
    "shard_deflation_basis",
    "DistributedGroup",
    "InProcessGroup",
    "ShardGroup",
]
