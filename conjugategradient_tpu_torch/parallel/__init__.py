"""Row-sharded solves over a group of shards.  Counterpart of
``conjugategradient_tpu.parallel`` for its one 1-D solve core: the
blocked-ELL, symmetric blocked-ELL, DIA, symmetric DIA and SELL front ends
with every single-RHS method (CG, Jacobi / general per-shard PCG, MINRES,
pipelined, s-step, BiCGStab, GMRES, deflated CG; the fused kernels on
blocked-ELL), their partitioners, the ring halo, and the shard groups that
take the place of the JAX device mesh.

The JAX names not ported yet (the state API, the 2-D and batched solves,
the sharded stencil, multigrid, AMG, FSAI and LOBPCG) raise
``NotImplementedError`` naming ROADMAP.md's item when they are looked up
here; as the error is also an ``AttributeError``, ``hasattr`` is False for
them.
"""

from .collectives import DistributedGroup, InProcessGroup, ShardGroup
from .local_ops import ring_halo
from .partition import (make_row_mesh, partition_csr_rows, partition_dia_rows,
                        partition_sell_rows, partition_symbell_rows)
from .sharded_cg import (ShardedPreconditioner, shard_deflation_basis, sharded_cg_solve,
                         sharded_dia_cg_solve, sharded_sell_cg_solve, sharded_symbell_cg_solve,
                         sharded_symdia_cg_solve)

#: the JAX package's parallel names that wait for a later slice
QUEUED = (
    "ShardedCGState",
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
    "sharded_cg_solve_2d",
    "sharded_cg_solve_2d_batched",
    "sharded_cg_solve_batched",
    "sharded_dia_cg_solve_batched",
    "sharded_sell_cg_solve_batched",
    "make_mesh_2d",
    "partition_csr_blocks_2d",
)


class NotPortedError(NotImplementedError, AttributeError):
    """A JAX ``parallel`` name this package has not ported yet."""


def __getattr__(name):
    if name in QUEUED:
        raise NotPortedError(
            f"conjugategradient_tpu_torch.parallel.{name} is not ported yet "
            "(ROADMAP.md section 1, item 12)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ShardedPreconditioner",
    "sharded_cg_solve",
    "sharded_dia_cg_solve",
    "sharded_sell_cg_solve",
    "make_row_mesh",
    "partition_csr_rows",
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
