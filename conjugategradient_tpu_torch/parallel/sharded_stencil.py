"""Row (x-slab) sharded matrix-free stencil CG.  Counterpart of
``conjugategradient_tpu/parallel/sharded_stencil.py``.

The 3-D 7-point operator (``types.StencilOperator``) sharded over the
leading grid axis: each shard owns ``sx = nx / n_shards`` x-planes of the
volume and the matching slices of x, b, r and p.  The product's halo is one
y-z plane (ny·nz values) from each ring neighbour — the flat slab's first
and last ny·nz entries — so the group's ``ring_halo`` supplies it, and its
zero fill at the edge shards is the operator's Dirichlet boundary.

Each shard applies the port's stencil (``ops/cuda/stencil.stencil7``:
kernel 11 on a CUDA device, its plain version on the CPU) to its haloed
(sx + 2, ny, nz) window and keeps the sx interior planes.  Every interior
point sees its true neighbours, and the kernel sums them as
``(x− + x+) + (y− + y+) + (z− + z+)`` with the rounding of its plain
version, so each shard's product is bit for bit the matching slice of the
one-card product.  The JAX function sums the neighbours left to right
(x−, x+, y+, y−, z+, z−): float64 results agree to roundoff.

Communication an iteration: one ring halo of ny·nz values each way and the
dots' sums; no operator bytes exist.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.cuda.stencil import stencil7
from ..types.stencil import round_to
from .loops import _sharded_pcg
from .partition import make_row_mesh
from .sharded_cg import _local_precond, _owned_rows, _solve_info, _split


def _local_stencil_matvec(group, slabs, center: float, off: float, grid_local):
    """The 7-point product of every owned slab (flat, sx·ny·nz each): one
    ring halo of a y-z plane, the stencil on each (sx + 2, ny, nz) window,
    its interior planes."""
    sx, ny, nz = grid_local
    windows = group.ring_halo(slabs, ny * nz)
    return [stencil7(w.reshape(sx + 2, ny, nz), center, off)[1:-1].reshape(-1)
            for w in windows]


def sharded_stencil_cg_solve(
    grid_shape: Tuple[int, int, int],
    b,
    x0=None,
    *,
    center: float = 6.0,
    off: float = -1.0,
    mesh=None,
    axis: str = "rows",
    tol: float = 0.0,
    maxiter: Optional[int] = None,
    inv_diag=None,
    M_local=None,
):
    """x-slab sharded CG on the matrix-free 7-point operator.

    Args:
      grid_shape: (nx, ny, nz); nx must be divisible by the group's size.
      b: flat (nx·ny·nz,) right-hand side.
      center / off: the stencil's coefficients (Poisson: 6, -1), rounded
        to b's dtype as ``StencilOperator`` rounds them.
      mesh: the shard group (``make_row_mesh(n, device)`` or a
        ``DistributedGroup``); None: every shard on the default device.
      inv_diag: optional (n,) Jacobi diagonal (a uniform scaling for a
        constant-coefficient stencil; accepted for parity).
      M_local: a per-shard preconditioner — ``r_local -> z_local`` or a
        ``ShardedPreconditioner`` such as
        :func:`~.sharded_multigrid.sharded_multigrid_preconditioner`'s.
        Exclusive with ``inv_diag``.

    Returns (x, CGInfo); x is the whole (n,) solution.
    """
    del axis
    nx, ny, nz = (int(v) for v in grid_shape)
    group = mesh if mesh is not None else make_row_mesh(1)
    n_shards = group.n_shards
    if nx % n_shards:
        raise ValueError(f"nx={nx} must be divisible by n_shards={n_shards}")
    if inv_diag is not None and M_local is not None:
        raise ValueError("pass either inv_diag or M_local, not both")
    n = nx * ny * nz
    b = torch.as_tensor(b)
    if tuple(b.shape) != (n,):
        raise ValueError(f"b must be ({n},), got {tuple(b.shape)}")
    maxiter = int(n + 1 if maxiter is None else maxiter)
    c, o = round_to(center, b.dtype), round_to(off, b.dtype)
    grid_local = (nx // n_shards, ny, nz)
    own_rows, m = _owned_rows(group, n)

    def own(v):
        return _split(own_rows(v), m)

    def apply(vs):
        return _local_stencil_matvec(group, [v.to(b.dtype) for v in vs], c, o, grid_local)

    precond = own(inv_diag)
    if M_local is not None:
        precond = _local_precond(M_local, group, own_rows)
    x_l, k, done, rho, rnorm, hist = _sharded_pcg(
        group, apply, own(b), own(torch.zeros_like(b) if x0 is None else x0), precond, tol,
        maxiter)
    return group.assemble(x_l), _solve_info(k, done, rho, rnorm, hist)
