"""x-slab sharded geometric multigrid for the matrix-free stencil.
Counterpart of ``conjugategradient_tpu/parallel/sharded_multigrid.py``.

The same operator as :func:`~conjugategradient_tpu_torch.solver.multigrid.
multigrid_preconditioner` — the same smoothing, transfers, scale factors
and dense coarsest solve — over the x-slab decomposition of
``sharded_stencil.py``, so MG-PCG takes the one-card iteration counts on a
grid spread over shards.  Each step is the one-card step's arithmetic on a
slab: the stencil applies are kernel 11 (or its plain version) on haloed
windows (``sharded_stencil._local_stencil_matvec``), the x transfers read
their neighbour planes through the ring halo, and the y/z transfers and
the smoothing updates are the one-card code on the slab.  So the sharded
apply gives the one-card apply's bits.

Communication a V-cycle level:

* **smoothing and residual**: each stencil apply takes one y-z plane from
  each x neighbour (``ring_halo``), shrinking 4x a level;
* **x-restriction**: coarse plane cc (fine index 2cc + 1) reads fine
  planes 2cc, 2cc + 1 and 2cc + 2; the last crosses to the right
  neighbour, and the edge shards' zero halo is the one-card zero padding;
* **x-prolongation**: the even fine plane 2cc reads coarse plane cc − 1,
  which crosses to the left neighbour; the interleave is the one-card
  stack and reshape;
* **agglomeration**: once a level's slab would thin below 2 planes or the
  level holds at most ``agglomerate_below`` points, one all_gather of the
  coarse residual gives every process the whole level, which runs the
  remaining levels of the ONE-CARD cycle (``solver.multigrid._make_vcycle``,
  the same code) and keeps its own slabs.  In an in-process group that
  tail runs once and its shards share it: the bits are those of each
  process of a ``DistributedGroup`` running it alone.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.spmv import full_precision_matmul
from ..solver.multigrid import (_cheb_smooth_steps, _dense_stencil_inverse, _level_shapes,
                                _make_vcycle, _prolong, _restrict, _stencil_rho_bound)
from ..types.stencil import round_to
from .sharded_cg import ShardedPreconditioner
from .sharded_stencil import _local_stencil_matvec


def _halo_windows(group, us):
    """(sx, ny, nz) slabs -> (sx + 2, ny, nz) windows with the neighbours'
    x planes (zeros past the edge shards: the Dirichlet boundary)."""
    sx, ny, nz = us[0].shape
    return [w.reshape(sx + 2, ny, nz)
            for w in group.ring_halo([u.reshape(-1) for u in us], ny * nz)]


def _restrict_x_sharded(group, fs):
    """Full-weighting x-restriction of each slab (even local length, so the
    global odd-index convention stays shard-aligned)."""
    sxc = fs[0].shape[0] // 2
    out = []
    for w in _halo_windows(group, fs):
        a = w[1:2 * sxc:2]  # f[2cc]
        b = w[2:2 * sxc + 1:2]  # f[2cc+1]
        c = w[3:2 * sxc + 2:2]  # f[2cc+2]; the last one is the right halo
        out.append(0.25 * a + 0.5 * b + 0.25 * c)
    return out


def _prolong_x_sharded(group, es):
    """Linear x-interpolation of each coarse slab: the even fine planes
    average coarse planes cc − 1 (the left halo at cc = 0) and cc."""
    sxc, ny, nz = es[0].shape
    out = []
    for ew in _halo_windows(group, es):
        even = 0.5 * (ew[:-2] + ew[1:-1])
        out.append(torch.stack([even, ew[1:-1]], dim=1).reshape(2 * sxc, ny, nz))
    return out


def sharded_multigrid_preconditioner(
    grid_shape: Tuple[int, int, int],
    n_shards: int,
    *,
    axis: str = "rows",
    center: float = 6.0,
    off: float = -1.0,
    dtype=torch.float32,
    nu: int = 2,
    omega: float = 0.85,
    cycles: int = 1,
    coarse_size: int = 512,
    agglomerate_below: int = 32768,
    smoother: str = "jacobi",
    cheb_lower: float = 1.0 / 6.0,
) -> ShardedPreconditioner:
    """The x-slab sharded V-cycle for ``sharded_stencil_cg_solve(M_local=)``.

    Returns a collective :class:`~.sharded_cg.ShardedPreconditioner` (no
    operator arrays; its apply takes every owned shard's flat residual
    slab, makes the ring halos and the one coarse all_gather of a cycle,
    and returns the slabs of M⁻¹r).  It applies the one-card
    :func:`multigrid_preconditioner`'s operator: pass the same ``nu``,
    ``omega``, ``cycles`` and ``coarse_size`` to both and the iteration
    counts match.

    Arguments as the one-card function's, plus:
      grid_shape / n_shards: the x-slab decomposition (``nx`` divisible by
        ``n_shards``, as in the sharded stencil solve); ``axis`` is
        accepted as the JAX signature has it and not read.
      dtype: the apply's dtype (the solve's).
      agglomerate_below: levels of at most this many points (or whose slab
        would thin below 2 planes) run replicated after one all_gather.
    """
    del axis
    nx, ny, nz = grid_shape
    if nx % n_shards:
        raise ValueError(f"nx={nx} must be divisible by n_shards={n_shards}")
    if center <= 0.0:
        raise ValueError(f"stencil center must be positive for an SPD operator, got {center}")
    if nu < 1:
        raise ValueError(f"nu must be >= 1, got {nu}")
    if cycles < 1:
        raise ValueError(f"cycles must be >= 1, got {cycles}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"smoother must be 'jacobi' or 'chebyshev', got {smoother!r}")
    if not (0.0 < cheb_lower < 1.0):
        raise ValueError(f"cheb_lower must be in (0, 1), got {cheb_lower}")

    shapes = _level_shapes(tuple(grid_shape), coarse_size, None)
    # the sharded prefix: levels whose slab stays even and worth sharding
    split = 0
    while split < len(shapes) - 1:
        nx_l = shapes[split][0]
        if (nx_l % n_shards or (nx_l // n_shards) % 2
                or int(np.prod(shapes[split])) <= agglomerate_below):
            break
        split += 1

    c, o = round_to(center, dtype), round_to(off, dtype)
    cheb_steps = None
    if smoother == "chebyshev":
        rho_b = _stencil_rho_bound(shapes[0], c, o)
        cheb_steps = _cheb_smooth_steps(cheb_lower * rho_b, rho_b, nu)
        inv_diag_omega = round_to(1.0 / c, dtype)
    else:
        inv_diag_omega = round_to(omega / c, dtype)
    inv_coarse_host = _dense_stencil_inverse(shapes[-1], c, o)
    tails = {}

    def tail_vcycle(device):
        """The one-card cycle over the agglomerated levels, built once per
        device."""
        if device not in tails:
            inv_coarse = torch.as_tensor(inv_coarse_host, dtype=dtype, device=device)
            tails[device] = _make_vcycle(shapes[split:], c, o, inv_diag_omega, inv_coarse, nu,
                                         smoother=smoother, cheb_steps=cheb_steps)
        return tails[device]

    def make_local_apply(arrays, group):
        del arrays
        if group.n_shards != n_shards:
            raise ValueError(f"built for {n_shards} shards, the group has {group.n_shards}")
        full_precision_matmul()
        tail = tail_vcycle(group.device)

        def A(us):
            sx, sy, sz = us[0].shape
            return [y.reshape(sx, sy, sz)
                    for y in _local_stencil_matvec(group, [u.reshape(-1) for u in us], c, o,
                                                   (sx, sy, sz))]

        def smooth(us, bs):
            if smoother == "chebyshev":
                step1, coeffs = cheb_steps
                zs = [inv_diag_omega * (b - y) for b, y in zip(bs, A(us))]
                ds = [step1 * z for z in zs]
                us = [u + d for u, d in zip(us, ds)]
                for c_d, c_z in coeffs:
                    zs = [inv_diag_omega * (b - y) for b, y in zip(bs, A(us))]
                    ds = [c_d * d + c_z * z for d, z in zip(ds, zs)]
                    us = [u + d for u, d in zip(us, ds)]
                return us
            for _ in range(nu):
                us = [u + inv_diag_omega * (b - y) for u, b, y in zip(us, bs, A(us))]
            return us

        def smooth_from_zero(bs):
            if smoother == "chebyshev":
                step1, coeffs = cheb_steps
                ds = [step1 * (inv_diag_omega * b) for b in bs]
                us = ds
                for c_d, c_z in coeffs:
                    zs = [inv_diag_omega * (b - y) for b, y in zip(bs, A(us))]
                    ds = [c_d * d + c_z * z for d, z in zip(ds, zs)]
                    us = [u + d for u, d in zip(us, ds)]
                return us
            us = [inv_diag_omega * b for b in bs]  # sweep 1 from the zero guess
            for _ in range(nu - 1):
                us = [u + inv_diag_omega * (b - y) for u, b, y in zip(us, bs, A(us))]
            return us

        def v_cycle(level, bs):
            sx_l = shapes[level][0] // n_shards
            if level == split:
                full = group.all_gather([b.reshape(-1) for b in bs]).reshape(shapes[level])
                e_full = tail(0, full)
                return [e_full[s * sx_l:(s + 1) * sx_l] for s in group.shards]
            us = smooth_from_zero(bs)
            rs = [b - y for b, y in zip(bs, A(us))]
            fine_local = (sx_l,) + tuple(shapes[level][1:])
            coarse_local = (shapes[level + 1][0] // n_shards,) + tuple(shapes[level + 1][1:])
            # x first (sharded), then y/z on the slab: the one-card order
            rcs = [4.0 * _restrict(r, coarse_local) for r in _restrict_x_sharded(group, rs)]
            es = _prolong_x_sharded(group, v_cycle(level + 1, rcs))
            us = [u + _prolong(e, fine_local) for u, e in zip(us, es)]
            return smooth(us, bs)

        def apply(rs_flat):
            sx = shapes[0][0] // n_shards
            bs = [r.reshape(sx, ny, nz) for r in rs_flat]
            zs = v_cycle(0, bs)
            for _ in range(cycles - 1):
                zs = [z + e for z, e in zip(zs, v_cycle(0, [b - y for b, y in zip(bs, A(zs))]))]
            return [z.reshape(r.shape) for z, r in zip(zs, rs_flat)]

        return apply

    return ShardedPreconditioner(op_arrays=(), make_local_apply=make_local_apply,
                                 collective=True)
