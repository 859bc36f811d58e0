"""Geometric multigrid V-cycle preconditioner for the matrix-free stencil.
Counterpart of ``conjugategradient_tpu/solver/multigrid.py``, the same
hierarchy and arithmetic (tests/test_torch_multigrid.py holds the apply
against the JAX one):

* vertex coarsening at odd fine indices — coarse point c sits at fine index
  2c + 1, so n_c = n // 2 for every n >= 2;
* P = linear interpolation, R = (1/2)^d Pᵀ (full weighting), equal pre- and
  post-smoothing: the V-cycle is symmetric, as PCG requires;
* the rediscretized coarse operator is the same dimensionless stencil, so
  the residual transfer carries the h² factor 4;
* damped-Jacobi or degree-ν Chebyshev smoothing;
* a dense coarsest solve: the stencil matrix assembled and inverted on the
  host in float64 at build time, applied as one full-precision matmul.

Every stencil apply of the cycle, at every level, goes through the
``stencil7`` wrapper, so on a CUDA device it launches the hand-written
kernel (float32 or float64); the transfers and smoothing updates are plain
torch, as the JAX package leaves them to XLA.  Returned by
:func:`multigrid_preconditioner` for ``cg_solve(..., M=apply)``, which runs
the portable loop (there is no fused MG-PCG).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda.stencil import stencil7
from ..ops.spmv import full_precision_matmul
from ..types import StencilOperator
from ..types.stencil import round_to


def _coarse_shape(shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Next-level grid: halve every axis that still has >= 2 points."""
    return tuple((n // 2) if n >= 2 else n for n in shape)


def _along(axis: int, sl: slice) -> tuple:
    """An index that applies ``sl`` to ``axis`` of a volume."""
    return (slice(None),) * axis + (sl,)


def _pad_axis(u: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """Zero-pad ``axis`` of a (nx, ny, nz) volume; the result is row-major."""
    pad = [0, 0] * (3 - axis)
    pad[-2:] = [before, after]
    return torch.nn.functional.pad(u, pad)


def _restrict_axis(u: torch.Tensor, axis: int) -> torch.Tensor:
    """Full-weighting restriction along ``axis`` (coarse c <- fine 2c+1)."""
    nc = u.shape[axis] // 2
    upad = _pad_axis(u, axis, 0, 1)
    a = upad[_along(axis, slice(0, 2 * nc - 1, 2))]  # f[2c]
    b = upad[_along(axis, slice(1, 2 * nc, 2))]  # f[2c+1]
    c = upad[_along(axis, slice(2, 2 * nc + 1, 2))]  # f[2c+2]
    return 0.25 * a + 0.5 * b + 0.25 * c


def _prolong_axis(e: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Linear interpolation along ``axis``: the transpose of ``2 *
    _restrict_axis``.  The interleave is a stack on a new axis after
    ``axis`` and a reshape that merges the two, so every pass stays
    row-major (the JAX package moves the axis to the front instead, which
    here would make strided transposes of the volume)."""
    nc = e.shape[axis]
    ce = n - nc  # number of even fine indices (= ceil(n/2))
    e_left = _pad_axis(e, axis, 1, 0)[_along(axis, slice(0, ce))]  # e[c-1], zero at c=0
    e_right = _pad_axis(e, axis, 0, 1)[_along(axis, slice(0, ce))]  # e[c], zero past the end
    even = 0.5 * (e_left + e_right)
    shape = list(e.shape)
    if n == 2 * nc:  # even size: perfect [even, odd] interleave
        shape[axis] = n
        return torch.stack([even, e], dim=axis + 1).reshape(shape)
    # odd size (n == 2*nc + 1): interleave the first 2*nc, append even[nc]
    shape[axis] = 2 * nc
    body = torch.stack([even[_along(axis, slice(0, nc))], e], dim=axis + 1).reshape(shape)
    return torch.cat([body, even[_along(axis, slice(nc, None))]], dim=axis)


def _restrict(u: torch.Tensor, coarse: Tuple[int, int, int]) -> torch.Tensor:
    for axis in range(3):
        if coarse[axis] != u.shape[axis]:
            u = _restrict_axis(u, axis)
    return u


def _prolong(e: torch.Tensor, fine: Tuple[int, int, int]) -> torch.Tensor:
    for axis in range(3):
        if fine[axis] != e.shape[axis]:
            e = _prolong_axis(e, axis, fine[axis])
    return e


def _stencil_apply(u: torch.Tensor, center: float, off: float) -> torch.Tensor:
    return stencil7(u, center, off)


def _dense_stencil_inverse(shape: Tuple[int, int, int], center: float,
                           off: float) -> np.ndarray:
    """Assemble the coarsest-level stencil matrix densely (float64) and
    invert it (the connectivity of ``ops/stencil.poisson7_csr`` with any
    (center, off))."""
    nx, ny, nz = shape
    n = nx * ny * nz
    A = np.zeros((n, n), dtype=np.float64)
    idx = lambda i, j, k: (i * ny + j) * nz + k
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                r = idx(i, j, k)
                A[r, r] = center
                for di, dj, dk in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                   (0, 1, 0), (0, 0, -1), (0, 0, 1)):
                    ii, jj, kk = i + di, j + dj, k + dk
                    if 0 <= ii < nx and 0 <= jj < ny and 0 <= kk < nz:
                        A[r, idx(ii, jj, kk)] = off
    return np.linalg.inv(A)


def _level_shapes(shape: Tuple[int, int, int], coarse_size: int,
                  max_levels: Optional[int]) -> List[Tuple[int, int, int]]:
    shapes = [tuple(shape)]
    while True:
        if max_levels is not None and len(shapes) >= max_levels:
            break
        if int(np.prod(shapes[-1])) <= coarse_size:
            break
        nxt = _coarse_shape(shapes[-1])
        if nxt == shapes[-1]:
            break
        shapes.append(nxt)
    return shapes


def _stencil_rho_bound(shape: Tuple[int, int, int], center: float, off: float) -> float:
    """Gershgorin bound on rho(D^-1 S): the max row gets 2 neighbours per
    axis with >= 3 points, 1 per length-2 axis, 0 per singleton axis."""
    k = sum(0 if n <= 1 else (1 if n == 2 else 2) for n in shape)
    return (abs(center) + k * abs(off)) / center


def _cheb_smooth_steps(a: float, b: float, nu: int):
    """Static scalar schedule of the degree-``nu`` preconditioned Chebyshev
    semi-iteration on [a, b] (Saad, Iterative Methods, Alg. 12.1), copied
    from ``conjugategradient_tpu/solver/amg.py``: returns ``(step_1,
    [(c_d, c_z), ...])`` such that

        d_1 = step_1 * z_1;               u += d_1
        d_k = c_d * d_{k-1} + c_z * z_k;  u += d_k   (k = 2..nu)

    with z_k = D^-1 (b - A u)."""
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coeffs = []
    for _ in range(nu - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return 1.0 / theta, coeffs


def _make_vcycle(shapes, center: float, off: float, inv_diag_omega: float,
                 inv_coarse: torch.Tensor, nu: int, smoother: str = "jacobi",
                 cheb_steps=None):
    """The recursive V-cycle ``(level, b) -> approx solution`` over the
    level hierarchy.  With ``smoother="chebyshev"``, ``inv_diag_omega`` is
    the raw 1/center and one (step_1, coeffs) schedule serves every level
    (the dimensionless stencil repeats)."""
    if smoother == "chebyshev":
        step1, coeffs = cheb_steps

    def smooth(u, b):
        if smoother == "chebyshev":
            z = inv_diag_omega * (b - _stencil_apply(u, center, off))
            d = step1 * z
            u = u + d
            for c_d, c_z in coeffs:
                z = inv_diag_omega * (b - _stencil_apply(u, center, off))
                d = c_d * d + c_z * z
                u = u + d
            return u
        for _ in range(nu):
            u = u + inv_diag_omega * (b - _stencil_apply(u, center, off))
        return u

    def smooth_from_zero(b):
        # sweep 1 from the zero guess is a scaling of b (one stencil pass
        # saved per level)
        if smoother == "chebyshev":
            d = step1 * (inv_diag_omega * b)
            u = d
            for c_d, c_z in coeffs:
                z = inv_diag_omega * (b - _stencil_apply(u, center, off))
                d = c_d * d + c_z * z
                u = u + d
            return u
        u = inv_diag_omega * b
        for _ in range(nu - 1):
            u = u + inv_diag_omega * (b - _stencil_apply(u, center, off))
        return u

    def v_cycle(level: int, b: torch.Tensor) -> torch.Tensor:
        """Solve S u = b approximately on ``level`` (zero initial guess)."""
        if level == len(shapes) - 1:
            return torch.matmul(inv_coarse, b.reshape(-1)).reshape(shapes[level])
        u = smooth_from_zero(b)
        r = b - _stencil_apply(u, center, off)
        # dimensionless stencil at every level => h^2 scale factor of 4
        e_c = v_cycle(level + 1, 4.0 * _restrict(r, shapes[level + 1]))
        u = u + _prolong(e_c, shapes[level])
        return smooth(u, b)

    return v_cycle


def multigrid_preconditioner(
    A: Any,
    *,
    nu: int = 2,
    omega: float = 0.85,
    cycles: int = 1,
    coarse_size: int = 512,
    max_levels: Optional[int] = None,
    smoother: str = "jacobi",
    cheb_lower: float = 1.0 / 6.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``M⁻¹ r`` = ``cycles`` symmetric geometric-multigrid V-cycles
    for a :class:`StencilOperator` (2-D problems ride as ``(nx, ny, 1)``
    grids with ``center=4``).  Arguments as the JAX function's: ``nu``
    pre- and post-smoothing sweeps (or the Chebyshev degree), ``omega`` the
    Jacobi damping, ``cycles`` V-cycles per apply, ``coarse_size`` the
    largest level solved densely, ``max_levels`` a depth cap,
    ``smoother`` "jacobi" or "chebyshev" (on [cheb_lower·ρ, ρ], ρ the
    Gershgorin bound; ``omega`` ignored).  Building is host work (the dense
    coarsest inverse); reuse the closure across solves.
    """
    if not isinstance(A, StencilOperator):
        raise TypeError(
            "multigrid_preconditioner is the geometric (regular-grid) "
            f"preconditioner and needs a StencilOperator, got {type(A).__name__}; "
            "for assembled sparse operators use block_jacobi_preconditioner "
            "or chebyshev_preconditioner"
        )
    if nu < 1:
        raise ValueError(f"nu must be >= 1, got {nu}")
    if not (0.0 < omega < 2.0):
        raise ValueError(f"omega must be in (0, 2), got {omega}")
    if cycles < 1:
        raise ValueError(f"cycles must be >= 1, got {cycles}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"smoother must be 'jacobi' or 'chebyshev', got {smoother!r}")
    if not (0.0 < cheb_lower < 1.0):
        raise ValueError(f"cheb_lower must be in (0, 1), got {cheb_lower}")

    shapes = _level_shapes(A.grid_shape, coarse_size, max_levels)
    center, off, dtype = A.center, A.off, A.dtype
    if center <= 0.0:
        raise ValueError(f"stencil center must be positive for an SPD operator, got {center}")
    full_precision_matmul()
    inv_coarse = torch.as_tensor(_dense_stencil_inverse(shapes[-1], center, off),
                                 dtype=dtype, device=A.device)
    cheb_steps = None
    if smoother == "chebyshev":
        rho_b = _stencil_rho_bound(shapes[0], center, off)
        cheb_steps = _cheb_smooth_steps(cheb_lower * rho_b, rho_b, nu)
        inv_diag_omega = round_to(1.0 / center, dtype)
    else:
        inv_diag_omega = round_to(omega / center, dtype)
    v_cycle = _make_vcycle(shapes, center, off, inv_diag_omega, inv_coarse, nu,
                           smoother=smoother, cheb_steps=cheb_steps)

    def apply(rhs: torch.Tensor) -> torch.Tensor:
        b = rhs.reshape(shapes[0])
        z = v_cycle(0, b)
        for _ in range(cycles - 1):
            z = z + v_cycle(0, b - _stencil_apply(z, center, off))
        return z.reshape(rhs.shape)

    return apply
