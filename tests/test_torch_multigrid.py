"""The port's geometric-multigrid preconditioner against the JAX package's
(``solver/multigrid.py``), on the CPU, in float64 from the same numpy
inputs.

* The apply (``cycles`` V-cycles) within 1e-10 relative of the JAX one at
  (16, 16, 16) with ``coarse_size=8`` (four levels), (9, 12, 10) and the
  2-D (32, 32, 1) grid with center 4, for both smoothers and 1 or 2
  cycles.  The arithmetic is the same; sums may round in another order.
* The V-cycle is symmetric to 1e-12 (materialized on small grids).
* MG-PCG takes the JAX solve's iteration count.
* The transfers, the dense coarse inverse and the Chebyshev schedule equal
  the JAX helpers', and multigrid_preconditioner refuses what the JAX one
  refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver import amg as jamg
from conjugategradient_tpu.solver import multigrid as jmg
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import StencilOperator as JStencil
from conjugategradient_tpu_torch import cg_solve, multigrid_preconditioner
from conjugategradient_tpu_torch.solver import multigrid as tmg
from conjugategradient_tpu_torch.types import CSRMatrix, StencilOperator

APPLY_RTOL = 1e-10

CASES = [((16, 16, 16), 6.0, 8), ((9, 12, 10), 6.0, 512), ((32, 32, 1), 4.0, 512)]


def _pair(grid, center, dtype=torch.float64):
    j = JStencil(jnp.asarray(center, jnp.float64), jnp.asarray(-1.0, jnp.float64), grid)
    return j, StencilOperator(center, -1.0, grid, dtype, "cpu")


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("grid,center,coarse", CASES, ids=lambda v: str(v))
def test_apply_matches_jax(grid, center, coarse, smoother, cycles):
    jop, top = _pair(grid, center)
    kw = dict(coarse_size=coarse, smoother=smoother, cycles=cycles)
    jM = jmg.multigrid_preconditioner(jop, **kw)
    tM = multigrid_preconditioner(top, **kw)
    r = np.random.default_rng(sum(grid)).standard_normal(top.shape[0])
    zj = np.asarray(jM(jnp.asarray(r)))
    zt = tM(torch.from_numpy(r))
    assert zt.dtype == torch.float64 and zt.shape == r.shape
    np.testing.assert_allclose(zt.numpy(), zj, rtol=APPLY_RTOL, atol=APPLY_RTOL * np.abs(zj).max())


def _matrix(apply, n):
    eye = torch.eye(n, dtype=torch.float64)
    return torch.stack([apply(eye[:, j].contiguous()) for j in range(n)], dim=1).numpy()


@pytest.mark.parametrize("smoother,cycles", [("jacobi", 1), ("chebyshev", 1), ("jacobi", 2)])
@pytest.mark.parametrize("grid,center", [((7, 7, 7), 6.0), ((9, 9, 1), 4.0)])
def test_vcycle_is_symmetric_positive(grid, center, smoother, cycles):
    _, top = _pair(grid, center)
    M = _matrix(multigrid_preconditioner(top, coarse_size=27, smoother=smoother,
                                         cycles=cycles), top.shape[0])
    np.testing.assert_allclose(M, M.T, rtol=0, atol=1e-12 * np.abs(M).max())
    assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("grid,center", [((16, 16, 16), 6.0), ((33, 17, 1), 4.0)])
def test_mgpcg_iterations_match_jax(grid, center, smoother):
    jop, top = _pair(grid, center)
    b = np.random.default_rng(5).standard_normal(top.shape[0])
    tol = 1e-8 * float(np.linalg.norm(b))
    xj, ji = jcg.cg_solve(jop, jnp.asarray(b), tol=tol,
                          M=jmg.multigrid_preconditioner(jop, smoother=smoother))
    xt, ti = cg_solve(top, torch.from_numpy(b), tol=tol,
                      M=multigrid_preconditioner(top, smoother=smoother))
    assert bool(ti.converged) and int(ti.iterations) == int(ji.iterations) <= 15
    k = int(ji.iterations)
    np.testing.assert_allclose(ti.rho_history.numpy()[:k + 1], np.asarray(ji.rho_history)[:k + 1],
                               rtol=1e-8)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_mgpcg_float32_converges():
    """The float32 path (the card's at 256^3) on a small grid: MG-PCG far
    ahead of plain CG."""
    top = StencilOperator.poisson((24, 24, 24), device="cpu")
    b = torch.arange(1, top.shape[0] + 1, dtype=torch.float32) / top.shape[0]
    tol = 1e-5 * float(b.norm())
    _, plain = cg_solve(top, b, tol=tol)
    for smoother in ("jacobi", "chebyshev"):
        x, mg = cg_solve(top, b, tol=tol, M=multigrid_preconditioner(top, smoother=smoother))
        assert bool(mg.converged) and 5 * int(mg.iterations) <= int(plain.iterations)
        assert float((b - top.matvec(x)).norm()) <= 2 * tol


@pytest.mark.parametrize("shape", [(7, 7, 7), (8, 6, 4), (9, 9, 1)])
def test_transfers_match_jax_and_are_transposes(shape):
    coarse = tmg._level_shapes(shape, coarse_size=1, max_levels=2)[1]
    assert coarse == jmg._level_shapes(shape, coarse_size=1, max_levels=2)[1]
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(shape), rng.standard_normal(coarse)
    ru = tmg._restrict(torch.from_numpy(u), coarse)
    pv = tmg._prolong(torch.from_numpy(v), shape)
    assert ru.is_contiguous() and pv.is_contiguous()
    np.testing.assert_allclose(ru.numpy(), np.asarray(jmg._restrict(jnp.asarray(u), coarse)),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jmg._prolong(jnp.asarray(v), shape)),
                               rtol=1e-15, atol=1e-15)
    d = sum(1 for a, b in zip(shape, coarse) if a != b)
    np.testing.assert_allclose(float((ru * torch.from_numpy(v)).sum()),
                               float((torch.from_numpy(u) * pv).sum()) * 0.5 ** d, rtol=1e-12)


def test_helpers_equal_jax():
    for shape in ((3, 4, 2), (2, 2, 2)):
        np.testing.assert_array_equal(tmg._dense_stencil_inverse(shape, 6.0, -1.0),
                                      jmg._dense_stencil_inverse(shape, 6.0, -1.0))
    for shape in ((256, 256, 256), (9, 12, 10), (2, 5, 1)):
        assert tmg._level_shapes(shape, 512, None) == jmg._level_shapes(shape, 512, None)
        assert tmg._stencil_rho_bound(shape, 4.0, -1.0) == jmg._stencil_rho_bound(shape, 4.0, -1.0)
    assert tmg._level_shapes((64, 64, 64), 8, 3) == jmg._level_shapes((64, 64, 64), 8, 3)
    for nu in (1, 2, 5):
        assert tmg._cheb_smooth_steps(1 / 3, 2.0, nu) == jamg._cheb_smooth_steps(1 / 3, 2.0, nu)


def test_rejects_what_jax_rejects():
    A = CSRMatrix.from_coo(np.array([0, 1]), np.array([0, 1]), np.array([2.0, 2.0]), (2, 2),
                           device="cpu")
    with pytest.raises(TypeError, match="StencilOperator"):
        multigrid_preconditioner(A)
    with pytest.raises(TypeError, match="StencilOperator"):
        jmg.multigrid_preconditioner(JCSR.from_coo(np.array([0, 1]), np.array([0, 1]),
                                                   np.array([2.0, 2.0]), (2, 2)))
    op = StencilOperator.poisson((8, 8, 8), dtype=torch.float64, device="cpu")
    for kw, match in ((dict(nu=0), "nu"), (dict(omega=2.5), "omega"), (dict(cycles=0), "cycles"),
                      (dict(smoother="gs"), "smoother"),
                      (dict(smoother="chebyshev", cheb_lower=0.0), "cheb_lower")):
        with pytest.raises(ValueError, match=match):
            multigrid_preconditioner(op, **kw)
    with pytest.raises(ValueError, match="center"):
        multigrid_preconditioner(StencilOperator(-6.0, -1.0, (4, 4, 4), torch.float64, "cpu"))
