"""The port's implicit gradients (``conjugategradient_tpu_torch.solver.
autodiff``) against the JAX package's ``jax.grad`` / ``jax.vjp`` through
``conjugategradient_tpu.solver.autodiff``, on the same numpy inputs made
from a seed: one counterpart for each case of tests/test_autodiff.py, plus
the stencil coefficients' gradient and the dtype of a bfloat16 operator's
cotangent.

Every check runs in float64 on the CPU.  Gradients are held to the JAX
ones to 1e-8 relative (the two packages sum the CG dots in other orders, so
the adjoint solves part at roundoff, which the 1e-12 / 1e-10 forward
tolerances keep far below 1e-8), and, where tests/test_autodiff.py holds an
analytic value or a finite difference, to that too with its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.problems import convection_diffusion_2d_coo, poisson2d_coo
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, DIAMatrix, StencilOperator,
                                         SymBellMatrix, cg_solve, gmres_solve, implicit_cg_solve,
                                         implicit_gmres_solve, jacobi_preconditioner)

CPU = "cpu"
RTOL = 1e-8


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _small_spd(seed=0, n=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    return q @ q.T + n * np.eye(n)


def _pair_csr(a):
    """The same dense matrix as a JAX and a port CSR operator."""
    rows, cols = np.nonzero(a)
    return (jcg.CSRMatrix.from_coo(rows, cols, a[rows, cols], a.shape),
            CSRMatrix.from_coo(rows, cols, a[rows, cols], a.shape, device=CPU))


def _vec(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def _jloss(op, b, **kw):
    x, _ = jcg.implicit_cg_solve(op, b, tol=0.0, **kw)
    return jnp.sum(x ** 3)


def _tloss(op, b, **kw):
    x, _ = implicit_cg_solve(op, b, tol=0.0, **kw)
    return torch.sum(x ** 3)


def _grad_b(loss, op, b_np, **kw):
    b = torch.tensor(b_np, requires_grad=True)
    (g,) = torch.autograd.grad(loss(op, b, **kw), b)
    return g.numpy()


def _with_grad(op, field):
    """The port operator with ``field`` a fresh leaf that requires grad."""
    leaf = getattr(op, field).detach().clone().requires_grad_()
    return dataclasses.replace(op, **{field: leaf}), leaf


# ---- TestGradB ----------------------------------------------------------------

def test_grad_b_matches_jax_and_dense_analytic():
    a = _small_spd()
    jop, top = _pair_csr(a)
    b = _vec(a.shape[0])
    gb = _grad_b(_tloss, top, b)
    gj = np.asarray(jax.grad(_jloss, argnums=1)(jop, jnp.asarray(b)))
    x = np.linalg.solve(a, b)
    np.testing.assert_allclose(gb, np.linalg.solve(a, 3 * x ** 2), rtol=1e-9)
    np.testing.assert_allclose(gb, gj, rtol=RTOL)


def test_preconditioner_does_not_change_gradient():
    a = _small_spd()
    jop, top = _pair_csr(a)
    b = _vec(a.shape[0])
    g_plain = _grad_b(_tloss, top, b)
    g_pcg = _grad_b(_tloss, top, b, M=jacobi_preconditioner(top))
    gj = np.asarray(jax.grad(_jloss, argnums=1)(jop, jnp.asarray(b),
                                                M=jcg.jacobi_preconditioner(jop)))
    np.testing.assert_allclose(g_pcg, g_plain, rtol=1e-8)
    np.testing.assert_allclose(g_pcg, gj, rtol=RTOL)


def test_two_autograd_entry_points_compose_alike():
    """The counterpart of the JAX ``jit(grad)`` case: ``backward()`` and
    ``torch.autograd.grad`` through the same solve give the same bits, and
    so do two backward passes."""
    a = _small_spd()
    _, top = _pair_csr(a)
    b_np = _vec(a.shape[0])
    g1 = _grad_b(_tloss, top, b_np)
    b = torch.tensor(b_np, requires_grad=True)
    _tloss(top, b).backward()
    g2 = b.grad.numpy()
    assert np.array_equal(g1, g2)
    assert np.array_equal(g1, _grad_b(_tloss, top, b_np))


def test_x0_gradient_is_zero():
    a = _small_spd()
    _, top = _pair_csr(a)
    b = torch.tensor(_vec(a.shape[0]))
    x0 = torch.tensor(_vec(a.shape[0], seed=2), requires_grad=True)
    x, _ = implicit_cg_solve(top, b, x0, tol=0.0)
    (g,) = torch.autograd.grad(torch.sum(x ** 2), x0)
    assert torch.equal(g, torch.zeros_like(g))


# ---- TestGradA ----------------------------------------------------------------

def _poisson_pair(nx):
    rows, cols, vals, shape = poisson2d_coo(nx)
    return (jcg.CSRMatrix.from_coo(rows, cols, vals, shape),
            CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU), shape)


def test_csr_per_nonzero_gradient():
    """∂L/∂a_k = −w[row_k]·x[col_k] for every stored nonzero, as jax.grad
    gives it."""
    jop, top, shape = _poisson_pair(8)
    b = _vec(shape[0], seed=3)
    op, data = _with_grad(top, "data")
    (g,) = torch.autograd.grad(_tloss(op, torch.tensor(b)), data)
    g_j = jax.grad(_jloss, argnums=0, allow_int=True)(jop, jnp.asarray(b))
    a = top.to_dense().numpy()
    x = np.linalg.solve(a, b)
    w = np.linalg.solve(a, 3 * x ** 2)
    g_ref = -w[top.row_ids.numpy()] * x[top.indices.numpy()]
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j.data), rtol=RTOL)
    assert g.shape == top.data.shape


def test_finite_difference_csr():
    jop, top, shape = _poisson_pair(5)
    b = torch.tensor(_vec(shape[0], seed=4))
    op, data = _with_grad(top, "data")
    (g,) = torch.autograd.grad(_tloss(op, b), data)
    g_j = jax.grad(_jloss, argnums=0, allow_int=True)(jop, jnp.asarray(b.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j.data), rtol=RTOL)
    eps = 1e-6
    for k in (0, 7, 31):
        dv = torch.zeros_like(top.data)
        dv[k] = eps
        lp = float(_tloss(dataclasses.replace(top, data=top.data + dv), b))
        lm = float(_tloss(dataclasses.replace(top, data=top.data - dv), b))
        np.testing.assert_allclose(float(g[k]), (lp - lm) / (2 * eps), rtol=1e-4)


def _symbell_dense():
    n, bm = 32, 8
    a = np.zeros((n, n))
    rng = np.random.default_rng(7)
    for i in range(4):
        d = rng.standard_normal((bm, bm))
        a[i * bm:(i + 1) * bm, i * bm:(i + 1) * bm] = d + d.T + 30 * np.eye(bm)
    blk = rng.standard_normal((bm, bm))
    a[0:bm, bm:2 * bm] = blk
    a[bm:2 * bm, 0:bm] = blk.T
    return a, bm


def test_symbell_mirrored_gradient():
    """Each stored upper entry receives both mirrored contributions:
    ∂L/∂B[i,j] at tile (r,c) = −(w_r[i]·x_c[j] + w_c[j]·x_r[i]), and the
    whole stored gradient equals jax.grad's."""
    a, bm = _symbell_dense()
    n = a.shape[0]
    jcsr, tcsr = _pair_csr(a)
    jsym = jcg.SymBellMatrix.from_bell(jcg.BlockedEllMatrix.from_csr(jcsr, bm=bm, bn=bm))
    tsym = SymBellMatrix.from_bell(BlockedEllMatrix.from_csr(tcsr, bm=bm, bn=bm))
    b = _vec(n, seed=5)
    leaves = {f: getattr(tsym, f).detach().clone().requires_grad_()
              for f in ("diag_blocks", "off_blocks")}
    op = dataclasses.replace(tsym, **leaves)
    g_diag, g_off = torch.autograd.grad(_tloss(op, torch.tensor(b)), list(leaves.values()))
    g_j = jax.grad(_jloss, argnums=0, allow_int=True)(jsym, jnp.asarray(b))
    np.testing.assert_allclose(g_off.numpy(), np.asarray(g_j.off_blocks), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(g_diag.numpy(), np.asarray(g_j.diag_blocks), rtol=RTOL,
                               atol=1e-14)
    x = np.linalg.solve(a, b)
    w = np.linalg.solve(a, 3 * x ** 2)
    dense = -np.outer(w, x)
    expected = dense[0:bm, bm:2 * bm] + dense[bm:2 * bm, 0:bm].T
    (slot,) = np.nonzero(tsym.off_cols[0].numpy() == 1)
    np.testing.assert_allclose(g_off[0, slot[0]].numpy(), expected, rtol=1e-8)


def test_dia_gradient_finite_difference():
    jcsr, tcsr, shape = _poisson_pair(5)
    jop, top = jcg.DIAMatrix.from_csr(jcsr), DIAMatrix.from_csr(tcsr)
    b = torch.tensor(_vec(shape[0], seed=6))
    op, diags = _with_grad(top, "diags")
    (g,) = torch.autograd.grad(_tloss(op, b), diags)
    g_j = jax.grad(_jloss, argnums=0, allow_int=True)(jop, jnp.asarray(b.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j.diags), rtol=RTOL, atol=1e-14)
    eps, d, i = 1e-6, 0, 9
    dv = torch.zeros_like(top.diags)
    dv[d, i] = eps
    lp = float(_tloss(dataclasses.replace(top, diags=top.diags + dv), b))
    lm = float(_tloss(dataclasses.replace(top, diags=top.diags - dv), b))
    np.testing.assert_allclose(float(g[d, i]), (lp - lm) / (2 * eps), rtol=1e-4)


# ---- TestForwardValues --------------------------------------------------------

def test_forward_matches_cg_solve():
    jop, top, shape = _poisson_pair(8)
    b = torch.tensor(_vec(shape[0], seed=8))
    x1, i1 = implicit_cg_solve(top, b, tol=1e-12)
    x2, i2 = cg_solve(top, b, tol=1e-12)
    assert torch.equal(x1, x2)
    assert int(i1.iterations) == int(i2.iterations)
    assert torch.equal(i1.rho_history.isnan(), i2.rho_history.isnan())
    _, ij = jcg.implicit_cg_solve(jop, jnp.asarray(b.numpy()), tol=1e-12)
    assert int(i1.iterations) == int(ij.iterations)


# ---- TestImplicitGmres ----------------------------------------------------------

def _convdiff():
    rows, cols, vals, shape = convection_diffusion_2d_coo(8, peclet=15.0)
    a = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    a.sort_indices()
    return a


def _gmres_loss(op, b, power=3, **kw):
    n = b.shape[0]
    x, _ = implicit_gmres_solve(op, b, tol=1e-12, maxiter=4 * n, **kw)
    return torch.sum(x ** power)


def _jgmres_loss(op, b, power=3, **kw):
    n = b.shape[0]
    x, _ = jcg.implicit_gmres_solve(op, b, tol=1e-12, maxiter=4 * n, **kw)
    return jnp.sum(x ** power)


def test_gmres_matches_dense_analytic_adjoint():
    a = _convdiff()
    n = a.shape[0]
    top = CSRMatrix.from_scipy(a, device=CPU)
    jop = jcg.CSRMatrix.from_scipy(a)
    b_np = _vec(n, seed=9)
    op, data = _with_grad(top, "data")
    b = torch.tensor(b_np, requires_grad=True)
    g_data, g_b = torch.autograd.grad(_gmres_loss(op, b), [data, b])
    jg_op, jg_b = jax.grad(_jgmres_loss, argnums=(0, 1), allow_int=True)(jop, jnp.asarray(b_np))
    ad = a.toarray()
    x = np.linalg.solve(ad, b_np)
    w = np.linalg.solve(ad.T, 3 * x ** 2)  # the TRANSPOSED system
    np.testing.assert_allclose(g_b.numpy(), w, atol=1e-12)
    ga_ref = -(w[:, None] * x[None, :])
    data_ref = np.array([ga_ref[i, j] for i, j in zip(*a.nonzero())])
    np.testing.assert_allclose(g_data.numpy(), data_ref, atol=1e-12)
    np.testing.assert_allclose(g_b.numpy(), np.asarray(jg_b), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(g_data.numpy(), np.asarray(jg_op.data), rtol=RTOL, atol=1e-14)


def test_symmetric_shortcut_would_be_wrong():
    """On this nonsymmetric A, A⁻ᵀḡ differs from A⁻¹ḡ, and the port's GMRES
    rule gives the transposed one."""
    a = _convdiff()
    n = a.shape[0]
    b = _vec(n, seed=10)
    ad = a.toarray()
    x = np.linalg.solve(ad, b)
    g = 3 * x ** 2
    w_t, w_s = np.linalg.solve(ad.T, g), np.linalg.solve(ad, g)
    assert np.abs(w_t - w_s).max() > 1e-3 * np.abs(w_t).max()
    got = _grad_b(_gmres_loss, CSRMatrix.from_scipy(a, device=CPU), b)
    np.testing.assert_allclose(got, w_t, atol=1e-12)


def test_gmres_dense_operator_gradient():
    """Gradients flow to a dense tensor passed as the operator."""
    a = _convdiff()
    n = a.shape[0]
    dense_np = a.toarray()
    b_np = _vec(n, seed=11)
    dense = torch.tensor(dense_np, requires_grad=True)
    b = torch.tensor(b_np, requires_grad=True)
    g_dense, g_b = torch.autograd.grad(_gmres_loss(dense, b, power=2), [dense, b])
    jg_dense, jg_b = jax.grad(_jgmres_loss, argnums=(0, 1))(jnp.asarray(dense_np),
                                                           jnp.asarray(b_np), power=2)
    x = np.linalg.solve(dense_np, b_np)
    w = np.linalg.solve(dense_np.T, 2 * x)
    np.testing.assert_allclose(g_b.numpy(), w, atol=1e-11)
    np.testing.assert_allclose(g_dense.numpy(), -(w[:, None] * x[None, :]), atol=1e-11)
    np.testing.assert_allclose(g_b.numpy(), np.asarray(jg_b), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(g_dense.numpy(), np.asarray(jg_dense), rtol=RTOL, atol=1e-14)


def test_gmres_forward_matches_gmres_solve():
    a = _convdiff()
    top = CSRMatrix.from_scipy(a, device=CPU)
    b = torch.tensor(_vec(a.shape[0], seed=12))
    x1, i1 = implicit_gmres_solve(top, b, tol=1e-10, restart=20)
    x2, i2 = gmres_solve(top, b, tol=1e-10, restart=20)
    assert torch.equal(x1, x2)
    assert int(i1.iterations) == int(i2.iterations)
    _, ij = jcg.implicit_gmres_solve(jcg.CSRMatrix.from_scipy(a), jnp.asarray(b.numpy()),
                                     tol=1e-10, restart=20)
    assert int(i1.iterations) == int(ij.iterations)


# ---- TestAdjointPreconditioner ---------------------------------------------------

def test_gmres_linear_m_gradient_unchanged():
    """A NONSYMMETRIC linear M is transposed for the adjoint, and the
    converged gradient does not change."""
    from conjugategradient_tpu_torch.solver.autodiff import _transpose_preconditioner

    a = _convdiff()
    n = a.shape[0]
    top = CSRMatrix.from_scipy(a, device=CPU)
    b = _vec(n, seed=13)
    d = torch.tensor(1.0 / a.diagonal())
    jd = jnp.asarray(1.0 / a.diagonal())

    def m_shift(v):
        return d * (0.8 * v + 0.2 * torch.roll(v, 1))

    def jm_shift(v):
        return jd * (0.8 * v + 0.2 * jnp.roll(v, 1))

    g_plain = _grad_b(_gmres_loss, top, b)
    g_m = _grad_b(_gmres_loss, top, b, M=m_shift)
    np.testing.assert_allclose(g_m, g_plain, atol=1e-10)
    jg = jax.grad(_jgmres_loss, argnums=1)(jcg.CSRMatrix.from_scipy(a), jnp.asarray(b),
                                           M=jm_shift)
    np.testing.assert_allclose(g_m, np.asarray(jg), rtol=RTOL, atol=1e-14)
    # the rule picked the transpose: Mᵀu for u = e_0 is column 0 of M
    mt = _transpose_preconditioner(m_shift, torch.zeros(n, dtype=torch.float64))
    assert mt is not m_shift
    e0 = torch.zeros(n, dtype=torch.float64)
    e0[0] = 1.0
    want = torch.stack([m_shift(torch.eye(n, dtype=torch.float64)[i]) for i in range(n)])[:, 0]
    assert torch.allclose(mt(e0), want, rtol=0, atol=1e-15)


def test_gmres_nonlinear_m_falls_back():
    """A nonlinear M is reused untransposed, and the gradient is the
    converged, M-independent one."""
    from conjugategradient_tpu_torch.solver.autodiff import _transpose_preconditioner

    a = _convdiff()
    n = a.shape[0]
    top = CSRMatrix.from_scipy(a, device=CPU)
    b = _vec(n, seed=14)

    def m_nl(v):
        return v / (1.0 + 0.1 * torch.abs(v))

    def jm_nl(v):
        return v / (1.0 + 0.1 * jnp.abs(v))

    g_plain = _grad_b(_gmres_loss, top, b)
    g_m = _grad_b(_gmres_loss, top, b, M=m_nl)
    np.testing.assert_allclose(g_m, g_plain, atol=1e-10)
    jg = jax.grad(_jgmres_loss, argnums=1)(jcg.CSRMatrix.from_scipy(a), jnp.asarray(b), M=jm_nl)
    np.testing.assert_allclose(g_m, np.asarray(jg), rtol=RTOL, atol=1e-14)
    assert _transpose_preconditioner(m_nl, torch.zeros(n, dtype=torch.float64)) is m_nl


# ---- beyond tests/test_autodiff.py ------------------------------------------------

def test_stencil_coefficient_gradient_matches_jax():
    """The JAX StencilOperator's center and off are array leaves with a
    gradient; the port's take 0-d tensors (``coefficient_tensors``) and get
    the same gradient, while the kernels keep the host floats."""
    grid = (4, 3, 5)
    n = int(np.prod(grid))
    b = _vec(n, seed=15)
    center = torch.tensor(6.0, dtype=torch.float64, requires_grad=True)
    off = torch.tensor(-1.0, dtype=torch.float64, requires_grad=True)
    op = StencilOperator(center, off, grid, torch.float64, CPU)
    assert op.center == 6.0 and op.off == -1.0
    gc, go = torch.autograd.grad(_tloss(op, torch.tensor(b)), [center, off])
    jop = jcg.StencilOperator(jnp.asarray(6.0), jnp.asarray(-1.0), grid)
    jg = jax.grad(_jloss, argnums=0)(jop, jnp.asarray(b))
    np.testing.assert_allclose(float(gc), float(jg.center), rtol=RTOL)
    np.testing.assert_allclose(float(go), float(jg.off), rtol=RTOL)
    # the finite difference in the center coefficient
    eps = 1e-6
    lp = float(_tloss(StencilOperator(6.0 + eps, -1.0, grid, torch.float64, CPU), torch.tensor(b)))
    lm = float(_tloss(StencilOperator(6.0 - eps, -1.0, grid, torch.float64, CPU), torch.tensor(b)))
    np.testing.assert_allclose(float(gc), (lp - lm) / (2 * eps), rtol=1e-5)


def test_bf16_operator_gets_bf16_cotangent():
    """A bfloat16 operator's value cotangent is bfloat16, as jax.grad gives
    it; b's is float32 like b, and both match the JAX ones."""
    jcsr, tcsr, shape = _poisson_pair(6)
    t16 = tcsr.astype(torch.bfloat16)
    j16 = jcsr.astype(jnp.bfloat16)
    b_np = _vec(shape[0], seed=16).astype(np.float32)
    op, data = _with_grad(t16, "data")
    b = torch.tensor(b_np, requires_grad=True)

    def tl(op_, b_):
        x, _ = implicit_cg_solve(op_, b_, tol=0.0, maxiter=60)
        return torch.sum(x ** 2)

    def jl(op_, b_):
        x, _ = jcg.implicit_cg_solve(op_, b_, tol=0.0, maxiter=60)
        return jnp.sum(x ** 2)

    g_data, g_b = torch.autograd.grad(tl(op, b), [data, b])
    jg_op, jg_b = jax.grad(jl, argnums=(0, 1), allow_int=True)(j16, jnp.asarray(b_np))
    assert g_data.dtype == torch.bfloat16 and jg_op.data.dtype == jnp.bfloat16
    assert g_b.dtype == torch.float32 and jg_b.dtype == jnp.float32
    scale = np.abs(np.asarray(jg_b)).max()
    np.testing.assert_allclose(g_b.numpy(), np.asarray(jg_b), rtol=0, atol=1e-3 * scale)
    gd = g_data.float().numpy()
    jd = np.asarray(jg_op.data.astype(jnp.float32))
    np.testing.assert_allclose(gd, jd, rtol=0, atol=2e-2 * np.abs(jd).max())


def test_adjoint_gmres_miss_warns():
    """An adjoint GMRES that misses tol within maxiter says so, once."""
    a = _convdiff()
    top = CSRMatrix.from_scipy(a, device=CPU)
    b = torch.tensor(_vec(a.shape[0], seed=17), requires_grad=True)
    x, _ = implicit_gmres_solve(top, b, tol=1e-12, maxiter=3, restart=3)
    with pytest.warns(RuntimeWarning, match="adjoint GMRES did not converge") as rec:
        torch.autograd.grad(torch.sum(x ** 3), b)
    assert len([w for w in rec if "adjoint" in str(w.message)]) == 1
