"""The port's lockstep multi-RHS BiCGStab, GMRES and MINRES
(``solver/batched_nonsym.py``) against the JAX package's, on the same numpy
inputs (CPU), mirroring ``tests/test_batched_nonsym.py``.

Tolerances, with their reasons: in float64 both packages take the same
steps with sums in another order, so per-lane ``iterations``, ``cycles``,
``converged`` and ``breakdown`` are equal and X agrees to 1e-10 of
max|X|.  ``rnorm_history`` agrees to 1e-10 relative outside the converged
tail, where the two orders' roundoff (~1e-16·‖r₀‖ a step, accumulated) is
a growing share of the entry: an absolute 1e-12·‖r₀‖ covers the tail (the
bound of ``tests/test_torch_gmres.py``).  BiCGStab's to 1e-9 relative
and 1e-10·‖r₀‖ (the bound of ``tests/test_torch_bicgstab.py``): on a
near-breakdown spike (lane 0 of the 8 x 8 blocked-ELL case, ‖r‖ from
0.053 to 1.07·‖r₀‖ in one step) the two orders part by 5.2e-10.  On the
pure rotation r̂ᵀv is zero in exact arithmetic, and whether a sum order
gives 0 (a breakdown) or a tiny number (huge finite steps) is the
order's: there each package's batched lanes are held to its own solo
solves, as the JAX test does.
Where the JAX test holds a lane against its solo solve, the port's lane is
held against the port's solo solve the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, DIAMatrix, bicgstab_solve,
                                         bicgstab_solve_batched, gmres_solve, gmres_solve_batched,
                                         jacobi_preconditioner, minres_solve,
                                         minres_solve_batched)
from conjugategradient_tpu_torch.problems import banded_spd_coo, convection_diffusion_2d_coo

CPU = "cpu"


class _Ops:
    """JAX and port operators of one matrix in CSR, DIA and 8 x 8 bell."""

    def __init__(self, a):
        self.n = a.shape[0]
        jc, tc = JCSR.from_scipy(a), CSRMatrix.from_scipy(a, device=CPU)
        self.csr = (jc, tc)
        self.dia = (JDIA.from_csr(jc), DIAMatrix.from_csr(tc))
        self.bell = (JBell.from_csr(jc, bm=8, bn=8), BlockedEllMatrix.from_csr(tc, bm=8, bn=8))


def _ops(nx=14, peclet=12.0):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=peclet)
    return _Ops(sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr())


def _sym_ops(n=180, bw=5, seed=2):
    rows, cols, vals, shape = banded_spd_coo(n, bandwidth=bw, seed=seed)
    return _Ops(sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr())


def _rhs(n, R, seed=0):
    return np.random.default_rng(seed).standard_normal((R, n))


def _both(jfn, tfn, pair, B, **kw):
    """The JAX and the port's batched solve on the same inputs; ``M`` as a
    pair (jax, port), ``tol`` scalar or per lane."""
    jM, tM = kw.pop("M", (None, None))
    tol = kw.pop("tol")
    jres = jfn(pair[0], jnp.asarray(B), tol=jnp.asarray(tol), M=jM, **kw)
    tres = tfn(pair[1], torch.from_numpy(B), tol=torch.as_tensor(tol), M=tM, **kw)
    return jres, tres


def _check(jres, tres, flags=("converged",), rtol=1e-10, atol=1e-12):
    (Xj, ij), (Xt, it) = jres, tres
    Xj = np.asarray(Xj)
    np.testing.assert_array_equal(it.iterations.numpy(), np.asarray(ij.iterations))
    for name in flags:
        np.testing.assert_array_equal(getattr(it, name).numpy(), np.asarray(getattr(ij, name)))
    hj, ht = np.asarray(ij.rnorm_history), it.rnorm_history.numpy()
    assert ht.shape == hj.shape and Xt.shape == Xj.shape
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    fin = np.isfinite(hj)
    bound = rtol * np.abs(hj) + atol * hj[:, :1]
    assert np.all(np.abs(ht - hj)[fin] <= bound[fin])
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0, atol=1e-10 * max(np.abs(Xj).max(), 1.0))


def _solo(solve, top, B, X, info, tols, atol, same_history=False, cycles=False, **kw):
    """Each lane of the port's batched solve against the port's solo solve."""
    tols = np.broadcast_to(tols, (B.shape[0],))
    for i in range(B.shape[0]):
        x_s, i_s = solve(top, torch.from_numpy(B[i]), tol=float(tols[i]), **kw)
        assert int(info.iterations[i]) == int(i_s.iterations), i
        assert bool(info.converged[i]) == bool(i_s.converged), i
        if cycles:
            assert int(info.cycles[i]) == int(i_s.cycles), i
        np.testing.assert_allclose(X[i].numpy(), x_s.numpy(), rtol=0, atol=atol)
        if same_history:
            k = int(i_s.iterations)
            np.testing.assert_allclose(info.rnorm_history[i, : k + 1].numpy(),
                                       i_s.rnorm_history[: k + 1].numpy(), rtol=1e-6,
                                       atol=1e-12)


BICG = (jcg.bicgstab_solve_batched, bicgstab_solve_batched)
GMRES = (jcg.gmres_solve_batched, gmres_solve_batched)
MINRES = (jcg.minres_solve_batched, minres_solve_batched)
BICG_CHECK = dict(flags=("converged", "breakdown"), rtol=1e-9, atol=1e-10)
GMRES_FLAGS = ("converged", "breakdown", "cycles")


class TestBicgstabBatched:
    def test_per_lane_matches_solo_exactly(self):
        ops = _ops()
        B = _rhs(ops.n, 4)
        jres, (X, info) = _both(*BICG, ops.dia, B, tol=1e-9, maxiter=4 * ops.n)
        _check(jres, (X, info), **BICG_CHECK)
        _solo(bicgstab_solve, ops.dia[1], B, X, info, 1e-9, 1e-11, same_history=True,
              maxiter=4 * ops.n)

    def test_bell_layout_and_padding(self):
        ops = _ops(12)
        B = _rhs(ops.n, 3, seed=1)
        jres, (X, info) = _both(*BICG, ops.bell, B, tol=1e-9, maxiter=4 * ops.n)
        _check(jres, (X, info), **BICG_CHECK)
        assert bool(info.converged.all())
        for i in range(3):
            r = torch.from_numpy(B[i]) - ops.csr[1].matvec(X[i])
            assert float(torch.linalg.norm(r)) <= 5e-9

    def test_per_lane_tol(self):
        ops = _ops(12)
        B = _rhs(ops.n, 3, seed=2)
        jres, (X, info) = _both(*BICG, ops.dia, B, tol=np.array([1e-4, 1e-7, 1e-10]),
                                maxiter=4 * ops.n)
        _check(jres, (X, info), **BICG_CHECK)
        its = info.iterations.numpy()
        assert bool(info.converged.all()) and its[0] <= its[1] <= its[2]
        assert float(info.rnorm[2]) <= 1e-10

    def test_jacobi_rides_lockstep(self):
        ops = _ops(12, peclet=6.0)
        B = _rhs(ops.n, 3, seed=3)
        M = (jcg.jacobi_preconditioner(ops.dia[0]), jacobi_preconditioner(ops.dia[1]))
        jres, (X, info) = _both(*BICG, ops.dia, B, tol=1e-9, maxiter=4 * ops.n, M=M)
        _check(jres, (X, info), **BICG_CHECK)
        assert bool(info.converged.all())
        _solo(bicgstab_solve, ops.dia[1], B, X, info, 1e-9, 1e-10, maxiter=4 * ops.n, M=M[1])

    def test_breakdown_lane_is_isolated(self):
        """A pure rotation: per-lane flags are the solo solve's, and the
        JAX package's, whichever they are on this adversarial operator."""
        rot = np.array([[0.0, -1.0], [1.0, 0.0]])
        A = np.kron(np.eye(4), rot)
        a = sp.csr_matrix(A)
        pair = (JDIA.from_csr(JCSR.from_scipy(a)),
                DIAMatrix.from_csr(CSRMatrix.from_scipy(a, device=CPU)))
        b0 = np.random.default_rng(4).standard_normal(8)
        B = np.stack([b0, 2.0 * b0])
        X, info = bicgstab_solve_batched(pair[1], torch.from_numpy(B), tol=1e-12, maxiter=64)
        for i in range(2):
            _, i_s = bicgstab_solve(pair[1], torch.from_numpy(B[i]), tol=1e-12, maxiter=64)
            assert bool(info.breakdown[i]) == bool(i_s.breakdown)
            assert bool(info.converged[i]) == bool(i_s.converged)

    def test_vmap_fallback_csr(self):
        ops = _ops(10)
        B = _rhs(ops.n, 2, seed=5)
        jres, (X, info) = _both(*BICG, ops.csr, B, tol=1e-9, maxiter=4 * ops.n)
        _check(jres, (X, info), **BICG_CHECK)
        assert bool(info.converged.all())
        for i in range(2):
            r = torch.from_numpy(B[i]) - ops.csr[1].matvec(X[i])
            assert float(torch.linalg.norm(r)) <= 5e-9

    def test_rejects_1d_b(self):
        ops = _ops(10)
        with pytest.raises(ValueError, match="nrhs"):
            bicgstab_solve_batched(ops.dia[1], torch.ones(ops.n, dtype=torch.float64))


class TestGmresBatched:
    def test_per_lane_matches_solo_exactly(self):
        ops = _ops()
        B = _rhs(ops.n, 4, seed=6)
        jres, (X, info) = _both(*GMRES, ops.dia, B, tol=1e-9, maxiter=4 * ops.n, restart=23)
        _check(jres, (X, info), GMRES_FLAGS)
        _solo(gmres_solve, ops.dia[1], B, X, info, 1e-9, 1e-10, same_history=True,
              cycles=True, maxiter=4 * ops.n, restart=23)

    def test_lanes_converge_at_different_counts(self):
        ops = _ops(12)
        B = _rhs(ops.n, 3, seed=7)
        tols = np.array([1e-3, 1e-6, 1e-10])
        jres, (X, info) = _both(*GMRES, ops.dia, B, tol=tols, maxiter=4 * ops.n, restart=19)
        _check(jres, (X, info), GMRES_FLAGS)
        its = info.iterations.numpy()
        assert bool(info.converged.all()) and its[0] <= its[1] <= its[2]
        _solo(gmres_solve, ops.dia[1], B, X, info, tols, 1e-10, maxiter=4 * ops.n,
              restart=19)

    def test_right_preconditioned(self):
        ops = _ops(12, peclet=6.0)
        B = _rhs(ops.n, 2, seed=8)
        M = (jcg.jacobi_preconditioner(ops.dia[0]), jacobi_preconditioner(ops.dia[1]))
        jres, (X, info) = _both(*GMRES, ops.dia, B, tol=1e-9, maxiter=4 * ops.n, restart=20,
                                M=M)
        _check(jres, (X, info), GMRES_FLAGS)
        assert bool(info.converged.all())
        _solo(gmres_solve, ops.dia[1], B, X, info, 1e-9, 1e-10, maxiter=4 * ops.n,
              restart=20, M=M[1])

    def test_flexible_nonlinear_m(self):
        ops = _ops(10, peclet=8.0)
        B = _rhs(ops.n, 2, seed=9)
        M = (lambda v: v / (1.0 + 0.2 * jnp.abs(v)), lambda v: v / (1.0 + 0.2 * torch.abs(v)))
        jres, (X, info) = _both(*GMRES, ops.dia, B, tol=1e-9, maxiter=4 * ops.n, restart=20,
                                M=M, flexible=True)
        _check(jres, (X, info), GMRES_FLAGS)
        assert bool(info.converged.all())
        _solo(gmres_solve, ops.dia[1], B, X, info, 1e-9, 1e-10, maxiter=4 * ops.n,
              restart=20, M=M[1], flexible=True)

    def test_vmap_fallback_csr(self):
        ops = _ops(10)
        B = _rhs(ops.n, 2, seed=10)
        jres, (X, info) = _both(*GMRES, ops.csr, B, tol=1e-9, maxiter=4 * ops.n, restart=15)
        _check(jres, (X, info), GMRES_FLAGS)
        assert bool(info.converged.all())
        for i in range(2):
            r = torch.from_numpy(B[i]) - ops.csr[1].matvec(X[i])
            assert float(torch.linalg.norm(r)) <= 5e-9

    def test_maxiter_cap_mid_cycle(self):
        ops = _ops(10)
        B = _rhs(ops.n, 2, seed=11)
        jres, (X, info) = _both(*GMRES, ops.dia, B, tol=0.0, maxiter=13, restart=5)
        _check(jres, (X, info), GMRES_FLAGS)
        assert list(info.iterations.numpy()) == [13, 13] and not bool(info.converged.any())


class TestMinresBatched:
    def test_per_lane_matches_solo_exactly(self):
        ops = _sym_ops()
        B = _rhs(ops.n, 4, seed=12)
        jres, (X, info) = _both(*MINRES, ops.dia, B, tol=1e-9, maxiter=4 * ops.n)
        _check(jres, (X, info))
        _solo(minres_solve, ops.dia[1], B, X, info, 1e-9, 1e-10, same_history=True,
              maxiter=4 * ops.n, fused="never")

    def test_shift_indefinite_lanes(self):
        ops = _sym_ops(160, 4, seed=3)
        B = _rhs(ops.n, 3, seed=13)
        jres, (X, info) = _both(*MINRES, ops.dia, B, tol=1e-8, maxiter=6 * ops.n, shift=1.2)
        (Xj, ij) = jres
        # a knife-edge tolerance crossing may flip by one step between the
        # two sum orders (the JAX test's own allowance against its solo solve)
        assert np.all(np.abs(info.iterations.numpy() - np.asarray(ij.iterations)) <= 1)
        np.testing.assert_array_equal(info.converged.numpy(), np.asarray(ij.converged))
        np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)
        for i in range(3):
            x_s, i_s = minres_solve(ops.dia[1], torch.from_numpy(B[i]), tol=1e-8,
                                    maxiter=6 * ops.n, shift=1.2, fused="never")
            assert abs(int(info.iterations[i]) - int(i_s.iterations)) <= 1
            assert bool(info.converged[i]) == bool(i_s.converged)
            np.testing.assert_allclose(X[i].numpy(), x_s.numpy(), rtol=0, atol=1e-7)

    def test_per_lane_tol_and_jacobi(self):
        ops = _sym_ops(140, 4, seed=5)
        B = _rhs(ops.n, 3, seed=14)
        M = (jcg.jacobi_preconditioner(ops.dia[0]), jacobi_preconditioner(ops.dia[1]))
        jres, (X, info) = _both(*MINRES, ops.dia, B, tol=np.array([1e-4, 1e-7, 1e-10]),
                                maxiter=6 * ops.n, M=M)
        _check(jres, (X, info))
        its = info.iterations.numpy()
        assert bool(info.converged.all()) and its[0] <= its[1] <= its[2]

    def test_vmap_fallback_csr(self):
        ops = _sym_ops(120, 3, seed=6)
        B = _rhs(ops.n, 2, seed=15)
        jres, (X, info) = _both(*MINRES, ops.csr, B, tol=1e-9, maxiter=4 * ops.n)
        _check(jres, (X, info))
        assert bool(info.converged.all())
        for i in range(2):
            r = torch.from_numpy(B[i]) - ops.csr[1].matvec(X[i])
            assert float(torch.linalg.norm(r)) <= 5e-9


def test_gmres_batched_done_lane_history_stays_nan():
    """A lane that ends early gets no history entry from later cycles'
    true-residual writes (row maxiter stays NaN, as in its solo solve)."""
    ops = _ops(10)
    B = _rhs(ops.n, 2, seed=20)
    maxiter = 3 * ops.n
    jres, (X, info) = _both(*GMRES, ops.dia, B, tol=np.array([1e-1, 1e-10]), maxiter=maxiter,
                            restart=7)
    _check(jres, (X, info), GMRES_FLAGS)
    assert bool(info.converged.all())
    h0 = info.rnorm_history[0].numpy()
    k0 = int(info.iterations[0])
    assert np.isnan(h0[maxiter]) and np.all(np.isnan(h0[k0 + 1:]))
