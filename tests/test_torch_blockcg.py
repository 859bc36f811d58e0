"""The port's block CG (``solver/blockcg.py``) against the JAX package's, on
the same numpy inputs (CPU), mirroring ``tests/test_blockcg.py``.

Tolerances, with their reasons: in float64 both packages take the same
block iterations (per-lane ``iterations`` and ``converged`` equal); the
R x R eigendecompositions (LAPACK in both, another order of products
around them) put the histories 1e-8 relative apart outside the converged
tail (entries above 1e-14·ρ₀) and X 1e-9 of max|X|.  Float32 solves are
held to the JAX tests' own bounds on the true residual.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (BlockedEllMatrix, CSRMatrix, SellMatrix,
                                         block_cg_solve, cg_solve, cg_solve_batched,
                                         jacobi_preconditioner)
from conjugategradient_tpu_torch.problems import poisson2d_coo
from conjugategradient_tpu_torch.solver.blockcg import default_gram_rcond

CPU = "cpu"
TOL = 1e-8
HIST_FLOOR = 1e-14


def _csr(nx, dtype=np.float64):
    r, c, v, shape = poisson2d_coo(nx)
    a = sp.coo_matrix((np.asarray(v, dtype), (r, c)), shape=shape).tocsr()
    return JCSR.from_scipy(a, dtype=dtype), CSRMatrix.from_scipy(a, dtype=dtype, device=CPU)


@pytest.fixture(scope="module")
def system():
    jA, tA = _csr(30)
    B = np.random.default_rng(7).standard_normal((4, tA.shape[0]))
    return jA, tA, B


def _true_residuals(A, B, X):
    return np.array([float(torch.linalg.norm(torch.as_tensor(B[i]) - A.matvec(X[i])))
                     for i in range(B.shape[0])])


def _check(jres, tres):
    (Xj, ij), (Xt, it) = jres, tres
    Xj = np.asarray(Xj)
    np.testing.assert_array_equal(it.iterations.numpy(), np.asarray(ij.iterations))
    np.testing.assert_array_equal(it.converged.numpy(), np.asarray(ij.converged))
    hj, ht = np.asarray(ij.rho_history), it.rho_history.numpy()
    assert ht.shape == hj.shape
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    keep = np.isfinite(hj) & (hj > HIST_FLOOR * hj[:, :1])
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-8)
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0, atol=1e-9 * np.abs(Xj).max())


def _both(jA, tA, B, **kw):
    jM, tM = kw.pop("M", (None, None))
    tol = kw.pop("tol")
    jres = jcg.block_cg_solve(jA, jnp.asarray(B), tol=jnp.asarray(tol), M=jM, **kw)
    tres = block_cg_solve(tA, torch.from_numpy(B), tol=torch.as_tensor(tol), M=tM, **kw)
    return jres, tres


class TestBlockCG:
    def test_all_lanes_converge(self, system):
        jA, tA, B = system
        jres, (X, info) = _both(jA, tA, B, tol=TOL)
        _check(jres, (X, info))
        assert bool(info.converged.all())
        assert np.all(_true_residuals(tA, B, X) < 10 * TOL)

    def test_fewer_iterations_than_lockstep(self, system):
        _, tA, B = system
        _, ib = block_cg_solve(tA, torch.from_numpy(B), tol=TOL)
        _, il = cg_solve_batched(tA, torch.from_numpy(B), tol=TOL)
        kb, kl = ib.iterations.numpy(), il.iterations.numpy()
        assert np.all(kb < kl) and kb.max() < 0.85 * kl.max()

    def test_r1_degenerates_to_solo_cg(self, system):
        jA, tA, B = system
        jres, (X1, i1) = _both(jA, tA, B[:1], tol=TOL)
        _check(jres, (X1, i1))
        xs, is_ = cg_solve(tA, torch.from_numpy(B[0]), tol=TOL)
        k = int(is_.iterations)
        assert int(i1.iterations[0]) == k
        np.testing.assert_allclose(X1[0].numpy(), xs.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(i1.rho_history[0, : k + 1].numpy(),
                                   is_.rho_history[: k + 1].numpy(), rtol=1e-8)

    def test_rank_deficient_lanes(self, system):
        jA, tA, B = system
        Bdup = np.stack([B[0], B[0], B[1]])
        jres, (X, info) = _both(jA, tA, Bdup, tol=TOL)
        _check(jres, (X, info))
        assert bool(info.converged.all())
        assert np.all(_true_residuals(tA, Bdup, X) < 10 * TOL)
        np.testing.assert_allclose(X[0].numpy(), X[1].numpy(), rtol=0, atol=1e-10)

    def test_jacobi_preconditioned(self, system):
        jA, tA, B = system
        M = (jcg.jacobi_preconditioner(jA), jacobi_preconditioner(tA))
        jres, (X, info) = _both(jA, tA, B, tol=TOL, M=M)
        _check(jres, (X, info))
        assert bool(info.converged.all())
        assert np.all(_true_residuals(tA, B, X) < 10 * TOL)

    def test_per_lane_tol(self, system):
        jA, tA, B = system
        tols = np.array([TOL, 1e-2, TOL, 1e-2])
        jres, (X, info) = _both(jA, tA, B, tol=tols)
        _check(jres, (X, info))
        k = info.iterations.numpy()
        assert bool(info.converged.all()) and k[1] < k[0] and k[3] < k[2]

    def test_maxiter_cap_reports_unconverged(self, system):
        jA, tA, B = system
        jres, (X, info) = _both(jA, tA, B, tol=1e-14, maxiter=5)
        _check(jres, (X, info))
        assert np.all(info.iterations.numpy() == 5) and not bool(info.converged.any())

    def test_callable_operator(self, system):
        jA, tA, B = system
        X_csr, _ = block_cg_solve(tA, torch.from_numpy(B), tol=TOL)
        jres = jcg.block_cg_solve(jA.matvec, jnp.asarray(B), tol=TOL, n=jA.shape[0])
        X_mf, info = block_cg_solve(tA.matvec, torch.from_numpy(B), tol=TOL, n=tA.shape[0])
        _check(jres, (X_mf, info))
        assert bool(info.converged.all())
        np.testing.assert_allclose(X_mf.numpy(), X_csr.numpy(), rtol=0, atol=1e-9)

    def test_layout_fast_paths_agree(self, system):
        """SELL and blocked-ELL ride the multi-RHS SpMV; their solutions
        agree with the CSR path's, and each with the JAX package's."""
        jA, tA, B = system
        X_csr, _ = block_cg_solve(tA, torch.from_numpy(B), tol=TOL)
        for name, jl, tl in (
            ("sell", jcg.SellMatrix.from_csr(jA), SellMatrix.from_csr(tA)),
            ("bell", jcg.BlockedEllMatrix.from_csr(jA, bm=8, bn=8),
             BlockedEllMatrix.from_csr(tA, bm=8, bn=8)),
        ):
            jres, (Xl, il) = _both(jl, tl, B, tol=TOL)
            _check(jres, (Xl, il))
            assert bool(il.converged.all()), name
            np.testing.assert_allclose(Xl.numpy(), X_csr.numpy(), rtol=0, atol=1e-8,
                                       err_msg=name)

    def test_f32_default_rcond_converges(self):
        """The dtype-adaptive rcond (1e-4 in float32) converges where a
        cutoff at the float32 Gram noise diverged in the JAX package."""
        _, tA = _csr(34, np.float32)
        n = tA.shape[0]
        assert default_gram_rcond(torch.float32) == 1e-4
        assert default_gram_rcond(torch.float64) == 1e-10
        b = torch.arange(1, n + 1, dtype=torch.float32)
        B = torch.stack([torch.roll(b, j) for j in range(4)])
        tol = 1e-6 * float(torch.linalg.norm(b))
        X, info = block_cg_solve(tA, B, tol=tol, maxiter=2000)
        assert bool(info.converged.all())
        assert _true_residuals(tA, B.numpy(), X).max() < 2.0

    def test_f32_restart_tightens_true_residual(self):
        _, tA = _csr(34, np.float32)
        n = tA.shape[0]
        b = torch.arange(1, n + 1, dtype=torch.float32)
        B = torch.stack([torch.roll(b, j) for j in range(4)])
        tol = 1e-6 * float(torch.linalg.norm(b))
        X0_, _ = block_cg_solve(tA, B, tol=tol, maxiter=2000)
        Xr, ir = block_cg_solve(tA, B, tol=tol, maxiter=2000, recompute_r_every=50)
        assert bool(ir.converged.all())
        assert (_true_residuals(tA, B.numpy(), Xr).max()
                < 0.75 * _true_residuals(tA, B.numpy(), X0_).max())

    def test_numpy_oracle_parity(self, system):
        """Iteration for iteration against an independent NumPy float64
        replica of the recurrences (the JAX test's oracle)."""
        jA, tA, B = system
        rcond = 1e-10
        X, info = block_cg_solve(tA, torch.from_numpy(B), tol=TOL, rcond=rcond)
        An = sp.csr_matrix((np.asarray(jA.data), np.asarray(jA.indices), np.asarray(jA.indptr)),
                           shape=jA.shape)
        Bt = B.T.copy()
        n, R = Bt.shape

        def pinv_apply(W, Y):
            W = 0.5 * (W + W.T)
            w, V = np.linalg.eigh(W)
            keep = w > rcond * max(np.abs(w).max(), np.finfo(np.float64).tiny)
            inv = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0)
            return V @ (inv[:, None] * (V.T @ Y))

        Rv, P = Bt.copy(), Bt.copy()
        rho = Rv.T @ Rv
        hist = [np.sum(Rv * Rv, axis=0)]
        done = np.zeros(R, bool)
        iters = np.zeros(R, int)
        for _ in range(n + 1):
            if done.all():
                break
            done_new = np.sqrt(np.sum(Rv * Rv, axis=0)) <= TOL
            Q = An @ P
            alpha = pinv_apply(P.T @ Q, rho)
            Rv = Rv - Q @ alpha
            rho_next = Rv.T @ Rv
            P = Rv + P @ pinv_apply(rho, rho_next)
            rho = rho_next
            iters += ~done
            hist.append(np.sum(Rv * Rv, axis=0))
            done = np.where(~done, done_new, done)
        np.testing.assert_array_equal(info.iterations.numpy(), iters)
        want = np.stack(hist).T
        for j in range(R):
            kj = iters[j]
            np.testing.assert_allclose(info.rho_history[j, : kj + 1].numpy(),
                                       want[j][: kj + 1], rtol=1e-6, err_msg=f"lane {j}")
