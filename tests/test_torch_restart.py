"""Residual replacement (``recompute_r_every``) in the port against the JAX
package (CPU), on the portable loop and on the fused solves of both
blocked-ELL storages, and the loop driver's host-read cadence.

Tolerances, with their reasons:

* float64 portable solves (CSR): equal iteration counts and
  ``rho_history`` to rtol 1e-9, with an absolute floor of 1e-16·ρ₀ for the
  converged tail — both packages run the same algorithm in f64, and only
  the order of a few sums differs;
* float32 fused solves (plain kernel versions) against the JAX fused solves
  in interpret mode: ``rho_history`` to rtol 2e-3 over 32 steps, as
  tests/test_fused.py holds the JAX fused restart against its unfused one
  (f32 sums in another order; the replaced slots included);
* chunked against per-step host checks: bitwise (the same operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import SymBellMatrix as JSym
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import (
    cg_solve,
    fused_bell_cg_solve,
    fused_bell_pcg_solve,
    jacobi_preconditioner,
    restart,
)
from conjugategradient_tpu_torch.types import CSRMatrix


def _port_bell(jb):
    return convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols),
                                    jb.shape, jb.nnz)


def _port_sym(js):
    return convert.sym_bell_from_arrays(
        np.asarray(js.diag_blocks), np.asarray(js.off_blocks), np.asarray(js.off_cols),
        js.shape, js.nnz, js.full_kmax, js.banded)


@pytest.fixture(scope="module")
def poisson32():
    """tests/test_fused.py's restart operator: 2-D Poisson 32 x 32 as 128 x
    128 tiles (nrb = 8), b = (i + 1) / n."""
    rows, cols, vals, shape = poisson2d_coo(32)
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                        bm=128, bn=128)
    js = JSym.from_bell(jb)
    n = shape[0]
    b = (reference_rhs(n).astype(np.float32) / n).astype(np.float32)
    return {"full": (jb, _port_bell(jb)), "sym": (js, _port_sym(js))}, b


# ---- float64 portable loop ---------------------------------------------------

@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("every", [8, 13])
def test_f64_portable_restart_matches_jax(every, precond):
    rows, cols, vals, shape = banded_spd_coo(300, bandwidth=5, seed=5)
    jA = JCSR.from_coo(rows, cols, vals, shape)
    tA = CSRMatrix.from_coo(rows, cols, vals, shape)
    b = reference_rhs(shape[0])
    jM = jcg.jacobi_preconditioner(jA) if precond == "jacobi" else None
    tM = jacobi_preconditioner(tA) if precond == "jacobi" else None
    xj, ij = jcg.cg_solve(jA, jnp.asarray(b), tol=1e-8, M=jM, fused="never",
                          recompute_r_every=every)
    xt, it = cg_solve(tA, torch.from_numpy(b), tol=1e-8, M=tM, recompute_r_every=every)
    k = int(ij.iterations)
    assert bool(ij.converged) and bool(it.converged)
    assert int(it.iterations) == k > every
    h0 = float(ij.rho_history[0])
    np.testing.assert_allclose(it.rho_history.numpy()[: k + 1],
                               np.asarray(ij.rho_history)[: k + 1], rtol=1e-9, atol=1e-16 * h0)
    assert np.isnan(it.rho_history.numpy()[k + 1:]).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)


def test_restart_changes_the_trajectory():
    """A restart does something: with every = 8 the history leaves the
    no-restart one after step 8, and equals it up to there."""
    rows, cols, vals, shape = poisson2d_coo(12)
    A = CSRMatrix.from_coo(rows, cols, vals, shape)
    b = torch.from_numpy(reference_rhs(shape[0]))
    _, i0 = cg_solve(A, b, tol=0.0, maxiter=20)
    _, i8 = cg_solve(A, b, tol=0.0, maxiter=20, recompute_r_every=8)
    h0, h8 = i0.rho_history.numpy(), i8.rho_history.numpy()
    assert np.array_equal(h0[:8], h8[:8])
    np.testing.assert_allclose(h8[8], h0[8], rtol=1e-6)  # true vs recurrence ‖r‖²
    assert not np.allclose(h8[9:], h0[9:], rtol=1e-3)


# ---- float32 fused solves (plain kernel versions) against JAX interpret -------

@pytest.mark.parametrize("every", [8, 13])
@pytest.mark.parametrize("storage", ["full", "sym"])
def test_fused_restart_matches_jax(poisson32, storage, every):
    ops, b = poisson32
    jop, top = ops[storage]
    _, ij = jfused.fused_bell_cg_solve(jop, jnp.asarray(b), tol=0.0, maxiter=32,
                                       interpret=True, recompute_r_every=every)
    _, it = fused_bell_cg_solve(top, torch.from_numpy(b), tol=0.0, maxiter=32,
                                recompute_r_every=every)
    assert int(it.iterations) == int(ij.iterations) == 32
    np.testing.assert_allclose(it.rho_history.double().numpy()[:33],
                               np.asarray(ij.rho_history, np.float64)[:33], rtol=2e-3)


def test_fused_pcg_restart_matches_jax(poisson32):
    ops, b = poisson32
    jop, top = ops["full"]
    inv_d = (1.0 / np.asarray(jop.diagonal())).astype(np.float32)
    _, ij = jfused.fused_bell_pcg_solve(jop, jnp.asarray(b), jnp.asarray(inv_d), tol=0.0,
                                        maxiter=32, interpret=True, recompute_r_every=8)
    _, it = fused_bell_pcg_solve(top, torch.from_numpy(b), torch.from_numpy(inv_d),
                                 tol=0.0, maxiter=32, recompute_r_every=8)
    np.testing.assert_allclose(it.rho_history.double().numpy()[:33],
                               np.asarray(ij.rho_history, np.float64)[:33], rtol=2e-3)


@pytest.mark.parametrize("path", ["full", "sym", "portable"])
def test_restart_boundary_replaces_history_slot(path):
    """At a boundary the history slot holds the TRUE ‖b − A·x_k‖², and the
    steps before it are untouched (tests/test_fused.py's case)."""
    rows, cols, vals, shape = poisson2d_coo(24)
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                        bm=128, bn=128)
    op = _port_bell(jb) if path != "sym" else _port_sym(JSym.from_bell(jb))
    b = torch.from_numpy(reference_rhs(shape[0]).astype(np.float32))

    def solve(maxiter, every):
        if path == "portable":
            return cg_solve(op, b, tol=0.0, maxiter=maxiter, fused="never",
                            recompute_r_every=every)
        return fused_bell_cg_solve(op, b, tol=0.0, maxiter=maxiter, recompute_r_every=every)

    _, info = solve(16, 8)
    h = info.rho_history.numpy()
    assert np.isfinite(h[8]) and np.isfinite(h[16])
    _, plain = solve(16, 0)
    assert np.array_equal(h[:8], plain.rho_history.numpy()[:8])
    x8, i8 = solve(8, 8)
    r = b - op.matvec(x8)
    np.testing.assert_allclose(float(i8.rho_history[8]), float(torch.sum(r * r)), rtol=1e-5)
    assert float(i8.rho_history[8]) == float(h[8])


# ---- the loop driver -----------------------------------------------------------

def test_run_chunked_cadence():
    """Steps, restarts and host reads of a 70-step run with every = 8: the
    restarts add no host read."""
    calls = {"step": 0, "replace": [], "live": []}

    def step():
        calls["step"] += 1

    restart.run_chunked(step, lambda: calls["live"].append(calls["step"]) or True, 70,
                        every=8, replace=lambda: calls["replace"].append(calls["step"]))
    assert calls["step"] == 70
    assert calls["replace"] == [8, 16, 24, 32, 40, 48, 56, 64]
    assert calls["live"] == [32, 64]
    calls = {"step": 0, "live": 0}
    restart.run_chunked(step, lambda: False, 100)
    assert calls["step"] == restart.CHECK_EVERY
    with pytest.raises(ValueError, match="recompute_r_every"):
        restart.run_chunked(step, lambda: True, 10, every=-1)


@pytest.mark.parametrize("every", [8, 13, 40])
@pytest.mark.parametrize("path", ["fused", "portable"])
def test_chunked_host_checks_match_per_step(poisson32, monkeypatch, path, every):
    ops, b = poisson32
    _, top = ops["full"]
    tb = torch.from_numpy(b)

    def solve():
        if path == "fused":
            return fused_bell_cg_solve(top, tb, tol=1e-4, maxiter=500, recompute_r_every=every)
        return cg_solve(top, tb, tol=1e-4, maxiter=500, fused="never", recompute_r_every=every)

    x32, i32 = solve()
    monkeypatch.setattr(restart, "CHECK_EVERY", 1)
    x1, i1 = solve()
    k = int(i1.iterations)
    assert bool(i1.converged) and int(i32.iterations) == k > 40
    assert torch.equal(i32.rho_history.view(torch.int32), i1.rho_history.view(torch.int32))
    assert torch.equal(x32, x1)


def test_negative_every_raises():
    A = CSRMatrix.from_coo(*poisson2d_coo(4))
    with pytest.raises(ValueError, match="recompute_r_every"):
        cg_solve(A, torch.ones(16, dtype=torch.float64), recompute_r_every=-1)
