"""``fsai_preconditioner`` (solver/fsai.py) against the JAX package's on the
same numpy inputs (CPU), the cases of tests/test_fsai.py.

Tolerances:
* the host factor G bitwise equal to the JAX one (scipy CSR arrays), and
  its pattern (``_lower_pattern``) and batched row solves too;
* each device layout chosen as the JAX package chooses it;
* the float64 apply to 1e-12 of max|z| against the JAX apply and against
  Gᵀ(G r) on the host;
* float64 FSAI-PCG: equal iteration counts, rho_history to 1e-10 relative
  above 1e-16 of ‖r₀‖²; float32 counts within 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.solver import fsai as jfsai
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch.problems import (poisson2d_coo, powerlaw_spd_coo,
                                                  random_spd_dense)
from conjugategradient_tpu_torch.solver import (cg_solve, fsai_preconditioner,
                                                jacobi_preconditioner, minres_solve)
from conjugategradient_tpu_torch.solver import fsai as tfsai
from conjugategradient_tpu_torch.solver.amg import _to_scipy_csr
from conjugategradient_tpu_torch.types import (BlockedEllMatrix, CSRMatrix, DIAMatrix,
                                               SellMatrix)

CPU = "cpu"


def _pair(coo, dtype=np.float64):
    rows, cols, vals, shape = coo
    return (JCSR.from_coo(rows, cols, vals, shape, dtype=dtype),
            CSRMatrix.from_coo(rows, cols, vals, shape, dtype=dtype, device=CPU))


def _csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _assert_pcg(it, ij):
    assert bool(it.converged) and bool(ij.converged)
    k = int(ij.iterations)
    assert int(it.iterations) == k
    hj = np.asarray(ij.rho_history)[: k + 1]
    ht = it.rho_history[: k + 1].numpy()
    sel = hj > 1e-16 * hj[0]
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=1e-10)


CASES = {
    "poisson2d_14": lambda: _pair(poisson2d_coo(14)),
    "powerlaw_600": lambda: _pair(powerlaw_spd_coo(600, seed=5)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("power", [1, 2, 3])
def test_host_factor_is_bitwise_the_jax_one(case, power):
    ja, ta = CASES[case]()
    Mj = jcg.fsai_preconditioner(ja, power=power, dtype=np.float64)
    Mt = fsai_preconditioner(ta, power=power, dtype=np.float64)
    _csr_equal(Mt.G_host, Mj.G_host)
    assert Mt.nnz == Mj.nnz and Mt.power == Mj.power == power
    A_sp = _to_scipy_csr(ta)
    for t, j in zip(tfsai._lower_pattern(A_sp, power), jfsai._lower_pattern(A_sp, power)):
        np.testing.assert_array_equal(t, j)
    # the layouts chosen for G and its transpose
    assert type(Mt.G).__name__ == type(Mj.G).__name__
    assert type(Mt.Gt).__name__ == type(Mj.Gt).__name__


def test_row_solves_and_gather_are_the_jax_ones():
    rng = np.random.default_rng(0)
    A = random_spd_dense(12, seed=3)
    A_sp = sp.csr_matrix(A)
    keys = (np.repeat(np.arange(12), np.diff(A_sp.indptr)) * 12 + A_sp.indices).astype(np.int64)
    cols = np.sort(rng.choice(12, size=(5, 4), replace=True), axis=1)
    np.testing.assert_array_equal(tfsai._gather_submatrices(keys, A_sp.data, 12, cols),
                                  jfsai._gather_submatrices(keys, A_sp.data, 12, cols))
    sub = np.stack([A[np.ix_(c, c)] + 1e-3 * np.eye(4) for c in
                    [np.arange(4), np.arange(4, 8), np.arange(8, 12)]])
    diag = np.diag(A)[[3, 7, 11]]
    np.testing.assert_array_equal(tfsai._solve_rows(sub, diag), jfsai._solve_rows(sub, diag))


def test_full_pattern_is_the_exact_inverse_factor():
    n = 24
    A = random_spd_dense(n, seed=1)
    apply = fsai_preconditioner(A, dtype=np.float64, device=CPU)
    G = apply.G_host.toarray()
    L = np.linalg.cholesky(A)
    np.testing.assert_allclose(G @ L, np.eye(n), atol=1e-10)
    np.testing.assert_allclose(G.T @ G, np.linalg.inv(A), rtol=1e-8, atol=1e-10)


def test_gagt_unit_diagonal_and_spd():
    ja, ta = _pair(poisson2d_coo(14))
    apply = fsai_preconditioner(ta, dtype=np.float64)
    G = apply.G_host.toarray()
    Ad = ta.to_dense().numpy()
    np.testing.assert_allclose(np.diag(G @ Ad @ G.T), np.ones(ta.shape[0]), atol=1e-12)
    assert np.all(np.diag(G) > 0) and np.linalg.eigvalsh(G.T @ G).min() > 0


@pytest.mark.parametrize("layout", ["auto", "csr", "dia", "bell", "sell"])
def test_device_apply_matches_jax_and_host(layout):
    ja, ta = _pair(poisson2d_coo(10))
    Mj = jcg.fsai_preconditioner(ja, layout=layout, dtype=np.float64)
    Mt = fsai_preconditioner(ta, layout=layout, dtype=np.float64)
    want = {"auto": DIAMatrix, "csr": CSRMatrix, "dia": DIAMatrix, "bell": BlockedEllMatrix,
            "sell": SellMatrix}[layout]
    assert isinstance(Mt.G, want) and isinstance(Mt.Gt, want)
    r = np.random.default_rng(0).standard_normal(ta.shape[0])
    zt = Mt(torch.from_numpy(r)).numpy()
    zj = np.asarray(Mj(jnp.asarray(r)))
    z_host = Mt.G_host.T @ (Mt.G_host @ r)
    for want_z in (zj, z_host):
        np.testing.assert_allclose(zt, want_z, rtol=0, atol=1e-12 * np.abs(want_z).max())


@pytest.mark.parametrize("power", [1, 2])
def test_fsai_pcg_matches_jax_and_beats_jacobi(power):
    ja, ta = _pair(poisson2d_coo(24))
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(ta.shape[0])
    b = ta.to_dense().numpy() @ x_true
    Mj = jcg.fsai_preconditioner(ja, power=power, dtype=np.float64)
    Mt = fsai_preconditioner(ta, power=power, dtype=np.float64)
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=1e-10, M=Mj, maxiter=5000)
    x, it = cg_solve(ta, torch.from_numpy(b), tol=1e-10, M=Mt, maxiter=5000)
    _assert_pcg(it, ij)
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-7, atol=1e-8)
    _, jac = cg_solve(ta, torch.from_numpy(b), tol=1e-10, M=jacobi_preconditioner(ta),
                      maxiter=5000)
    assert int(it.iterations) < int(jac.iterations)


def test_power2_at_least_as_strong_and_minres():
    ja, ta = _pair(poisson2d_coo(20))
    b = torch.arange(1, ta.shape[0] + 1, dtype=torch.float64)
    its = []
    for p in (1, 2):
        _, info = cg_solve(ta, b, tol=1e-10, M=fsai_preconditioner(ta, power=p), maxiter=5000)
        its.append(int(info.iterations))
    assert its[1] <= its[0]
    # the SPD M also serves MINRES, as in the JAX package
    Mj = jcg.fsai_preconditioner(ja, dtype=np.float64)
    _, ij = jcg.minres_solve(ja, jnp.asarray(b.numpy()), tol=1e-8, M=Mj)
    _, it = minres_solve(ta, b, tol=1e-8, M=fsai_preconditioner(ta))
    assert bool(it.converged) and int(it.iterations) == int(ij.iterations)


def test_powerlaw_scattered_pattern():
    ja, ta = _pair(powerlaw_spd_coo(600, seed=5))
    rng = np.random.default_rng(7)
    x_true = rng.standard_normal(ta.shape[0])
    b = ta.to_dense().numpy() @ x_true
    Mj = jcg.fsai_preconditioner(ja, dtype=np.float64)
    Mt = fsai_preconditioner(ta, dtype=np.float64)
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=1e-8, M=Mj, maxiter=5000)
    x, it = cg_solve(ta, torch.from_numpy(b), tol=1e-8, M=Mt, maxiter=5000)
    _assert_pcg(it, ij)
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-5, atol=1e-6)


def test_float32_counts():
    ja, ta = _pair(poisson2d_coo(24), np.float32)
    b = np.arange(1, ta.shape[0] + 1, dtype=np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    _, ij = jcg.cg_solve(ja, jnp.asarray(b), tol=tol, M=jcg.fsai_preconditioner(ja))
    Mt = fsai_preconditioner(ta)
    assert Mt.G.dtype == torch.float32
    _, it = cg_solve(ta, torch.from_numpy(b), tol=tol, M=Mt)
    assert bool(it.converged) and abs(int(it.iterations) - int(ij.iterations)) <= 2


def test_scipy_and_dense_ingest():
    n = 16
    A = random_spd_dense(n, seed=2)
    for A_in in (A, sp.csr_matrix(A)):
        apply = fsai_preconditioner(A_in, dtype=np.float64, device=CPU)
        assert apply.nnz == n * (n + 1) // 2
        assert apply.G.dtype == torch.float64 and apply.G.device.type == "cpu"


def _errors(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


def test_rejects_bad_inputs_like_jax():
    bad = np.eye(4)
    bad[2, 2] = -1.0
    for args, kw in [((np.eye(4),), {"power": 0}),
                     ((sp.csr_matrix(np.ones((3, 4))),), {}),
                     ((bad,), {}),
                     ((np.eye(4),), {"layout": "symbell"})]:
        assert _errors(lambda: fsai_preconditioner(*args, device=CPU, **kw)) == \
            _errors(lambda: jcg.fsai_preconditioner(*args, **kw))


def test_indefinite_submatrix_falls_back_to_jacobi_row():
    A = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    apply = fsai_preconditioner(A, dtype=np.float64, device=CPU)
    G = apply.G_host.toarray()
    assert np.all(np.isfinite(G)) and np.all(np.diag(G) > 0)
    _csr_equal(apply.G_host, jcg.fsai_preconditioner(A, dtype=np.float64).G_host)
