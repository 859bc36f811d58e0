"""The port's Lanczos eigensolver (``solver/eigs.py``) against the JAX
package's, on the same numpy inputs (CPU), mirroring ``tests/test_eigs.py``;
and ``expected_step_count``, whose private Lanczos became a call to the
shared one, pinned to the integers it gave before.

Tolerances: Ritz values to 1e-10 relative and residual bounds to 1e-8 of
the largest |θ| against the JAX package (the same float64 recurrence,
sums in another order; 1e-5 and 1e-3 for a float32 callable), Ritz
vectors to 1e-8 up to sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (CSRMatrix, EigsResult, condition_estimate,
                                         expected_step_count, lanczos_eigs)
from conjugategradient_tpu_torch.problems import poisson2d_coo
from conjugategradient_tpu_torch.types import DenseOperator

CPU = "cpu"


def _spd(seed, n=40, cond=100.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.geomspace(1.0, cond, n)
    return (Q * vals) @ Q.T, vals


def _check(rt, rj, rtol=1e-10):
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.values, rj.values, rtol=rtol)
    scale = np.abs(rj.values).max()
    np.testing.assert_allclose(rt.residuals, rj.residuals, rtol=0, atol=100 * rtol * scale)
    np.testing.assert_array_equal(rt.converged, rj.converged)


@pytest.mark.parametrize("which", ["smallest", "largest"])
@pytest.mark.parametrize("iters", [20, 40])
def test_values_and_residuals_match_jax(which, iters):
    A, vals = _spd(iters)
    rj = jcg.lanczos_eigs(jnp.asarray(A), k=3, which=which, iters=iters)
    rt = lanczos_eigs(torch.from_numpy(A), k=3, which=which, iters=iters)
    assert isinstance(rt, EigsResult)
    _check(rt, rj)
    vt, vj = rt.vectors.numpy(), np.asarray(rj.vectors)
    signs = np.sign(np.sum(vt * vj, axis=0))
    np.testing.assert_allclose(vt * signs, vj, rtol=0, atol=1e-8)
    if iters == 40:  # the whole space: exact pairs, against dense eigh
        ref = vals[:3] if which == "smallest" else vals[::-1][:3]
        np.testing.assert_allclose(rt.values, ref, rtol=1e-9)
        np.testing.assert_allclose(vt.T @ vt, np.eye(3), atol=1e-10)
        r = A @ vt - vt * rt.values
        np.testing.assert_allclose(np.linalg.norm(r, axis=0), rt.residuals, atol=1e-8)


def test_csr_and_callable_match_jax():
    rows, cols, vals, shape = poisson2d_coo(10)
    jA = JCSR.from_coo(rows, cols, vals, shape)
    tA = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    _check(lanczos_eigs(tA, k=2, which="largest", iters=60),
           jcg.lanczos_eigs(jA, k=2, which="largest", iters=60))
    # a callable is a float32 operator in both packages: f32 recurrences
    rt = lanczos_eigs(tA.matvec, n=shape[0], k=2, iters=30, device=CPU)
    rj = jcg.lanczos_eigs(jA.matvec, n=shape[0], k=2, iters=30)
    assert rt.vectors.dtype == torch.float32
    _check(rt, rj, rtol=1e-5)
    assert lanczos_eigs(tA, k=2, return_vectors=False).vectors is None


def test_invariant_subspace_truncates_like_jax():
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0, 5.0, 5.0])
    rj = jcg.lanczos_eigs(jnp.asarray(np.diag(d)), k=3, iters=8)
    rt = lanczos_eigs(torch.from_numpy(np.diag(d)), k=3, iters=8)
    _check(rt, rj)
    assert rt.iters <= 4 and rt.converged.all()
    np.testing.assert_allclose(rt.values, [1.0, 2.0, 5.0], rtol=1e-10)
    ri = lanczos_eigs(torch.eye(16, dtype=torch.float64), k=1, iters=10)
    assert ri.iters == 1 and np.allclose(ri.values, [1.0], rtol=1e-12)
    r32 = lanczos_eigs(torch.eye(16), k=1, iters=10)  # float32: breakdown below 1e-6
    assert r32.iters == 1 and r32.vectors.dtype == torch.float32


@pytest.mark.parametrize("iters", [15, 40])
def test_condition_estimate_matches_jax(iters):
    A, vals = _spd(3, n=40, cond=50.0)
    kt = condition_estimate(torch.from_numpy(A), iters=iters)
    kj = jcg.condition_estimate(jnp.asarray(A), iters=iters)
    assert kt == pytest.approx(kj, rel=1e-10)
    assert kt <= vals[-1] / vals[0] * (1 + 1e-9)
    if iters == 40:
        assert kt == pytest.approx(vals[-1] / vals[0], rel=1e-7)


def test_validation():
    eye = torch.eye(40, dtype=torch.float64)
    with pytest.raises(ValueError, match="SPD"):
        condition_estimate(torch.diag(torch.tensor([-1.0, 1.0, 2.0, 3.0], dtype=torch.float64)),
                           iters=4)
    with pytest.raises(ValueError, match="which"):
        lanczos_eigs(eye, which="interior")
    with pytest.raises(ValueError, match="k >= 1"):
        lanczos_eigs(eye, k=0)
    with pytest.raises(ValueError, match="k <= iters"):
        lanczos_eigs(eye, k=9, iters=5)
    with pytest.raises(ValueError):
        lanczos_eigs(eye, k=2, iters=0)
    with pytest.raises(ValueError, match="iters >= 1"):
        condition_estimate(eye, iters=0)


# expected_step_count's integers before its Lanczos became the shared one:
# (poisson2d nx, accuracy) -> steps, from the parent tree on these inputs
PINNED = {(10, 1e-3): 27, (10, 1e-6): 51, (10, 1e-8): 67, (20, 1e-3): 51, (20, 1e-6): 97,
          (20, 1e-8): 127, (6, 1e-3): 17, (6, 1e-6): 32, (6, 1e-8): 42}


@pytest.mark.parametrize("nx,eps", list(PINNED), ids=[f"nx{k[0]}-{k[1]:g}" for k in PINNED])
def test_expected_step_count_unchanged(nx, eps):
    rows, cols, vals, shape = poisson2d_coo(nx)
    tA = CSRMatrix.from_coo(rows, cols, vals, shape, device=CPU)
    assert expected_step_count(tA, eps) == PINNED[(nx, eps)]
    if eps == 1e-6:
        t32 = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32, device=CPU)
        assert expected_step_count(t32, eps) == PINNED[(nx, eps)]
        assert expected_step_count(tA.matvec, eps, n=shape[0], device=CPU) == PINNED[(nx, eps)]


def test_expected_step_count_at_a_breakdown():
    assert expected_step_count(DenseOperator(torch.eye(8, dtype=torch.float64)), 1e-6) == 1
    d = torch.diag(torch.arange(1.0, 6.0, dtype=torch.float64))
    assert expected_step_count(DenseOperator(d), 1e-6) == 16
    assert expected_step_count(DenseOperator(d.float()), 1e-6) == 16
