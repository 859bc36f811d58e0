"""The portable CG, BiCGStab and MINRES loops on bfloat16 operators and
vectors against the JAX package, on the CPU.

Each problem is loaded by both packages with ``dtype=bfloat16``, and b =
arange(1, n + 1) / n rounded to bf16 goes to both; ``tol`` is a multiple
of ‖b‖, well above bf16's floor (the tester's default 1e-24 is below it,
where counts are chaotic, and is not asserted).

The steps meet a float32 recurrence scalar with each bf16 vector in
float32 and round once after, as JAX promotes a bf16 array against a
float32 one.  Bounds, from measurement:

* CG: iteration counts equal and the first 6 history entries within 1e-5
  relative (measured 2e-6: the float32 dots sum in another order).  On
  poisson2d_110 at 1e-3·‖b‖ the count is held within 2% (measured 231
  against 229): the histories part by 0.6% from step 13, where one last
  bit of a float32 dot moves a bf16 rounding, and the JAX package itself
  takes 229 on CSR and 188 on DIA there.
* BiCGStab on convdiff_34: the first 6 history entries within 1e-5
  relative (measured 3e-7), and counts at most 1.25x the JAX ones
  (measured 85 / 104 against 78 / 87): the bf16 recurrence parts after
  the sixth step, as two JAX layouts part from each other.
* MINRES: XLA keeps y − c1·r1 in float32 under its default flags, and so
  does the port (solver/minres.py).  Counts within 1 step on poisson2d_110
  at 1e-2·‖b‖ (measured 161 / 160 CSR, 145 / 144 DIA), equal on
  poisson2d_34 as DIA at 1e-2 and 1e-3·‖b‖ (44, 67); the first
  20 estimates on poisson2d_110 within 1e-3 relative (measured agreement
  to 1e-3 for 26 steps).  Near bf16's floor of the recurrence the two
  part: the bound held is the port's estimate within 5x of the JAX one
  over 400 steps on poisson2d_110 as CSR (measured 3.9x at most).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu_torch import bicgstab_solve, cg_solve, minres_solve
from conjugategradient_tpu_torch.io import load_matrix

ROOT = pathlib.Path(__file__).resolve().parents[1] / "problems"
CPU = torch.device("cpu")


def _load(name, layout):
    """Both packages' bf16 operator, b in both and ‖b‖."""
    path = str(ROOT / name)
    jop = jcg.load_matrix(path, layout=layout, dtype=jnp.bfloat16)
    top = load_matrix(path, layout=layout, dtype=torch.bfloat16, device=CPU)
    n = jop.shape[0]
    b32 = (np.arange(1, n + 1) / n).astype(np.float32)
    bj = jnp.asarray(b32).astype(jnp.bfloat16)
    bt = torch.from_numpy(b32).to(torch.bfloat16)
    assert np.array_equal(np.asarray(bj.astype(jnp.float32)), bt.float().numpy())
    return jop, top, bj, bt, float(np.linalg.norm(np.asarray(bj, np.float32)))


def _solve(jfn, tfn, case, tol, maxiter=3000):
    jop, top, bj, bt, _ = case
    _, ij = jfn(jop, bj, tol=tol, maxiter=maxiter)
    _, it = tfn(top, bt, tol=tol, maxiter=maxiter)
    return ij, it


def _hist(info):
    h = info.rho_history if hasattr(info, "rho_history") else info.rnorm_history
    if isinstance(h, torch.Tensor):
        return h.double().numpy()
    return np.asarray(h, np.float64)


def _early(ij, it, steps, rtol):
    hj, ht = _hist(ij)[:steps], _hist(it)[:steps]
    np.testing.assert_allclose(ht, hj, rtol=rtol)


@pytest.mark.parametrize("layout", ["csr", "dia", "symdia", "bell"])
def test_cg_counts_match_jax_poisson2d_34(layout):
    case = _load("poisson2d_34.mtx", layout)
    for rel in (1e-2, 1e-3):
        ij, it = _solve(jcg.cg_solve, cg_solve, case, rel * case[4])
        assert int(it.iterations) == int(ij.iterations), (layout, rel)
        _early(ij, it, 6, 1e-5)


def test_cg_counts_match_jax_poisson2d_110():
    case = _load("poisson2d_110.mtx", "csr")
    ij, it = _solve(jcg.cg_solve, cg_solve, case, 1e-2 * case[4])
    assert int(it.iterations) == int(ij.iterations) == 161
    _early(ij, it, 6, 1e-5)
    ij, it = _solve(jcg.cg_solve, cg_solve, case, 1e-3 * case[4])
    assert abs(int(it.iterations) - int(ij.iterations)) <= 0.02 * int(ij.iterations)


def test_bicgstab_counts_and_early_history_convdiff_34():
    case = _load("convdiff_34.mtx", "csr")
    for rel in (1e-2, 1e-3):
        ij, it = _solve(jcg.bicgstab_solve, bicgstab_solve, case, rel * case[4])
        kj, kt = int(ij.iterations), int(it.iterations)
        assert bool(it.converged) and bool(ij.converged)
        assert kj <= kt <= 1.25 * kj, (rel, kj, kt)
        _early(ij, it, 6, 1e-5)


@pytest.mark.parametrize("layout", ["csr", "dia"])
def test_minres_counts_match_jax_poisson2d_110(layout):
    case = _load("poisson2d_110.mtx", layout)
    for rel in (1e-2,):
        ij, it = _solve(jcg.minres_solve, minres_solve, case, rel * case[4])
        assert bool(it.converged) and bool(ij.converged)
        assert abs(int(it.iterations) - int(ij.iterations)) <= 1, (rel, ij.iterations,
                                                                    it.iterations)
        _early(ij, it, 20, 1e-3)


def test_minres_counts_equal_jax_poisson2d_34_dia():
    case = _load("poisson2d_34.mtx", "dia")
    for rel in (1e-2, 1e-3):
        ij, it = _solve(jcg.minres_solve, minres_solve, case, rel * case[4])
        assert int(it.iterations) == int(ij.iterations), rel


def test_minres_estimates_track_jax_to_the_floor_poisson2d_110():
    """The known difference near bf16's floor, held as a bound: the first
    20 estimates within 1e-3 relative, and every estimate of a 400-step
    run at tol 0 within 5x of the JAX one (the JAX estimate floors near
    8.7e-4·‖b‖ there, the port's near 3.2e-3·‖b‖)."""
    case = _load("poisson2d_110.mtx", "csr")
    ij, it = _solve(jcg.minres_solve, minres_solve, case, 0.0, maxiter=400)
    hj, ht = _hist(ij), _hist(it)
    np.testing.assert_allclose(ht[:20], hj[:20], rtol=1e-3)
    ratio = ht / hj
    assert np.all((ratio < 5.0) & (ratio > 0.2)), float(np.max(np.maximum(ratio, 1 / ratio)))


def test_tester_bf16_rhs_is_the_jax_testers(capsys):
    """The tester's b in bf16 is jnp.arange(1, n + 1, dtype=bfloat16)'s, in
    which 258 rounds to 256 (i rounded, then 1 added): the first history
    entry ‖b‖ agrees to float32's rounding, and CG and MINRES at
    tol = 200 (9e-3·‖b‖) take the JAX tester's counts."""
    import json

    import tester as jtester
    from conjugategradient_tpu_torch import tester

    for method in ("standard", "minres"):
        args = [str(ROOT / "poisson2d_34.mtx"), "--layout", "csr", "--dtype", "bfloat16",
                "--method", method, "--tol", "200", "--history"]
        assert jtester.main(args) == 0
        jout = capsys.readouterr().out.strip().splitlines()
        assert tester.main([*args, "--device", "cpu"]) == 0
        tout = capsys.readouterr().out.strip().splitlines()
        jh, th = json.loads(jout[1]), json.loads(tout[1])
        assert th["iterations"] == jh["iterations"], method
        np.testing.assert_allclose(th["residual_norms"][0], jh["residual_norms"][0], rtol=1e-6)
