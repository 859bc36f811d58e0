"""Kernels 18 and 19 of the fused BiCGStab iteration on the packed nonzeros
of sparse tiles (``bicgstab_dir_spmv_dot_packed``,
``bicgstab_s_spmv_dot_packed``), and the route of ``fused_bicgstab_step``
that takes them, in the port against the JAX package (CPU).

On the card a float32 operator whose tiles are mostly empty takes the
packed kernels; here the same rule (``ops/spmv.bell_packed_route``) sends
it to their plain versions, so these tests run the route the card takes.
Same numpy inputs on both sides; the JAX Pallas kernels run in interpret
mode.  Tolerances, with their reasons (XLA:CPU contracts multiply-add
pairs into FMAs where the port rounds every product and sum on its own,
and the packed product sums a row in another order than the tiles):

* p', p̂, s, ŝ, x_h: 1e-6 of the largest operand;
* v' and t: 1e-5 of their largest entry;
* the dots: 1e-5 relative;
* the packed against the dense plain versions: p', p̂, s, ŝ and x_h bit
  for bit (the same elementwise ops; only the product differs);
* whole solves: those of ``tests/test_torch_fused_bicgstab.py``
  (``rnorm_history`` to 5e-3 over the first 10 steps; x to rtol 5e-3 /
  atol 1e-4 and iterations within max(4, 10%) at a tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.ops.pallas import fused_bicgstab as jk
from conjugategradient_tpu.solver import fused_bicgstab as jfb
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import convert, fused_bicgstab_solve, jacobi_preconditioner
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as tk
from conjugategradient_tpu_torch.ops.spmv import bell_packed_route
from conjugategradient_tpu_torch.problems import (
    block_tridiag_tiles,
    convection_diffusion_2d_coo,
    reference_rhs,
)
from conjugategradient_tpu_torch.solver import fused_bicgstab as tfb
from conjugategradient_tpu_torch.types import BlockedEllMatrix

RTOL_ELEM = 1e-6
RTOL_SPMV = 1e-5
RTOL_DOT = 1e-5


def _port(jb):
    return convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols), jb.shape,
                                    jb.nnz, device="cpu")


def _jax_bell(rows, cols, vals, shape, bn):
    return JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32), bm=bn, bn=bn)


def _convdiff(nx, bn=128):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=10.0)
    return _jax_bell(rows, cols, vals, shape, bn)


def _random_sparse(n=301, per_row=4, bn=32, seed=5):
    """A nonsymmetric random operator with ~per_row scattered nonzeros a
    row and a dominant diagonal; n is not a multiple of bn (ragged)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        A[i, rng.choice(n, size=per_row, replace=False)] = rng.standard_normal(per_row)
    A[np.arange(n), np.arange(n)] = np.abs(A).sum(axis=1) + 1
    rows, cols = np.nonzero(A)
    return _jax_bell(rows, cols, A[rows, cols], A.shape, bn)


OPERATORS = {"convdiff16": lambda: _convdiff(16), "convdiff32": lambda: _convdiff(32),
             "random32": _random_sparse}
SCALARS = {"nonzero": (0.4, 0.25, 0.6), "zero": (0.0, 0.0, 0.0)}


@pytest.fixture(scope="module", params=list(OPERATORS))
def operator(request):
    jb = OPERATORS[request.param]()
    tb = _port(jb)
    assert bell_packed_route(tb)
    return jb, tb


def _vecs(tb, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((tb.nrb, tb.bn)).astype(np.float32) for _ in range(k)]


def _d(tb, seed):
    return (0.5 + np.abs(np.random.default_rng(seed).standard_normal((tb.nrb, tb.bn)))
            ).astype(np.float32)


def _s11(v):
    return np.full((1, 1), v, np.float32)


def _close_elem(got, want, operands):
    scale = max(float(np.abs(v).max()) for v in operands)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RTOL_ELEM * scale)


def _close_spmv(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL_SPMV * np.abs(want).max())


def _close_dot(got, want):
    np.testing.assert_allclose(float(got), float(np.asarray(want).reshape(-1)[0]), rtol=RTOL_DOT)


# ---- the packed plain versions against the Pallas kernels ------------------------------

@pytest.mark.parametrize("scalars", list(SCALARS))
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
def test_packed_dir_matches_jax(operator, with_d, scalars):
    jb, tb = operator
    beta_v, omega_v, _ = SCALARS[scalars]
    r, p, v, rhat = _vecs(tb, 4, tb.nrb)
    d = _d(tb, 1)
    beta, omega = _s11(beta_v), _s11(omega_v)
    want = jk.bicgstab_dir_spmv_dot(
        jb.blocks, jb.block_cols, *map(jnp.asarray, (r, p, v, rhat, beta, omega)),
        inv_diag2d=jnp.asarray(d) if with_d else None, interpret=True)
    before = dict(_common.LAUNCHES)
    got = tk.bicgstab_dir_spmv_dot_packed(tb.packed(), *map(torch.from_numpy,
                                                            (r, p, v, rhat, beta, omega)),
                                          torch.from_numpy(d) if with_d else None)
    # CPU tensors: the plain version ran (the view may have been built)
    assert {k: n for k, n in _common.LAUNCHES.items() if k != "bell_pack"} == {
        k: n for k, n in before.items() if k != "bell_pack"}
    _close_elem(got[0], want[0], (r, p, v))
    _close_elem(got[1], want[1], (r, p, v))
    _close_spmv(got[2], want[2])
    _close_dot(got[3], want[3])
    if beta_v == 0.0:
        assert torch.equal(got[0], torch.from_numpy(r))  # p' = r exactly


@pytest.mark.parametrize("scalars", list(SCALARS))
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
def test_packed_s_matches_jax(operator, with_d, scalars):
    jb, tb = operator
    _, _, alpha_v = SCALARS[scalars]
    r, vn, x, ph = _vecs(tb, 4, tb.nrb + 1)
    d = _d(tb, 2)
    alpha = _s11(alpha_v)
    want = jk.bicgstab_s_spmv_dot(
        jb.blocks, jb.block_cols, *map(jnp.asarray, (r, vn, x, ph, alpha)),
        inv_diag2d=jnp.asarray(d) if with_d else None, interpret=True)
    got = tk.bicgstab_s_spmv_dot_packed(tb.packed(), *map(torch.from_numpy, (r, vn, x, ph, alpha)),
                                        torch.from_numpy(d) if with_d else None)
    for i in range(3):  # s, ŝ, x_h
        _close_elem(got[i], want[i], (r, vn, x, ph))
    _close_spmv(got[3], want[3])
    for i in range(4, 7):  # s·s, t·s, t·t
        _close_dot(got[i], want[i])
    if alpha_v == 0.0:  # s = r and x_h = x exactly
        assert torch.equal(got[0], torch.from_numpy(r)) and torch.equal(got[2], torch.from_numpy(x))


def test_packed_and_dense_plain_versions_agree_bitwise():
    """One plain body per kernel: the packed and the dense forms differ only
    in the product, so every elementwise output is the same bits."""
    tb = _port(_convdiff(16))
    pk = tb.packed()
    r, p, v, rhat, x = map(torch.from_numpy, _vecs(tb, 5, 3))
    d = torch.from_numpy(_d(tb, 4))
    beta, omega, alpha = (torch.from_numpy(_s11(s)) for s in (0.4, 0.25, 0.6))
    kp = tk.bicgstab_dir_spmv_dot_packed(pk, r, p, v, rhat, beta, omega, d)
    kd = tk.bicgstab_dir_spmv_dot(tb.blocks, tb.block_cols, r, p, v, rhat, beta, omega, d)
    assert torch.equal(kp[0], kd[0]) and torch.equal(kp[1], kd[1])
    torch.testing.assert_close(kp[2], kd[2], rtol=0, atol=RTOL_SPMV * float(kd[2].abs().max()))
    sp = tk.bicgstab_s_spmv_dot_packed(pk, r, kp[2], x, kp[1], alpha, d)
    sd = tk.bicgstab_s_spmv_dot(tb.blocks, tb.block_cols, r, kp[2], x, kp[1], alpha, d)
    for i in range(3):  # s, ŝ, x_h
        assert torch.equal(sp[i], sd[i])
    torch.testing.assert_close(sp[3], sd[3], rtol=0, atol=RTOL_SPMV * float(sd[3].abs().max()))


# ---- the route ------------------------------------------------------------------------

def _dense_tridiag(nrb=6, bn=32):
    """Dense block-tridiagonal tiles, made nonsymmetric by halving the
    lower tiles: the dense route."""
    blocks, cols, nnz = block_tridiag_tiles(nrb * bn, bn, bn, seed=1)
    blocks = blocks.copy()
    blocks[cols < np.arange(nrb)[:, None]] *= 0.5
    return BlockedEllMatrix(torch.from_numpy(blocks), torch.from_numpy(cols),
                            (nrb * bn, nrb * bn), nnz)


@pytest.mark.parametrize("case", ["convdiff", "dense tridiagonal"])
def test_step_routes_by_tile_fill(case, monkeypatch):
    """``fused_bicgstab_step`` calls the packed pair on sparse tiles and the
    dense pair on dense ones, kernel 20 either way."""
    tb = _port(_convdiff(16)) if case == "convdiff" else _dense_tridiag()
    packed = case == "convdiff"
    assert bell_packed_route(tb) == packed
    calls = []
    for name in ("bicgstab_dir_spmv_dot", "bicgstab_dir_spmv_dot_packed",
                 "bicgstab_s_spmv_dot", "bicgstab_s_spmv_dot_packed", "bicgstab_update_dot"):
        fn = getattr(tfb, name)
        monkeypatch.setattr(tfb, name, lambda *a, _fn=fn, _name=name, **k: (
            calls.append(_name), _fn(*a, **k))[1])
    b = torch.from_numpy(reference_rhs(tb.n, dtype=np.float32) / tb.n)
    state = tfb.fused_bicgstab_init(tb, b, None, 3)
    for _ in range(3):
        tfb.fused_bicgstab_step(tb, state)
    suffix = "_packed" if packed else ""
    assert calls == [f"bicgstab_dir_spmv_dot{suffix}", f"bicgstab_s_spmv_dot{suffix}",
                     "bicgstab_update_dot"] * 3
    assert int(state.k) == 3 and np.isfinite(state.hist.numpy()).all()


def test_one_pack_per_operator_over_a_solve():
    """The view is built once for a whole solve (x0's residual, every step
    and the true residual), and again only after an in-place change."""
    jb = _convdiff(24)
    tb = _port(jb)
    n = tb.n
    b = torch.from_numpy(reference_rhs(n, dtype=np.float32) / n)
    x0 = torch.full((n,), 0.01)
    before = _common.LAUNCHES["bell_pack"]
    fused_bicgstab_solve(tb, b, x0, tol=0.0, maxiter=20)
    assert _common.LAUNCHES["bell_pack"] == before + 1
    fused_bicgstab_solve(tb, b, x0, tol=0.0, maxiter=5)
    assert _common.LAUNCHES["bell_pack"] == before + 1
    tb.blocks.mul_(2.0)
    fused_bicgstab_solve(tb, b, tol=0.0, maxiter=2)
    assert _common.LAUNCHES["bell_pack"] == before + 2


# ---- whole solves against the JAX fused solve --------------------------------------

@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_fused_solve_matches_jax(precond):
    jb = _convdiff(24)
    tb = _port(jb)
    n = tb.n
    b = (reference_rhs(n, dtype=np.float32) / n).astype(np.float32)
    jd = td = None
    if precond == "jacobi":
        jd, td = jcg.jacobi_preconditioner(jb).inv_diag, jacobi_preconditioner(tb).inv_diag
    _, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=0.0, maxiter=12, inv_diag=jd,
                                     interpret=True)
    _, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=12, inv_diag=td)
    np.testing.assert_allclose(it.rnorm_history.numpy()[:11], np.asarray(ij.rnorm_history)[:11],
                               rtol=5e-3)
    tol = 1e-5 * float(np.linalg.norm(b))
    xj, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=tol, maxiter=4 * n, inv_diag=jd,
                                      interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=tol, maxiter=4 * n, inv_diag=td)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert bool(it.converged) and bool(ij.converged) and abs(kt - kj) <= max(4, kj // 10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=5e-3, atol=1e-4)


def test_nan_in_b_exits_as_jax():
    jb = _convdiff(16)
    tb = _port(jb)
    b = (reference_rhs(tb.n, dtype=np.float32) / tb.n).astype(np.float32)
    b[37] = np.nan
    xj, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=1e-6, maxiter=20, interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=1e-6, maxiter=20)
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) == bool(ij.converged) is False
    assert bool(it.breakdown) == bool(ij.breakdown)
    np.testing.assert_array_equal(np.isnan(xt.numpy()), np.isnan(np.asarray(xj)))


def test_skew_breakdown_keeps_the_last_finite_iterate():
    """The skew matrix [[0, 1], [-1, 0]] at bn = 32 (one sparse tile): ρ = 0
    after one step, a breakdown; both packages return the last finite
    iterate."""
    jb = _jax_bell(np.array([0, 1]), np.array([1, 0]), np.array([1.0, -1.0], np.float32),
                   (2, 2), 32)
    tb = _port(jb)
    assert bell_packed_route(tb)
    b = np.array([1.0, 0.0], np.float32)
    xj, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=1e-12, maxiter=10, interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=1e-12, maxiter=10)
    assert bool(it.breakdown) == bool(ij.breakdown) is True
    assert not bool(it.converged) and int(it.iterations) == int(ij.iterations)
    assert np.isfinite(xt.numpy()).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-7)


# ---- operand checks -------------------------------------------------------------------

def test_packed_wrappers_refuse_bad_operands():
    tb = _port(_convdiff(16))
    pk = tb.packed()
    r, p, v, rhat, x = map(torch.from_numpy, _vecs(tb, 5, 9))
    one = torch.ones(1, 1)
    new = lambda: torch.empty_like(r)  # noqa: E731
    with pytest.raises(TypeError, match="float32"):
        tk.bicgstab_dir_spmv_dot_packed(tb.astype(torch.float64).packed(), r, p, v, rhat, one,
                                        one)
    with pytest.raises(TypeError, match="float32"):
        tk.bicgstab_s_spmv_dot_packed(tb.astype(torch.float64).packed(), r, v, x, p, one)
    with pytest.raises(ValueError, match="gather"):  # p' over p, which other rows gather
        tk.bicgstab_dir_spmv_dot_packed(pk, r, p, v, rhat, one, one, out=(p, new(), new()))
    with pytest.raises(ValueError, match="gather"):  # t over v'
        tk.bicgstab_s_spmv_dot_packed(pk, r, v, x, p, one, out=(new(), new(), new(), v))
    out = (new(), new(), x, new())  # x_h over x is allowed
    ref = tk.bicgstab_s_spmv_dot_packed(pk, r, v, x.clone(), p, one)
    got = tk.bicgstab_s_spmv_dot_packed(pk, r, v, x, p, one, out=out)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, ref)) and got[2] is x
    with pytest.raises(ValueError, match="vectors"):
        tk.bicgstab_dir_spmv_dot_packed(pk, r[:-1], p[:-1], v[:-1], rhat[:-1], one, one)
    with pytest.raises(ValueError, match="vectors"):
        tk.bicgstab_s_spmv_dot_packed(pk, r, v[:, :-1], x, p, one)
    with pytest.raises(ValueError, match="one float32"):
        tk.bicgstab_dir_spmv_dot_packed(pk, r, p, v, rhat, one.double(), one)
