"""The fused BiCGStab iteration of the port against the JAX package's (CPU):
each kernel wrapper's plain version against its Pallas kernel in interpret
mode, the scalar steps the kernels' last CTAs take, one
``fused_bicgstab_step`` from a state carried across by
``convert.fused_bicgstab_state_from_arrays``, whole solves, and the
dispatch of ``bicgstab_solve``.

Tolerances, with their reasons (XLA:CPU contracts the kernels' multiply-add
pairs into FMAs, the port rounds every product and sum on its own; so
elementwise results differ by the rounding of a product or two, and sums
run in another order):

* p', p̂, s, ŝ, x_h, x', r': 1e-6 of the largest operand;
* v' and t: 2e-5 of their largest entry; the dots: 1e-4 relative
  (tests/test_fused_bicgstab.py's own bounds for the Pallas kernels);
* one solver step from the same state: vectors as above, the new scalars
  to 1e-4 relative (they are functions of the dots);
* whole solves: tests/test_fused_bicgstab.py's bounds for the JAX fused
  solve against the JAX portable one: ``rnorm_history`` to 5e-3 over the
  first 10 steps, x to rtol 5e-3 / atol 1e-4, iteration counts within
  max(4, 10%).  Over steps 11-16 BiCGStab's products amplify the f32
  order noise faster than CG's: the JAX package allows 0.15 between its two
  loops, and the port's rounding (no FMA contraction) adds as much again,
  so 0.3 there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.ops.pallas import fused_bicgstab as jk
from conjugategradient_tpu.solver import fused_bicgstab as jfb
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu_torch import (
    bicgstab_solve,
    convert,
    fused_bicgstab_solve,
    fused_bicgstab_supported,
    jacobi_preconditioner,
)
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import fused_bicgstab as tk
from conjugategradient_tpu_torch.problems import convection_diffusion_2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import fused_bicgstab as tfb


def _operator(nx, peclet=10.0):
    rows, cols, vals, shape = convection_diffusion_2d_coo(nx, peclet=peclet)
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                        bm=128, bn=128)
    tb = convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols), jb.shape,
                                  jb.nnz, device="cpu")
    return jb, tb, shape[0]


@pytest.fixture(scope="module")
def cd32():
    return _operator(32)


@pytest.fixture(scope="module")
def cd16():
    return _operator(16)


def _rhs(n):
    return (reference_rhs(n, dtype=np.float32) / n).astype(np.float32)


def _vecs(rows, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, 128)).astype(np.float32) for _ in range(k)]


def _s11(v):
    return np.full((1, 1), v, np.float32)


def _close_elem(got, want, operands):
    scale = max(float(np.abs(v).max()) for v in operands)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * scale)


def _close_spmv(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def _close_dot(got, want):
    np.testing.assert_allclose(float(got), float(np.asarray(want).reshape(-1)[0]), rtol=1e-4)


# ---- the kernels' plain versions against the Pallas kernels ---------------------------

@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("nx", [17, 32], ids=["ragged-nrb3", "nrb8"])
def test_dir_plain_matches_pallas(nx, with_d):
    jb, tb, _ = _operator(nx)
    rows = jb.padded_shape[1] // 128
    r, p, v, rhat, d = _vecs(rows, 5, nx)
    d = 0.5 + np.abs(d)
    beta, omega = _s11(0.4), _s11(0.25)
    want = jk.bicgstab_dir_spmv_dot(
        jb.blocks, jb.block_cols, *map(jnp.asarray, (r, p, v, rhat, beta, omega)),
        inv_diag2d=jnp.asarray(d) if with_d else None, interpret=True)
    before = dict(_common.LAUNCHES)
    got = tk.bicgstab_dir_spmv_dot(tb.blocks, tb.block_cols,
                                   *map(torch.from_numpy, (r, p, v, rhat, beta, omega)),
                                   torch.from_numpy(d) if with_d else None)
    assert _common.LAUNCHES == before  # CPU tensors: the plain version ran
    _close_elem(got[0], want[0], (r, p, v))
    _close_elem(got[1], want[1], (r, p, v))
    _close_spmv(got[2], want[2])
    _close_dot(got[3], want[3])


@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("nx", [17, 32], ids=["ragged-nrb3", "nrb8"])
def test_s_plain_matches_pallas(nx, with_d):
    jb, tb, _ = _operator(nx)
    rows = jb.padded_shape[1] // 128
    r, vn, x, ph, d = _vecs(rows, 5, nx + 1)
    d = 0.5 + np.abs(d)
    alpha = _s11(0.6)
    want = jk.bicgstab_s_spmv_dot(
        jb.blocks, jb.block_cols, *map(jnp.asarray, (r, vn, x, ph, alpha)),
        inv_diag2d=jnp.asarray(d) if with_d else None, interpret=True)
    got = tk.bicgstab_s_spmv_dot(tb.blocks, tb.block_cols,
                                 *map(torch.from_numpy, (r, vn, x, ph, alpha)),
                                 torch.from_numpy(d) if with_d else None)
    for i in range(3):  # s, ŝ, x_h
        _close_elem(got[i], want[i], (r, vn, x, ph))
    _close_spmv(got[3], want[3])
    for i in range(4, 7):  # s·s, t·s, t·t
        _close_dot(got[i], want[i])


@pytest.mark.parametrize("rows,lanes", [(16, 128), (13, 100), (3, 70)])
def test_update_plain_matches_pallas(rows, lanes):
    rng = np.random.default_rng(rows)
    xh, sh, s, t, rhat = (rng.standard_normal((rows, lanes)).astype(np.float32)
                          for _ in range(5))
    w = _s11(0.45)
    want = jk.bicgstab_update_dot(*map(jnp.asarray, (xh, sh, s, t, rhat, w)), interpret=True)
    xt = torch.from_numpy(xh.copy())
    got = tk.bicgstab_update_dot(xt, *map(torch.from_numpy, (sh, s, t, rhat, w)),
                                 out=(xt, torch.empty(rows, lanes)))
    assert got[0] is xt  # x' written over x_h, as the solver does
    for i in range(2):
        _close_elem(got[i], want[i], (xh, sh, s, t))
    _close_dot(got[2], want[2])
    _close_dot(got[3], want[3])


@pytest.mark.parametrize("out", [True, False], ids=["in-place", "no-out"])
def test_update_plain_not_live_returns_its_inputs(out):
    """Kernel 20's plain version at a length that is not a multiple of 1024
    (7 x 150 = 1050): live, it matches the Pallas kernel and takes the
    solver's step; on a work that is not live it returns x_h and s (or the
    out buffers, which hold them) untouched, zero dots, and the work as it
    was."""
    rng = np.random.default_rng(1050)
    xh, sh, s, t, rhat = (rng.standard_normal((7, 150)).astype(np.float32) for _ in range(5))
    w = _s11(0.45)
    want = jk.bicgstab_update_dot(*map(jnp.asarray, (xh, sh, s, t, rhat, w)), interpret=True)
    args = [torch.from_numpy(v.copy()) for v in (xh, sh, s, t, rhat, w)]
    live = tk.BicgstabWork.new("cpu", maxiter=9, tol=0.5)
    live.start(torch.tensor(4.0))
    got = tk.bicgstab_update_dot(*args, out=(args[0], args[2]) if out else None, work=live)
    for i in range(2):
        _close_elem(got[i], want[i], (xh, sh, s, t))
    _close_dot(got[2], want[2])
    _close_dot(got[3], want[3])
    assert int(live.ctl[tk.C_K]) == 1
    idle = tk.BicgstabWork.new("cpu", maxiter=9, tol=0.5)
    idle.ctl[tk.C_LIVE] = 0
    kept = [t_.clone() for t_ in (idle.scal, idle.ctl, idle.hist)]
    args = [torch.from_numpy(v.copy()) for v in (xh, sh, s, t, rhat, w)]
    got = tk.bicgstab_update_dot(*args, out=(args[0], args[2]) if out else None, work=idle)
    assert got[0] is args[0] and got[1] is args[2]
    assert np.array_equal(got[0].numpy(), xh) and np.array_equal(got[1].numpy(), s)
    assert float(got[2]) == float(got[3]) == 0.0
    # bit for bit (hist holds NaN past k)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(kept, (idle.scal, idle.ctl, idle.hist)))


def test_clamped_scalars_make_exact_no_ops(cd16):
    """α = 0 (a clamped non-finite α) leaves s = r and x_h = x bit for bit;
    ω = 0 gives x' = x_h and r' = s; β = 0 gives p' = r."""
    _, tb, _ = cd16
    r, v, x, p, rhat = map(torch.from_numpy, _vecs(tb.nrb, 5, 3))
    z = torch.zeros(1, 1)
    pn, ph, vn, _ = tk.bicgstab_dir_spmv_dot(tb.blocks, tb.block_cols, r, p, v, rhat, z,
                                             torch.ones(1, 1))
    assert torch.equal(pn, r) and torch.equal(ph, r)
    s, sh, xh, t, *_ = tk.bicgstab_s_spmv_dot(tb.blocks, tb.block_cols, r, vn, x, ph, z)
    assert torch.equal(s, r) and torch.equal(xh, x)
    x2, r2, rn, _ = tk.bicgstab_update_dot(xh, sh, s, t, rhat, z)
    assert torch.equal(x2, xh) and torch.equal(r2, s)
    torch.testing.assert_close(rn[0, 0], torch.sum(s * s), rtol=1e-6, atol=0)


# ---- the scalar steps ---------------------------------------------------------------------

def _work(**slots):
    w = tk.BicgstabWork.new("cpu", maxiter=9, tol=0.5)
    w.start(torch.tensor(4.0))
    for name, val in slots.items():
        w.scal[getattr(tk, name)] = val
    return w


def test_scalar_steps_follow_the_jax_step():
    # K1: alpha = rho_k / rv, clamped only when not finite
    w = _work(B_RHO_NEXT=3.0)
    tk.finish_dir(w, torch.tensor(2.0))
    assert float(w.scal[tk.B_ALPHA]) == 1.5 == float(w.scal[tk.B_ALPHA_C])
    tk.finish_dir(w, torch.tensor(0.0))
    assert np.isinf(float(w.scal[tk.B_ALPHA])) and float(w.scal[tk.B_ALPHA_C]) == 0.0
    # K2: omega, and omega_c = 0 on the half-step exit
    tk.finish_s(w, torch.tensor(4.0), torch.tensor(3.0), torch.tensor(2.0))
    assert int(w.ctl[tk.C_HALF]) == 0 and float(w.scal[tk.B_OMEGA_C]) == 1.5
    tk.finish_s(w, torch.tensor(0.16), torch.tensor(3.0), torch.tensor(2.0))
    assert int(w.ctl[tk.C_HALF]) == 1 and float(w.scal[tk.B_OMEGA]) == 1.5
    assert float(w.scal[tk.B_OMEGA_C]) == 0.0
    tk.finish_s(w, torch.tensor(4.0), torch.tensor(0.0), torch.tensor(0.0))
    assert np.isnan(float(w.scal[tk.B_OMEGA])) and float(w.scal[tk.B_OMEGA_C]) == 0.0
    # K3: a NaN omega breaks down, sticky, with hist[k] the new norm
    tk.finish_update(w, torch.tensor(9.0), torch.tensor(1.0))
    assert bool(w.ctl[tk.C_BROKE]) and bool(w.ctl[tk.C_DONE]) and not bool(w.ctl[tk.C_LIVE])
    assert int(w.ctl[tk.C_K]) == 1 and float(w.hist[1]) == 3.0
    assert float(w.scal[tk.B_RNORM_PREV]) == 2.0 and float(w.scal[tk.B_RNORM]) == 3.0
    # a finite step that converges, and the next beta from the unclamped values
    w = _work(B_RHO_NEXT=2.0, B_ALPHA=0.5, B_OMEGA=0.25)
    tk.finish_update(w, torch.tensor(0.09), torch.tensor(1.0))
    assert not bool(w.ctl[tk.C_BROKE]) and bool(w.ctl[tk.C_DONE])
    assert float(w.scal[tk.B_RHO]) == 2.0 and float(w.scal[tk.B_RHO_NEXT]) == 1.0
    assert float(w.scal[tk.B_BETA]) == (1.0 / 2.0) * (0.5 / 0.25)
    # omega == 0 on a step that did not converge is a breakdown
    w = _work(B_RHO_NEXT=2.0, B_ALPHA=0.5, B_OMEGA=0.0)
    tk.finish_update(w, torch.tensor(4.0), torch.tensor(1.0))
    assert bool(w.ctl[tk.C_BROKE]) and float(w.scal[tk.B_BETA_C]) == 0.0


# ---- one step from a carried state -----------------------------------------------------

_SCALARS = ("rho", "rho_next", "alpha", "omega", "rnorm", "rnorm_prev")
_SLOTS = dict(zip(_SCALARS, (tk.B_RHO, tk.B_RHO_NEXT, tk.B_ALPHA, tk.B_OMEGA, tk.B_RNORM,
                             tk.B_RNORM_PREV)))


@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
def test_one_step_from_a_carried_state(cd16, with_d):
    jb, tb, n = cd16
    mp = jb.padded_shape[1]
    tol = 1e-7
    d2d = None
    if with_d:
        d = np.ones(mp, np.float32)
        d[:n] = 1.0 / np.asarray(jb.diagonal())
        d2d = d.reshape(-1, 128)
    jd = None if d2d is None else jnp.asarray(d2d)
    tol_j = jnp.asarray(tol, jnp.float32)
    s = jfb.fused_bicgstab_init(jb, jnp.asarray(_rhs(n)), None, 8, jd)
    for _ in range(3):
        s = jfb.fused_bicgstab_step(jb, s, tol_j, d2d=jd, interpret=True)
    f = {fld.name: np.asarray(getattr(s, fld.name)) for fld in dataclasses.fields(s)}
    ts = convert.fused_bicgstab_state_from_arrays(
        f["x"], f["xprev"], f["r"], f["rhat"], f["p"], f["v"], *(f[k] for k in _SCALARS),
        int(f["k"]), bool(f["done"]), bool(f["broke"]), f["hist"], tol=tol, inv_diag2d=d2d,
        device="cpu")
    s = jfb.fused_bicgstab_step(jb, s, tol_j, d2d=jd, interpret=True)
    ts = tfb.fused_bicgstab_step(tb, ts)
    assert int(ts.k) == int(s.k) == 4 and bool(ts.done) == bool(s.done) is False
    for name in ("x", "xprev", "r", "p", "v"):
        want = np.asarray(getattr(s, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1e-3), err_msg=name)
    for name, slot in _SLOTS.items():
        np.testing.assert_allclose(float(ts.work.scal[slot]), float(getattr(s, name)[0, 0]),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ts.hist.numpy()[:5], np.asarray(s.hist)[:5], rtol=1e-4)
    assert np.isnan(ts.hist.numpy()[5:]).all()


# ---- whole solves ---------------------------------------------------------------------

def _traj(hf, hr, k=16):
    np.testing.assert_allclose(hf[:11], hr[:11], rtol=5e-3)
    np.testing.assert_allclose(hf[11:k + 1], hr[11:k + 1], rtol=0.3)


def test_trajectory_parity_with_jax(cd32, cd16):
    jb, tb, n = cd32
    b = _rhs(n)
    _, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=0.0, maxiter=16, interpret=True)
    _, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=16)
    assert int(it.iterations) == int(ij.iterations) == 16 and not bool(it.converged)
    _traj(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history))
    # and to tolerance on the smaller operator
    jb, tb, n = cd16
    b = _rhs(n)
    xj, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=1e-5, maxiter=4 * n,
                                      interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=1e-5, maxiter=4 * n)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert bool(it.converged) and abs(kt - kj) <= max(4, kj // 10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=5e-3, atol=1e-4)
    assert np.isfinite(float(it.rnorm_true)) and np.isnan(it.rnorm_history.numpy()[kt + 1:]).all()
    # against the port's own portable loop on the same operator
    xp, ip = bicgstab_solve(tb, torch.from_numpy(b), tol=1e-5, maxiter=4 * n)
    assert abs(kt - int(ip.iterations)) <= max(4, kt // 10)
    np.testing.assert_allclose(xt.numpy(), xp.numpy(), rtol=5e-3, atol=1e-4)


def test_jacobi_parity():
    jb, tb, n = _operator(24, peclet=6.0)
    b = _rhs(n)
    jM, tM = jcg.jacobi_preconditioner(jb), jacobi_preconditioner(tb)
    _, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=0.0, maxiter=12,
                                     inv_diag=jM.inv_diag, interpret=True)
    _, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=12,
                                 inv_diag=tM.inv_diag)
    np.testing.assert_allclose(it.rnorm_history.numpy()[:13], np.asarray(ij.rnorm_history)[:13],
                               rtol=5e-3)
    _, ip = bicgstab_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=12, M=tM)
    np.testing.assert_allclose(it.rnorm_history.numpy()[:13], ip.rnorm_history.numpy()[:13],
                               rtol=5e-3)


def test_half_step_exit(cd16):
    jb, tb, n = cd16
    b = _rhs(n)
    _, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=1e-3, maxiter=4 * n,
                                     interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=1e-3, maxiter=4 * n)
    assert bool(it.converged) == bool(ij.converged) is True
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    r = b - tb.matvec(xt).numpy()
    assert np.linalg.norm(r) <= 3e-3
    # an exact half-step exit: the first step j whose ‖s‖ undercuts every
    # norm before it, with tol just above it
    st = tfb.fused_bicgstab_init(tb, torch.from_numpy(b), None, 40)
    seen, j = [float(st.rnorm)], None
    for step in range(1, 41):
        tfb.fused_bicgstab_step(tb, st)
        snorm = float(torch.sqrt(st.work.scal[tk.B_SS]))
        if snorm < 0.999 * min(seen) and float(st.rnorm) < snorm:
            j = step
            break
        seen += [snorm, float(st.rnorm)]
    assert j is not None
    tol = snorm * (1 + 1e-6)
    xh, ih = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=tol, maxiter=40)
    assert int(ih.iterations) == j and bool(ih.converged) and not bool(ih.breakdown)
    np.testing.assert_allclose(float(ih.rnorm), snorm, rtol=1e-5)
    jh, jih = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=tol, maxiter=40, interpret=True)
    _, ph = bicgstab_solve(tb, torch.from_numpy(b), tol=tol, maxiter=40)
    assert int(jih.iterations) == int(ph.iterations) == j
    np.testing.assert_allclose(xh.numpy(), np.asarray(jh), rtol=1e-3, atol=1e-5)


def test_breakdown_keeps_last_finite_iterate():
    rot = np.array([[0.0, -1.0], [1.0, 0.0]], dtype=np.float32)
    a = np.kron(np.eye(64, dtype=np.float32), rot)  # a 128 x 128 rotation
    rows, cols = np.nonzero(a)
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, a[rows, cols], (128, 128), dtype=np.float32),
                        bm=128, bn=128)
    tb = convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols), jb.shape,
                                  jb.nnz, device="cpu")
    b = np.random.default_rng(4).standard_normal(128).astype(np.float32)
    xj, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), tol=1e-10, maxiter=64, interpret=True)
    xt, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=1e-10, maxiter=64)
    _, ip = bicgstab_solve(tb, torch.from_numpy(b), tol=1e-10, maxiter=64)
    assert bool(it.breakdown) == bool(ij.breakdown) == bool(ip.breakdown) is True
    assert not bool(it.converged) and int(it.iterations) == int(ij.iterations)
    assert np.isfinite(xt.numpy()).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-5)
    k = int(it.iterations)
    assert float(it.rnorm_history[k]) == float(it.rnorm)  # hist[k] restored too


def test_maxiter_cap_and_x0(cd16):
    jb, tb, n = cd16
    b = _rhs(n)
    _, it = fused_bicgstab_solve(tb, torch.from_numpy(b), tol=0.0, maxiter=7)
    assert int(it.iterations) == 7 and not bool(it.converged)
    x0 = (0.01 * np.random.default_rng(5).standard_normal(n)).astype(np.float32)
    _, ij = jfb.fused_bicgstab_solve(jb, jnp.asarray(b), jnp.asarray(x0), tol=0.0, maxiter=8,
                                     interpret=True)
    _, it = fused_bicgstab_solve(tb, torch.from_numpy(b), torch.from_numpy(x0), tol=0.0,
                                 maxiter=8)
    np.testing.assert_allclose(it.rnorm_history.numpy()[:9], np.asarray(ij.rnorm_history)[:9],
                               rtol=1e-2)
    x, info = fused_bicgstab_solve(tb, torch.zeros(n), tol=1e-30)
    assert int(info.iterations) == 0 and bool(info.converged) and not x.any()


def test_steps_past_the_end_change_nothing(cd16, monkeypatch):
    """The loop launches steps after ``done`` until its next host read; they
    are no-ops, and ``settle`` gives the traded buffers their names back: a
    solve that reads the flag every step gives the same bits."""
    from conjugategradient_tpu_torch.solver import restart

    _, tb, n = cd16
    b = torch.from_numpy(_rhs(n))
    x32, i32 = fused_bicgstab_solve(tb, b, tol=1e-4)
    monkeypatch.setattr(restart, "CHECK_EVERY", 1)
    x1, i1 = fused_bicgstab_solve(tb, b, tol=1e-4)
    k = int(i1.iterations)
    assert bool(i1.converged) and int(i32.iterations) == k and k % 32 not in (0, 31)
    np.testing.assert_array_equal(i32.rnorm_history.numpy(), i1.rnorm_history.numpy())
    assert torch.equal(x32, x1)


# ---- dispatch and operand checks -----------------------------------------------------

def test_dispatch_and_support_gate(cd16):
    _, tb, n = cd16
    b = torch.from_numpy(_rhs(n))
    assert not fused_bicgstab_supported(tb, dtype=torch.float32)  # CPU tensors
    with pytest.raises(ValueError, match="CUDA device"):
        bicgstab_solve(tb, b, tol=1e-4, fused="always")
    with pytest.raises(ValueError, match="Jacobi"):
        bicgstab_solve(tb, b, tol=1e-4, fused="always", M=lambda r: 0.5 * r)
    # "auto" is the portable loop: the same bits as "never"
    _, auto = bicgstab_solve(tb, b, tol=1e-4)
    _, never = bicgstab_solve(tb, b, tol=1e-4, fused="never")
    np.testing.assert_array_equal(auto.rnorm_history.numpy(), never.rnorm_history.numpy())
    with pytest.raises(TypeError, match="full blocked-ELL"):
        fused_bicgstab_solve(torch.eye(4), torch.ones(4))


def test_wrappers_validate_their_operands(cd16):
    _, tb, _ = cd16
    r, p, v, rhat, x = map(torch.from_numpy, _vecs(tb.nrb, 5, 9))
    one = torch.ones(1, 1)
    new = lambda: torch.empty_like(r)  # noqa: E731
    with pytest.raises(ValueError, match="gather"):  # p' over p, which other rows gather
        tk.bicgstab_dir_spmv_dot(tb.blocks, tb.block_cols, r, p, v, rhat, one, one,
                                 out=(p, new(), new()))
    with pytest.raises(ValueError, match="gather"):  # t over v'
        tk.bicgstab_s_spmv_dot(tb.blocks, tb.block_cols, r, v, x, p, one,
                               out=(new(), new(), new(), v))
    out = (new(), new(), x, new())  # x_h over x is allowed
    ref = tk.bicgstab_s_spmv_dot(tb.blocks, tb.block_cols, r, v, x.clone(), p, one)
    got = tk.bicgstab_s_spmv_dot(tb.blocks, tb.block_cols, r, v, x, p, one, out=out)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, ref)) and got[2] is x
    with pytest.raises(ValueError, match="distinct"):
        tk.bicgstab_update_dot(r, p, v, x, rhat, one, out=(r, r))
    with pytest.raises(ValueError, match="one float32"):
        tk.bicgstab_dir_spmv_dot(tb.blocks, tb.block_cols, r, p, v, rhat, one.double(), one)
    with pytest.raises(TypeError, match="float32"):
        tk.bicgstab_dir_spmv_dot(tb.blocks.double(), tb.block_cols, r, p, v, rhat, one, one)
    with pytest.raises(ValueError, match="vectors"):
        tk.bicgstab_update_dot(r, p[:1], v, x, rhat, one)
