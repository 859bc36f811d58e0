"""The fused MINRES iteration of the port against the JAX package's (CPU):
each kernel wrapper's plain version against its Pallas kernel in interpret
mode, one ``fused_minres_step`` from a state carried across by
``convert.fused_minres_state_from_arrays``, and whole solves.

Tolerances, with their reasons (XLA:CPU contracts the kernels' multiply-add
pairs into FMAs, the port rounds every product and sum on its own; so
elementwise results differ by the rounding of one product, and sums run in
another order):

* v: 1e-6 relative (one or two products); w_new, x_new and r2': 1e-6 of the
  largest operand (two or three product roundings and a cancellation);
* q: 2e-5 of max|q|; the dots: 1e-4 relative (tests/test_fused_minres.py's
  own bounds for the Pallas kernels against numpy);
* one solver step from the same state: vectors as above, the new scalars
  to 1e-4 relative (they are functions of the dots);
* whole solves: ``rnorm_history`` to rtol 2e-3 over 24-32 steps (5e-3 with
  an indefinite shift) and x to rtol 1e-3, the bounds under which
  tests/test_fused_minres.py holds the JAX fused solve to the JAX portable
  one; equal iteration counts only where the run is capped.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conjugategradient_tpu as jcg
from conjugategradient_tpu.ops.pallas import fused_minres as jk
from conjugategradient_tpu.solver import fused_minres as jfm
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import SymBellMatrix as JSym
from conjugategradient_tpu_torch import convert, fused_minres_solve, fused_minres_supported
from conjugategradient_tpu_torch import jacobi_preconditioner, minres_solve
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import fused_minres as tk
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import fused_minres as tfm


def _port_bell(jb):
    return convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols),
                                    jb.shape, jb.nnz, device="cpu")


def _port_sym(js):
    return convert.sym_bell_from_arrays(
        np.asarray(js.diag_blocks), np.asarray(js.off_blocks), np.asarray(js.off_cols),
        js.shape, js.nnz, js.full_kmax, js.banded, device="cpu")


def _operators(coo):
    rows, cols, vals, shape = coo
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                        bm=128, bn=128)
    js = JSym.from_bell(jb)
    return {"full": (jb, _port_bell(jb)), "sym": (js, _port_sym(js))}, shape[0]


@pytest.fixture(scope="module")
def banded():
    """tests/test_fused_minres.py's banded operator (n = 700, block
    tridiagonal at 128 x 128) in both storages."""
    return _operators(banded_spd_coo(700, bandwidth=6, seed=3))


@pytest.fixture(scope="module")
def poisson():
    return _operators(poisson2d_coo(24))


def _rhs(n):
    return (reference_rhs(n).astype(np.float32) / n).astype(np.float32)


SU = (0.31, 0.07, 0.11, 0.23, 0.57, 0.83)  # 1/β, σ, ε̄, δ̄, 1/γ̄, φ̄


def _dir_inputs(rows, seed, first=False):
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal((rows, 128)).astype(np.float32) for _ in range(6)]
    su = np.zeros((1, 8), np.float32)
    su[0, :6] = SU[:2] + ((0.0,) * 4 if first else SU[2:])
    d = (0.5 + rng.random((rows, 128))).astype(np.float32)
    return vecs, su, d


def _check_dir(got, want, vecs):
    scale = max(float(np.abs(v).max()) for v in vecs)
    v, q, w, x, vq, vr1 = (np.asarray(t) for t in want)
    np.testing.assert_allclose(got[0].numpy(), v, rtol=1e-6, atol=1e-7 * scale)
    np.testing.assert_allclose(got[1].numpy(), q, rtol=0, atol=2e-5 * np.abs(q).max())
    np.testing.assert_allclose(got[2].numpy(), w, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got[3].numpy(), x, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(float(got[4]), float(vq[0, 0]), rtol=1e-4)
    np.testing.assert_allclose(float(got[5]), float(vr1[0, 0]), rtol=1e-4)


# ---- the kernels' plain versions against the Pallas kernels ----------------------

@pytest.mark.parametrize("first", [False, True], ids=["pending", "first-step"])
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
def test_full_dir_plain_matches_pallas(banded, with_d, first):
    jb, tb = banded[0]["full"]
    vecs, su, d = _dir_inputs(jb.padded_shape[1] // 128, 0, first)
    want = jk.minres_dir_spmv_dot(jb.blocks, jb.block_cols, *map(jnp.asarray, vecs),
                                  jnp.asarray(su), inv_diag2d=jnp.asarray(d) if with_d else None,
                                  interpret=True)
    before = dict(_common.LAUNCHES)
    got = tk.minres_dir_spmv_dot(tb.blocks, tb.block_cols, *map(torch.from_numpy, vecs),
                                 torch.from_numpy(su), torch.from_numpy(d) if with_d else None)
    assert _common.LAUNCHES == before  # CPU tensors: the plain version ran
    _check_dir(got, want, vecs)
    if first:  # no pending update: x kept bit for bit, w = 0
        assert np.array_equal(got[3].numpy(), vecs[5]) and not got[2].any()


@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("mirror", ["scatter", "banded"])
def test_sym_dir_plain_matches_pallas(banded, mirror, with_d):
    js, ts = banded[0]["sym"]
    assert js.banded and ts.banded
    vecs, su, d = _dir_inputs(js.padded_shape[1] // 128, 1)
    want = jk.sym_minres_dir_spmv_dot(
        js.diag_blocks, js.off_blocks, js.off_cols, *map(jnp.asarray, vecs), jnp.asarray(su),
        inv_diag2d=jnp.asarray(d) if with_d else None, interpret=True, mirror=mirror)
    got = tk.sym_minres_dir_spmv_dot(
        ts.diag_blocks, ts.off_blocks, ts.off_cols, *map(torch.from_numpy, vecs),
        torch.from_numpy(su), torch.from_numpy(d) if with_d else None,
        mirror=mirror, mirror_src=ts.mirror_src)
    _check_dir(got, want, vecs)


def test_sym_dir_plain_matches_pallas_off_band(poisson):
    """2-D Poisson 24 x 24 at 128 x 128 tiles; the general landing."""
    js, ts = poisson[0]["sym"]
    vecs, su, _ = _dir_inputs(js.padded_shape[1] // 128, 2)
    want = jk.sym_minres_dir_spmv_dot(
        js.diag_blocks, js.off_blocks, js.off_cols, *map(jnp.asarray, vecs), jnp.asarray(su),
        interpret=True, mirror="scatter")
    got = tk.sym_minres_dir_spmv_dot(
        ts.diag_blocks, ts.off_blocks, ts.off_cols, *map(torch.from_numpy, vecs),
        torch.from_numpy(su), mirror="scatter", mirror_src=ts.mirror_src)
    _check_dir(got, want, vecs)


@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("rows", [8, 16])
def test_update_plain_matches_pallas(rows, with_d):
    rng = np.random.default_rng(rows)
    q, r1, r2 = (rng.standard_normal((rows, 128)).astype(np.float32) for _ in range(3))
    d = (0.5 + rng.random((rows, 128))).astype(np.float32)
    c1, ia = np.full((1, 1), 0.4, np.float32), np.full((1, 1), 0.9, np.float32)
    want_y, want_b = jk.minres_update_dot(
        jnp.asarray(q), jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(c1), jnp.asarray(ia),
        inv_diag2d=jnp.asarray(d) if with_d else None, interpret=True)
    r1t = torch.from_numpy(r1.copy())
    got_y, got_b = tk.minres_update_dot(
        torch.from_numpy(q), r1t, torch.from_numpy(r2), torch.from_numpy(c1),
        torch.from_numpy(ia), torch.from_numpy(d) if with_d else None, out=r1t)
    assert got_y.data_ptr() == r1t.data_ptr()  # written over r1, as the solver does
    scale = max(np.abs(q).max(), np.abs(r1).max(), np.abs(r2).max())
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(float(got_b), float(want_b[0, 0]), rtol=1e-5)


def test_wrappers_validate_their_operands(banded):
    _, tb = banded[0]["full"]
    _, ts = banded[0]["sym"]
    vecs, su, d = _dir_inputs(tb.nrb, 3)
    vecs, su = [torch.from_numpy(v) for v in vecs], torch.from_numpy(su)
    new = lambda: torch.empty_like(vecs[0])  # noqa: E731
    with pytest.raises(ValueError, match="alias"):  # v over r2, which other rows gather
        tk.minres_dir_spmv_dot(tb.blocks, tb.block_cols, *vecs, su, out=(vecs[0], new(), new(), new()))
    with pytest.raises(ValueError, match="alias"):  # w_new over w-1
        tk.minres_dir_spmv_dot(tb.blocks, tb.block_cols, *vecs, su, out=(new(), new(), vecs[3], new()))
    out = (vecs[2], new(), vecs[4], vecs[5])  # the solver's in-place buffers
    ref = tk.minres_dir_spmv_dot(tb.blocks, tb.block_cols, *(v.clone() for v in vecs), su)
    got = tk.minres_dir_spmv_dot(tb.blocks, tb.block_cols, *vecs, su, out=out)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)) and got[0] is vecs[2]
    with pytest.raises(ValueError, match="mirror"):
        tk.sym_minres_dir_spmv_dot(ts.diag_blocks, ts.off_blocks, ts.off_cols, *vecs, su,
                                   mirror="split", mirror_src=ts.mirror_src)
    with pytest.raises(ValueError, match=r"\(1, 8\)"):
        tk.minres_dir_spmv_dot(tb.blocks, tb.block_cols, *vecs, su[:, :6])
    with pytest.raises(TypeError, match="float32"):
        tk.minres_dir_spmv_dot(tb.blocks.double(), tb.block_cols, *vecs, su)
    with pytest.raises(ValueError, match="one float32"):
        tk.minres_update_dot(vecs[0], vecs[1], vecs[2], su, su[:, :1])


# ---- one step from a carried state ----------------------------------------------------

_SCALARS = ("beta", "oldb", "dbar", "epsln", "phibar", "cs", "sn",
            "p_oldeps", "p_delta", "p_igamma", "p_phi")
_SLOTS = dict(zip(_SCALARS, (tk.M_BETA, tk.M_OLDB, tk.M_DBAR, tk.M_EPSLN, tk.M_PHIBAR,
                             tk.M_CS, tk.M_SN, tk.SU_OLDEPS, tk.SU_DELTA, tk.SU_IGAMMA,
                             tk.SU_PHI)))


def _carry(js_state, tol, shift, d2d):
    f = {fld.name: np.asarray(getattr(js_state, fld.name)) for fld in dataclasses.fields(js_state)}
    return convert.fused_minres_state_from_arrays(
        f["x"], f["r1"], f["r2"], f["vprev"], f["wm1"], f["wm2"],
        *(f[name] for name in _SCALARS), int(f["k"]), bool(f["done"]), bool(f["nan"]),
        f["hist"], tol=tol, shift=shift, inv_diag2d=d2d, device="cpu")


@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("storage", ["full", "sym"])
def test_one_step_from_a_carried_state(banded, storage, with_d):
    ops, n = banded
    jop, top = ops[storage]
    mp = jop.padded_shape[1]
    shift, tol = 0.4, 1e-7
    d2d = None
    if with_d:
        d = np.ones(mp, np.float32)
        d[:n] = 1.0 / np.asarray(jop.diagonal())
        d2d = d.reshape(-1, 128)
    jd = None if d2d is None else jnp.asarray(d2d)
    shift2, tol_j = jnp.full((1, 1), shift, jnp.float32), jnp.asarray(tol, jnp.float32)
    s = jfm.fused_minres_init(jop, jnp.asarray(_rhs(n)), None, 8, jd, shift2, tol=tol_j)
    for _ in range(3):  # a state with a pending update and v_{k-1} terms
        s = jfm.fused_minres_step(jop, s, tol_j, shift2, inv_diag2d=jd, interpret=True)
    ts = _carry(s, tol, shift, d2d)
    s = jfm.fused_minres_step(jop, s, tol_j, shift2, inv_diag2d=jd, interpret=True)
    ts = tfm.fused_minres_step(top, ts)
    assert int(ts.k) == int(s.k) == 4 and bool(ts.done) == bool(s.done) is False
    for name in ("x", "r1", "r2", "vprev", "wm1", "wm2"):
        want = np.asarray(getattr(s, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1e-3), err_msg=name)
    for name, slot in _SLOTS.items():
        np.testing.assert_allclose(float(ts.work.scal[slot]), float(getattr(s, name)[0, 0]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(ts.hist.numpy()[:5], np.asarray(s.hist)[:5], rtol=1e-4)
    assert np.isnan(ts.hist.numpy()[5:]).all()


# ---- whole solves ---------------------------------------------------------------------

@pytest.mark.parametrize("shift,rtol", [(0.0, 2e-3), (1.5, 5e-3)], ids=["spd", "indefinite"])
@pytest.mark.parametrize("storage", ["full", "sym"])
def test_solve_trajectory_matches_jax(banded, storage, shift, rtol):
    ops, n = banded
    jop, top = ops[storage]
    b = _rhs(n)
    _, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=0.0, maxiter=24, shift=shift,
                                   interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), tol=0.0, maxiter=24, shift=shift)
    assert int(it.iterations) == int(ij.iterations) == 24 and not bool(it.converged)
    np.testing.assert_allclose(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history), rtol=rtol)
    h = it.rnorm_history.numpy()
    # at the f32 floor the true residual is roundoff: 1e-6·φ̄₀ absolute
    np.testing.assert_allclose(float(it.rnorm_true), float(ij.rnorm_true), rtol=1e-2,
                               atol=1e-6 * h[0])
    assert np.all(np.diff(h) <= 1e-6 * h[0])  # monotone, indefinite or not


@pytest.mark.parametrize("storage", ["full", "sym"])
def test_solve_to_tolerance_matches_jax(poisson, storage):
    ops, n = poisson
    jop, top = ops[storage]
    b = _rhs(n)
    xj, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=1e-4, interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), tol=1e-4)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert bool(it.converged) and bool(ij.converged) and abs(kt - kj) <= max(4, kj // 20)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)
    assert float(it.rnorm) <= 1e-4 and np.isnan(it.rnorm_history.numpy()[kt + 1:]).all()
    assert float(it.rnorm_true) <= 10 * max(float(ij.rnorm_true), 1e-4)
    # and against the port's own portable loop on the same operator
    xp, ip = minres_solve(top, torch.from_numpy(b), tol=1e-4, fused="never")
    assert abs(kt - int(ip.iterations)) <= max(4, kt // 20)
    np.testing.assert_allclose(xt.numpy(), xp.numpy(), rtol=1e-3, atol=1e-4)


def test_sym_storage_follows_full_storage(banded):
    ops, n = banded
    b = torch.from_numpy(_rhs(n))
    _, i_full = fused_minres_solve(ops["full"][1], b, tol=0.0, maxiter=24)
    _, i_sym = fused_minres_solve(ops["sym"][1], b, tol=0.0, maxiter=24)
    np.testing.assert_allclose(i_sym.rnorm_history.numpy(), i_full.rnorm_history.numpy(),
                               rtol=2e-3)


def test_jacobi_solve_matches_jax():
    ops, n = _operators(banded_spd_coo(600, bandwidth=5, seed=9))
    jop, top = ops["full"]
    b = _rhs(n)
    jM, tM = jcg.jacobi_preconditioner(jop), jacobi_preconditioner(top)
    _, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=0.0, maxiter=24,
                                   inv_diag=jM.inv_diag, interpret=True)
    _, it = fused_minres_solve(top, torch.from_numpy(b), tol=0.0, maxiter=24,
                               inv_diag=tM.inv_diag)
    np.testing.assert_allclose(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history), rtol=2e-3)
    xj, _ = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=1e-5, inv_diag=jM.inv_diag,
                                   interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), tol=1e-5, inv_diag=tM.inv_diag)
    assert bool(it.converged)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("cap", [1, 2, 7])
def test_cap_flushes_the_pending_update(poisson, cap):
    """Leaving at the cap still applies the last iteration's hoisted
    solution update: x equals the portable loop's at the same cap."""
    ops, n = poisson
    jop, top = ops["full"]
    b = _rhs(n)
    xj, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=0.0, maxiter=cap, interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), tol=0.0, maxiter=cap)
    xp, _ = minres_solve(top, torch.from_numpy(b), tol=0.0, maxiter=cap, fused="never")
    assert int(it.iterations) == int(ij.iterations) == cap
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.numpy(), xp.numpy(), rtol=1e-4, atol=1e-6)


def test_zero_rhs_and_x0(poisson):
    ops, n = poisson
    jop, top = ops["full"]
    x, info = fused_minres_solve(top, torch.zeros(n), tol=1e-30)
    assert int(info.iterations) == 0 and bool(info.converged) and not x.any()
    b = _rhs(n)
    x0 = (0.01 * np.random.default_rng(5).standard_normal(n)).astype(np.float32)
    xj, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), jnp.asarray(x0), tol=0.0, maxiter=16,
                                    interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), torch.from_numpy(x0), tol=0.0,
                                maxiter=16)
    np.testing.assert_allclose(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history), rtol=2e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-5)


def test_steps_past_the_end_change_nothing(poisson, monkeypatch):
    """The loop launches steps after ``done`` until its next host read; they
    are no-ops, and ``settle`` gives the traded buffers their names back: a
    solve that reads the flag every step gives the same bits."""
    from conjugategradient_tpu_torch.solver import restart

    ops, n = poisson
    b = torch.from_numpy(_rhs(n))
    x32, i32 = fused_minres_solve(ops["sym"][1], b, tol=1e-3)
    monkeypatch.setattr(restart, "CHECK_EVERY", 1)
    x1, i1 = fused_minres_solve(ops["sym"][1], b, tol=1e-3)
    k = int(i1.iterations)
    assert bool(i1.converged) and int(i32.iterations) == k and k % 32 not in (0, 31)
    assert torch.equal(i32.rnorm_history.view(torch.int32), i1.rnorm_history.view(torch.int32))
    assert torch.equal(x32, x1)


def test_dispatch_and_support_gate(poisson):
    ops, n = poisson
    _, top = ops["full"]
    b = torch.from_numpy(_rhs(n))
    assert not fused_minres_supported(top, dtype=torch.float32)  # CPU tensors
    x, info = minres_solve(top, b, tol=1e-4)  # auto on the CPU: the portable loop
    assert bool(info.converged)
    with pytest.raises(ValueError, match="fused='always'"):
        minres_solve(top, b, tol=1e-4, fused="always")
    with pytest.raises(TypeError, match="blocked-ELL"):
        fused_minres_solve(torch.eye(4), torch.ones(4))
