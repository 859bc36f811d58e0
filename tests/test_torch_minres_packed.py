"""Kernels 14 and 15 of the fused MINRES iteration on the packed nonzeros of
sparse tiles (``minres_dir_spmv_dot_packed`` on ``BlockedEllMatrix.packed()``
and on ``SymBellMatrix.packed()``, the view of D + U + Uᵀ), and the route of
``fused_minres_step`` that takes them, in the port against the JAX package
(CPU).

On the card a float32 operator whose tiles are mostly empty takes the
packed kernel in either storage; here the same rule
(``ops/spmv.bell_packed_route``) sends it to the kernel's plain version, so
these tests run the route the card takes.  Same numpy inputs on both sides;
the JAX Pallas kernels run in interpret mode.  Tolerances, with their
reasons (XLA:CPU contracts multiply-add pairs into FMAs where the port
rounds every product and sum on its own, and the packed product sums a row
in another order than the tiles), those of ``tests/test_torch_fused_minres.py``:

* v: 1e-6 relative; w_new and x_new: 1e-6 of the largest operand;
* q: 2e-5 of max|q|; the dots v·q and v·r1: 1e-4 relative;
* the packed against the tile plain versions: v, w_new and x_new bit for
  bit (the same elementwise ops; only the product differs);
* the symmetric view's product against ``sym_bell_spmv`` and the dense
  product: 1e-5 of max|y| (another summation order);
* whole solves: ``rnorm_history`` to rtol 2e-3 over 24 steps and the
  iteration count at a tolerance within max(4, 5%), x to rtol 1e-3 /
  atol 1e-4.
"""

import os

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
from conjugategradient_tpu_torch import convert, fused_minres_solve, jacobi_preconditioner
from conjugategradient_tpu_torch.io import read_csr_host
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import fused_minres as tk
from conjugategradient_tpu_torch.ops.cuda.bell_spmv import packed_apply
from conjugategradient_tpu_torch.ops.spmv import bell_apply, bell_packed_route, sym_bell_spmv
from conjugategradient_tpu_torch.problems import block_tridiag_tiles, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import fused_minres as tfm
from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix
from conjugategradient_tpu_torch.types.bell import PACK_CHUNK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_SPMV = 1e-5


def _poisson34():
    data, indices, indptr, shape = read_csr_host(os.path.join(ROOT, "problems/poisson2d_34.mtx"))
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    return rows, indices, data, shape


COO = {"p24": lambda: poisson2d_coo(24), "p34mtx": _poisson34}


def _operators(name, bn):
    """The JAX and port operators of one problem at bn x bn tiles, in both
    storages: {"full": (jax, port), "sym": (jax, port)}, and the host CSR."""
    rows, cols, vals, shape = COO[name]()
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32), bm=bn, bn=bn)
    js = JSym.from_bell(jb)
    tb = convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols), jb.shape,
                                  jb.nnz, device="cpu")
    ts = convert.sym_bell_from_arrays(
        np.asarray(js.diag_blocks), np.asarray(js.off_blocks), np.asarray(js.off_cols),
        js.shape, js.nnz, js.full_kmax, js.banded, device="cpu")
    return {"full": (jb, tb), "sym": (js, ts)}, (rows, cols, np.asarray(vals, np.float32), shape)


_CACHE = {}


def operators(name, bn):
    if (name, bn) not in _CACHE:
        _CACHE[(name, bn)] = _operators(name, bn)
    return _CACHE[(name, bn)]


CASES = [(name, bn) for name in COO for bn in (32, 128)]
IDS = [f"{name}-bn{bn}" for name, bn in CASES]

SU = (0.31, 0.11, 0.23, 0.57, 0.83)  # 1/β, ε̄, δ̄, 1/γ̄, φ̄


def _inputs(nrb, bn, seed, shift, first):
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal((nrb, bn)).astype(np.float32) for _ in range(6)]
    su = np.zeros((1, 8), np.float32)
    su[0, tk.SU_INV_BETA], su[0, tk.SU_SHIFT] = SU[0], shift
    if not first:
        su[0, tk.SU_OLDEPS], su[0, tk.SU_DELTA], su[0, tk.SU_IGAMMA], su[0, tk.SU_PHI] = SU[1:]
    d = (0.5 + rng.random((nrb, bn))).astype(np.float32)
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


def _unpack(pk):
    """The view's rows as [(columns, values)], in the order a row sums."""
    out = []
    for r in range(pk.rows):
        e = int(pk.chunk_off[r // PACK_CHUNK]) + r % PACK_CHUNK + PACK_CHUNK * np.arange(
            int(pk.row_len[r]))
        out.append((pk.cols.numpy()[e], pk.vals.numpy()[e]))
    return out


# ---- the symmetric view ---------------------------------------------------------------

@pytest.mark.parametrize("name,bn", CASES, ids=IDS)
def test_symmetric_view_equals_the_csr(name, bn):
    """``SymBellMatrix.packed()`` holds every nonzero of D + U + Uᵀ, each
    row's in ascending column, exact zeros and padding dropped: the host
    CSR's rows, entry for entry."""
    ops, (rows, cols, vals, shape) = operators(name, bn)
    ts = ops["sym"][1]
    pk = ts.packed()
    assert pk.symmetric and pk.rows == pk.ncols == ts.padded_shape[0]
    keep = vals != 0
    order = np.lexsort((cols[keep], rows[keep]))
    r, c, v = rows[keep][order], cols[keep][order], vals[keep][order]
    assert pk.nnz == len(v)
    bounds = np.searchsorted(r, np.arange(pk.rows + 1))
    got = _unpack(pk)
    for i in range(pk.rows):
        lo, hi = bounds[i], bounds[i + 1]
        np.testing.assert_array_equal(got[i][0], c[lo:hi], err_msg=f"row {i} columns")
        np.testing.assert_array_equal(got[i][1], v[lo:hi], err_msg=f"row {i} values")
    # each chunk is as wide as its longest row; past a row's length, zeros
    width = np.diff(pk.chunk_off.numpy()) // PACK_CHUNK
    lens = np.pad(pk.row_len.numpy(), (0, len(width) * PACK_CHUNK - pk.rows))
    np.testing.assert_array_equal(width, lens.reshape(-1, PACK_CHUNK).max(axis=1))
    assert int((pk.vals != 0).sum()) == pk.nnz


@pytest.mark.parametrize("name,bn", CASES, ids=IDS)
def test_symmetric_view_product_matches_sym_bell_spmv(name, bn):
    ops, (rows, cols, vals, shape) = operators(name, bn)
    ts = ops["sym"][1]
    x = torch.from_numpy(np.random.default_rng(bn).standard_normal(ts.padded_shape[0])
                         .astype(np.float32))
    y = packed_apply(ts.packed(), x)
    ref = sym_bell_spmv(ts, x[:ts.n])
    np.testing.assert_allclose(y[:ts.n].numpy(), ref.numpy(), rtol=0,
                               atol=RTOL_SPMV * float(ref.abs().max()))
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    want = dense @ x[:ts.n].double().numpy()
    np.testing.assert_allclose(y[:ts.n].numpy(), want, rtol=0, atol=RTOL_SPMV * np.abs(want).max())
    assert not y[ts.n:].any()  # padding rows


def test_symmetric_view_is_cached_and_rebuilt_after_a_change():
    ops, _ = operators("p24", 32)
    src = ops["sym"][1]  # a copy of its own: the change below stays here
    ts = SymBellMatrix(src.diag_blocks.clone(), src.off_blocks.clone(), src.off_cols.clone(),
                       src.shape, src.nnz, src.full_kmax, src.banded)
    before = _common.LAUNCHES["bell_pack"]
    pk = ts.packed()
    assert ts.packed() is pk and _common.LAUNCHES["bell_pack"] == before + 1
    ts.off_blocks.mul_(2.0)
    pk2 = ts.packed()
    assert pk2 is not pk and _common.LAUNCHES["bell_pack"] == before + 2
    # the mirrored entries changed with their stored ones, the diagonal did not
    assert torch.equal(pk2.cols, pk.cols)
    diag_col = pk.cols.long() // 32 == _rows_of(pk) // 32  # an entry of a diagonal tile
    assert torch.equal(pk2.vals[diag_col], pk.vals[diag_col])
    assert torch.equal(pk2.vals[~diag_col], 2.0 * pk.vals[~diag_col])
    ts.diag_blocks.add_(1.0)
    assert ts.packed() is not pk2 and _common.LAUNCHES["bell_pack"] == before + 3


def _rows_of(pk):
    """The row of every entry slot of the view."""
    rows = torch.zeros(pk.vals.numel(), dtype=torch.long)
    for r in range(pk.rows):
        e = int(pk.chunk_off[r // PACK_CHUNK]) + r % PACK_CHUNK
        rows[e: int(pk.chunk_off[r // PACK_CHUNK + 1]): PACK_CHUNK] = r
    return rows


# ---- the packed plain versions against the Pallas kernels ------------------------------

@pytest.mark.parametrize("first", [False, True], ids=["pending", "first-step"])
@pytest.mark.parametrize("shift", [0.0, 0.07], ids=["shift0", "shift"])
@pytest.mark.parametrize("with_d", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("storage", ["full", "sym"])
@pytest.mark.parametrize("name,bn", CASES, ids=IDS)
def test_packed_dir_matches_jax(name, bn, storage, with_d, shift, first):
    """Kernel 14 (full storage's view) against the JAX ``minres_dir_spmv_dot``
    and kernel 15 (the symmetric view) against the JAX
    ``sym_minres_dir_spmv_dot(mirror="scatter")``."""
    ops, _ = operators(name, bn)
    jop, top = ops[storage]
    assert bell_packed_route(top)
    nrb = top.padded_shape[0] // bn
    vecs, su, d = _inputs(nrb, bn, nrb + bn, shift, first)
    jd = jnp.asarray(d) if with_d else None
    if storage == "full":
        want = jk.minres_dir_spmv_dot(jop.blocks, jop.block_cols, *map(jnp.asarray, vecs),
                                      jnp.asarray(su), inv_diag2d=jd, interpret=True)
    else:
        want = jk.sym_minres_dir_spmv_dot(jop.diag_blocks, jop.off_blocks, jop.off_cols,
                                          *map(jnp.asarray, vecs), jnp.asarray(su),
                                          inv_diag2d=jd, interpret=True, mirror="scatter")
    pk = top.packed()
    before = {k: n for k, n in _common.LAUNCHES.items() if k != "bell_pack"}
    got = tk.minres_dir_spmv_dot_packed(pk, *map(torch.from_numpy, vecs), torch.from_numpy(su),
                                        torch.from_numpy(d) if with_d else None)
    # CPU tensors: the plain version ran
    assert {k: n for k, n in _common.LAUNCHES.items() if k != "bell_pack"} == before
    _check_dir(got, want, vecs)
    if first:  # no pending update: x kept bit for bit, w = 0
        assert np.array_equal(got[3].numpy(), vecs[5]) and not got[2].any()


@pytest.mark.parametrize("storage", ["full", "sym"])
def test_packed_and_tile_plain_versions_agree_bitwise(storage):
    """One plain body for the three forms: the packed and the tile versions
    differ only in the product, so v, w_new and x_new are the same bits."""
    ops, _ = operators("p24", 128)
    _, top = ops[storage]
    vecs, su, d = _inputs(top.nrb, 128, 4, 0.07, False)
    vecs, su, d = [torch.from_numpy(v) for v in vecs], torch.from_numpy(su), torch.from_numpy(d)
    kp = tk.minres_dir_spmv_dot_packed(top.packed(), *vecs, su, d)
    if storage == "full":
        kd = tk.minres_dir_spmv_dot(top.blocks, top.block_cols, *vecs, su, d)
    else:
        kd = tk.sym_minres_dir_spmv_dot(top.diag_blocks, top.off_blocks, top.off_cols, *vecs,
                                        su, d, mirror="scatter", mirror_src=top.mirror_src)
    for i in (0, 2, 3):
        assert torch.equal(kp[i], kd[i])
    torch.testing.assert_close(kp[1], kd[1], rtol=0, atol=2e-5 * float(kd[1].abs().max()))


# ---- the route ------------------------------------------------------------------------

def _tridiag(n=13 * 32, bn=32):
    """Dense block-tridiagonal tiles (the bench operator's generator) in both
    storages: the dense route."""
    blocks, cols, nnz = block_tridiag_tiles(n, bn, bn, seed=1)
    tb = BlockedEllMatrix(torch.from_numpy(blocks), torch.from_numpy(cols), (n, n), nnz)
    return tb, SymBellMatrix.from_bell(tb)


def test_route_rule_on_both_storages():
    for name, bn in CASES:
        ops, _ = operators(name, bn)
        for storage in ("full", "sym"):
            top = ops[storage][1]
            assert bell_packed_route(top), (name, bn, storage)
            assert not bell_packed_route(top.astype(torch.float64))
    tb, ts = _tridiag()
    assert ts.banded and not bell_packed_route(tb) and not bell_packed_route(ts)
    # the n = 262,144 bench operator at its own shapes (meta tensors: the
    # rule reads shapes and nnz only)
    n, bn, nrb = 262_144, 128, 2048
    nnz = nrb * 3 * bn * bn
    meta = dict(device="meta")
    big_full = BlockedEllMatrix(torch.empty(nrb, 3, bn, bn, **meta),
                                torch.empty(nrb, 3, dtype=torch.int32, **meta), (n, n), nnz)
    big_sym = SymBellMatrix(torch.empty(nrb, bn, bn, **meta), torch.empty(nrb, 1, bn, bn, **meta),
                            torch.empty(nrb, 1, dtype=torch.int32, **meta), (n, n), nnz, 3, True,
                            torch.empty(nrb, 1, dtype=torch.int32, **meta))
    assert not bell_packed_route(big_full) and not bell_packed_route(big_sym)


def _spy(monkeypatch):
    calls = []
    for name in ("minres_dir_spmv_dot", "minres_dir_spmv_dot_packed", "sym_minres_dir_spmv_dot",
                 "minres_update_dot"):
        fn = getattr(tfm, name)
        monkeypatch.setattr(tfm, name, lambda *a, _fn=fn, _name=name, **k: (
            calls.append(_name), _fn(*a, **k))[1])
    return calls


@pytest.mark.parametrize("case", ["poisson full", "poisson sym", "tridiag full", "tridiag sym"])
def test_step_routes_by_tile_fill(case, monkeypatch):
    """``fused_minres_step`` calls the packed kernel on sparse tiles in
    either storage and the tile kernels on dense ones, kernel 16 either
    way."""
    kind, storage = case.split()
    if kind == "poisson":
        top = operators("p24", 128)[0][storage][1]
    else:
        top = _tridiag()[storage == "sym"]
    calls = _spy(monkeypatch)
    b = torch.from_numpy(reference_rhs(top.n, dtype=np.float32) / top.n)
    state = tfm.fused_minres_init(top, b, None, 3)
    for _ in range(3):
        tfm.fused_minres_step(top, state)
    k1 = ("minres_dir_spmv_dot_packed" if kind == "poisson" else
          "minres_dir_spmv_dot" if storage == "full" else "sym_minres_dir_spmv_dot")
    assert calls == [k1, "minres_update_dot"] * 3
    assert int(state.k) == 3 and np.isfinite(state.hist.numpy()).all()


def test_packed_step_ignores_mirror_but_refuses_banded_off_band():
    ops, _ = operators("p34mtx", 32)
    ts = ops["sym"][1]
    assert not ts.banded
    b = torch.from_numpy(reference_rhs(ts.n, dtype=np.float32) / ts.n)
    hists = []
    for mirror in ("auto", "scatter"):
        state = tfm.fused_minres_init(ts, b, None, 4)
        for _ in range(4):
            tfm.fused_minres_step(ts, state, mirror=mirror)
        hists.append(state.hist.clone())
    assert torch.equal(hists[0], hists[1])
    state = tfm.fused_minres_init(ts, b, None, 4)
    with pytest.raises(ValueError, match="block-tridiagonal"):
        tfm.fused_minres_step(ts, state, mirror="banded")


def test_one_pack_per_operator_over_a_solve():
    """A solve builds each storage's view once (every step reads it), and a
    second solve on the same operator none."""
    ops, _ = operators("p34mtx", 128)
    b = torch.from_numpy(reference_rhs(ops["full"][1].n, dtype=np.float32))
    for storage in ("full", "sym"):
        top = ops[storage][1]
        top.__dict__.pop("_packed", None)
        before = _common.LAUNCHES["bell_pack"]
        fused_minres_solve(top, b, tol=0.0, maxiter=10)
        fused_minres_solve(top, b, tol=0.0, maxiter=5)
        assert _common.LAUNCHES["bell_pack"] == before + 1


# ---- whole solves against the JAX fused solve ----------------------------------------

@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("storage", ["full", "sym"])
def test_fused_solve_matches_jax(storage, precond, monkeypatch):
    ops, _ = operators("p24", 128)
    jop, top = ops[storage]
    n = top.n
    b = (reference_rhs(n).astype(np.float32) / n).astype(np.float32)
    jd = td = None
    if precond == "jacobi":
        jd, td = jcg.jacobi_preconditioner(jop).inv_diag, jacobi_preconditioner(top).inv_diag
    calls = _spy(monkeypatch)
    _, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=0.0, maxiter=24, inv_diag=jd,
                                   interpret=True)
    _, it = fused_minres_solve(top, torch.from_numpy(b), tol=0.0, maxiter=24, inv_diag=td)
    assert calls.count("minres_dir_spmv_dot_packed") == 24 and len(set(calls)) == 2
    assert int(it.iterations) == int(ij.iterations) == 24
    np.testing.assert_allclose(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history), rtol=2e-3)
    tol = 1e-4 * float(np.linalg.norm(b))
    xj, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=tol, inv_diag=jd, interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), tol=tol, inv_diag=td)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert bool(it.converged) and bool(ij.converged) and abs(kt - kj) <= max(4, kj // 20)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)


def test_storages_agree_on_the_packed_route():
    """Both views hold the same operator, in other row orders: the two
    storages' solves follow one trajectory."""
    ops, _ = operators("p34mtx", 32)
    b = torch.from_numpy(reference_rhs(ops["full"][1].n, dtype=np.float32))
    _, i_full = fused_minres_solve(ops["full"][1], b, tol=0.0, maxiter=24, shift=0.5)
    _, i_sym = fused_minres_solve(ops["sym"][1], b, tol=0.0, maxiter=24, shift=0.5)
    np.testing.assert_allclose(i_sym.rnorm_history.numpy(), i_full.rnorm_history.numpy(),
                               rtol=2e-3)


# ---- operand checks -------------------------------------------------------------------

def test_packed_wrapper_refuses_bad_operands():
    ops, _ = operators("p24", 32)
    tb, ts = ops["full"][1], ops["sym"][1]
    vecs, su, d = _inputs(tb.nrb, 32, 9, 0.07, False)
    vecs, su = [torch.from_numpy(v) for v in vecs], torch.from_numpy(su)
    new = lambda: torch.empty_like(vecs[0])  # noqa: E731
    for pk in (tb.packed(), ts.packed()):
        with pytest.raises(ValueError, match="alias"):  # v over r2, which other rows gather
            tk.minres_dir_spmv_dot_packed(pk, *vecs, su, out=(vecs[0], new(), new(), new()))
        with pytest.raises(ValueError, match="alias"):  # w_new over w-1
            tk.minres_dir_spmv_dot_packed(pk, *vecs, su, out=(new(), new(), vecs[3], new()))
        with pytest.raises(ValueError, match="distinct"):
            q = new()
            tk.minres_dir_spmv_dot_packed(pk, *vecs, su, out=(new(), q, q, new()))
        with pytest.raises(ValueError, match=r"\(1, 8\)"):
            tk.minres_dir_spmv_dot_packed(pk, *vecs, su[:, :6])
        with pytest.raises(ValueError, match="entries"):
            tk.minres_dir_spmv_dot_packed(pk, *(v[:-1] for v in vecs), su)
        with pytest.raises(ValueError, match="vectors"):
            tk.minres_dir_spmv_dot_packed(pk, *vecs[:5], vecs[5].double(), su)
        ref = tk.minres_dir_spmv_dot_packed(pk, *(v.clone() for v in vecs), su)
        mine = [v.clone() for v in vecs]
        out = (mine[2], new(), mine[4], mine[5])  # the solver's in-place buffers
        got = tk.minres_dir_spmv_dot_packed(pk, *mine, su, out=out)
        assert all(torch.equal(a_, b_) for a_, b_ in zip(got, ref)) and got[0] is mine[2]
    with pytest.raises(TypeError, match="float32"):
        tk.minres_dir_spmv_dot_packed(ts.astype(torch.float64).packed(), *vecs, su)
    rect = BlockedEllMatrix(tb.blocks[:-1].clone(), tb.block_cols[:-1].clone(),
                            ((tb.nrb - 1) * 32, tb.shape[1]), tb.nnz)
    with pytest.raises(ValueError, match="square"):
        tk.minres_dir_spmv_dot_packed(rect.packed(), *(v[:-1] for v in vecs), su)


def test_plain_product_is_bell_apply_on_full_storage():
    """Kernel 14's view computes what the tiles compute (the tile plain
    product) to RTOL_SPMV."""
    ops, _ = operators("p34mtx", 128)
    tb = ops["full"][1]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((tb.nrb, 128))
                         .astype(np.float32))
    y = packed_apply(tb.packed(), x.reshape(-1)).reshape(x.shape)
    ref = bell_apply(tb.blocks, tb.block_cols, x)
    torch.testing.assert_close(y, ref, rtol=0, atol=RTOL_SPMV * float(ref.abs().max()))
