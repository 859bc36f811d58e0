"""The bfloat16 forms of kernels 10 (symmetric DIA), 14 and 15 (fused
MINRES, full and symmetric storage, dense and packed) and 17 (the
row-sharded MINRES shard kernel) against the JAX package, on the CPU: each
plain version on bf16 operators with float32 vectors against the Pallas
kernel in interpret mode on the same bf16 operator, the paths that reach
them (fused MINRES, sharded MINRES, the tester's bf16 SymDIA and MINRES
runs) against the JAX ones, and the fused MINRES gate against the JAX gate.

Widening bf16 to float32 is exact, so the bounds are the float32 tests'
(tests/test_torch_dia.py, tests/test_torch_fused_minres.py,
tests/test_torch_sharded_fused.py), with their reasons (XLA:CPU contracts
multiply-add pairs into FMAs where the port rounds each product and sum,
and sums run in another order):

* DIA: y to 1e-5 of max|y|;
* MINRES kernel 1: v 1e-6 relative, q 2e-5 of max|q|, w and x' 1e-6 of the
  largest operand, the dots 1e-4 relative;
* whole fused solves: ``rnorm_history`` rtol 2e-3 over 24 steps, x rtol
  1e-3 (of max|x| for the sharded solve);
* the tester: dim and nnz equal, both converged, rel_error under the bound
  of the run (bf16 SymDIA CG 5e-3 as in tests/test_torch_tester.py; bf16
  MINRES 1e-2: measured 5.9e-3 against the JAX tester's 6.4e-3), inner
  iterations within 15% (bfloat16 vector arithmetic rounds at other places
  in XLA).
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conjugategradient_tpu.ops.pallas import dia_spmv as jk_dia
from conjugategradient_tpu.ops.pallas import fused_minres as jk
from conjugategradient_tpu.parallel import sharded_cg_solve as jsharded
from conjugategradient_tpu.solver import fused_minres as jfm
from conjugategradient_tpu.types import BlockedEllMatrix as JBell
from conjugategradient_tpu.types import CSRMatrix as JCSR
from conjugategradient_tpu.types import DIAMatrix as JDIA
from conjugategradient_tpu.types import SymBellMatrix as JSym
from conjugategradient_tpu.types import SymDIAMatrix as JSymDIA
from conjugategradient_tpu_torch import convert, fused_minres_solve, fused_minres_supported
from conjugategradient_tpu_torch import tester
from conjugategradient_tpu_torch.ops import spmv as tspmv
from conjugategradient_tpu_torch.ops.cuda import _common
from conjugategradient_tpu_torch.ops.cuda import dia_spmv as tk_dia
from conjugategradient_tpu_torch.ops.cuda import fused_minres as tk
from conjugategradient_tpu_torch.parallel import make_row_mesh, partition_csr_rows, sharded_cg_solve
from conjugategradient_tpu_torch.problems import banded_spd_coo, poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.types import BlockedEllMatrix, SymBellMatrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
MTX = str(ROOT / "problems" / "poisson2d_34.mtx")
BF16 = torch.bfloat16


def _same_bf16(tt, jt):
    """The port's bf16 tensor holds the JAX one's bits."""
    assert tt.dtype == BF16 and jt.dtype == jnp.bfloat16
    assert np.array_equal(tt.float().numpy(), np.asarray(jt.astype(jnp.float32)))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# ---- kernel 10 ---------------------------------------------------------------

def _symdia_like(n, offsets, seed):
    """A symmetric half band whose offsets are spaced like symdia-big's
    (0, 1, a few multiples of 32): diagonally dominant, zero past the end."""
    rng = np.random.default_rng(seed)
    diags = (0.1 * rng.standard_normal((len(offsets), n))).astype(np.float32)
    diags[0] = 4.0 + rng.random(n).astype(np.float32)
    for d, k in enumerate(offsets):
        if k:
            diags[d, n - k:] = 0.0
    nnz = n + 2 * sum(n - k for k in offsets if k)
    return diags, offsets, nnz


@pytest.mark.parametrize("n,offsets", [(5001, (0, 1, 32, 96, 1024)), (1001, (0, 3, 300))],
                         ids=["symdia-like", "ragged"])
def test_sym_dia_bf16_matches_pallas(n, offsets):
    """The plain version of kernel 10's bf16 form against
    ``sym_dia_spmv_pallas_blocked`` on the same bf16 diagonals (halo'd
    1024-blocks): float32 y, the promoted dtype; bit-equal to the float32
    version on the widened diagonals; the same route as float32."""
    diags, offsets, nnz = _symdia_like(n, offsets, n)
    js = JSymDIA(jnp.asarray(diags), offsets, (n, n), nnz).astype(jnp.bfloat16)
    ts = convert.sym_dia_from_arrays(diags, offsets, (n, n), nnz, device="cpu").astype(BF16)
    _same_bf16(ts.diags, js.diags)
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x)
    before = dict(_common.LAUNCHES)
    y = tk_dia.sym_dia_spmv_diags(ts.diags, ts.offsets, ts.offsets_dev, xt)
    assert _common.LAUNCHES == before and y.dtype == torch.float32
    assert torch.equal(y, tk_dia.sym_dia_spmv_diags(ts.diags.float(), ts.offsets,
                                                    ts.offsets_dev, xt))
    assert torch.equal(ts.matvec(xt), y)
    blk = js.with_blocked(block_len=1024)
    want = jk_dia.sym_dia_spmv_pallas_blocked(blk.diags_blocked, blk.offsets, jnp.asarray(x),
                                              n=n, hw=blk.blocked_halo, interpret=True)
    assert want.dtype == jnp.float32
    _close(y.numpy(), np.asarray(want), 1e-5)
    # the tiling is chosen from (offsets, n) alone: a bf16 operator's is a
    # float32 one's, and at these sizes both dtypes take the by-value kernel
    assert tk_dia.sym_dia_tiling(ts.offsets, n) == tk_dia.sym_dia_tiling(offsets, n)
    assert tk_dia.sym_dia_route(ts.offsets, n, BF16) == tk_dia.sym_dia_route(offsets, n) \
        == "sym_dia_spmv_rows"


# ---- kernels 14 and 15 ---------------------------------------------------------

def _port_bell(jb):
    return convert.bell_from_arrays(np.asarray(jb.blocks), np.asarray(jb.block_cols),
                                    jb.shape, jb.nnz, device="cpu")


def _port_sym(js):
    return convert.sym_bell_from_arrays(
        np.asarray(js.diag_blocks), np.asarray(js.off_blocks), np.asarray(js.off_cols),
        js.shape, js.nnz, js.full_kmax, js.banded, device="cpu")


def _bf16_operators(coo):
    """Both storages at 128 x 128, float32 packed, then each package's
    astype(bfloat16): the same bits."""
    rows, cols, vals, shape = coo
    jb = JBell.from_csr(JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32),
                        bm=128, bn=128)
    js = JSym.from_bell(jb)
    tb, ts = _port_bell(jb), _port_sym(js)
    jb, js, tb, ts = (jb.astype(jnp.bfloat16), js.astype(jnp.bfloat16), tb.astype(BF16),
                      ts.astype(BF16))
    _same_bf16(tb.blocks, jb.blocks)
    _same_bf16(ts.diag_blocks, js.diag_blocks)
    _same_bf16(ts.off_blocks, js.off_blocks)
    return {"full": (jb, tb), "sym": (js, ts)}, shape[0]


@pytest.fixture(scope="module")
def banded():
    """tests/test_fused_minres.py's banded operator (n = 700, block
    tridiagonal at 128 x 128: dense tiles) in bf16."""
    return _bf16_operators(banded_spd_coo(700, bandwidth=6, seed=3))


@pytest.fixture(scope="module")
def poisson():
    """2-D Poisson 24 x 24 at 128 x 128 in bf16: sparse tiles, the packed
    route, and off-band symmetric tiles (the general landing)."""
    return _bf16_operators(poisson2d_coo(24))


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


def _pallas_dir(jop, vecs, su, d, mirror):
    args = (*map(jnp.asarray, vecs), jnp.asarray(su))
    dj = None if d is None else jnp.asarray(d)
    if isinstance(jop, JSym):
        return jk.sym_minres_dir_spmv_dot(jop.diag_blocks, jop.off_blocks, jop.off_cols, *args,
                                          inv_diag2d=dj, interpret=True, mirror=mirror)
    return jk.minres_dir_spmv_dot(jop.blocks, jop.block_cols, *args, inv_diag2d=dj,
                                  interpret=True)


def _port_dir(top, vecs, su, d, mirror):
    args = (*map(torch.from_numpy, vecs), torch.from_numpy(su))
    dt = None if d is None else torch.from_numpy(d)
    if isinstance(top, SymBellMatrix):
        return tk.sym_minres_dir_spmv_dot(top.diag_blocks, top.off_blocks, top.off_cols, *args,
                                          dt, mirror=mirror, mirror_src=top.mirror_src)
    return tk.minres_dir_spmv_dot(top.blocks, top.block_cols, *args, dt)


@pytest.mark.parametrize("storage,mirror,with_d,first", [
    ("full", None, False, False), ("full", None, True, True),
    ("sym", "banded", False, True), ("sym", "banded", True, False),
    ("sym", "scatter", True, False), ("sym", "scatter", False, True),
], ids=lambda v: str(v))
def test_dir_bf16_matches_pallas(banded, storage, mirror, with_d, first):
    """Kernels 14 and 15's bf16 forms (plain versions) on dense bf16 tiles,
    with and without a Jacobi d, on a first step and a later one; the
    launch counters untouched (CPU tensors)."""
    jop, top = banded[0][storage]
    vecs, su, d = _dir_inputs(top.padded_shape[1] // 128, 7, first)
    d = d if with_d else None
    want = _pallas_dir(jop, vecs, su, d, mirror)
    before = dict(_common.LAUNCHES)
    got = _port_dir(top, vecs, su, d, mirror)
    assert _common.LAUNCHES == before
    _check_dir(got, want, vecs)
    # bit-equal to the float32 plain version on the widened tiles
    ref = _port_dir(top.astype(torch.float32), vecs, su, d, mirror)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if first:  # no pending update: x kept bit for bit, w = 0
        assert np.array_equal(got[3].numpy(), vecs[5]) and not got[2].any()


@pytest.mark.parametrize("storage", ["full", "sym"])
def test_dir_bf16_general_landing_and_packed_match_pallas(poisson, storage):
    """Sparse bf16 tiles: the packed form's plain version (the route these
    tiles take, on ``packed()`` of either storage, bf16 values) and the
    tile form (the general landing on symmetric storage) against the Pallas
    kernel on the same tiles."""
    jop, top = poisson[0][storage]
    assert tspmv.bell_packed_route(top)
    pk = top.packed()
    assert pk.vals.dtype == BF16 and pk.symmetric == (storage == "sym")
    vecs, su, d = _dir_inputs(top.padded_shape[1] // 128, 11)
    want = _pallas_dir(jop, vecs, su, d, "scatter")
    _check_dir(_port_dir(top, vecs, su, d, "scatter"), want, vecs)
    got = tk.minres_dir_spmv_dot_packed(pk, *map(torch.from_numpy, vecs), torch.from_numpy(su),
                                        torch.from_numpy(d))
    _check_dir(got, want, vecs)
    ref = tk.minres_dir_spmv_dot_packed(top.astype(torch.float32).packed(),
                                        *map(torch.from_numpy, vecs), torch.from_numpy(su),
                                        torch.from_numpy(d))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---- kernel 17 -------------------------------------------------------------------

@pytest.mark.parametrize("first", [False, True], ids=["pending", "first-step"])
def test_shard_bf16_matches_pallas(first):
    """Kernel 17's bf16 form (plain version) on one shard of bf16 tiles
    with GLOBAL column blocks, a ragged nrb = 13 at a shard offset that is
    not 0, against the Pallas kernel on the same bf16 tiles."""
    rng = np.random.default_rng(17)
    nrb, bn, n_shards, shard = 13, 128, 2, 1
    blocks = rng.standard_normal((nrb, 3, bn, bn)).astype(np.float32)
    cols = rng.integers(0, n_shards * nrb, (nrb, 3)).astype(np.int32)
    full = rng.standard_normal((n_shards * nrb, bn)).astype(np.float32)
    off = shard * nrb * bn
    r1, vprev, wm1, wm2, x = (rng.standard_normal((nrb, bn)).astype(np.float32)
                              for _ in range(5))
    su = np.zeros((1, 8), np.float32)
    su[0, :6] = SU[:2] + ((0.0,) * 4 if first else SU[2:])
    bj = jnp.asarray(blocks).astype(jnp.bfloat16)
    bt = torch.from_numpy(blocks).to(BF16)
    _same_bf16(bt, bj)
    vec_np = (full, r1, vprev, wm1, wm2, x, su)
    j = jk.minres_shard_spmv_dot(bj, jnp.asarray(cols), *map(jnp.asarray, vec_np),
                                 jnp.asarray([off], jnp.int32), interpret=True)
    t = tk.minres_shard_spmv_dot(bt, torch.from_numpy(cols), *map(torch.from_numpy, vec_np), off)
    _close(t[0], j[0], 2e-5)
    scale = max(np.abs(a).max() for a in (vprev, wm1, wm2, x))
    for i in (1, 2):  # w, x'
        np.testing.assert_allclose(np.asarray(t[i]), np.asarray(j[i]), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(float(t[3]), float(j[3][0, 0]), rtol=1e-4)
    vwin = full[off // bn:off // bn + nrb]
    assert abs(float(t[4]) - float(j[4][0, 0])) <= 1e-4 * np.linalg.norm(vwin) * np.linalg.norm(r1)
    ref = tk.minres_shard_spmv_dot(bt.float(), torch.from_numpy(cols),
                                   *map(torch.from_numpy, vec_np), off)
    assert all(torch.equal(a, b) for a, b in zip(t, ref))


# ---- the paths -------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["full", "sym"])
def test_fused_minres_bf16_solve_matches_jax(banded, storage):
    """fused_minres_solve on bf16 tiles (float32 b) against the JAX fused
    solve on the same tiles: 24 capped steps, then to a tolerance."""
    ops, n = banded
    jop, top = ops[storage]
    b = (reference_rhs(n).astype(np.float32) / n).astype(np.float32)
    _, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=0.0, maxiter=24, interpret=True)
    _, it = fused_minres_solve(top, torch.from_numpy(b), tol=0.0, maxiter=24)
    assert int(it.iterations) == int(ij.iterations) == 24
    np.testing.assert_allclose(it.rnorm_history.numpy(), np.asarray(ij.rnorm_history), rtol=2e-3)
    xj, ij = jfm.fused_minres_solve(jop, jnp.asarray(b), tol=1e-4, interpret=True)
    xt, it = fused_minres_solve(top, torch.from_numpy(b), tol=1e-4)
    assert bool(it.converged) and bool(ij.converged)
    kj, kt = int(ij.iterations), int(it.iterations)
    assert abs(kt - kj) <= max(4, kj // 20)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)


def test_sharded_minres_bf16_matches_jax(monkeypatch):
    """sharded_cg_solve(method="minres") on bf16 shards with float32 b
    (the fused shard loop, use_fused="always": on CPU tensors the plain
    versions) against the JAX one; the shards keep their bf16 dtype."""
    a = sp.csr_matrix(_csr32(banded_spd_coo(1024, bandwidth=5, seed=7)))
    blocks, bcols, _ = partition_csr_rows(a.data, a.indices, a.indptr, a.shape, 8,
                                          bm=128, bn=128)
    bt = torch.from_numpy(blocks).to(BF16)
    bj = jnp.asarray(blocks).astype(jnp.bfloat16)
    _same_bf16(bt, bj)
    b = np.random.default_rng(7).standard_normal(1024).astype(np.float32)
    seen = []
    orig = tk.minres_shard_spmv_dot

    def spy(blk, *args, **kw):
        seen.append(blk.dtype)
        return orig(blk, *args, **kw)

    monkeypatch.setattr(tk, "minres_shard_spmv_dot", spy)
    x, info = sharded_cg_solve(bt, bcols, b, mesh=make_row_mesh(8, "cpu"), tol=0.0,
                               maxiter=24, method="minres", use_fused="always")
    monkeypatch.undo()
    assert seen and set(seen) == {BF16}
    xj, ij = jsharded(bj, jnp.asarray(bcols), jnp.asarray(b), tol=0.0, maxiter=24,
                      method="minres", use_fused="always", interpret=True)
    assert int(info.iterations) == int(ij.iterations) == 24
    np.testing.assert_allclose(np.asarray(info.rho_history), np.asarray(ij.rho_history), rtol=5e-3)
    _close(x, xj, 1e-3)


def _csr32(coo):
    rows, cols, vals, shape = coo
    a = sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a


def _both(capsys, args):
    import tester as jtester

    jrc = jtester.main(args)
    jout = capsys.readouterr()
    trc = tester.main([*args, "--device", "cpu"])
    tout = capsys.readouterr()
    return (jrc, jout.out.strip().splitlines()), (trc, tout.out.strip().splitlines())


@pytest.mark.parametrize("extra,bound", [
    (["--layout", "symdia", "--dtype", "bfloat16", "--tol", "1"], 5e-3),
    (["--layout", "symdia", "--dtype", "float32", "--refine", "bfloat16", "--tol", "1"], 1e-10),
    (["--method", "minres", "--dtype", "bfloat16", "--tol", "1"], 1e-2),
], ids=["symdia-bf16", "symdia-refine-bf16", "minres-bf16"])
def test_tester_bf16_runs_match_the_jax_tester(capsys, extra, bound):
    """The tester's bf16 SymDIA runs (the ones that reach kernel 10's bf16
    form on the card) and --method minres --dtype bfloat16 (the portable
    loop in both packages: bf16 vectors) against the JAX tester on
    poisson2d_34."""
    (jrc, jlines), (trc, tlines) = _both(capsys, [MTX, "--summary", *extra])
    assert jrc == trc == 0
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    assert 0 <= float(tlines[0].split()[3]) < bound
    assert 0 <= float(jlines[0].split()[3]) < bound
    ti, ji = ts["iterations"][0], js["iterations"][0]
    assert abs(ti - ji) <= 0.15 * ji


# ---- the gate ----------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["full", "sym"])
@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_fused_minres_gate_matches_jax(monkeypatch, banded, storage, op_dtype):
    """fused_minres_supported against the JAX gate (interpret=True) on
    float32 and bf16 operators of each storage and each vector dtype, with
    the device term aside: the port's operator is made to report a CUDA
    device, as the gate's other terms are pure shape and dtype.  A
    rectangular padded system and a CSR operator are refused by both."""
    jop, top = banded[0][storage]
    if op_dtype == "float32":
        jop, top = jop.astype(jnp.float32), top.astype(torch.float32)
    cls = BlockedEllMatrix if storage == "full" else SymBellMatrix
    assert not fused_minres_supported(top, dtype=torch.float32)  # CPU tensors
    monkeypatch.setattr(cls, "device", property(lambda self: torch.device("cuda")))
    for jd, td in ((None, None), (jnp.float32, torch.float32), (jnp.float64, torch.float64),
                   (jnp.bfloat16, BF16)):
        want = jfm.fused_minres_supported(jop, dtype=jd, interpret=True)
        assert fused_minres_supported(top, dtype=td) == want, (jd, td)
        assert want == (jd in (None, jnp.float32))
    rows, cols, vals, shape = poisson2d_coo(12)
    jc = JCSR.from_coo(rows, cols, vals, shape, dtype=np.float32)
    jr = JBell.from_csr(jc, bm=128, bn=128)
    rect = BlockedEllMatrix.from_csr_host(np.asarray(jc.data), np.asarray(jc.indices),
                                          np.asarray(jc.indptr), shape, bm=8, bn=128,
                                          device="cpu")
    jrect = JBell.from_csr(jc, bm=8, bn=128)
    assert rect.padded_shape[0] != rect.padded_shape[1]
    assert not fused_minres_supported(rect) and not jfm.fused_minres_supported(jrect,
                                                                              interpret=True)
    assert not jfm.fused_minres_supported(jc, interpret=True)
    assert jfm.fused_minres_supported(jr, interpret=True)
    assert not fused_minres_supported(convert.csr_from_arrays(
        np.asarray(jc.data), np.asarray(jc.indices), np.asarray(jc.indptr), shape,
        device="cpu"))
    assert not fused_minres_supported(
        convert.dia_from_arrays(*_dia_fields(jc), device="cpu"))


def _dia_fields(jc):
    jd = JDIA.from_csr(jc)
    return np.asarray(jd.diags), jd.offsets, jd.shape, jd.nnz
