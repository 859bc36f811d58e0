"""The port's fused-CG kernels (conjugategradient_tpu_torch/ops/cuda) against
the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain-torch version; the JAX kernels run
in interpret mode, as tests/test_symbell.py runs them.  Same numpy inputs
on both sides; tolerance rtol 1e-5 (f32, different summation order).
Sparse symmetric tiles take the packed route (kernel 1's function as the
packed kernel 4 on ``SymBellMatrix.packed()``, the view of D + U + Uᵀ):
here its plain version, held to the same 1e-5 against the JAX kernel;
whole solves against the JAX fused solve: the same iteration count, the
history to 2e-3 relative over 25 steps (f32 sums in another order, which
a CG recurrence amplifies; the bound of tests/test_torch_minres_packed.py).  The
CUDA kernels themselves are held against the plain versions on the card
(the ``cuda`` marker; skipped without a GPU) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathlib

from conjugategradient_tpu.io import loader as jloader
from conjugategradient_tpu.ops import spmv as jspmv
from conjugategradient_tpu.ops.pallas import fused_cg as jfc
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.types import BlockedEllMatrix, CSRMatrix, SymBellMatrix
from conjugategradient_tpu_torch import convert, fused_bell_cg_solve, fused_bell_pcg_solve
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.ops import spmv as tspmv
from conjugategradient_tpu_torch.ops.cuda import _build
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tfc
from conjugategradient_tpu_torch.ops.cuda.bell_spmv import packed_apply
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.solver import fused as tfused
from conjugategradient_tpu_torch.types import BlockedEllMatrix as TBell

RTOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _random_block_sym(rng, nrb=16, bm=8, per_row=3):
    """Random block-sparse SPD matrix (tests/test_symbell.py's shape)."""
    n = nrb * bm
    A = np.zeros((n, n), np.float32)
    for i in range(nrb):
        D = rng.standard_normal((bm, bm)).astype(np.float32)
        A[i * bm:(i + 1) * bm, i * bm:(i + 1) * bm] = D + D.T + 20 * np.eye(bm, dtype=np.float32)
        hi = np.arange(i + 1, nrb)
        for c in rng.choice(hi, size=min(per_row, len(hi)), replace=False):
            B = rng.standard_normal((bm, bm)).astype(np.float32)
            A[i * bm:(i + 1) * bm, c * bm:(c + 1) * bm] = B
            A[c * bm:(c + 1) * bm, i * bm:(i + 1) * bm] = B.T
    return A


def _block_tridiag(rng, nrb=12, bm=8):
    n = nrb * bm
    A = np.zeros((n, n), np.float32)
    for i in range(nrb):
        D = rng.standard_normal((bm, bm)).astype(np.float32)
        A[i * bm:(i + 1) * bm, i * bm:(i + 1) * bm] = D + D.T + 20 * np.eye(bm, dtype=np.float32)
        if i + 1 < nrb:
            B = rng.standard_normal((bm, bm)).astype(np.float32)
            A[i * bm:(i + 1) * bm, (i + 1) * bm:(i + 2) * bm] = B
            A[(i + 1) * bm:(i + 2) * bm, i * bm:(i + 1) * bm] = B.T
    return A


def _jax_sym(A, bm=8):
    n = A.shape[0]
    rows, cols = np.nonzero(A)
    csr = CSRMatrix.from_coo(rows, cols, A[rows, cols], (n, n), dtype=A.dtype)
    return SymBellMatrix.from_bell(BlockedEllMatrix.from_csr(csr, bm=bm, bn=bm))


def _port_sym(jsym):
    return convert.sym_bell_from_arrays(
        np.asarray(jsym.diag_blocks), np.asarray(jsym.off_blocks),
        np.asarray(jsym.off_cols), jsym.shape, jsym.nnz, jsym.full_kmax,
        jsym.banded, device="cpu"
    )


@pytest.fixture(scope="module")
def operators():
    rng = np.random.default_rng(7)
    out = {}
    for name, A in (("tridiag", _block_tridiag(rng)),
                    ("general", _random_block_sym(rng))):
        jsym = _jax_sym(A)
        out[name] = (A, jsym, _port_sym(jsym))
    assert out["tridiag"][1].banded and out["tridiag"][2].banded
    assert out["general"][2].ku > 1
    return out


def _assert_close_q(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


CASES = [(op, m) for op in ("tridiag", "general")
         for m in ("banded", "scatter", "split") if not (op == "general" and m == "banded")]


@pytest.mark.parametrize("with_d", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("row_group", [1, 4])
@pytest.mark.parametrize("op,mirror", CASES)
def test_sym_dir_spmv_dot_matches_jax(operators, op, mirror, row_group, with_d):
    A, jsym, tsym = operators[op]
    rng = np.random.default_rng(11)
    n = A.shape[0]
    r = rng.standard_normal(n).astype(np.float32).reshape(-1, 8)
    p = rng.standard_normal(n).astype(np.float32).reshape(-1, 8)
    d = (1.0 / np.diag(A)).astype(np.float32).reshape(-1, 8) if with_d else None
    beta = np.full((1, 1), 0.37, np.float32)
    jp, jq, jpap = jfc.sym_fused_dir_spmv_dot(
        jsym.diag_blocks.astype(jnp.float32), jsym.off_blocks.astype(jnp.float32),
        jsym.off_cols, jnp.asarray(r), jnp.asarray(p), jnp.asarray(beta),
        inv_diag2d=None if d is None else jnp.asarray(d),
        interpret=True, row_group=row_group, mirror=mirror,
    )
    before = dict(tfc.LAUNCHES)
    tp, tq, tpap = tfc.sym_fused_dir_spmv_dot(
        tsym.diag_blocks, tsym.off_blocks, tsym.off_cols, torch.from_numpy(r),
        torch.from_numpy(p), torch.from_numpy(beta),
        None if d is None else torch.from_numpy(d),
        mirror=mirror, row_group=row_group, mirror_src=tsym.mirror_src,
    )
    assert tfc.LAUNCHES == before  # CPU tensors: the plain version ran
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)
    _assert_close_q(tq.numpy(), jq)
    assert tpap.shape == (1, 1)
    np.testing.assert_allclose(float(tpap), float(jpap[0, 0]), rtol=RTOL)


@pytest.mark.parametrize("shape", [(16, 128), (12, 8)])
@pytest.mark.parametrize("pcg", [False, True], ids=["cg", "pcg"])
def test_update_dot_matches_jax(shape, pcg):
    rng = np.random.default_rng(3)
    x, p, r, q = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    d = (np.abs(rng.standard_normal(shape)) + 0.1).astype(np.float32)
    alpha = np.full((1, 1), -0.61, np.float32)
    J = lambda a: jnp.asarray(a)
    T = torch.from_numpy
    if pcg:
        jout = jfc.fused_update_dot_pcg(J(x), J(p), J(r), J(q), J(d), J(alpha), interpret=True)
        tout = tfc.fused_update_dot_pcg(T(x), T(p), T(r), T(q), T(d), T(alpha))
    else:
        jout = jfc.fused_update_dot(J(x), J(p), J(r), J(q), J(alpha), interpret=True)
        tout = tfc.fused_update_dot(T(x), T(p), T(r), T(q), T(alpha))
    assert len(tout) == len(jout)
    for t, j in zip(tout[:2], jout[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=1e-6)
    for t, j in zip(tout[2:], jout[2:]):
        assert t.shape == (1, 1)
        np.testing.assert_allclose(float(t), float(j[0, 0]), rtol=RTOL)


@pytest.mark.parametrize("n,ctas", [(262_144, 256), (65_536, 64), (32_768, 32),
                                    (256 ** 3, 1024), (1023, 1), (1, 1), (4097, 5)])
def test_update_grid(n, ctas):
    """The update kernels' grid (K2/K3, K16, K20): one float4 a thread of
    256, at most 1024 CTAs; n = 262,144, its shards n/4 and n/8, 256^3."""
    from conjugategradient_tpu_torch.ops.cuda import _common, fused_bicgstab, fused_minres

    assert _common.update_grid(n) == ctas
    for mod in (tfc, fused_minres, fused_bicgstab):  # one helper for the three wrappers
        assert mod.update_grid is _common.update_grid


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("pcg", [False, True], ids=["cg", "pcg"])
def test_update_partials_only_over_shards_matches_jax(pcg, n_shards):
    """The sharded loop's K2/K3: each shard's partials-only call, summed
    over the shards, against the JAX kernel on the whole vector; the
    solve's scalars untouched."""
    rng = np.random.default_rng(11 + n_shards)
    shape = (32, 128)
    x, p, r, q = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    d = (np.abs(rng.standard_normal(shape)) + 0.1).astype(np.float32)
    alpha = np.full((1, 1), 0.61, np.float32)
    J = jnp.asarray
    if pcg:
        jout = jfc.fused_update_dot_pcg(J(x), J(p), J(r), J(q), J(d), J(alpha), interpret=True)
    else:
        jout = jfc.fused_update_dot(J(x), J(p), J(r), J(q), J(alpha), interpret=True)
    work = tfc.FusedWork.new("cpu", maxiter=4, tol=1e-3)
    kept = (work.scal.clone(), work.ctl.clone())
    rows = shape[0] // n_shards
    outs = []
    for s in range(n_shards):
        sl = [torch.from_numpy(v[s * rows:(s + 1) * rows]) for v in (x, p, r, q, d)]
        if pcg:
            outs.append(tfc.fused_update_dot_pcg(*sl, torch.from_numpy(alpha), work=work,
                                                 partials_only=True))
        else:
            outs.append(tfc.fused_update_dot(*sl[:4], torch.from_numpy(alpha), work=work,
                                             partials_only=True))
    assert torch.equal(work.scal, kept[0]) and torch.equal(work.ctl, kept[1])
    for i in range(2):  # x', r'
        np.testing.assert_allclose(torch.cat([o[i] for o in outs]).numpy(), np.asarray(jout[i]),
                                   rtol=RTOL, atol=1e-6)
    for i in range(2, len(jout)):  # rnorm (and rho), summed over the shards
        got = sum(float(o[i]) for o in outs)
        np.testing.assert_allclose(got, float(jout[i][0, 0]), rtol=RTOL)


def test_fused_step_from_jax_state(operators):
    """A JAX fused state carried across (convert.fused_state_from_arrays),
    stepped by both packages: the kernels' scalar step (α; done, β, k,
    hist[k]) matches solver/fused.py's."""
    A, jsym, tsym = operators["general"]
    n = A.shape[0]
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n).astype(np.float32)
    jstate = jfused.fused_cg_init(jsym.astype(jnp.float32), jnp.asarray(b), maxiter=6)
    jstep = lambda s: jfused.fused_cg_step(jsym.astype(jnp.float32), s,
                                           jnp.asarray(0.0, jnp.float32), interpret=True)
    # two JAX steps first, so the carried state has beta != 0 and k = 2
    for _ in range(2):
        jstate = jstep(jstate)
    tstate = convert.fused_state_from_arrays(
        np.asarray(jstate.x), np.asarray(jstate.r), np.asarray(jstate.p),
        np.asarray(jstate.beta), np.asarray(jstate.rho), int(jstate.k),
        bool(jstate.done), np.asarray(jstate.hist), device="cpu"
    )
    for _ in range(2):
        jstate = jstep(jstate)
        tfused.fused_cg_step(tsym, tstate)
    assert int(tstate.k) == int(jstate.k) == 4
    assert bool(tstate.done) == bool(jstate.done)
    for t, j in ((tstate.x, jstate.x), (tstate.r, jstate.r), (tstate.p, jstate.p)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(j)).max())
    np.testing.assert_allclose(tstate.hist.numpy()[:5], np.asarray(jstate.hist)[:5],
                               rtol=1e-4)
    np.testing.assert_allclose(float(tstate.beta), float(jstate.beta[0, 0]), rtol=1e-4)


class TestWrapperContract:
    def _args(self, operators):
        A, _, tsym = operators["general"]
        v = torch.zeros(tsym.nrb, tsym.bn)
        return tsym, v, torch.zeros(1, 1)

    def test_rejects_non_f32_tiles(self, operators):
        """float64 tiles (and tiles of two dtypes) are refused; bfloat16 ones
        are the kernels' other form (test_accepts_bf16_tiles)."""
        tsym, v, beta = self._args(operators)
        with pytest.raises(TypeError, match="float32"):
            tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks.double(), tsym.off_blocks.double(),
                                       tsym.off_cols, v, v, beta, mirror_src=tsym.mirror_src)
        with pytest.raises(TypeError, match="float32"):
            tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks.bfloat16(), tsym.off_blocks,
                                       tsym.off_cols, v, v, beta, mirror_src=tsym.mirror_src)
        with pytest.raises(TypeError, match="float32"):
            tfc.fused_dir_spmv_dot(torch.zeros(tsym.nrb, 1, tsym.bn, tsym.bn,
                                               dtype=torch.float64),
                                   torch.zeros(tsym.nrb, 1, dtype=torch.int32), v, v, beta)

    @pytest.mark.parametrize("storage", ["sym", "full"])
    def test_accepts_bf16_tiles(self, operators, storage):
        """bfloat16 tiles with float32 vectors: the plain version on CPU
        tensors widens the tiles, so it returns exactly what the float32
        tiles' bf16-rounded copy gives, counted under the ``_bf16`` name."""
        A, _, tsym = operators["general"]
        rows, cols = np.nonzero(A)
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=A.shape[0]))])
        tfull = TBell.from_csr_host(A[rows, cols], cols, indptr, A.shape, bm=8, bn=8,
                                    device="cpu")
        rng = np.random.default_rng(7)
        r = torch.from_numpy(rng.standard_normal((tsym.nrb, tsym.bn)).astype(np.float32))
        p = torch.from_numpy(rng.standard_normal((tsym.nrb, tsym.bn)).astype(np.float32))
        beta = torch.full((1, 1), 0.37)
        if storage == "sym":
            lo = tsym.astype(torch.bfloat16)
            got = tfc.sym_fused_dir_spmv_dot(lo.diag_blocks, lo.off_blocks, lo.off_cols, r, p,
                                             beta, mirror_src=lo.mirror_src)
            want = tfc.sym_fused_dir_spmv_dot(lo.diag_blocks.float(), lo.off_blocks.float(),
                                              lo.off_cols, r, p, beta,
                                              mirror_src=lo.mirror_src)
            name = "sym_fused_dir_spmv_dot_bf16"
        else:
            lo = tfull.astype(torch.bfloat16)
            got = tfc.fused_dir_spmv_dot(lo.blocks, lo.block_cols, r, p, beta)
            want = tfc.fused_dir_spmv_dot(lo.blocks.float(), lo.block_cols, r, p, beta)
            name = "fused_dir_spmv_dot_bf16"
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[1].dtype == torch.float32 and name in tfc.LAUNCHES

    def test_mirror_validation(self, operators):
        tsym, v, beta = self._args(operators)
        with pytest.raises(ValueError, match="mirror"):
            tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks, tsym.off_blocks, tsym.off_cols,
                                       v, v, beta, mirror="registers",
                                       mirror_src=tsym.mirror_src)
        with pytest.raises(ValueError, match="banded"):
            tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks, tsym.off_blocks, tsym.off_cols,
                                       v, v, beta, mirror="banded",
                                       mirror_src=tsym.mirror_src)

    def test_step_rejects_banded_on_general_pattern(self, operators):
        _, _, tsym = operators["general"]
        state = tfused.fused_cg_init(tsym, torch.ones(tsym.n), maxiter=2)
        with pytest.raises(ValueError, match="banded"):
            tfused.fused_cg_step(tsym, state, mirror="banded")

    def test_rejects_bad_shapes_and_mixed_devices(self, operators):
        tsym, v, beta = self._args(operators)
        with pytest.raises(ValueError, match="vectors"):
            tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks, tsym.off_blocks, tsym.off_cols,
                                       v[:-1], v, beta, mirror_src=tsym.mirror_src)
        with pytest.raises(ValueError, match="several devices"):
            tfc.fused_update_dot(v, v, v, v.to("meta"), beta)
        with pytest.raises(ValueError, match="shape"):
            tfc.fused_update_dot(v, v, v[:-1], v, beta)

    def test_plain_counts_stay_zero_on_cpu(self, operators):
        tsym, v, beta = self._args(operators)
        tfc.fused_update_dot(v, v, v, v, beta)
        assert tfc.PLAIN_ON_CUDA == dict.fromkeys(tfc.LAUNCHES, 0)

    def test_build_needs_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()

    def test_library_key_follows_sources(self):
        p = _build.library_path()
        assert p == _build.library_path()
        assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
        assert any(s.suffix == ".cu" for s in _build._sources())


@pytest.mark.cuda
@pytest.mark.parametrize("op,mirror", CASES)
def test_cuda_kernels_match_plain(operators, op, mirror):
    """Hand-written kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(1)
    A = _block_tridiag(rng, nrb=13, bm=32) if op == "tridiag" else \
        _random_block_sym(rng, nrb=13, bm=32)
    tsym = _port_sym(_jax_sym(A, bm=32)).to("cuda")
    n = A.shape[0]
    dev = torch.device("cuda")
    r = torch.randn(n // 32, 32, device=dev)
    p = torch.randn(n // 32, 32, device=dev)
    beta = torch.full((1, 1), 0.37, device=dev)
    before = tfc.LAUNCHES["sym_fused_dir_spmv_dot"]
    k = tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks, tsym.off_blocks, tsym.off_cols,
                                   r, p, beta, mirror=mirror, row_group=4,
                                   mirror_src=tsym.mirror_src)
    assert tfc.LAUNCHES["sym_fused_dir_spmv_dot"] == before + 1
    pl = tfc._sym_dir_plain(tsym.diag_blocks, tsym.off_blocks, tsym.off_cols, r, p,
                            beta, None, tsym.mirror_src, None, None)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[0], pl[0], rtol=1e-6, atol=0)
    _assert_close_q(k[1].cpu().numpy(), pl[1].cpu().numpy())
    np.testing.assert_allclose(float(k[2]), float(pl[2]), rtol=RTOL)
    x = torch.randn_like(r)
    alpha = torch.full((1, 1), 0.5, device=dev)
    ku = tfc.fused_update_dot(x, p, r, k[1], alpha)
    pu = tfc._update_plain("fused_update_dot", x, p, r, k[1], None, alpha, None, None)
    for a, b in zip(ku, pu):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-6)


# ---- kernel 1 on the packed nonzeros of sparse symmetric tiles --------------------

def _poisson_sym(nx, bn):
    """2-D Poisson nx x nx in symmetric storage with bn x bn tiles: the
    JAX operator and the port's (CPU), from the same arrays."""
    rows, cols, vals, shape = poisson2d_coo(nx)
    csr = CSRMatrix.from_coo(rows, cols, vals, shape, dtype=np.float32)
    jsym = SymBellMatrix.from_bell(BlockedEllMatrix.from_csr(csr, bm=bn, bn=bn))
    return jsym, _port_sym(jsym)


PACKED_OPS = {"poisson24-bn128": (24, 128), "ragged37-bn32": (37, 32)}


@pytest.fixture(scope="module")
def packed_ops():
    return {k: _poisson_sym(*v) for k, v in PACKED_OPS.items()}


@pytest.mark.parametrize("beta_v", [0.0, 0.37], ids=["beta0", "beta"])
@pytest.mark.parametrize("with_d", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("op", list(PACKED_OPS))
def test_sym_packed_dir_matches_jax(packed_ops, op, with_d, beta_v):
    """The packed route of kernel 1 (plain version on the CPU) against the
    JAX ``sym_fused_dir_spmv_dot`` in interpret mode, on sparse symmetric
    tiles where the route holds (the ragged one: n = 1369 = 42·32 + 25)."""
    jsym, tsym = packed_ops[op]
    assert tspmv.bell_packed_route(tsym)
    pk = tsym.packed()
    assert pk.symmetric and pk.rows == tsym.padded_shape[0]
    bn = tsym.bn
    rng = np.random.default_rng(21)
    m = tsym.nrb * bn
    r = rng.standard_normal(m).astype(np.float32).reshape(-1, bn)
    p = rng.standard_normal(m).astype(np.float32).reshape(-1, bn)
    d = (0.5 + rng.random(m)).astype(np.float32).reshape(-1, bn) if with_d else None
    beta = np.full((1, 1), beta_v, np.float32)
    jp, jq, jpap = jfc.sym_fused_dir_spmv_dot(
        jsym.diag_blocks.astype(jnp.float32), jsym.off_blocks.astype(jnp.float32),
        jsym.off_cols, jnp.asarray(r), jnp.asarray(p), jnp.asarray(beta),
        inv_diag2d=None if d is None else jnp.asarray(d), interpret=True, mirror="scatter")
    before = dict(tfc.LAUNCHES)
    tp, tq, tpap = tfc.fused_dir_spmv_dot_packed(
        pk, torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(beta),
        None if d is None else torch.from_numpy(d))
    assert tfc.LAUNCHES == before  # CPU tensors: the plain version ran
    # p_new: XLA may contract d·r + β·p into one FMA where the port rounds
    # the product first, so where the two terms cancel the relative error
    # grows; one rounding of the larger term bounds it: 1e-6 of max|p_new|
    jp = np.asarray(jp)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=RTOL, atol=1e-6 * np.abs(jp).max())
    _assert_close_q(tq.numpy(), jq)
    np.testing.assert_allclose(float(tpap), float(jpap[0, 0]), rtol=RTOL)


def _spy(monkeypatch):
    """Record which kernel-1 form each fused CG step calls."""
    calls = []
    packed, general = tfused.fused_dir_spmv_dot_packed, tfused.sym_fused_dir_spmv_dot

    def spy_packed(pk, *a, **k):
        calls.append("sym_fused_dir_spmv_dot_packed" if pk.symmetric
                     else "fused_dir_spmv_dot_packed")
        return packed(pk, *a, **k)

    def spy_general(*a, **k):
        calls.append("sym_fused_dir_spmv_dot")
        return general(*a, **k)

    monkeypatch.setattr(tfused, "fused_dir_spmv_dot_packed", spy_packed)
    monkeypatch.setattr(tfused, "sym_fused_dir_spmv_dot", spy_general)
    return calls


def test_fused_step_on_sparse_symbell_takes_the_packed_kernel(packed_ops, monkeypatch):
    """``fused_cg_step`` on sparse symmetric tiles calls the packed kernel
    (named ``sym_fused_dir_spmv_dot_packed``) and never the general
    landing; dense symmetric 32 x 32 tiles keep the tile kernel."""
    dense = _port_sym(_jax_sym(_random_block_sym(np.random.default_rng(2), bm=32), bm=32))
    assert not tspmv.bell_packed_route(dense) and dense.ku > 1
    calls = _spy(monkeypatch)
    for label, a, want in (
        ("sparse", packed_ops["ragged37-bn32"][1], "sym_fused_dir_spmv_dot_packed"),
        ("dense", dense, "sym_fused_dir_spmv_dot"),
    ):
        calls.clear()
        b = torch.from_numpy(reference_rhs(a.n, dtype=np.float32) / a.n)
        state = tfused.fused_cg_init(a, b, maxiter=3)
        for _ in range(3):
            tfused.fused_cg_step(a, state)
        assert calls == [want] * 3, label
        assert int(state.k) == 3 and np.isfinite(state.hist.numpy()).all()


def test_packed_step_ignores_mirror_but_refuses_banded_off_band(packed_ops):
    tsym = packed_ops["ragged37-bn32"][1]
    b = torch.from_numpy(reference_rhs(tsym.n, dtype=np.float32) / tsym.n)
    hists = []
    for mirror in ("auto", "scatter", "split"):
        state = tfused.fused_cg_init(tsym, b, maxiter=4)
        for _ in range(4):
            tfused.fused_cg_step(tsym, state, mirror=mirror)
        hists.append(state.hist.clone())
    assert torch.equal(hists[0], hists[1]) and torch.equal(hists[0], hists[2])
    state = tfused.fused_cg_init(tsym, b, maxiter=4)
    with pytest.raises(ValueError, match="block-tridiagonal"):
        tfused.fused_cg_step(tsym, state, mirror="banded")


@pytest.fixture(scope="module")
def poisson34_symbell():
    path = ROOT / "problems" / "poisson2d_34.mtx"
    jsym = SymBellMatrix.from_bell(jloader.load_matrix(path, layout="bell", dtype=np.float32,
                                                       bm=128, bn=128))
    tsym = tloader.load_matrix(path, layout="symbell", dtype=np.float32, bn=128, device="cpu")
    return jsym, tsym


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_fused_symbell_solve_matches_jax(poisson34_symbell, precond, monkeypatch):
    """problems/poisson2d_34.mtx as ``--layout symbell`` (float32, 128 x 128,
    sparse tiles: the packed route) against the JAX fused solve in interpret
    mode: the same iteration count to 1e-5·‖b‖, the first 25 entries of the
    history to 2e-3 relative, x to 1e-3 / 1e-4."""
    jsym, tsym = poisson34_symbell
    assert tspmv.bell_packed_route(tsym)
    n = tsym.n
    b = reference_rhs(n).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b.astype(np.float64)))
    calls = _spy(monkeypatch)
    jd = td = None
    if precond == "jacobi":
        jd = (1.0 / np.asarray(jsym.diagonal())).astype(np.float32)
        td = 1.0 / tsym.diagonal()
        np.testing.assert_allclose(td.numpy(), jd, rtol=1e-7)
        run_j = lambda **k: jfused.fused_bell_pcg_solve(jsym, jnp.asarray(b), jnp.asarray(jd),
                                                        interpret=True, **k)
        run_t = lambda **k: fused_bell_pcg_solve(tsym, torch.from_numpy(b), td, **k)
    else:
        run_j = lambda **k: jfused.fused_bell_cg_solve(jsym, jnp.asarray(b), interpret=True, **k)
        run_t = lambda **k: fused_bell_cg_solve(tsym, torch.from_numpy(b), **k)
    _, ij25 = run_j(tol=0.0, maxiter=25)
    _, it25 = run_t(tol=0.0, maxiter=25)
    assert set(calls) == {"sym_fused_dir_spmv_dot_packed"} and len(calls) == 25
    np.testing.assert_allclose(it25.rho_history.numpy()[:26],
                               np.asarray(ij25.rho_history)[:26], rtol=2e-3)
    xj, ij = run_j(tol=tol)
    xt, it = run_t(tol=tol)
    assert bool(ij.converged) and bool(it.converged)
    assert int(it.iterations) == int(ij.iterations)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("op", list(PACKED_OPS))
def test_sym_bell_spmv_packed_route_matches_jax(packed_ops, op):
    """``sym_bell_spmv`` on sparse symmetric tiles reads the packed view
    (packed kernel 5's plain version on the CPU, the same bits as
    ``packed_apply``) and agrees with the JAX ``sym_bell_spmv`` to 1e-5 of
    max|y|; ``use_kernel="never"`` keeps the tiles' plain form, which agrees
    too; float64 and bad ``use_kernel`` values as before."""
    jsym, tsym = packed_ops[op]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(tsym.n).astype(np.float32)
    want = np.asarray(jspmv.sym_bell_spmv(jsym, jnp.asarray(x)))
    y = tspmv.sym_bell_spmv(tsym, torch.from_numpy(x))
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, tsym.padded_shape[1] - tsym.n))
    assert torch.equal(y, packed_apply(tsym.packed(), xp)[:tsym.n])
    assert torch.equal(tsym.matvec(torch.from_numpy(x)), y)
    _assert_close_q(y.numpy(), want)
    _assert_close_q(tspmv.sym_bell_spmv(tsym, torch.from_numpy(x), use_kernel="never").numpy(),
                    want)
    y64 = tspmv.sym_bell_spmv(tsym, torch.from_numpy(x).double())
    assert y64.dtype == torch.float64
    _assert_close_q(y64.numpy(), want)
    with pytest.raises(ValueError, match="use_kernel"):
        tspmv.sym_bell_spmv(tsym, torch.from_numpy(x), use_kernel="sometimes")


# ---- kernels 1 and 4 on bfloat16 tiles (float32 vectors) --------------------

@pytest.mark.parametrize("with_d", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("op,mirror", CASES)
def test_sym_dir_spmv_dot_bf16_tiles_match_jax(operators, op, mirror, with_d):
    """The plain version of kernel 1's bf16 form (tiles widened to float32
    first) against the Pallas kernel in interpret mode on the same bf16
    tiles and float32 vectors, to the float32 cases' tolerances."""
    A, jsym, tsym = operators[op]
    rng = np.random.default_rng(12)
    n = A.shape[0]
    r = rng.standard_normal(n).astype(np.float32).reshape(-1, 8)
    p = rng.standard_normal(n).astype(np.float32).reshape(-1, 8)
    d = (1.0 / np.diag(A)).astype(np.float32).reshape(-1, 8) if with_d else None
    beta = np.full((1, 1), 0.37, np.float32)
    jd, jo = jsym.diag_blocks.astype(jnp.bfloat16), jsym.off_blocks.astype(jnp.bfloat16)
    jp, jq, jpap = jfc.sym_fused_dir_spmv_dot(
        jd, jo, jsym.off_cols, jnp.asarray(r), jnp.asarray(p), jnp.asarray(beta),
        inv_diag2d=None if d is None else jnp.asarray(d), interpret=True, mirror=mirror)
    lo = tsym.astype(torch.bfloat16)
    assert np.array_equal(lo.off_blocks.float().numpy(), np.asarray(jo.astype(jnp.float32)))
    before = dict(tfc.LAUNCHES)
    tp, tq, tpap = tfc.sym_fused_dir_spmv_dot(
        lo.diag_blocks, lo.off_blocks, lo.off_cols, torch.from_numpy(r), torch.from_numpy(p),
        torch.from_numpy(beta), None if d is None else torch.from_numpy(d),
        mirror=mirror, mirror_src=lo.mirror_src)
    assert tfc.LAUNCHES == before  # CPU tensors: the plain version ran
    assert tq.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)
    _assert_close_q(tq.numpy(), jq)
    np.testing.assert_allclose(float(tpap), float(jpap[0, 0]), rtol=RTOL)


@pytest.mark.parametrize("with_d", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("op", ["tridiag", "general"])
def test_full_dir_spmv_dot_bf16_tiles_match_jax(operators, op, with_d):
    """The plain versions of kernel 4's bf16 forms (the tiles, and the
    packed view) against the Pallas kernel in interpret mode on the same
    bf16 tiles and float32 vectors, to the float32 cases' tolerances."""
    A = operators[op][0]
    rng = np.random.default_rng(13)
    n = A.shape[0]
    rows, cols = np.nonzero(A)
    jb = BlockedEllMatrix.from_csr(CSRMatrix.from_coo(rows, cols, A[rows, cols], (n, n),
                                                      dtype=A.dtype), bm=8, bn=8)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    lo = TBell.from_csr_host(A[rows, cols], cols, indptr, A.shape, bm=8, bn=8,
                             device="cpu").astype(torch.bfloat16)
    r = rng.standard_normal(n).astype(np.float32).reshape(-1, 8)
    p = rng.standard_normal(n).astype(np.float32).reshape(-1, 8)
    d = (1.0 / np.diag(A)).astype(np.float32).reshape(-1, 8) if with_d else None
    beta = np.full((1, 1), 0.37, np.float32)
    jp, jq, jpap = jfc.fused_dir_spmv_dot(
        jb.blocks.astype(jnp.bfloat16), jb.block_cols, jnp.asarray(r), jnp.asarray(p),
        jnp.asarray(beta), inv_diag2d=None if d is None else jnp.asarray(d), interpret=True)
    args = (torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(beta),
            None if d is None else torch.from_numpy(d))
    for tp, tq, tpap in (tfc.fused_dir_spmv_dot(lo.blocks, lo.block_cols, *args),
                         tfc.fused_dir_spmv_dot_packed(lo.packed(), *args)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)
        _assert_close_q(tq.numpy(), jq)
        np.testing.assert_allclose(float(tpap), float(jpap[0, 0]), rtol=RTOL)
