"""The port's fused-CG kernels (conjugategradient_tpu_torch/ops/cuda) against
the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain-torch version; the JAX kernels run
in interpret mode, as tests/test_symbell.py runs them.  Same numpy inputs
on both sides; tolerance rtol 1e-5 (f32, different summation order).  The
CUDA kernels themselves are held against the plain versions on the card
(the ``cuda`` marker; skipped without a GPU) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conjugategradient_tpu.ops.pallas import fused_cg as jfc
from conjugategradient_tpu.solver import fused as jfused
from conjugategradient_tpu.types import BlockedEllMatrix, CSRMatrix, SymBellMatrix
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch.ops.cuda import _build
from conjugategradient_tpu_torch.ops.cuda import fused_cg as tfc
from conjugategradient_tpu_torch.solver import fused as tfused

RTOL = 1e-5


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
        jsym.banded,
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
        bool(jstate.done), np.asarray(jstate.hist),
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
        tsym, v, beta = self._args(operators)
        for dt in (torch.bfloat16, torch.float64):
            with pytest.raises(TypeError, match="float32"):
                tfc.sym_fused_dir_spmv_dot(tsym.diag_blocks.to(dt), tsym.off_blocks.to(dt),
                                           tsym.off_cols, v, v, beta,
                                           mirror_src=tsym.mirror_src)

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
