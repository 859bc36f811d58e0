"""Host ingest of the port — MatrixMarket parse, problem generators and the
symmetric blocked-ELL packing — bitwise equal to the JAX package's, on
every file in problems/*.mtx.  Also: the port imports no jax."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from conjugategradient_tpu import problems as jproblems
from conjugategradient_tpu.io import loader as jloader
from conjugategradient_tpu.io import mtx as jmtx
from conjugategradient_tpu.types import SymBellMatrix as JSymBell
from conjugategradient_tpu_torch import convert
from conjugategradient_tpu_torch import problems as tproblems
from conjugategradient_tpu_torch.io import loader as tloader
from conjugategradient_tpu_torch.io import mtx as tmtx
from conjugategradient_tpu_torch.types import SymBellMatrix as TSymBell
from conjugategradient_tpu_torch.types import mirror_index

ROOT = pathlib.Path(__file__).resolve().parents[1]
MTX = sorted((ROOT / "problems").glob("*.mtx"))
PACK_BN = 32  # small tiles keep the largest files' packs a few tens of MB


def test_all_nine_problem_files_present():
    assert len(MTX) == 9


@pytest.fixture(scope="module")
def parsed():
    """Each file parsed once by each package: (jax CSR, port CSR)."""
    return {p.name: (jloader.read_csr_host(p), tloader.read_csr_host(p)) for p in MTX}


@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_mtx_parse_bitwise(path, parsed):
    jc = jmtx.read_mtx_coo(path)
    tc = tmtx.read_mtx_coo(path)
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(jc, f), getattr(tc, f))
    assert (jc.shape, jc.symmetric) == (tc.shape, tc.symmetric)
    jcsr, tcsr = parsed[path.name]
    for a, b in zip(jcsr[:3], tcsr[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jcsr[3] == tcsr[3]


@pytest.mark.parametrize("path", MTX, ids=lambda p: p.name)
def test_symbell_packing_bitwise(path, parsed):
    data, indices, indptr, shape = parsed[path.name][1]
    kw = dict(bn=PACK_BN, dtype=np.float32, check=True)
    try:
        jsym = JSymBell.from_csr_host(data, indices, indptr, shape, **kw)
    except ValueError as e:
        # non-symmetric files (convdiff_34) fail the same check the same way
        with pytest.raises(ValueError) as te:
            TSymBell.from_csr_host(data, indices, indptr, shape, **kw)
        assert str(te.value) == str(e)
        return
    tsym = TSymBell.from_csr_host(data, indices, indptr, shape, **kw)
    carried = convert.sym_bell_from_arrays(
        np.asarray(jsym.diag_blocks), np.asarray(jsym.off_blocks),
        np.asarray(jsym.off_cols), jsym.shape, jsym.nnz, jsym.full_kmax,
        jsym.banded,
    )
    for got in (tsym, carried):
        for f in ("diag_blocks", "off_blocks", "off_cols", "mirror_src"):
            assert np.array_equal(getattr(got, f).numpy(), getattr(tsym, f).numpy())
        assert np.array_equal(got.diag_blocks.numpy(), np.asarray(jsym.diag_blocks))
        assert np.array_equal(got.off_blocks.numpy(), np.asarray(jsym.off_blocks))
        assert np.array_equal(got.off_cols.numpy(), np.asarray(jsym.off_cols))
        assert (got.shape, got.nnz, got.full_kmax, got.banded) == (
            tuple(jsym.shape), jsym.nnz, jsym.full_kmax, jsym.banded)


GENERATORS = [
    ("poisson2d_coo", (7, 5), {}),
    ("poisson3d_coo", (4, 3, 5), {}),
    ("convection_diffusion_2d_coo", (6,), {"peclet": 3.0}),
    ("banded_spd_coo", (40,), {"bandwidth": 3, "seed": 2}),
    ("powerlaw_spd_coo", (80,), {"seed": 4}),
    ("circuit_spd_coo", (90,), {"seed": 1}),
    ("elasticity3d_coo", (3,), {"seed": 3, "edge_keep": 0.7}),
    ("bcsstk17_profile_coo", (), {}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_problem_generators_bitwise(name, args, kw):
    j = getattr(jproblems, name)(*args, **kw)
    t = getattr(tproblems, name)(*args, **kw)
    for a, b in zip(j[:3], t[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert j[3] == t[3]


def test_dense_and_rhs_generators_bitwise():
    assert np.array_equal(jproblems.random_spd_dense(12, seed=3),
                          tproblems.random_spd_dense(12, seed=3))
    assert np.array_equal(jproblems.reference_rhs(17), tproblems.reference_rhs(17))


def test_block_tridiag_matches_bench_generator():
    import bench

    j = bench._block_tridiag_np(1024, 128, 128)
    t = tproblems.block_tridiag_tiles(1024, 128, 128, seed=0)
    for a, b in zip(j[:2], t[:2]):
        assert np.array_equal(a, b)
    assert j[2] == t[2]


def test_mirror_index_lists_incoming_slots_in_row_order():
    # rows 0 and 1 both mirror into row 2; row 3's slot is padding (self)
    off_cols = np.array([[2, 0], [2, 3], [3, 2], [3, 3]], np.int32)
    idx = mirror_index(off_cols)
    assert idx.shape == (4, 2)
    assert idx[2].tolist() == [0, 2]  # slot 0*2+0, then slot 1*2+0
    assert idx[3].tolist() == [3, 4]  # slot 1*2+1, then slot 2*2+0
    assert idx[0].tolist() == [-1, -1] and idx[1].tolist() == [-1, -1]


def test_port_imports_no_jax():
    pkg = ROOT / "conjugategradient_tpu_torch"
    offenders = []
    for py in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(py.read_text(), str(py))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "conjugategradient_tpu"):
                    offenders.append(f"{py.relative_to(ROOT)}: {n}")
    assert not offenders, offenders
    assert len(list(pkg.rglob("*.py"))) >= 20


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "conjugategradient_tpu")


def test_loader_layouts(parsed):
    path = ROOT / "problems" / "poisson2d_34.mtx"
    for layout in ("auto", "dia", "symdia", "sell"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tloader.load_matrix(path, layout=layout)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloader.load_matrix(path, layout="sell", reorder=True)
    with pytest.raises(ValueError, match="unknown layout"):
        tloader.load_matrix(path, layout="tiles")
    csr = tloader.load_matrix(path, layout="csr", dtype=np.float64)
    data, indices, indptr, shape = parsed["poisson2d_34.mtx"][1]
    assert np.array_equal(csr.data.numpy(), data)
    assert np.array_equal(csr.indptr.numpy(), indptr)
    sym = tloader.load_matrix(path, layout="symbell", dtype=np.float32, bn=32)
    assert sym.dtype == torch.float32 and sym.bn == 32
    x = np.random.default_rng(0).standard_normal(shape[0])
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(sym.matvec(torch.from_numpy(x.astype(np.float32))).numpy(),
                               dense @ x, rtol=1e-5, atol=1e-4)
