"""The port's harness (``python -m conjugategradient_tpu_torch.tester``):
the reference protocol's one-line output, the JSON extras, and the exits
for what is not ported yet.  Runs on the CPU (``--device cpu``)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch import tester

MTX = str(pathlib.Path(__file__).resolve().parents[1] / "problems" / "poisson2d_34.mtx")
SYMBELL = ["--layout", "symbell", "--dtype", "float32", "--device", "cpu"]


def _run(capsys, *args):
    rc = tester.main([MTX, *args])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def test_symbell_f32_prints_four_fields(capsys):
    rc, lines, _ = _run(capsys, *SYMBELL, "--tol", "1e-3")
    assert rc == 0 and len(lines) == 1
    fields = lines[0].split()
    assert len(fields) == 4
    dim, nnz, ms, rel = int(fields[0]), int(fields[1]), float(fields[2]), float(fields[3])
    assert (dim, nnz) == (1156, 5644)
    assert ms > 0 and 0 <= rel < 1e-10


def test_history_is_valid_json(capsys):
    rc, lines, _ = _run(capsys, *SYMBELL, "--precond", "jacobi", "--tol", "1e-3",
                        "--history", "--summary")
    assert rc == 0 and len(lines) == 3
    summ, hist = json.loads(lines[1]), json.loads(lines[2])
    k = hist["iterations"]
    assert summ["iterations"] == [k] and summ["converged"] == [True]
    assert hist["converged"] is True and len(hist["residual_norms"]) == k + 1
    norms = np.array(hist["residual_norms"], float)
    assert norms[-1] <= 1e-3 < norms[0]
    np.testing.assert_allclose(summ["final_rnorm"][0], norms[-1], rtol=1e-6)


def test_default_csr_f64_matches_reference_protocol(capsys):
    rc, lines, _ = _run(capsys, "--device", "cpu", "--tol", "1e-8", "--summary")
    assert rc == 0
    rel = float(lines[0].split()[3])
    assert rel < 1e-20
    assert json.loads(lines[1])["converged"] == [True]


@pytest.mark.parametrize("args", [
    ["--method", "pipelined"],
    ["--nrhs", "4"],
    ["--refine", "bfloat16"],
    ["--eigs", "2"],
    ["--layout", "stencil"],
    ["--dtype", "bfloat16"],
    ["--precond", "amg"],
], ids=lambda a: " ".join(a))
def test_unported_flags_exit_2(capsys, args):
    rc, lines, err = _run(capsys, "--device", "cpu", *args)
    assert rc == 2 and not lines
    assert "not yet ported" in err


BELL = ["--layout", "bell", "--dtype", "float32", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--bm", "8"], ["--precond", "jacobi"]],
                         ids=["128x128", "8x128", "jacobi"])
def test_bell_f32_prints_four_fields(capsys, extra):
    rc, lines, _ = _run(capsys, *BELL, "--tol", "1e-3", "--summary", *extra)
    assert rc == 0 and len(lines) == 2
    dim, nnz, ms, rel = lines[0].split()
    assert (int(dim), int(nnz)) == (1156, 5644)
    assert float(ms) > 0 and 0 <= float(rel) < 1e-10
    assert json.loads(lines[1])["converged"] == [True]


def test_reorder_keeps_dim_nnz_and_error(capsys):
    rc, lines, _ = _run(capsys, *BELL, "--tol", "1e-3", "--reorder")
    assert rc == 0 and len(lines) == 1
    dim, nnz, _, rel = lines[0].split()
    assert (int(dim), int(nnz)) == (1156, 5644) and float(rel) < 1e-10
    rc, lines, _ = _run(capsys, "--device", "cpu", "--tol", "1e-8", "--reorder")
    assert rc == 0 and float(lines[0].split()[3]) < 1e-20


def test_recompute_runs_and_replaces(capsys):
    rc, lines, _ = _run(capsys, *BELL, "--tol", "1e-3", "--maxiter", "24",
                        "--recompute", "8", "--history")
    assert rc == 0 and len(lines) == 2
    hist = json.loads(lines[1])
    assert hist["iterations"] == 24 and len(hist["residual_norms"]) == 25
    assert all(v is not None and v > 0 for v in hist["residual_norms"])
    rc, _, err = _run(capsys, *BELL, "--recompute", "-1")
    assert rc == 2 and "--recompute" in err


def test_missing_file_exits_2(capsys):
    rc = tester.main(["/nonexistent/matrix.mtx", "--device", "cpu"])
    assert rc == 2
    assert "cannot read" in capsys.readouterr().err


def test_cuda_device_without_gpu_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs there")
    rc = tester.main([MTX])  # --device cuda is the default
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


# the port's tester against the JAX package's (the root tester.py), f64 with
# the same flags: the same "dim NNZ" and a rel_error under REL_BOUND on both
# (tol 1e-8 absolute on ||r||, so ||r||^2 <= 1e-16 while ||x||^2 >= 1e4)
REL_BOUND = 1e-18
PROBLEMS = pathlib.Path(MTX).parent
LAYOUT_CASES = [
    ("poisson2d_34", "auto", False), ("poisson2d_34", "dia", False),
    ("poisson2d_34", "symdia", False), ("poisson2d_34", "sell", False),
    ("poisson2d_34", "auto", True), ("poisson2d_34", "dia", True),
    ("powerlaw_1138", "auto", False), ("powerlaw_1138", "sell", False),
    ("powerlaw_1138", "auto", True), ("powerlaw_1138", "sell", True),
]


@pytest.mark.parametrize("name,layout,reorder", LAYOUT_CASES,
                         ids=[f"{n}-{lay}{'-reorder' if r else ''}" for n, lay, r in LAYOUT_CASES])
def test_layouts_match_the_jax_tester(capsys, name, layout, reorder):
    import tester as jtester  # the JAX package's harness, at the repository root

    args = [str(PROBLEMS / f"{name}.mtx"), "--layout", layout, "--tol", "1e-8"]
    args += ["--reorder"] if reorder else []
    assert jtester.main(args) == 0
    jline = capsys.readouterr().out.strip().splitlines()[0].split()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[0].split()
    assert tline[:2] == jline[:2]
    assert 0 <= float(tline[3]) < REL_BOUND and 0 <= float(jline[3]) < REL_BOUND


@pytest.mark.parametrize("layout", ["auto", "dia", "symdia", "sell"])
def test_new_layouts_f32_jacobi(capsys, layout):
    rc, lines, _ = _run(capsys, "--layout", layout, "--dtype", "float32", "--device", "cpu",
                        "--precond", "jacobi", "--tol", "1e-3", "--summary")
    assert rc == 0 and len(lines) == 2
    dim, nnz, ms, rel = lines[0].split()
    assert (int(dim), int(nnz)) == (1156, 5644)
    assert float(ms) > 0 and 0 <= float(rel) < 1e-10
    assert json.loads(lines[1])["converged"] == [True]


def test_symdia_on_a_nonsymmetric_file_exits_2(capsys):
    rc = tester.main([str(PROBLEMS / "convdiff_34.mtx"), "--layout", "symdia", "--device", "cpu"])
    assert rc == 2 and "not symmetric" in capsys.readouterr().err


# the matrix-free stencil: input (the JAX tester's pseudo-input)
def test_stencil_matches_the_jax_tester(capsys):
    import tester as jtester

    assert jtester.main(["stencil:16"]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[0].split()
    rc = tester.main(["stencil:16", "--device", "cpu"])
    tline = capsys.readouterr().out.strip().splitlines()[0].split()
    assert rc == 0 and tline[:2] == jline[:2] == ["4096", "27136"]
    assert 0 <= float(tline[3]) < 1e-20


@pytest.mark.parametrize("args,msg", [
    (["stencil:16", "--layout", "bell"], "matrix-free"),
    (["stencil:16", "--reorder"], "matrix-free"),
    (["stencil:4x5"], "cannot parse"),
    (["stencil:8x8x1"], "cannot parse"),
    (["stencil:1"], "cannot parse"),
    (["stencil:abc"], "cannot parse"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else a)
def test_stencil_refusals_exit_2(capsys, args, msg):
    rc = tester.main([*args, "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 2 and not out.out and msg in out.err


@pytest.mark.parametrize("extra", [
    ["--precond", "amg"], ["--precond", "amg", "--smoother", "chebyshev"],
    ["--precond", "jacobi"], ["--dtype", "float32"],
    ["--dtype", "float32", "--precond", "amg", "--smoother", "chebyshev"],
], ids=lambda a: " ".join(a))
def test_stencil_solves(capsys, extra):
    rc = tester.main(["stencil:12x10x9", "--device", "cpu", "--tol", "1e-3", "--summary", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 2
    dim, nnz, ms, rel = lines[0].split()
    assert (int(dim), int(nnz)) == (1080, 7560 - 2 * (90 + 108 + 120))
    assert float(ms) > 0 and 0 <= float(rel) < 1e-8
    summ = json.loads(lines[1])
    assert summ["converged"] == [True]
    if "amg" in extra:
        assert summ["iterations"][0] <= 12


# --method minres and --shift (the JAX tester's lane for symmetric indefinite systems)
@pytest.mark.parametrize("extra", [
    [], ["--precond", "jacobi"], ["--layout", "symbell", "--dtype", "float32", "--tol", "1e-1"],
    ["--layout", "bell", "--dtype", "float32", "--tol", "1e-1", "--precond", "jacobi"],
], ids=lambda a: " ".join(a) or "csr-f64")
def test_minres_matches_the_jax_tester(capsys, extra):
    import tester as jtester

    args = [MTX, "--method", "minres", "--tol", "1e-8", "--summary", *extra]
    assert jtester.main(args) == 0
    jlines = capsys.readouterr().out.strip().splitlines()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlines = capsys.readouterr().out.strip().splitlines()
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    if "float32" in extra:  # f32 counts are not pinned: a few steps apart at most
        assert abs(ts["iterations"][0] - js["iterations"][0]) <= 4
    else:
        assert ts["iterations"] == js["iterations"]
        np.testing.assert_allclose(ts["final_rnorm"], js["final_rnorm"], rtol=1e-6)
    assert 0 <= float(tlines[0].split()[3]) < (1e-8 if "float32" in extra else 1e-20)


def test_minres_shift_history_is_norms_and_rel_error_uses_the_shifted_operator(capsys):
    """--shift inside the spectrum (indefinite): the history line holds the
    estimates themselves (the adapter squares them, the printing takes the
    root), non-increasing, and rel_error is that of (A - shift I) x = b."""
    import tester as jtester

    args = [MTX, "--method", "minres", "--shift", "0.5", "--tol", "1e-6", "--maxiter", "5000",
            "--history", "--summary"]
    assert jtester.main(args) == 0
    jlines = capsys.readouterr().out.strip().splitlines()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlines = capsys.readouterr().out.strip().splitlines()
    th, jh = json.loads(tlines[2]), json.loads(jlines[2])
    assert th["converged"] is True and jh["converged"] is True
    norms = np.array(th["residual_norms"], float)
    assert len(norms) == th["iterations"] + 1 and norms[-1] <= 1e-6 < norms[0]
    assert np.all(np.diff(norms) <= 1e-12 * norms[0])
    np.testing.assert_allclose(norms[:40], np.array(jh["residual_norms"], float)[:40], rtol=1e-9)
    assert 0 <= float(tlines[0].split()[3]) < 1e-16 and float(jlines[0].split()[3]) < 1e-16


@pytest.mark.parametrize("args,msg", [
    (["--shift", "0.5"], "--shift drives --method minres"),
    (["--method", "minres", "--recompute", "8"], "--recompute drives the standard"),
    (["--method", "bicgstab"], "not yet ported"),
    (["--method", "gmres"], "not yet ported"),
    (["--method", "sstep"], "not yet ported"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else None)
def test_method_refusals_exit_2(capsys, args, msg):
    rc, lines, err = _run(capsys, "--device", "cpu", *args)
    assert rc == 2 and not lines and msg in err


def test_minres_on_the_stencil_with_multigrid(capsys):
    rc = tester.main(["stencil:12x10x9", "--device", "cpu", "--method", "minres",
                      "--precond", "amg", "--tol", "1e-6", "--summary"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and json.loads(lines[1])["converged"] == [True]
    assert json.loads(lines[1])["iterations"][0] <= 12 and float(lines[0].split()[3]) < 1e-12
