"""The port's harness (``python -m conjugategradient_tpu_torch.tester``):
the reference protocol's one-line output, the JSON extras, and the exits
for what is not ported yet.  Runs on the CPU (``--device cpu``)."""

import json
import logging
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
    # --method pipelined|sstep, --precond amg|fsai on a matrix file, --deflate
    # and --eigs* are ported: their cases moved to the JAX refusals that now
    # apply (test_method_refusals_exit_2, test_nrhs_refusals_match_the_jax_tester,
    # test_eigs_and_deflate_refusals_match_the_jax_tester) and to runs against
    # the JAX tester (test_ca_and_assembled_preconds_...,
    # test_eigs_and_deflate_match_the_jax_tester); --refine and --dtype
    # bfloat16 are ported: their cases moved to runs against the JAX tester
    # (test_refine_and_bf16_match_the_jax_tester) and its refusals
    # (test_refine_refusals_match_the_jax_tester)
    ["--layout", "stencil"],
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
    # BiCGStab is ported: this case now holds the shift refusal on it
    pytest.param(["--method", "bicgstab", "--shift", "0.5"], "--shift drives --method minres",
                 id="--method bicgstab"),
    (["--method", "bicgstab", "--recompute", "8"], "--recompute drives the standard"),
    # GMRES is ported: this case now holds the shift refusal on it
    pytest.param(["--method", "gmres", "--shift", "0.5"], "--shift drives --method minres",
                 id="--method gmres"),
    # s-step is ported: this case now holds its refusal of a preconditioner
    pytest.param(["--method", "sstep", "--precond", "jacobi"],
                 "--method sstep is unpreconditioned", id="--method sstep"),
    (["--method", "sstep", "--recompute", "8"], "--recompute drives the standard"),
    (["--method", "sstep", "--precond", "amg"], "--method sstep is unpreconditioned"),
    (["--precond", "fsai", "--layout", "dia"], "--precond fsai needs --layout csr"),
    (["--precond", "amg", "--layout", "bell"], "--precond amg needs --layout csr"),
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


# --method bicgstab (the JAX tester's lane for nonsymmetric systems)
CONVDIFF = str(pathlib.Path(__file__).resolve().parents[1] / "problems" / "convdiff_34.mtx")


@pytest.mark.parametrize("extra", [
    [], ["--precond", "jacobi"],
    ["--layout", "bell", "--dtype", "float32", "--tol", "1e-3"],
    ["--layout", "dia", "--dtype", "float32", "--tol", "1e-3", "--precond", "jacobi"],
    ["--layout", "auto", "--dtype", "float32", "--tol", "1e-3"],
    ["--layout", "sell", "--dtype", "float32", "--tol", "1e-3", "--precond", "jacobi"],
], ids=lambda a: " ".join(a) or "csr-f64")
def test_bicgstab_matches_the_jax_tester(capsys, extra):
    """convdiff_34.mtx is a general (nonsymmetric) file: the reference line
    and the summary of the root tester, iteration counts equal in float64
    and a few steps apart at most in float32."""
    import tester as jtester

    # f64 to 1e-4 (4e-9 of ||b||): nearer the roundoff floor the two
    # packages' sum orders can part by a few steps
    args = [CONVDIFF, "--method", "bicgstab", "--tol", "1e-4", "--summary", *extra]
    assert jtester.main(args) == 0
    jlines = capsys.readouterr().out.strip().splitlines()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlines = capsys.readouterr().out.strip().splitlines()
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    trel, jrel = float(tlines[0].split()[3]), float(jlines[0].split()[3])
    if "float32" in extra:
        assert abs(ts["iterations"][0] - js["iterations"][0]) <= 4
        assert 0 <= trel < 1e-8
    else:
        assert ts["iterations"] == js["iterations"]
        # the final norm is ~1e-9 of ||b||: it agrees to the roundoff of the
        # run, 1e-10 of ||b|| (tests/test_torch_bicgstab.py's bound)
        bnorm = np.linalg.norm(np.arange(1, 1157, dtype=float))
        np.testing.assert_allclose(ts["final_rnorm"], js["final_rnorm"], rtol=0,
                                   atol=1e-10 * bnorm)
        np.testing.assert_allclose(trel, jrel, rtol=1e-2)
        assert trel < 1e-12


def test_bicgstab_history_holds_norms(capsys):
    rc = tester.main([CONVDIFF, "--method", "bicgstab", "--tol", "1e-6", "--device", "cpu",
                      "--history", "--summary"])
    lines = capsys.readouterr().out.strip().splitlines()
    summ, hist = json.loads(lines[1]), json.loads(lines[2])
    norms = np.array(hist["residual_norms"], float)
    assert rc == 0 and len(norms) == hist["iterations"] + 1 == summ["iterations"][0] + 1
    b = np.arange(1, 1157, dtype=float)
    np.testing.assert_allclose(norms[0], np.linalg.norm(b), rtol=1e-12)
    assert norms[-1] <= 1e-6 < norms[0]
    np.testing.assert_allclose(summ["final_rnorm"][0], norms[-1], rtol=1e-9)


# --method gmres, --precond blockjacobi|chebyshev, --progress, --estimate-steps
# and --verbose: each against the root tester on the same file
def _both(capsys, args):
    import tester as jtester

    jrc = jtester.main(args)
    jout = capsys.readouterr()
    trc = tester.main([*args, "--device", "cpu"])
    tout = capsys.readouterr()
    return (jrc, jout.out.strip().splitlines(), jout.err), (trc, tout.out.strip().splitlines(),
                                                            tout.err)


@pytest.mark.parametrize("extra", [
    ["--restart", "20"], ["--restart", "5", "--precond", "jacobi"],
    ["--precond", "blockjacobi", "--block-size", "4"],
    ["--layout", "dia", "--dtype", "float32", "--tol", "1"],
    ["--layout", "bell", "--dtype", "float32", "--tol", "1", "--restart", "40"],
], ids=lambda a: " ".join(a))
def test_gmres_matches_the_jax_tester(capsys, extra):
    """--method gmres on the general convdiff_34.mtx: equal iterations in
    float64, a few steps apart at most in float32 (to 4.4e-5 ||b||: 1e-3
    is below the float32 floor, where neither package converges)."""
    args = [CONVDIFF, "--method", "gmres", "--tol", "1e-4", "--summary", *extra]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    trel = float(tlines[0].split()[3])
    if "float32" in extra:
        assert abs(ts["iterations"][0] - js["iterations"][0]) <= 4 and 0 <= trel < 1e-8
    else:
        assert ts["iterations"] == js["iterations"]
        np.testing.assert_allclose(ts["final_rnorm"], js["final_rnorm"], rtol=1e-6)
        assert trel < 1e-12


@pytest.mark.parametrize("extra", [
    ["--precond", "blockjacobi"], ["--precond", "blockjacobi", "--block-size", "20"],
    ["--precond", "blockjacobi", "--block-size", "3", "--layout", "dia"],
    ["--precond", "blockjacobi", "--layout", "sell"],
    ["--precond", "chebyshev"], ["--precond", "chebyshev", "--cheb-degree", "4"],
    ["--precond", "blockjacobi", "--dtype", "float32", "--layout", "dia", "--tol", "1e-3"],
    ["--precond", "chebyshev", "--dtype", "float32", "--tol", "1e-3"],
], ids=lambda a: " ".join(a))
def test_new_preconditioners_match_the_jax_tester(capsys, extra):
    args = [MTX, "--tol", "1e-6", "--summary", *extra]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    if "float32" in extra:
        assert abs(ts["iterations"][0] - js["iterations"][0]) <= 2
        assert float(tlines[0].split()[3]) < 1e-8
    else:
        assert ts["iterations"] == js["iterations"]
        assert float(tlines[0].split()[3]) < 1e-16


def _log_lines(caplog, needle):
    lines = [r.getMessage() for r in caplog.records if needle in r.getMessage()]
    caplog.clear()
    return lines


def test_progress_logs_the_same_trace(capsys, caplog):
    """--progress 25: one 'iter k ||r||' line per chunk (the warm-up solve
    logs nothing), the root tester's k and ||r|| to 1e-6."""
    import tester as jtester

    args = [MTX, "--tol", "1e-8", "--progress", "25", "--summary"]
    caplog.set_level(logging.INFO, logger="conjugategradient_tpu")
    assert jtester.main(args) == 0
    jlines, jtrace = capsys.readouterr().out.strip().splitlines(), _log_lines(caplog, "iter ")
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlines, ttrace = capsys.readouterr().out.strip().splitlines(), _log_lines(caplog, "iter ")
    assert len(ttrace) == len(jtrace) >= 2
    parse = lambda lines: np.array([[float(w) for w in ln.split()[1::3]] for ln in lines])  # noqa
    tk, jk = parse(ttrace), parse(jtrace)  # (k, ||r||) per line
    assert np.array_equal(tk[:, 0], jk[:, 0])
    np.testing.assert_allclose(tk[:, 1], jk[:, 1], rtol=1e-6)  # the last is at the f64 floor
    k = json.loads(tlines[1])["iterations"][0]
    assert k == json.loads(jlines[1])["iterations"][0]
    assert ttrace[-1].startswith(f"iter {k} ") and all(t.startswith("iter ") for t in ttrace)


@pytest.mark.parametrize("extra", [[], ["--precond", "jacobi"], ["--layout", "dia"]],
                         ids=lambda a: " ".join(a) or "csr")
def test_estimate_steps_prints_the_same_line(capsys, extra):
    args = [MTX, "--tol", "1e-6", "--estimate-steps", *extra]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0
    assert tlines[0] == jlines[0] and tlines[0].startswith("expected_steps ")
    assert len(tlines) == len(jlines) == 2


def test_verbose_logs_the_load_and_the_interval(capsys, caplog):
    import tester as jtester

    args = [MTX, "--tol", "1e-6", "--precond", "chebyshev", "--verbose"]
    caplog.set_level(logging.DEBUG, logger="conjugategradient_tpu")
    assert jtester.main(args) == 0
    jlog = [r.getMessage() for r in caplog.records if r.levelno == logging.DEBUG]
    caplog.clear()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlog = [r.getMessage() for r in caplog.records if r.levelno == logging.DEBUG]
    capsys.readouterr()
    assert tlog == jlog and len(tlog) == 2
    assert tlog[0].startswith("loaded ") and tlog[1].startswith("chebyshev interval [")


@pytest.mark.parametrize("args,msg", [
    (["--progress", "10", "--method", "minres"], "--progress drives the standard single-RHS loop"),
    (["--progress", "10", "--method", "gmres"], "--progress drives the standard single-RHS loop"),
    (["--progress", "10", "--recompute", "8"], "--recompute drives the standard"),
    (["--method", "gmres", "--recompute", "8"], "--recompute drives the standard"),
    (["--precond", "chebyshev", "--cheb-degree", "1"], "chebyshev setup failed: degree must be"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else None)
def test_new_flag_refusals_match_the_jax_tester(capsys, args, msg):
    (jrc, jlines, jerr), (trc, tlines, terr) = _both(capsys, [MTX, *args])
    assert jrc == trc == 2 and not tlines and not jlines
    assert msg in terr and msg in jerr
    assert terr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]


# --nrhs R (lane j solves roll(b, j)) and --method block, against the root
# tester.  Float64: the same per-lane iterations and flags, and rel_error to
# 1e-3 relative (at the tolerance the true residual carries an absolute
# ~eps·‖A‖·‖x‖ of roundoff, 1e-4 of its size on poisson2d_34: the two
# packages' rel_error part by 6e-6 for the lockstep loops and 2.3e-4 for
# block CG).  Float32 at tol 1e-5 (4.4e-10 of ‖b‖, below the float32
# floor): a lane stops where its recurrence residual crosses the tolerance,
# which the sum order moves, so the counts agree within 10% (as in
# tests/test_torch_gmres.py; measured up to 8.5%, block CG's lane 2) and
# both rel_errors sit at the float32 floor.


def _nrhs_lines(lines):
    dim, nnz, ms, rel = lines[0].split()
    return (dim, nnz), float(ms), float(rel), json.loads(lines[1])


@pytest.mark.parametrize("extra", [
    [], ["--method", "block"], ["--method", "minres"], ["--precond", "jacobi"],
    ["--layout", "dia", "--precond", "blockjacobi"], ["--layout", "bell", "--bm", "8"],
    ["--layout", "symbell"], ["--layout", "sell", "--method", "minres"],
    ["--dtype", "float32"], ["--dtype", "float32", "--method", "block"],
    ["--dtype", "float32", "--method", "minres"],
], ids=lambda a: " ".join(a) or "csr-f64")
def test_nrhs_matches_the_jax_tester(capsys, extra):
    args = [MTX, "--nrhs", "4", "--tol", "1e-5", *extra]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0 and len(tlines) == len(jlines) == 2
    jdn, _, jrel, js = _nrhs_lines(jlines)
    tdn, tms, trel, ts = _nrhs_lines(tlines)
    assert tdn == jdn == ("1156", "5644")
    assert set(ts) == {"nrhs", "iterations", "converged", "per_rhs_ms"} and ts["nrhs"] == 4
    np.testing.assert_allclose(ts["per_rhs_ms"], tms / 4, rtol=1e-12)
    assert ts["converged"] == js["converged"] == [True] * 4
    if "float32" in extra:
        assert np.all(np.abs(np.subtract(ts["iterations"], js["iterations"]))
                      <= 0.1 * np.array(js["iterations"]))
        assert 0 <= trel < 1e-10 and 0 <= jrel < 1e-10
    else:
        assert ts["iterations"] == js["iterations"]
        np.testing.assert_allclose(trel, jrel, rtol=1e-3)


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_nrhs_nonsymmetric_matches_the_jax_tester(capsys, method):
    args = [CONVDIFF, "--method", method, "--nrhs", "3", "--tol", "1e-4", "--summary",
            "--history"]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0 and len(tlines) == len(jlines) == 4
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    for i in (1, 2):  # the per-lane line and the summary: every lane
        tj, jj = json.loads(tlines[i]), json.loads(jlines[i])
        assert tj["iterations"] == jj["iterations"] and tj["converged"] == jj["converged"]
        assert len(tj["iterations"]) == 3
    # norms to 1e-10 of ‖b‖, the bound of test_bicgstab_matches_the_jax_tester:
    # the final ones are ~1e-9 of ‖b‖, where the sum orders part
    atol = 1e-10 * np.linalg.norm(np.arange(1, 1157, dtype=float))
    np.testing.assert_allclose(json.loads(tlines[2])["final_rnorm"],
                               json.loads(jlines[2])["final_rnorm"], rtol=0, atol=atol)
    th, jh = json.loads(tlines[3]), json.loads(jlines[3])  # the history: lane 0
    assert th["iterations"] == jh["iterations"] == json.loads(tlines[1])["iterations"][0]
    # BiCGStab on convdiff_34 amplifies the sum order mid-solve: its solo
    # solves part by 0.28 (6.6e-4 relative) in float64 in both packages'
    # pairing, and each package's lane 0 equals its own solo solve
    rtol = 1e-3 if method == "bicgstab" else 0
    np.testing.assert_allclose(np.array(th["residual_norms"], float),
                               np.array(jh["residual_norms"], float), rtol=rtol, atol=atol)


def test_block_nrhs_1_and_history_match_the_jax_tester(capsys):
    """--method block with --nrhs 1: a block of one lane, no per-lane line;
    --summary and --history as the root tester prints them."""
    args = [MTX, "--method", "block", "--tol", "1e-6", "--summary", "--history"]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0 and len(tlines) == len(jlines) == 3
    ts, js = json.loads(tlines[1]), json.loads(jlines[1])
    assert ts["iterations"] == js["iterations"] and len(ts["iterations"]) == 1
    th, jh = json.loads(tlines[2]), json.loads(jlines[2])
    assert th["iterations"] == jh["iterations"] == ts["iterations"][0]
    np.testing.assert_allclose(np.array(th["residual_norms"], float),
                               np.array(jh["residual_norms"], float), rtol=1e-6, atol=1e-9)


def test_nrhs_on_the_stencil(capsys):
    """A stencil: input has no multi-RHS SpMV: each lane runs the solo
    portable loop (kernel 11 on the card), as the JAX package vmaps it."""
    args = ["stencil:12x10x9", "--nrhs", "3", "--tol", "1e-6", "--summary"]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0
    assert tlines[0].split()[:2] == jlines[0].split()[:2]
    assert json.loads(tlines[1])["iterations"] == json.loads(jlines[1])["iterations"]
    assert json.loads(tlines[2])["converged"] == [True] * 3


@pytest.mark.parametrize("args,msg", [
    (["--nrhs", "4", "--progress", "10"], "--progress drives the standard single-RHS loop"),
    (["--nrhs", "4", "--recompute", "8"], "--recompute drives the standard"),
    (["--method", "block", "--recompute", "8"], "--recompute drives the standard"),
    (["--method", "block", "--progress", "10"], "--progress drives the standard single-RHS loop"),
    (["--method", "block", "--shift", "0.5"], "--shift drives --method minres"),
    (["--nrhs", "4", "--shift", "0.5"], "--shift drives --method minres"),
    # pipelined and s-step are ported: the JAX refusal of --nrhs applies
    (["--nrhs", "4", "--method", "pipelined"], "--nrhs > 1 uses the lockstep loop"),
    (["--nrhs", "4", "--method", "sstep"], "--nrhs > 1 uses the lockstep loop"),
    (["--method", "sstep", "--precond", "jacobi"], "--method sstep is unpreconditioned"),
    (["--method", "sstep", "--recompute", "8"], "--recompute drives the standard"),
    (["--precond", "fsai", "--layout", "bell"], "--precond fsai needs --layout csr"),
    (["--precond", "amg", "--layout", "sell"], "--precond amg needs --layout csr"),
    # --eigs and --deflate are ported: the JAX refusals of --nrhs apply
    (["--nrhs", "4", "--eigs", "2"], "--eigs is an eigensolver lane"),
    (["--nrhs", "4", "--deflate", "2"], "--deflate drives the standard single-RHS loop"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else None)
def test_nrhs_refusals_match_the_jax_tester(capsys, args, msg):
    (jrc, jlines, jerr), (trc, tlines, terr) = _both(capsys, [MTX, *args])
    assert jrc == trc == 2 and not tlines and not jlines
    assert msg in terr and msg in jerr
    assert terr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]


@pytest.mark.parametrize("args,jax_msg", [
    (["--nrhs", "4", "--refine", "float32"], "--refine drives the single-RHS standard loop"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else None)
def test_nrhs_with_unported_flags_exit_2(capsys, args, jax_msg):
    """The root tester's --nrhs refusals of flags that were unported here
    (--refine is ported now): both exit 2 with the root tester's message."""
    (jrc, _, jerr), (trc, tlines, terr) = _both(capsys, [MTX, *args])
    assert jrc == trc == 2 and not tlines
    assert jax_msg in jerr and jax_msg in terr
    assert terr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]


# --method pipelined|sstep and --precond amg|fsai on a matrix file, against
# the root tester's line: float64 iteration counts equal, the final norm to
# 1e-10 of ||b||; s-step at s = 4 runs at 1e-4 (4e-9 of ||b||), where its
# monomial basis stays off the float64 roundoff floor (nearer it the two
# packages' counts part: 124 against 136 at 1e-8); float32 counts within 4
@pytest.mark.parametrize("extra", [
    ["--method", "pipelined", "--tol", "1e-8"],
    ["--method", "pipelined", "--precond", "jacobi", "--tol", "1e-8"],
    ["--method", "pipelined", "--precond", "amg", "--tol", "1e-8"],
    ["--method", "pipelined", "--recompute", "25", "--tol", "1e-8"],
    ["--method", "pipelined", "--precond", "jacobi", "--tol", "1e-3", "--dtype", "float32",
     "--recompute", "50"],
    ["--method", "pipelined", "--layout", "dia", "--dtype", "float32", "--tol", "1e-3"],
    ["--method", "sstep", "--tol", "1e-4"],
    ["--method", "sstep", "--sstep-s", "2", "--tol", "1e-8"],
    # float32 s-step at 4e-6 of ||b||: at 1e-3 (4e-8, the float32 floor) the
    # two packages' counts part by 12
    ["--method", "sstep", "--sstep-s", "2", "--layout", "bell", "--dtype", "float32",
     "--tol", "1e-1"],
    ["--precond", "amg", "--tol", "1e-8"],
    ["--precond", "amg", "--smoother", "chebyshev", "--tol", "1e-8"],
    ["--precond", "amg", "--method", "gmres", "--tol", "1e-8"],
    ["--precond", "amg", "--method", "bicgstab", "--tol", "1e-8"],
    ["--precond", "amg", "--dtype", "float32", "--tol", "1e-3"],
    ["--precond", "fsai", "--tol", "1e-8"],
    ["--precond", "fsai", "--fsai-power", "2", "--tol", "1e-8"],
    ["--precond", "fsai", "--method", "minres", "--tol", "1e-8"],
    ["--precond", "fsai", "--dtype", "float32", "--tol", "1e-3"],
], ids=lambda a: " ".join(a))
def test_ca_and_assembled_preconds_match_the_jax_tester(capsys, extra):
    (jrc, jlines, _), (trc, tlines, terr) = _both(capsys, [MTX, "--summary", *extra])
    assert jrc == trc == 0, terr
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    assert ts["converged"] == js["converged"] == [True]
    trel = float(tlines[0].split()[3])
    if "float32" in extra:
        assert abs(ts["iterations"][0] - js["iterations"][0]) <= 4
        assert 0 <= trel < 1e-8
    else:
        assert ts["iterations"] == js["iterations"]
        bnorm = np.linalg.norm(np.arange(1, 1157, dtype=float))
        np.testing.assert_allclose(ts["final_rnorm"], js["final_rnorm"], rtol=0,
                                   atol=1e-10 * bnorm)
        assert 0 <= trel < 1e-20


def test_gmres_with_amg_prints_no_tpu_warning(capsys):
    """The JAX tester forces CSR-layout AMG levels under --method gmres and
    warns about a TPU worker fault; the port keeps the default level layout
    (DIA levels where a level qualifies) and prints no such warning."""
    rc = tester.main([MTX, "--precond", "amg", "--method", "gmres", "--tol", "1e-6",
                      "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0 and "TPU" not in out.err and "warning" not in out.err


# --eigs and --deflate (queue 1 item 8), against the root tester
@pytest.mark.parametrize("args,msg", [
    (["--eigs", "2", "--nrhs", "2"], "--eigs is an eigensolver lane"),
    (["--eigs", "2", "--eigs-method", "lanczos", "--precond", "jacobi"],
     "--eigs-method lanczos is unpreconditioned"),
    (["--eigs", "2", "--eigs-method", "lanczos", "--history"],
     "--history needs --eigs-method lobpcg"),
    (["--eigs", "2", "--method", "minres"], "--eigs is an eigensolver lane"),
    (["--eigs", "2", "--recompute", "8"], "--eigs is an eigensolver lane"),
    (["--deflate", "2", "--nrhs", "2"], "--deflate drives the standard single-RHS loop"),
    (["--deflate", "2", "--method", "sstep"], "--deflate drives the standard single-RHS loop"),
    (["--deflate", "2", "--progress", "10"], "--deflate drives the standard single-RHS loop"),
    (["--deflate", "2", "--recompute", "8"], "--recompute drives the standard"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else None)
def test_eigs_and_deflate_refusals_match_the_jax_tester(capsys, args, msg):
    (jrc, jlines, jerr), (trc, tlines, terr) = _both(capsys, [MTX, *args])
    assert jrc == trc == 2 and not tlines and not jlines
    assert msg in terr and msg in jerr
    assert terr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]


# float64 eigenvalues to 1e-10 relative (the same solve on the same inputs),
# float32 to 1e-4 (unconverged runs to the cap: 1.6e-5 measured); the
# residual-based fields of float32 runs are not pinned (their residuals sit
# at the float32 floor, where the sum order moves them)
EIGS_CASES = [
    ["--eigs", "4", "--precond", "jacobi", "--eigs-iters", "80", "--dtype", "float32"],
    ["--eigs", "3", "--eigs-method", "lanczos", "--eigs-which", "largest", "--eigs-iters", "60",
     "--dtype", "float32"],
    ["--eigs", "2", "--dtype", "float32", "--eigs-iters", "15", "--history"],
    ["--eigs", "3", "--eigs-iters", "40", "--eigs-tol", "1e-3", "--history"],
    ["--eigs", "3", "--eigs-method", "lanczos", "--eigs-iters", "80", "--eigs-tol", "1e-4"],
    ["--eigs", "2", "--eigs-which", "largest", "--layout", "dia", "--precond", "blockjacobi"],
]


@pytest.mark.parametrize("extra", EIGS_CASES, ids=lambda a: " ".join(a))
def test_eigs_lines_match_the_jax_tester(capsys, extra):
    (jrc, jlines, _), (trc, tlines, terr) = _both(capsys, [MTX, *extra])
    assert jrc == trc == 0, terr
    assert len(tlines) == len(jlines) == (3 if "--history" in extra else 2)
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    tj, jj = json.loads(tlines[1]), json.loads(jlines[1])
    assert set(tj) == set(jj) == {"eigenvalues", "residuals", "converged", "iterations",
                                  "which", "method"}
    assert (tj["which"], tj["method"], tj["iterations"]) == (jj["which"], jj["method"],
                                                             jj["iterations"])
    f32 = "float32" in extra
    np.testing.assert_allclose(tj["eigenvalues"], jj["eigenvalues"], rtol=1e-4 if f32 else 1e-10)
    lam = tj["eigenvalues"]
    assert lam == sorted(lam, reverse="largest" in extra)
    if not f32:
        assert tj["converged"] == jj["converged"]
        np.testing.assert_allclose(tj["residuals"], jj["residuals"], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(float(tlines[0].split()[3]), float(jlines[0].split()[3]),
                                   rtol=1e-6)
    if "--history" in extra:
        th, jh = json.loads(tlines[2]), json.loads(jlines[2])
        assert (len(th["eigenvalue_history"]) == tj["iterations"] + 1
                == len(jh["eigenvalue_history"]))
        np.testing.assert_allclose(th["eigenvalue_history"], jh["eigenvalue_history"],
                                   rtol=1e-4 if f32 else 1e-10)
        assert np.array(th["residual_history"]).shape == np.array(jh["residual_history"]).shape


def test_eigs_lobpcg_lane_finds_the_poisson_minimum(capsys):
    """tests/test_lobpcg.py's lane: Jacobi LOBPCG's smallest eigenvalue is
    2-D Poisson's 4(1 - cos(pi/35)) to 1e-3."""
    rc, lines, _ = _run(capsys, "--eigs", "4", "--dtype", "float32", "--precond", "jacobi",
                        "--eigs-iters", "80", "--device", "cpu")
    rec = json.loads(lines[-1])
    assert rc == 0 and rec["method"] == "lobpcg" and rec["which"] == "smallest"
    np.testing.assert_allclose(rec["eigenvalues"][0], 4.0 * (1.0 - np.cos(np.pi / 35.0)),
                               rtol=1e-3)


@pytest.mark.parametrize("extra", [
    ["--deflate", "8", "--tol", "1e-8"],
    ["--deflate", "4", "--deflate-m", "40", "--precond", "jacobi", "--tol", "1e-8", "--history"],
    ["--deflate", "6", "--layout", "dia", "--tol", "1e-8"],
    # float32 at 4.4e-6 of ||b||: at 1e-3 (4.4e-8, below the float32 floor)
    # both packages stop at the divergence guard, unconverged
    ["--deflate", "8", "--layout", "bell", "--bm", "8", "--dtype", "float32", "--tol", "1e-1"],
], ids=lambda a: " ".join(a))
def test_deflate_lines_match_the_jax_tester(capsys, extra):
    """--deflate: the harvest outside the timed region, then the deflated
    solve; float64 counts equal and rel_error < 1e-10 (tests/test_deflated.py's
    bound for the JAX tester), float32 counts within 4."""
    args = [MTX, "--summary", *extra]
    (jrc, jlines, _), (trc, tlines, terr) = _both(capsys, args)
    assert jrc == trc == 0, terr
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    ts, js = json.loads(tlines[1]), json.loads(jlines[1])
    assert ts["converged"] == js["converged"] == [True]
    trel = float(tlines[0].split()[3])
    assert 0 <= trel < 1e-10
    if "float32" in extra:
        assert abs(ts["iterations"][0] - js["iterations"][0]) <= 4
    else:
        assert ts["iterations"] == js["iterations"]
        bnorm = np.linalg.norm(np.arange(1, 1157, dtype=float))
        np.testing.assert_allclose(ts["final_rnorm"], js["final_rnorm"], rtol=0,
                                   atol=1e-10 * bnorm)
    if "--history" in extra:
        th, jh = json.loads(tlines[2]), json.loads(jlines[2])
        assert th["iterations"] == jh["iterations"] and th["converged"] is True
        np.testing.assert_allclose(th["residual_norms"], jh["residual_norms"], rtol=1e-6,
                                   atol=1e-9)


def test_deflate_verbose_logs_the_basis_quality(capsys, caplog):
    import tester as jtester

    args = [MTX, "--deflate", "8", "--tol", "1e-6", "--verbose"]
    caplog.set_level(logging.DEBUG, logger="conjugategradient_tpu")
    assert jtester.main(args) == 0
    jlog = [r.getMessage() for r in caplog.records if "deflation basis" in r.getMessage()]
    caplog.clear()
    assert tester.main([*args, "--device", "cpu"]) == 0
    tlog = [r.getMessage() for r in caplog.records if "deflation basis" in r.getMessage()]
    capsys.readouterr()
    assert len(tlog) == len(jlog) == 1
    assert tlog[0].startswith("deflation basis k=8 max Ritz residual ")
    np.testing.assert_allclose(float(tlog[0].split()[-1]), float(jlog[0].split()[-1]), rtol=1e-2)


# ---- --refine and --dtype bfloat16 ------------------------------------------

@pytest.mark.parametrize("layout", ["csr", "bell", "dia"])
@pytest.mark.parametrize("extra", [
    ["--dtype", "float32", "--refine", "bfloat16", "--tol", "1"],
    ["--dtype", "float64", "--refine", "float32", "--tol", "1e-8"],
    ["--dtype", "bfloat16", "--tol", "1"],
], ids=lambda a: " ".join(a))
def test_refine_and_bf16_match_the_jax_tester(capsys, extra, layout):
    """--refine and --dtype bfloat16 on poisson2d_34 against the JAX tester:
    dim and nnz equal, the same converged, rel_error under the bound of
    the run's dtype (float64 refinement 1e-20, float32 refinement 1e-10,
    bfloat16 5e-3; measured 4.1e-29, 1.8e-14 and 1.3e-3 against the JAX
    tester's 4.1e-29, 2.0e-14 and 1.3e-3), equal inner iterations for
    float64 over float32 and within 15% otherwise (bfloat16 vector
    arithmetic rounds at other places in XLA), and the --history record's
    keys: the labelled refine record, or the plain one."""
    args = [MTX, "--layout", layout, "--summary", "--history", *extra]
    (jrc, jlines, _), (trc, tlines, _) = _both(capsys, args)
    assert jrc == trc == 0
    assert tlines[0].split()[:2] == jlines[0].split()[:2] == ["1156", "5644"]
    js, ts = json.loads(jlines[1]), json.loads(tlines[1])
    jh, th = json.loads(jlines[2]), json.loads(tlines[2])
    assert ts["converged"] == js["converged"] == [True]
    assert set(th) == set(jh)
    bound = {"float64": 1e-20, "float32": 1e-10, "bfloat16": 5e-3}[extra[1]]
    assert 0 <= float(tlines[0].split()[3]) < bound
    if "--refine" in extra:
        assert set(th) == {"inner_iterations", "converged", "outer_residual_norms"}
        assert th["converged"] is True and th["outer_residual_norms"][-1] <= float(extra[-1])
    else:
        assert set(th) == {"iterations", "converged", "residual_norms"}
    ti, ji = ts["iterations"][0], js["iterations"][0]
    if extra[1] == "float64":
        assert ti == ji
        # the last entries are rounding-sized (1e-13 of the first): held to
        # 1e-12 of the first, the others to 1e-6 relative
        h = jh["outer_residual_norms"]
        np.testing.assert_allclose(th["outer_residual_norms"], h, rtol=1e-6, atol=1e-12 * h[0])
    else:
        assert abs(ti - ji) <= 0.15 * ji


@pytest.mark.parametrize("args,msg", [
    (["--refine", "float32", "--method", "minres"], "--refine drives the standard loop"),
    (["--refine", "float32", "--method", "block", "--nrhs", "2"],
     "--refine drives the standard loop"),
    (["--refine", "float32", "--progress", "5"], "--refine drives the standard loop"),
    (["--refine", "bfloat16", "--dtype", "bfloat16"], "is not below --dtype bfloat16"),
    (["--refine", "float32", "--dtype", "float32"], "is not below --dtype float32"),
    (["--refine", "float32", "--recompute", "5"], "--recompute drives the standard"),
    (["--refine", "float32", "--deflate", "2"], "--deflate drives the standard single-RHS"),
    (["--refine", "float32", "--eigs", "2"], "--eigs is an eigensolver lane"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else None)
def test_refine_refusals_match_the_jax_tester(capsys, args, msg):
    (jrc, jlines, jerr), (trc, tlines, terr) = _both(capsys, [MTX, *args])
    assert jrc == trc == 2 and not tlines and not jlines
    assert msg in terr and msg in jerr
    assert terr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]


def test_bf16_symdia_and_stencil_run_on_the_cpu(capsys):
    """The bf16 SymDIA and stencil products run their plain versions on the
    CPU, as the JAX tester runs them: the same dim and nnz, converged,
    rel_error under 5e-3 (on the card SymDIA runs kernel 10's bf16 forms;
    the stencil on bf16 vectors has no kernel yet)."""
    for args in ([MTX, "--layout", "symdia", "--dtype", "bfloat16", "--tol", "1"],
                 ["stencil:8", "--dtype", "bfloat16", "--tol", "1"],
                 ["stencil:8", "--dtype", "float32", "--refine", "bfloat16", "--tol", "1e-1"]):
        (jrc, jlines, _), (trc, tlines, _) = _both(capsys, [*args, "--summary"])
        assert jrc == trc == 0
        assert tlines[0].split()[:2] == jlines[0].split()[:2]
        assert json.loads(tlines[1])["converged"] == json.loads(jlines[1])["converged"] == [True]
        assert 0 <= float(tlines[0].split()[3]) < 5e-3


def test_bf16_unported_kernels_exit_2_on_cuda(capsys):
    """No bf16 run exits 2 any more.  The tester used to refuse, on --device
    cuda, the bf16 runs that reached a kernel with no bf16 form (the stencil
    on bf16 vectors); every kernel the tester reaches now has one (the
    stencil's ``stencil7_bf16``, with the C entry the library binds), so
    the gate is gone and the runs it refused run: here on the CPU through
    the same wrappers, in ``tests/test_torch_cuda.py`` on the card."""
    from conjugategradient_tpu_torch.ops.cuda import _build, _common

    assert not hasattr(tester, "_bf16_unported")
    for name, entry in (("stencil7", "cg_stencil7"), ("bell_spmv_dot", "cg_bell_spmv_dot"),
                        ("bicgstab_dir_spmv_dot", "bicgstab_dir"),
                        ("bicgstab_s_spmv_dot", "bicgstab_s"),
                        ("bicgstab_dir_spmv_dot_packed", "bicgstab_dir_packed"),
                        ("bicgstab_s_spmv_dot_packed", "bicgstab_s_packed")):
        assert f"{name}_bf16" in _common.LAUNCHES and f"{entry}_bf16" in _build.SIGNATURES
    for args in (["stencil:8", "--dtype", "bfloat16", "--tol", "1"],
                 [MTX, "--layout", "symdia", "--dtype", "bfloat16", "--tol", "1"],
                 ["stencil:8", "--dtype", "float32", "--refine", "bfloat16", "--tol", "1e-1"]):
        rc = tester.main([*args, "--device", "cpu"])
        out = capsys.readouterr()
        assert rc == 0 and "not yet ported" not in out.err, args
        assert len(out.out.strip().splitlines()) == 1
