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
    ["--layout", "dia"],
    ["--method", "pipelined"],
    ["--nrhs", "4"],
    ["--layout", "sell"],
    ["--layout", "auto"],
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
