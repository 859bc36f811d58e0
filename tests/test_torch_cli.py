"""The port's console entry points (``conjugategradient_tpu_torch/cli.py``)
and its copy of ``tools/make_problem.py`` (``make_problem.py``, on the
port's generators and writer): each generator at a small size writes a
``.mtx`` file byte-identical to the one ``tools/make_problem.py`` writes
with the JAX package's, and prints the same line."""

import importlib.util
import pathlib
import sys

import pytest

from conjugategradient_tpu_torch import cli, make_problem

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "poisson2d": ["--nx", "7"],
    "poisson2d-rect": ["--nx", "6", "--ny", "9"],
    "poisson3d": ["--nx", "4", "--ny", "5", "--nz", "3"],
    "banded": ["--n", "57", "--bandwidth", "4", "--seed", "3"],
    "dense": ["--n", "12", "--seed", "1"],
    "powerlaw": ["--n", "90", "--seed", "2"],
    "circuit": ["--n", "80", "--avg-degree", "5.0"],
    "elasticity3d": ["--nx", "3", "--ny", "2", "--nz", "2"],
    "bcsstk17": [],
    "convdiff": ["--nx", "6", "--peclet", "3.5"],
}


@pytest.fixture(scope="module")
def tools_make_problem():
    spec = importlib.util.spec_from_file_location("_tools_make_problem",
                                                  ROOT / "tools" / "make_problem.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", list(CASES))
def test_make_problem_writes_the_tools_bytes(tools_make_problem, tmp_path, capsys, case):
    kind = case.split("-")[0]
    args = [kind, *CASES[case]]
    assert tools_make_problem.main([*args, "-o", str(tmp_path / "j.mtx")]) == 0
    jout = capsys.readouterr().out
    assert make_problem.main([*args, "-o", str(tmp_path / "t.mtx")]) == 0
    tout = capsys.readouterr().out
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    assert tout.replace("t.mtx", "j.mtx") == jout


def test_cli_entry_points(tmp_path, monkeypatch, capsys):
    out = tmp_path / "p.mtx"
    monkeypatch.setattr(sys, "argv", ["cgtorch-make-problem", "poisson2d", "--nx", "5",
                                      "-o", str(out)])
    assert cli.make_problem_main() == 0 and out.read_text().startswith("%%MatrixMarket")
    monkeypatch.setattr(sys, "argv", ["cgtorch-tester", str(out), "--device", "cpu",
                                      "--tol", "1e-8"])
    capsys.readouterr()
    assert cli.tester_main() == 0
    dim, nnz, _, rel = capsys.readouterr().out.split("\n")[0].split()
    assert (dim, nnz) == ("25", "105") and float(rel) < 1e-16
