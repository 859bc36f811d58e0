"""The comparison that decides ``correct`` fails what it must: a whole run
of each cell at a tiny size on the CPU (the look for a card skipped), with
the timed path broken underneath, comes out not correct; so does the
control, the plain reference in the program's place one precision lower.
A sound run comes out correct."""

import time

import pytest
import torch

import conjugategradient_tpu_torch as port
from cgbench.calibrate import LOWER
from cgbench.harness import run_cell
from cgbench.spec import Bench
from cgbench.tests.tiny import tiny_root
from cgbench.traffic import dtype_of

CELLS = ["hpcg-104.cg", "poisson7-256.cg", "hpcg-104.lockstep32", "poisson7-256.cg-f64"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Bench(tiny_root(tmp_path_factory.mktemp("faults")))


def run(bench, workload, seed=2**31 + 3):
    return run_cell(bench, workload, seed, 0.1, False, "cpu", time.perf_counter(),
                    log=lambda s: None)


def broken(monkeypatch, fault):
    """Wrap the port's two entry points so that their answers carry ``fault``."""
    solo, batched = port.cg_solve, port.cg_solve_batched

    def cg_solve(A, b, *args, **kw):
        x, info = solo(A, b, *args, **kw)
        return fault(x), info

    def cg_solve_batched(A, B, *args, **kw):
        X, info = batched(A, B, *args, **kw)
        return fault(X), info

    monkeypatch.setattr(port, "cg_solve", cg_solve)
    monkeypatch.setattr(port, "cg_solve_batched", cg_solve_batched)


def half_batch(X):
    X = X.clone()
    X[X.shape[0] // 2:] = 0
    return X


FAULTS = {
    # a step that returns its state unchanged: x stays x0 = 0
    "unchanged": torch.zeros_like,
    # an answer altered where it is produced
    "altered": lambda x: x * (1 + 1e-3),
    "one_entry": lambda x: x.index_add(-1, torch.tensor([0]), torch.ones_like(x[..., :1])),
}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    assert run(tiny, workload)["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    broken(monkeypatch, FAULTS[fault])
    assert run(tiny, workload)["correct"] is False


def test_half_batch_is_not_correct(tiny, monkeypatch):
    broken(monkeypatch, half_batch)
    assert run(tiny, "hpcg-104.lockstep32")["correct"] is False


def test_unconverged_is_not_correct(tiny, monkeypatch):
    solo = port.cg_solve

    def capped(A, b, *args, **kw):
        return solo(A, b, *args, **{**kw, "maxiter": 2})

    monkeypatch.setattr(port, "cg_solve", capped)
    result = run(tiny, "poisson7-256.cg")
    assert result["correct"] is False and result["failed"] == result["attempted"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, monkeypatch, workload):
    """The reference CG, one precision below the cell's, in the program's
    place (its cap three times the program's steps, as calibrate.py's)."""
    w = tiny.workload(workload)
    cfg, mix = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    ref, refcg = tiny.module("reference", cfg["operator"]), tiny.module("reference", "cg")
    low = LOWER[dtype_of(mix)]
    steps = {}

    def control(B, tol):
        B2 = B.reshape(-1, ref.n(cfg))
        tol = torch.as_tensor(tol, dtype=torch.float64).reshape(-1).expand(B2.shape[0])
        X, k = refcg.cg(lambda v: ref.matvec(cfg, v), B2.to(low), tol,
                        3 * steps.setdefault("most", 200))
        iters = k.to(torch.int32) if B.ndim == 2 else k[0].to(torch.int32)
        return X.to(B.dtype).reshape(B.shape), port.CGInfo(
            iterations=iters, converged=iters < 10**6, rho=None, rnorm_sq=None,
            rho_history=None)

    monkeypatch.setattr(port, "cg_solve", lambda A, b, *a, tol, **kw: control(b, tol))
    monkeypatch.setattr(port, "cg_solve_batched", lambda A, B, *a, tol, **kw: control(B, tol))
    assert run(tiny, workload)["correct"] is False
