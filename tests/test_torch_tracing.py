"""The port's spans (``utils/tracing.py``) on the solve path, on the CPU:
recorded only while torch's profiler records, one ``cg.solve`` a request,
and nested on the trace's timeline as the benchmark's idle attribution
reads them."""

import json

import pytest
import torch

from cgbench.trace import HOST_CATS
from conjugategradient_tpu_torch import (CSRMatrix, StencilOperator, SymBellMatrix, cg_solve,
                                         cg_solve_batched)
from conjugategradient_tpu_torch.problems import poisson3d_coo
from conjugategradient_tpu_torch.utils import tracing

NX = 6  # poisson3d(6): n = 216


def _csr():
    rows, cols, vals, shape = poisson3d_coo(NX)
    return CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu")


def _rhs(n, seed=0):
    return torch.randn(n, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))


def _symbell():
    return SymBellMatrix.from_csr(_csr(), bm=8, bn=8)


def _stencil():
    return StencilOperator.poisson((NX, NX, NX), dtype=torch.float64, device="cpu")


def _solve(kind):
    """One request of ``kind``: (its iterations on the host, as the loop
    launched them)."""
    if kind == "symbell":
        A = _symbell()
        _, info = cg_solve(A, _rhs(A.shape[0]), tol=1e-8)
    elif kind == "stencil":
        _, info = cg_solve(_stencil(), _rhs(NX ** 3), tol=1e-8)
    else:
        A = _symbell() if kind == "lockstep" else _csr()
        B = torch.stack([_rhs(NX ** 3, seed) for seed in range(3)])
        _, info = cg_solve_batched(A, B, tol=1e-8)
    return int(info.iterations.max())


def test_off_records_nothing_and_never_emits(monkeypatch):
    def emit(name):
        raise AssertionError(f"span {name!r} emitted with the profiler off")

    monkeypatch.setattr(tracing, "_EMIT", emit)
    tracing.reset()
    _solve("symbell")
    _solve("lockstep")
    assert tracing.totals() == {}


def test_on_follows_the_profiler():
    assert not tracing.on()
    with torch.profiler.profile():
        assert tracing.on()
    assert not tracing.on()


@pytest.mark.parametrize("kind", ["symbell", "stencil", "lockstep", "lanes"])
def test_one_solve_span_a_request(kind):
    """Each call is one ``cg.solve``: the per-lane fallback's inner solves
    (``lanes``) are not requests of their own."""
    _solve(kind)  # warm
    with torch.profiler.profile():
        tracing.reset()
        iters = [_solve(kind) for _ in range(2)]
        t = tracing.totals()
    assert t["cg.solve"]["n"] == 2
    assert t["cg.solve"]["s"] > t["cg.loop"]["s"] > t["cg.step"]["s"] > 0
    if kind == "lanes":
        assert t["cg.loop"]["n"] == 6  # one loop a lane
    else:
        assert t["cg.loop"]["n"] == 2
        # on CPU tensors a polled loop stops at the step that set done
        assert t["cg.step"]["n"] == sum(iters)
    assert t["cg.poll_wait"]["n"] >= t["cg.step"]["n"]


def test_spans_nest_on_the_trace(tmp_path):
    A = _symbell()
    b = _rhs(A.shape[0])
    with tracing.trace(str(tmp_path)):
        cg_solve(A, b, tol=1e-8)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("cg."):
            assert e["cat"] in HOST_CATS
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    (solve,), (loop,) = spans["cg.solve"], spans["cg.loop"]
    assert solve[0] <= loop[0] and loop[1] <= solve[1]
    assert len(spans["cg.step"]) == tracing.totals()["cg.step"]["n"] > 0
    assert all(loop[0] <= s and e <= loop[1] for s, e in spans["cg.step"])


def test_pack_build_is_a_span():
    A = _symbell()
    with torch.profiler.profile():
        tracing.reset()
        A.packed()
        A.packed()  # kept with the operator: no second build
        assert tracing.totals()["bell.pack"]["n"] == 1
