"""The readers of the port's spans on a hand-made registry, and the idle
attribution of a gap that a port span covers."""

import pytest

from cgbench import trace
from cgbench.spec import Bench
from conjugategradient_tpu_torch.utils import tracing

TOTALS = {
    "cg.solve": {"n": 4, "s": 0.100},
    "cg.loop": {"n": 4, "s": 0.096},
    "cg.step": {"n": 640, "s": 0.0896},
    "cg.live_read": {"n": 20, "s": 0.004},
    "cg.poll_wait": {"n": 2, "s": 0.001},
}


@pytest.mark.parametrize("name, value", [
    ("host_step_ms", 0.14),  # 89.6 ms over 640 steps
    ("entry_ms", 1.0),  # (100 - 96) ms over 4 requests
    ("host_reads_per_solve", 5.5),  # (20 + 2) reads over 4 requests
])
def test_readers(monkeypatch, name, value):
    reader = Bench().module("metrics", name)
    monkeypatch.setattr(tracing, "totals", lambda: TOTALS)
    assert reader.read(None) == pytest.approx(value, rel=1e-12)
    # a registry with no request in it reads nothing, as does a port
    # without the registry
    for empty in ({}, {k: v for k, v in TOTALS.items() if k != "cg.solve"}):
        monkeypatch.setattr(tracing, "totals", lambda: empty)
        assert reader.read(None) is None
    monkeypatch.delattr(tracing, "totals")
    assert reader.read(None) is None


def test_a_gap_inside_a_step_is_put_down_to_the_step():
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        ev(trace.REQUEST_SPAN, "user_annotation", 0, 100),
        ev("cg.solve", "cpu_op", 1, 98),
        ev("cg.loop", "cpu_op", 5, 90),
        ev("cg.step", "cpu_op", 10, 30),
        ev("cudaLaunchKernel", "cuda_runtime", 12, 3),
        ev("k1", "kernel", 15, 10),
        ev("k2", "kernel", 40, 55),
    ]
    gaps = dict(trace.summarize(events)["idle_gaps"])
    # idle 0-15 (the loop started last of the spans under way at its
    # middle), 25-40 (inside the step, no op under way at its middle) and
    # 95-100 (the solve's end)
    assert gaps["cg.loop"] == pytest.approx(15e-6)
    assert gaps["cg.step"] == pytest.approx(15e-6)
    assert gaps["cg.solve"] == pytest.approx(5e-6)
    assert trace.REQUEST_SPAN not in gaps
