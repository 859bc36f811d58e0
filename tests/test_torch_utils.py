"""The port's utilities (``utils/logging.py``, ``utils/profiling.py``,
``utils/tracing.py``) against the JAX package's, on the CPU."""

import json
import logging

import pytest
import torch

from conjugategradient_tpu.utils import logging as jlog
from conjugategradient_tpu.utils import profiling as jprof
from conjugategradient_tpu_torch import CSRMatrix, cg_solve, utils
from conjugategradient_tpu_torch.problems import poisson2d_coo, reference_rhs
from conjugategradient_tpu_torch.utils import logging as tlog
from conjugategradient_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("args", [(5000, 1000), (5000, 1000, 8, 4), (0, 7, 2, 8)])
def test_byte_helpers_equal_jax(args):
    assert tprof.spmv_bytes(*args) == jprof.spmv_bytes(*args)
    assert tprof.bell_spmv_bytes(*args[:3]) == jprof.bell_spmv_bytes(*args[:3])


@pytest.mark.parametrize("achieved,peak", [(1500.0, 3000.0), (10.0, 0.0), (0.0, -1.0)])
def test_roofline_fraction_equals_jax(achieved, peak):
    assert tprof.roofline_fraction(achieved, peak) == jprof.roofline_fraction(achieved, peak)


def test_hbm_bandwidth_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        utils.hbm_bandwidth_gbps(1 << 12, 2, device="cpu")


@pytest.mark.parametrize("level,expect", [("none", logging.WARNING), ("info", logging.INFO),
                                          ("verbose", logging.DEBUG), ("bogus", logging.INFO)])
def test_logging_levels_follow_jax(level, expect):
    tlog.set_verbosity(level)
    assert tlog.get_logger().level == expect
    jlog.set_verbosity(level)
    assert jlog.get_logger().level == expect
    assert tlog.get_logger() is jlog.get_logger()  # one logger name in both packages
    assert len(tlog.get_logger().handlers) == 1
    tlog.set_verbosity("info")


def test_trace_writes_a_file_and_annotate_nests(tmp_path):
    rows, cols, vals, shape = poisson2d_coo(8)
    A = CSRMatrix.from_coo(rows, cols, vals, shape, device="cpu")
    b = torch.from_numpy(reference_rhs(shape[0]))
    with utils.trace(str(tmp_path / "tr")):
        with utils.annotate("outer"):
            with utils.annotate("inner"):
                cg_solve(A, b, tol=1e-8)
    files = list((tmp_path / "tr").iterdir())
    assert [f.name for f in files] == ["trace.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_memory_stats_on_the_cpu_is_empty():
    assert utils.memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert utils.memory_stats() == {}


def test_exports_follow_jax():
    import conjugategradient_tpu.utils as ju

    assert utils.__all__ == ju.__all__
