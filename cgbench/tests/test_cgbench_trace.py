"""The trace reduction on a hand-made Chrome trace."""

from cgbench import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_union_window_and_idle_gaps():
    events = [
        ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        ev(trace.REQUEST_SPAN, "user_annotation", 0, 100),
        ev("k1", "kernel", 10, 20),
        ev("k2", "kernel", 20, 20),  # overlaps k1: counted once in the union
        ev("copy", "gpu_memcpy", 60, 10),
        ev("k1", "kernel", 95, 10),  # runs past the window: cut at its end
        ev("cudaLaunchKernel", "cuda_runtime", 45, 10),
        ev("cpu_only", "python_function", 0, 100),  # not a host category read
    ]
    s = trace.summarize(events)
    assert abs(s["window_s"] - 100e-6) < 1e-12
    assert abs(s["busy_s"] - (30 + 10 + 5) * 1e-6) < 1e-12
    ops = dict(s["device_ops"])
    assert abs(ops["k1"] - 25e-6) < 1e-12 and abs(ops["k2"] - 20e-6) < 1e-12
    gaps = dict(s["idle_gaps"])
    # idle 0-10, 40-60, 70-95: the launch covers the middle of 40-60
    assert abs(gaps["cudaLaunchKernel"] - 20e-6) < 1e-12
    assert abs(gaps[trace.REQUEST_SPAN] - 35e-6) < 1e-12
    assert s["idle_gaps"][0][0] == trace.REQUEST_SPAN


def test_no_device_time_reads_nothing():
    events = [ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
              ev("aten::add", "cpu_op", 10, 5)]
    assert trace.summarize(events) is None
    assert trace.summarize([ev("k", "kernel", 0, 5)]) is None
