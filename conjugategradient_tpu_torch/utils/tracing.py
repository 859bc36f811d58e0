"""Profiler tracing on ``torch.profiler``.  Counterpart of
``conjugategradient_tpu/utils/tracing.py``::

    with trace("/tmp/cg_trace"):
        x, info = cg_solve(A, b, tol=1e-8)

writes a Chrome trace of the enclosed block (the card's kernels beside the
host's ops when a GPU is there) into the directory, with named spans from
:func:`annotate`.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and write ``trace.json`` into ``logdir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span on the trace's timeline (a context manager)."""
    return record_function(name)


#: torch.cuda.memory_stats keys under the names the JAX device reports
_MEMORY_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
}


def memory_stats(device=None) -> dict:
    """The device's memory counters in bytes, under the JAX keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ...); ``{}`` on the CPU."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    out = {key: int(stats[name]) for key, name in _MEMORY_KEYS.items() if name in stats}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(dev or 0).total_memory)
    return out
