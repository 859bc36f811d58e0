"""Profiler tracing on ``torch.profiler``, and the port's own spans.
Counterpart of ``conjugategradient_tpu/utils/tracing.py``::

    with trace("/tmp/cg_trace"):
        x, info = cg_solve(A, b, tol=1e-8)

writes a Chrome trace of the enclosed block (the card's kernels beside the
host's ops when a GPU is there) into the directory.

Tracing is on exactly while torch's profiler records: inside :func:`trace`
or any ``torch.profiler.profile``.  There is no other switch.  While it is
on, the solve path records these spans on the profiler's timeline, where
they share a clock with the device's events, and adds each one's host
duration and count to an in-memory registry that :func:`totals` reads:

* ``cg.solve``: one request, ``cg_solve`` or ``cg_solve_batched`` (the
  outermost call only: a lane of the batched fallback is no request);
* ``cg.loop``: the loop of a solve, ``solver/restart.run_chunked``;
* ``cg.step``: each launched loop step, with the done-flag copy of a
  polled loop;
* ``cg.live_read``: the host read of the ``live`` flag every
  ``CHECK_EVERY`` steps (on the card it waits for the launched steps);
* ``cg.poll_wait``: a blocking wait for a polled loop's done flag;
* ``bell.pack``: the build of a blocked-ELL operator's packed view.

:func:`annotate` names a span of the caller's own.  While tracing is off
nothing is recorded, and a span costs one attribute read.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

#: the profiler's cheapest span where the installed torch has it; both it
#: and ``record_function`` land among the host's ops of the Chrome trace
_EMIT = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
#: name -> [count, host nanoseconds] of the spans recorded since reset()
_TOTALS: dict = {}
#: names of the outermost spans open now (:func:`outermost`)
_OPEN: set = set()
_OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether torch's profiler is recording, and so the port's spans."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """A span on the profiler's timeline whose host duration and count go
    to the registry under its name."""

    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mark = _EMIT(self.name)
        self.mark.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.mark.__exit__(*exc)
        entry = _TOTALS.setdefault(self.name, [0, 0])
        entry[0] += 1
        entry[1] += dt
        return False


def annotate(name: str):
    """A named span (a context manager): recorded while tracing is on, a
    shared no-op while it is off."""
    return _Span(name) if on() else _OFF


def outermost(name: str):
    """Decorator: each call is a span ``name``, except a call made inside
    another call under the same name."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not on() or name in _OPEN:
                return fn(*args, **kwargs)
            _OPEN.add(name)
            try:
                with _Span(name):
                    return fn(*args, **kwargs)
            finally:
                _OPEN.discard(name)

        return call

    return wrap


def totals() -> dict:
    """``{name: {"n": count, "s": host seconds}}`` of the spans recorded
    since :func:`reset`."""
    return {name: {"n": n, "s": ns * 1e-9} for name, (n, ns) in _TOTALS.items()}


def reset() -> None:
    """Empty the registry."""
    _TOTALS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and write ``trace.json`` into ``logdir``;
    the registry starts empty."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
