"""The device trace of a traced window: torch.profiler (CUPTI) records the
card's operations and the host's ops; this module reduces the exported
Chrome trace to the seconds the device was busy, the traced window's
length, the operations that took most device time, and the idle gaps by
what the host was doing meanwhile."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Callable, Optional

#: the spans the harness puts around the traced window and each request
WINDOW_SPAN = "cgbench.window"
REQUEST_SPAN = "cgbench.request"
#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of host activity an idle gap is put down to
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def profile(fn: Callable[[], None]) -> list:
    """Run ``fn``, which ends with the device idle, under torch.profiler
    (CPU, and CUDA where a card is there) and return the trace's events
    (the Chrome trace's ``traceEvents``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list) -> Optional[dict]:
    """busy_s, window_s, device_ops and idle_gaps of the traced window, or
    None where the trace holds no window span or no device time."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, host = [], []
    by_op = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                by_op[e["name"]] += (t - s) * 1e-6
        elif cat in HOST_CATS and e["name"] != WINDOW_SPAN:
            host.append((s, t, e["name"]))
    busy = _merge(dev)
    busy_us = sum(t - s for s, t in busy)
    if busy_us <= 0:
        return None
    host.sort()
    starts = [h[0] for h in host]
    requests = [h for h in host if h[2] == REQUEST_SPAN]
    req_starts = [h[0] for h in requests]
    idle = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t > s:
            mid = (s + t) / 2
            name = _host_at(host, starts, mid) or _host_at(requests, req_starts, mid)
            idle[name or "between requests"] += (t - s) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": _top(by_op), "idle_gaps": _top(idle)}


def _top(seconds: dict) -> list:
    """The ``TOP`` largest entries as [name, seconds] pairs."""
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_at(host: list, starts: list, t: float, look: int = 256) -> Optional[str]:
    """The innermost host activity under way at time ``t``: of the events
    that started before it and have not ended, the one that started last
    (``look`` bounds how far back it searches; None if none is found)."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - look):i]):
        if e >= t:
            return name
    return None
