"""One run of one cell: set-up, the measured window, the reference check and
the result line.

Requests are a closed loop with one client: the next solve starts when the
previous one has returned and the device has finished it.  A request is
timed from the call to the synchronise after its return.  The window runs
``seconds``; the request in flight at the close is finished and counted,
and the window ends with it.  With ``trace`` the window is shorter
(``TRACE_SECONDS`` at most) and runs under the profiler, and the per-layer
metrics are read from it.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from . import bytemodel, check, peaks, trace as tracing
from .traffic import draw_pool, dtype_of

#: longest traced window: the trace of a longer one takes long to read
TRACE_SECONDS = 5.0
#: module names that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "conjugategradient_tpu")


@dataclasses.dataclass
class Window:
    """What one measured window saw."""

    seconds: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    iterations: list = dataclasses.field(default_factory=list)  # device tensors
    converged: list = dataclasses.field(default_factory=list)  # device tensors
    launches: int = 0
    plain_on_cuda: int = 0


@dataclasses.dataclass
class Context:
    """What a metric reader (``metrics/<name>.py``) may read."""

    workload: str
    requests: int
    rhs_per_request: int
    iterations: list  # per request: the loop steps (lockstep: the slowest lane)
    latencies: list  # seconds per request
    window_s: float  # host clock, the measured or traced window
    setup_s: float
    peak_bytes: int  # since the inputs were made
    launches: int  # kernel launches of the port in the window
    step_bytes: int  # the byte model's bytes of one loop step
    hbm_bytes_per_s: Optional[float]
    spans: dict  # host-clock spans around the harness's calls, seconds
    busy_s: Optional[float] = None  # device busy seconds in the traced window
    trace_window_s: Optional[float] = None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def launch_total() -> tuple:
    from conjugategradient_tpu_torch.ops.cuda._common import LAUNCHES, PLAIN_ON_CUDA

    return sum(LAUNCHES.values()), sum(PLAIN_ON_CUDA.values())


def measure(entry, pool_size: int, seconds: float, sync: Callable[[], None],
            kept: dict, annotate: bool = False) -> Window:
    """Serve requests for ``seconds``: request i solves pool entry i mod P;
    ``kept`` holds the last answer to each."""
    w = Window()
    l0, p0 = launch_total()
    span = torch.profiler.record_function if annotate else None
    start = time.perf_counter()
    i = 0
    while True:
        j = i % pool_size
        t0 = time.perf_counter()
        if span is None:
            x, it, conv = entry.request(j)
            sync()
        else:
            with span(tracing.REQUEST_SPAN):
                x, it, conv = entry.request(j)
                sync()
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        w.iterations.append(it)
        w.converged.append(conv)
        kept[j] = x
        i += 1
        if t1 - start >= seconds:
            break
    w.seconds = t1 - start
    l1, p1 = launch_total()
    w.launches, w.plain_on_cuda = l1 - l0, p1 - p0
    return w


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, log=None) -> dict:
    """Run one cell once and return the result line's object.  ``t0``: the
    host clock at the process's start, from which set-up is counted;
    ``log``: where the earlier lines go (standard error)."""
    import conjugategradient_tpu_torch as port

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    ref = bench.module("reference", cfg["operator"])

    # set-up: the inputs (the operator's values, the right-hand sides), then
    # the port's own set-up and one warm request of the cell's shape
    spans = {"start_s": time.perf_counter() - t0}
    A = bench.module("operators", cfg["operator"]).build(
        port, cfg, dtype_of(traffic), dev)
    pool = draw_pool(traffic, ref.shape(cfg), seed, dev)
    sync()
    spans["inputs_s"] = time.perf_counter() - t0 - spans["start_s"]
    inputs_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    entry = bench.module("solvers", traffic["solver"]).Entry(port, A, pool, traffic, spans, sync)
    t_warm = time.perf_counter()
    entry.request(0)
    sync()
    spans["warm_s"] = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - t0

    P = len(pool)
    kept = {}
    summary = None
    if not trace:
        w = measure(entry, P, seconds, sync, kept)
    else:
        box = []

        def traced():
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                box.append(measure(entry, P, min(seconds, TRACE_SECONDS), sync, kept,
                                   annotate=True))

        events = tracing.profile(traced)
        w = box[0]
        summary = tracing.summarize(events)
        del events
        if summary is None:
            log("trace: no device time in the traced window")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    iters = [int(t.max()) for t in torch.stack(w.iterations).cpu()]
    unconverged = int((~torch.stack(w.converged).cpu()).reshape(len(w.converged), -1)
                      .any(dim=1).sum())
    # the program's state goes before the reference runs
    del entry, A
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    values = check.readings(bench, cfg, traffic, pool, kept)
    check_s = time.perf_counter() - t_check
    values["unconverged"] = unconverged
    verdict = check.judge(values, limits)

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = Context(
        workload=workload, requests=len(w.latencies),
        rhs_per_request=int(traffic["rhs_per_request"]), iterations=iters,
        latencies=w.latencies, window_s=w.seconds, setup_s=setup_s, peak_bytes=peak,
        launches=w.launches, step_bytes=bytemodel.step_bytes(ref, cfg, traffic),
        hbm_bytes_per_s=peaks.hbm_bytes_per_s(kind), spans=spans,
        busy_s=summary["busy_s"] if summary else None,
        trace_window_s=summary["window_s"] if summary else None)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    # a traced run on the card whose trace holds no device time reports no
    # per-layer metric (a CPU run has no device trace to read)
    silent = trace and cuda and summary is None
    for m in [] if silent else bench.metrics_of(section, workload):
        value = bench.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else dev.type, "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": max(peak, inputs_peak)}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    if cuda:
        log(f"card: {power_limit()}")
    lat_ms = [1e3 * x for x in w.latencies]
    p95 = (statistics.quantiles(lat_ms, n=100, method="inclusive")[94]
           if len(lat_ms) > 1 else lat_ms[0])
    log(f"requests {len(lat_ms)} in {w.seconds:.4f} s; latency ms p50 "
        f"{statistics.median(lat_ms)} p95 {p95} max {max(lat_ms)}; iterations "
        f"{min(iters)}-{max(iters)}, reference {min(values['ref_iters'])}-"
        f"{max(values['ref_iters'])}; launches {w.launches}, plain on cuda {w.plain_on_cuda}; "
        f"setup_s {setup_s}; spans {spans}; peak bytes inputs {inputs_peak} run {peak}; "
        f"check_s {check_s}; readings true_res {values['true_res']!r} "
        f"x_gap {values['x_gap']!r}")
    result = {"correct": verdict["correct"], "attempted": len(w.latencies),
              "failed": unconverged, "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = verdict["compared"]
    return result


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"
