from .timing import Timer
from .logging import get_logger, set_verbosity
from .profiling import hbm_bandwidth_gbps, spmv_bytes, roofline_fraction
from .tracing import annotate, memory_stats, trace

__all__ = [
    "Timer",
    "get_logger",
    "set_verbosity",
    "hbm_bandwidth_gbps",
    "spmv_bytes",
    "roofline_fraction",
    "annotate",
    "memory_stats",
    "trace",
]
