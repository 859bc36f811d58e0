"""Roofline accounting: a measured copy rate and byte counts of the SpMVs.
Counterpart of ``conjugategradient_tpu/utils/profiling.py``."""

from __future__ import annotations

import torch

from ..types.base import DEFAULT_DEVICE


def hbm_bandwidth_gbps(nbytes: int = 1 << 28, iters: int = 64, device=DEFAULT_DEVICE) -> float:
    """Streaming rate of ``device`` in GB/s (read and write counted): a
    device-to-device copy of ``nbytes`` timed with CUDA events over
    ``iters`` copies after a warm-up.  Needs a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"hbm_bandwidth_gbps times a copy on a CUDA device, got {dev}")
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    for _ in range(3):
        dst.copy_(src)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        dst.copy_(src)
    e1.record()
    e1.synchronize()
    seconds = e0.elapsed_time(e1) / 1e3
    return 2 * src.numel() * 4 * iters / seconds / 1e9


def spmv_bytes(nnz: int, n: int, val_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Least traffic of one CSR SpMV: values and column indices once, x and
    y once (x gathers may re-read)."""
    return nnz * (val_bytes + idx_bytes) + 2 * n * val_bytes


def bell_spmv_bytes(blocks_size: int, n: int, val_bytes: int = 4) -> int:
    """Blocked-ELL SpMV traffic: the tile stream dominates."""
    return blocks_size * val_bytes + 2 * n * val_bytes


def roofline_fraction(achieved_gbps: float, peak_gbps: float) -> float:
    return achieved_gbps / peak_gbps if peak_gbps > 0 else 0.0
