"""Stopwatch in milliseconds (the reference harness's Timer).  On a CUDA
device it records CUDA events on the current stream and synchronises on
stop, so the time covers the device work; on the CPU it is the host
clock."""

from __future__ import annotations

import time
from typing import Optional

import torch


class Timer:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None
        self._e0 = self._e1 = None

    def start_measure(self) -> "Timer":
        if self._cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e1 = torch.cuda.Event(enable_timing=True)
            self._e0.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def stop_measure(self) -> "Timer":
        if self._cuda:
            self._e1.record(torch.cuda.current_stream(self.device))
            self._e1.synchronize()
        else:
            self._t1 = time.perf_counter()
        return self

    def get_duration(self) -> float:
        """Milliseconds between start and stop."""
        if self._cuda:
            if self._e0 is None or self._e1 is None:
                raise RuntimeError("Timer not started/stopped")
            return float(self._e0.elapsed_time(self._e1))
        if self._t0 is None or self._t1 is None:
            raise RuntimeError("Timer not started/stopped")
        return (self._t1 - self._t0) * 1e3
