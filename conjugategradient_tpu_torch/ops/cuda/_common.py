"""What every kernel wrapper of this package shares: the launch counters,
the device dispatch rule and the checks made before a launch.

``LAUNCHES`` counts kernel launches per wrapper; ``PLAIN_ON_CUDA`` counts
calls of a wrapper's plain version that were given CUDA tensors (only
direct comparisons make those).
"""

from __future__ import annotations

from typing import Optional

import torch

#: tile widths the kernels are compiled for
CUDA_BN = (32, 64, 128, 256)

LAUNCHES = {
    "sym_fused_dir_spmv_dot": 0,
    "fused_dir_spmv_dot": 0,
    "fused_update_dot": 0,
    "fused_update_dot_pcg": 0,
    "bell_spmv": 0,
    "bell_spmv_dot": 0,
    "dia_spmv": 0,
    "sym_dia_spmv": 0,
    "stencil7": 0,
    "fused_stencil_dir_dot": 0,
    "minres_dir_spmv_dot": 0,
    "sym_minres_dir_spmv_dot": 0,
    "minres_update_dot": 0,
    "minres_shard_spmv_dot": 0,
    "bicgstab_dir_spmv_dot": 0,
    "bicgstab_s_spmv_dot": 0,
    "bicgstab_update_dot": 0,
    "bell_spmv_packed": 0,
    "fused_dir_spmv_dot_packed": 0,
    "bicgstab_dir_spmv_dot_packed": 0,
    "bicgstab_s_spmv_dot_packed": 0,
    "minres_dir_spmv_dot_packed": 0,
    "sym_minres_dir_spmv_dot_packed": 0,
    # not a kernel: builds of BlockedEllMatrix.packed() and
    # SymBellMatrix.packed() (torch ops, once per operator)
    "bell_pack": 0,
}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def on_cuda(name: str, *tensors) -> bool:
    """True for all-CUDA operands (one device), False for all-CPU ones."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def check_cuda_operands(name, tensors, vec4=()):
    """Contiguous operands; ``vec4`` ones are read as float4 (16-byte
    aligned)."""
    for t in tensors:
        if t is not None:
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
    for t in vec4:
        if t is not None:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: vectors must be 16-byte aligned")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {err})")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
