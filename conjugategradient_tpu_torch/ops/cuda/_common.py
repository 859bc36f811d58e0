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
#: most CTAs of an update kernel (K2/K3, K16, K20); a grid-stride loop beyond
UPDATE_MAX_GRID = 1024
_UPDATE_THREADS = 256

LAUNCHES = {
    "sym_fused_dir_spmv_dot": 0,
    "fused_dir_spmv_dot": 0,
    "fused_update_dot": 0,
    "fused_update_dot_pcg": 0,
    "bell_spmv": 0,
    "bell_spmv_dot": 0,
    "dia_spmv": 0,
    "dia_spmv_rows": 0,
    "sym_dia_spmv": 0,
    "sym_dia_spmv_tiled": 0,
    "sym_dia_spmv_rows": 0,
    "stencil7": 0,
    "stencil7_staged": 0,
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
    "sym_fused_dir_spmv_dot_packed": 0,
    "bicgstab_dir_spmv_dot_packed": 0,
    "bicgstab_s_spmv_dot_packed": 0,
    "minres_dir_spmv_dot_packed": 0,
    "sym_minres_dir_spmv_dot_packed": 0,
    # the bfloat16-tile forms of kernels 1, 4, 5 and 7 (float32 vectors)
    "sym_fused_dir_spmv_dot_bf16": 0,
    "fused_dir_spmv_dot_bf16": 0,
    "bell_spmv_bf16": 0,
    "dia_spmv_bf16": 0,
    "dia_spmv_rows_bf16": 0,
    "bell_spmv_packed_bf16": 0,
    "fused_dir_spmv_dot_packed_bf16": 0,
    "sym_fused_dir_spmv_dot_packed_bf16": 0,
    # the bfloat16-tile forms of kernels 10, 14, 15 and 17 (float32 vectors)
    "sym_dia_spmv_bf16": 0,
    "sym_dia_spmv_tiled_bf16": 0,
    "minres_dir_spmv_dot_bf16": 0,
    "minres_dir_spmv_dot_packed_bf16": 0,
    "sym_minres_dir_spmv_dot_bf16": 0,
    "sym_minres_dir_spmv_dot_packed_bf16": 0,
    "minres_shard_spmv_dot_bf16": 0,
    # kernel 10's by-value form on bfloat16 diagonals
    "sym_dia_spmv_rows_bf16": 0,
    # the bfloat16 forms of kernels 18, 19 and 6 (bf16 tiles or packed
    # values, float32 vectors) and of kernel 11 (bf16 volumes)
    "bicgstab_dir_spmv_dot_bf16": 0,
    "bicgstab_dir_spmv_dot_packed_bf16": 0,
    "bicgstab_s_spmv_dot_bf16": 0,
    "bicgstab_s_spmv_dot_packed_bf16": 0,
    "bell_spmv_dot_bf16": 0,
    "stencil7_bf16": 0,
    "stencil7_staged_bf16": 0,
    # not a kernel: builds of BlockedEllMatrix.packed() and
    # SymBellMatrix.packed() (torch ops, once per operator)
    "bell_pack": 0,
}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)


#: operator element types of the kernels with a bfloat16 form (kernels 1,
#: 4, 5, 6, 7, 10, 14, 15, 17, 18 and 19; float32 vectors)
OPERATOR_DTYPES = (torch.float32, torch.bfloat16)


def form(name: str, dtype: torch.dtype) -> str:
    """The launch counter of kernel ``name`` on operator values of
    ``dtype``: ``name`` for float32, ``name + "_bf16"`` for bfloat16 (its C
    entry point is the float32 one's with ``_bf16`` at the end too)."""
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


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


def update_grid(n: int) -> int:
    """CTAs of an update kernel over ``n`` entries: one float4 a thread of
    256, so ceil(n / 1024), at least 1 and at most :data:`UPDATE_MAX_GRID`.
    The grid fixes the kernels' reduction tree, and so their bits."""
    return max(1, min(-(-n // (4 * _UPDATE_THREADS)), UPDATE_MAX_GRID))


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {err})")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
