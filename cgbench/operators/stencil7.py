"""The 7-point stencil as the port's matrix-free ``StencilOperator``."""

from __future__ import annotations

import torch


def build(port, cfg: dict, dtype: torch.dtype, device) -> "port.StencilOperator":
    return port.StencilOperator(cfg["center"], cfg["off"], tuple(cfg["grid"]), dtype, device)
