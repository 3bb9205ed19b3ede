"""Shared model building blocks (counterpart of the parts of
``repro/models/common.py`` the serving heads use): the normal
initializer, RMS norm and the norm parameters."""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: float = 0.02) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` drawn in f32 on the CPU from ``gen``,
    stored in ``dtype``."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``(xf * rsqrt(mean(xf^2) + eps)).to(x.dtype) * w`` with xf the
    f32 copy of x: the reference's cast order."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_norm(kind: str, d: int, dtype) -> Dict[str, torch.Tensor]:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype),
                "b": torch.zeros((d,), dtype=dtype)}
    return {"w": torch.ones((d,), dtype=dtype)}
