"""Feed-forward blocks (counterpart of ``repro/models/ffn.py``): SwiGLU
(``w1, w3, w2``), or GeLU / squared ReLU with biases
(``w1, b1, w2, b2``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import DistCtx, dense_init


def init_ffn(gen: torch.Generator, d: int, d_ff: int, activation: str,
             dtype) -> Dict[str, torch.Tensor]:
    if activation == "swiglu":
        return {"w1": dense_init(gen, (d, d_ff), dtype),
                "w3": dense_init(gen, (d, d_ff), dtype),
                "w2": dense_init(gen, (d_ff, d), dtype)}
    return {"w1": dense_init(gen, (d, d_ff), dtype),
            "b1": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
            "w2": dense_init(gen, (d_ff, d), dtype),
            "b2": torch.zeros((d,), dtype=dtype, device=gen.device)}


def apply_ffn(p, x: torch.Tensor, activation: str,
              ctx: DistCtx = None) -> torch.Tensor:
    """x (..., d) -> (..., d), in the weights' dtype as the reference
    (products of the storage dtype; GeLU is the tanh form, jax.nn.gelu's
    default)."""
    if activation == "swiglu":
        return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    h = x @ p["w1"] + p["b1"]
    if activation == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w2"] + p["b2"]
