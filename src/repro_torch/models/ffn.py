"""Feed-forward parameter layout (counterpart of ``init_ffn`` in
``repro/models/ffn.py``): SwiGLU (``w1, w3, w2``), or GeLU / squared
ReLU with biases (``w1, b1, w2, b2``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import dense_init


def init_ffn(gen: torch.Generator, d: int, d_ff: int, activation: str,
             dtype) -> Dict[str, torch.Tensor]:
    if activation == "swiglu":
        return {"w1": dense_init(gen, (d, d_ff), dtype),
                "w3": dense_init(gen, (d, d_ff), dtype),
                "w2": dense_init(gen, (d_ff, d), dtype)}
    return {"w1": dense_init(gen, (d, d_ff), dtype),
            "b1": torch.zeros((d_ff,), dtype=dtype),
            "w2": dense_init(gen, (d_ff, d), dtype),
            "b2": torch.zeros((d,), dtype=dtype)}
