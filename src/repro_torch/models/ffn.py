"""Feed-forward blocks (counterpart of ``repro/models/ffn.py``): SwiGLU
(``w1, w3, w2``), or GeLU / squared ReLU with biases
(``w1, b1, w2, b2``).

Under a mesh (``ctx``; ``launch/sharding.py`` lays the leaves out) the
block is tensor-parallel where its hidden dim divides over ``tp``:
``w1`` / ``w3`` (and ``b1``) hold this rank's columns, ``w2`` its rows,
and the partial product of ``w2`` is summed over ``tp`` (``b2`` added
once, after the sum); FSDP-cut dims are gathered over the ``dp`` axes
at use. Where the hidden dim does not divide, every rank runs the whole
block.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as SH
from repro_torch.models.common import (DistCtx, dense_init, enter_region,
                                       leave_region, tp_heads)


def ffn_shapes(d: int, d_ff: int, activation: str) -> Dict[str, tuple]:
    """The leaves' whole shapes, in the reference's draw order."""
    if activation == "swiglu":
        return {"w1": (d, d_ff), "w3": (d, d_ff), "w2": (d_ff, d)}
    return {"w1": (d, d_ff), "b1": (d_ff,), "w2": (d_ff, d), "b2": (d,)}


def init_ffn(gen: torch.Generator, d: int, d_ff: int, activation: str,
             dtype, cut=None) -> Dict[str, torch.Tensor]:
    """``cut(name, shape)`` gives the parts of a leaf this rank keeps
    (None: every leaf whole)."""
    out = {}
    for name, shape in ffn_shapes(d, d_ff, activation).items():
        part = None if cut is None else cut(name, shape)
        if name.startswith("b"):
            out[name] = torch.zeros(SH.parts_shape(part, shape), dtype=dtype,
                                    device=gen.device)
        else:
            out[name] = dense_init(gen, shape, dtype, part=part)
    return out


def apply_ffn(p, x: torch.Tensor, activation: str, ctx: DistCtx = None, *,
              cfg=None, name: str = "ffn", seq: bool = False
              ) -> torch.Tensor:
    """x (..., d) -> (..., d), in the weights' dtype as the reference
    (products of the storage dtype; GeLU is the tanh form, jax.nn.gelu's
    default). Under a mesh (``cfg`` given; ``name`` the leaves' key,
    ``ffn`` or ``shared``) x and the result are laid out as the residual
    stream: cut on the sequence (dim 1) over ``tp`` where ``seq``, else
    replicated over ``tp``."""
    if cfg is None or ctx is None or ctx.mesh is None:
        return _ffn(p, x, activation)
    d = x.shape[-1]
    d_ff = (cfg.moe.n_shared * cfg.moe.d_expert if name == "shared"
            else cfg.d_ff)
    local = tp_heads(ctx, d_ff) is not None   # d_ff divides over tp
    pu = {}
    for leaf, shape in ffn_shapes(d, d_ff, activation).items():
        if leaf == "b2":     # added after the sum over tp
            pu[leaf] = SH.use(p[leaf], cfg, ctx, (name, leaf), shape,
                              tp_partial=local and seq)
            continue
        pu[leaf] = SH.use(p[leaf], cfg, ctx, (name, leaf), shape,
                          keep_tp=local, tp_partial=local)
    h = enter_region(x, ctx, seq=seq, local=local)
    y = leave_region(_ffn(pu, h, activation, bias=not local), ctx, seq=seq,
                     local=local)
    if local and "b2" in pu:
        y = y + pu["b2"]
    return y


def _ffn(p, x: torch.Tensor, activation: str,
         bias: bool = True) -> torch.Tensor:
    if activation == "swiglu":
        return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    h = x @ p["w1"] + p["b1"]
    if activation == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w2"] + p["b2"] if bias else h @ p["w2"]
