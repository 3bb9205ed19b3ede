"""GQA attention parameters and masked, non-causal attention over a
short key set (counterpart of ``init_gqa`` and ``plain_attention`` in
``repro/models/attention.py``).

``plain_attention`` is plain matmul + softmax, not
``scaled_dot_product_attention``: a query whose keys are all masked
(an empty queue slot of the routed step) must get uniform weights and a
finite output, as in the reference, where SDPA gives NaN.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models.common import dense_init

MASKED_SCORE = -1e30  # the reference's additive mask value


def init_gqa(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    """``cfg`` has ``d_model``, ``n_heads``, ``n_kv_heads``, ``hd`` and
    ``qkv_bias``."""
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(gen, (d, H * hd), dtype),
         "wk": dense_init(gen, (d, KVH * hd), dtype),
         "wv": dense_init(gen, (d, KVH * hd), dtype),
         "wo": dense_init(gen, (H * hd, d), dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype)
    return p


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, S, H, Dk); k: (B, J, KVH, Dk); v: (B, J, KVH, Dv);
    kv_mask: (B, J) bool. Scores and softmax in f32; returns
    (B, S, H, Dv) in q's dtype."""
    B, S, H, Dk = q.shape
    KVH = k.shape[2]
    g = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, S, KVH, g, Dk).float() * scale
    s = torch.einsum("bqhgd,bjhd->bqhgj", qg, k.float())
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, None, :], s,
                        torch.full_like(s, MASKED_SCORE))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgj,bjhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)
