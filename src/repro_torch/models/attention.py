"""GQA attention (counterpart of ``repro/models/attention.py``): the
parameters, chunked flash-style attention for prefill, masked attention
over a short key set, one-token decode against a full or a ring
(sliding-window) KV cache, and the caches themselves.

Every attention here is written out (matmul + softmax in f32 with the
reference's -1e30 masks), not ``scaled_dot_product_attention``: a query
whose keys are all masked (an empty queue slot of the routed step) must
get uniform weights and a finite output, as in the reference, where
SDPA gives NaN. The one kernel is the ring-cache decode: it goes
through ``kernels.ops.swa_decode_attention``, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU one.

The caches are updated in place: ``gqa_decode`` writes the new token's
key, value (and ring position) into the layer's cache tensors and
returns them. The reference returns new arrays; at full width a copy of
every layer's cache per step would move as many bytes as the attention
reads.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import DistCtx, apply_rope, dense_init

MASKED_SCORE = -1e30  # the reference's additive mask value


# --------------------------------------------------- chunked attention --

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cq: int = 1024, ck: int = 1024) -> torch.Tensor:
    """Self-attention over a fresh sequence. q: (B, S, H, Dk);
    k: (B, S, KVH, Dk); v: (B, S, KVH, Dv) -> (B, S, H, Dv) in q's dtype.

    The reference's tiling: query tiles of ``cq`` in a static loop, each
    walking only the key tiles of ``ck`` it can see (static bounds from
    causality and the window) with an online softmax in f32, so no
    (S, S) score matrix exists. Key j is visible to query i where
    j < S, j <= i (causal) and j > i - window."""
    B, S, H, Dk = q.shape
    KVH, Dv = k.shape[2], v.shape[-1]
    g = H // KVH
    scale = 1.0 / math.sqrt(Dk)
    dev = q.device

    cq = min(cq, S)
    ck = min(ck, S)
    pad_s = (-S) % cq
    if pad_s:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_s))
    Sp = q.shape[1]
    pad_k = (-S) % ck
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    Skp = k.shape[1]

    qg = q.reshape(B, Sp, KVH, g, Dk).float() * scale
    outs = []
    for qi in range(Sp // cq):
        qb = qg[:, qi * cq:(qi + 1) * cq]              # (B,cq,KVH,g,Dk)
        q_pos = qi * cq + torch.arange(cq, device=dev)
        hi = min(Skp, ((qi + 1) * cq + ck - 1) // ck * ck) if causal else Skp
        lo = 0
        if window is not None:
            lo = max(0, (qi * cq - window) // ck * ck)
        m = torch.full((B, cq, KVH, g), MASKED_SCORE, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, cq, KVH, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, KVH, g, Dv), dtype=torch.float32,
                          device=dev)
        for base in range(lo, hi, ck):
            kc = k[:, base:base + ck].float()
            vc = v[:, base:base + ck].float()
            s = torch.einsum("bqhgd,bjhd->bqhgj", qb, kc)
            j_pos = base + torch.arange(ck, device=dev)
            allow = (j_pos[None, :] < S).expand(cq, ck)
            if causal:
                allow = allow & (j_pos[None, :] <= q_pos[:, None])
            if window is not None:
                allow = allow & (j_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(allow[None, :, None, None, :], s,
                            torch.full_like(s, MASKED_SCORE))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgj,bjhd->bqhgd", p, vc)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])

    out = torch.cat(outs, dim=1)[:, :S]
    return out.reshape(B, S, H, Dv).to(q.dtype)


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


def decode_attention(q1: torch.Tensor, K: torch.Tensor, V: torch.Tensor, *,
                     kv_valid: torch.Tensor) -> torch.Tensor:
    """One-token decode against a cache. q1: (B, H, Dk); K / V:
    (B, S, KVH, D*); kv_valid: (B, S) bool -> (B, H, Dv) in q1's dtype."""
    B, H, Dk = q1.shape
    KVH = K.shape[2]
    g = H // KVH
    qg = q1.reshape(B, KVH, g, Dk).float() * (1.0 / math.sqrt(Dk))
    s = torch.einsum("bhgd,bshd->bhgs", qg, K.float())
    s = torch.where(kv_valid[:, None, None, :], s,
                    torch.full_like(s, MASKED_SCORE))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, V.float())
    return o.reshape(B, H, V.shape[-1]).to(q1.dtype)


# ------------------------------------------------------------ KV caches --

def init_full_cache(B: int, S: int, KVH: int, hd: int, dtype, layers: int,
                    device=None) -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros((layers, B, S, KVH, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((layers, B, S, KVH, hd), dtype=dtype,
                             device=device),
            "len": torch.zeros((B,), dtype=torch.int32, device=device)}


def init_ring_cache(B: int, W: int, KVH: int, hd: int, dtype, layers: int,
                    device=None) -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros((layers, B, W, KVH, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((layers, B, W, KVH, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((layers, B, W), -1, dtype=torch.int32,
                              device=device),
            "len": torch.zeros((B,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------- GQA block --

def init_gqa(gen: torch.Generator, cfg, dtype) -> Dict[str, torch.Tensor]:
    """``cfg`` has ``d_model``, ``n_heads``, ``n_kv_heads``, ``hd`` and
    ``qkv_bias``."""
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(gen, (d, H * hd), dtype),
         "wk": dense_init(gen, (d, KVH * hd), dtype),
         "wv": dense_init(gen, (d, KVH * hd), dtype),
         "wo": dense_init(gen, (H * hd, d), dtype)}
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KVH * hd),
                            ("bv", KVH * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def _qkv(p, x: torch.Tensor, cfg):
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KVH, hd),
            v.reshape(B, S, KVH, hd))


def gqa_self(p, x: torch.Tensor, cfg, ctx: DistCtx = None, *,
             causal: bool = True):
    """Prefill self-attention over positions 0..S-1, windowed by
    ``cfg.sliding_window``. x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        cq=cfg.attn_chunk, ck=cfg.attn_chunk)
    return o.reshape(B, S, -1) @ p["wo"]


def gqa_decode(p, x1: torch.Tensor, cache_layer: Dict[str, torch.Tensor],
               cfg, ctx: DistCtx = None, *, lengths: torch.Tensor):
    """One-token decode. x1: (B, d); ``cache_layer`` holds this layer's
    k / v (B, S, KVH, hd) (full) or ring buffers (B, W, KVH, hd) with
    their positions ``pos`` (B, W). Position ``lengths[b]`` goes to row
    ``lengths[b]`` of a full cache, or to slot ``lengths[b] % W`` of a
    ring, in place. Returns (out (B, d), cache_layer)."""
    B, _ = x1.shape
    q, k, v = _qkv(p, x1[:, None, :], cfg)
    pos = lengths.long()                               # (B,)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0]      # (B,H,hd)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]      # (B,KVH,hd)
    v = v[:, 0]
    bidx = torch.arange(B, device=x1.device)
    K, V = cache_layer["k"], cache_layer["v"]
    if "pos" in cache_layer:   # ring (sliding-window) cache
        PS = cache_layer["pos"]
        slot = pos % K.shape[1]
        K[bidx, slot] = k
        V[bidx, slot] = v
        PS[bidx, slot] = pos.to(PS.dtype)
        bias = torch.where(PS >= 0, 0.0, MASKED_SCORE).float()
        o = ops.swa_decode_attention(q, K, V, bias, 1.0 / math.sqrt(cfg.hd))
        new_cache = {"k": K, "v": V, "pos": PS}
    else:
        K[bidx, pos] = k
        V[bidx, pos] = v
        valid = (torch.arange(K.shape[1], device=x1.device)[None, :]
                 <= pos[:, None])
        o = decode_attention(q, K, V, kv_valid=valid)
        new_cache = {"k": K, "v": V}
    return o.reshape(B, -1) @ p["wo"], new_cache
