"""Attention (counterpart of ``repro/models/attention.py``): GQA and
DeepSeek-V3's multi-head latent attention (MLA), their parameters,
chunked flash-style attention for prefill and training, masked attention
over a short key set, one-token decode against a full, a ring
(sliding-window) or a latent KV cache, and the caches themselves.

Every attention here is written out (matmul + softmax in f32 with the
reference's -1e30 masks), not ``scaled_dot_product_attention``: a query
whose keys are all masked (an empty queue slot of the routed step) must
get uniform weights and a finite output, as in the reference, where
SDPA gives NaN. The one kernel is the ring-cache decode: it goes
through ``kernels.ops.swa_decode_attention``, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU one.

MLA prefill up-projects the latent to per-head keys and values and runs
the chunked attention; MLA decode is the reference's absorbed form
(scores and context in the latent space, f32), whose cache holds
kv_lora + rope values a token (576 for DeepSeek-V3).

The caches are updated in place: ``gqa_decode`` and ``mla_decode``
write the new token's key, value (ring position, or latent and rope
key) into the layer's cache tensors and return them. The reference
returns new arrays; at full width a copy of every layer's cache per
step would move as many bytes as the attention reads.

Under a mesh (``ctx``; ``launch/sharding.py`` lays the leaves out) the
attention is tensor-parallel where the heads divide over ``tp``
(:func:`tp_heads`): each rank runs its
``n_heads / tp`` query heads (``wq``, ``bq``, MLA's ``wq_b``, ``wk_b``,
``wv_b`` cut on heads, ``wo`` on its rows) and its output is the
partial product of ``wo``, summed over ``tp`` by the caller
(``models/transformer.py``). The kv heads are this rank's ``n_kv_heads /
tp`` where they divide; where they do not, ``wk`` / ``wv`` are gathered
over ``tp`` and every rank computes every kv head and attends with the
ones its query heads read (the kv heads replicated over ``tp``, as
Megatron does for fewer kv heads than ranks; the cache then holds them
all, as the reference's ``cache_specs_tree`` lays it out). MLA keeps
``wq_a`` and ``wkv_a`` whole over ``tp`` (FSDP-cut only) and its latent
cache replicated over ``tp``. Where the heads do not divide the leaves
are gathered whole and every rank runs every head. FSDP-cut dims are
gathered over the ``dp`` axes at use (``launch/sharding.use``).

The decode cache holds this rank's rows of the batch where the batch
divides over ``dp``. Where it does not (B = 1 at a long context), the
cache is context-parallel (``launch/sharding.seq_block``): each rank
holds a contiguous block of the sequence of every key, value and latent
leaf (of the full cache, the ring's slots, MLA's latents, the encoder's
frames), the rank that holds the new token's row writes it (masked
index arithmetic on the device, no host sync), every rank attends over
its block only and returns its softmax state (m, l, acc), and the
states of the ``dp`` ranks are gathered and merged in shard order
(:func:`merge_partial`), the same arithmetic, so the same bits, on
every rank. The ring decode's state comes from the ``swa_decode``
kernel's split kernel and is merged by its combine kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.launch import sharding as SH
from repro_torch.models.common import (DistCtx, apply_rope, dense_init,
                                       rms_norm, tp_heads)

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


def _state(s: torch.Tensor, weigh) -> torch.Tensor:
    """The softmax state of masked scores s (..., n) f32: (..., D + 2),
    the row max m, l = sum exp(s - m) and ``weigh(exp(s - m))`` (...,
    D)."""
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return torch.cat([m, torch.sum(p, dim=-1, keepdim=True), weigh(p)],
                     dim=-1)


def decode_partial(q1: torch.Tensor, K: torch.Tensor, V: torch.Tensor, *,
                   kv_valid: torch.Tensor) -> torch.Tensor:
    """:func:`decode_attention`'s softmax state over the keys given (a
    rank's block of a context-parallel cache): (B, H, Dv + 2) f32, m the
    row max of the masked, scaled scores (-1e30 where every key is
    masked), l = sum exp(s - m), acc = sum exp(s - m) V."""
    B, H, Dk = q1.shape
    KVH = K.shape[2]
    qg = q1.reshape(B, KVH, H // KVH, Dk).float() * (1.0 / math.sqrt(Dk))
    s = torch.einsum("bhgd,bshd->bhgs", qg, K.float())
    s = torch.where(kv_valid[:, None, None, :], s,
                    torch.full_like(s, MASKED_SCORE))
    return _state(s, lambda p: torch.einsum(
        "bhgs,bshd->bhgd", p, V.float())).reshape(B, H, -1)


def gather_states(ctx: DistCtx, part: torch.Tensor) -> torch.Tensor:
    """Chunk states (rows, S, D + 2) of this rank's block of the keys ->
    every ``dp`` rank's, rank after rank: (rows, R S, D + 2)."""
    g = ctx.mesh.group(tuple(ctx.dp))
    rows, S, width = part.shape
    return g.all_gather(part[None]).transpose(0, 1).reshape(
        rows, g.size * S, width)


def merge_partial(ctx: DistCtx, state: torch.Tensor) -> torch.Tensor:
    """Softmax states (..., D + 2) f32 of this rank's block of the keys,
    gathered over ``dp`` and merged in shard order (``kernels/ref.
    merge_states``): M = max_r m_r, w_r = exp(m_r - M), out = sum_r w_r
    acc_r / max(sum_r w_r l_r, 1e-30) -> (..., D) f32, the same bits on
    every rank. A rank whose keys are all masked weighs 0; a row with no
    valid key anywhere averages V over every slot, as the softmax over
    -1e30 scores does."""
    lead = state.shape[:-1]
    part = gather_states(ctx, state.reshape(-1, 1, state.shape[-1]))
    return _ref.merge_states(part).reshape(lead + (-1,))


def split_decode_attention(q1: torch.Tensor, K: torch.Tensor,
                           V: torch.Tensor, *, kv_valid: torch.Tensor,
                           ctx: DistCtx) -> torch.Tensor:
    """:func:`decode_attention` over a context-parallel cache: this
    rank's block of the keys (``kv_valid`` its block of the mask), the
    ``dp`` ranks' states merged (:func:`merge_partial`). (B, H, Dv) in
    q1's dtype, the same on every rank."""
    return merge_partial(ctx, decode_partial(q1, K, V, kv_valid=kv_valid)
                         ).to(q1.dtype)


def cache_block(ctx: DistCtx, B: int, held: int,
                whole: int) -> Optional[tuple]:
    """This rank's block [lo, hi) of a cache leaf's ``whole`` positions
    (``launch/sharding.seq_block``), or None where it holds them all;
    a leaf holding ``held`` positions otherwise is refused."""
    block = SH.seq_block(ctx, B, whole)
    want = whole if block is None else block[1] - block[0]
    if held != want:
        raise ValueError(
            f"a decode-cache leaf holds {held} of its {whole} positions, "
            f"but this rank's part is {want} (launch/sharding.cache_spec); "
            f"make the cache with Model.prefill or Model.init_cache under "
            f"this mesh, and decode it through Model.serve_step")
    return block


def _room(ctx: Optional[DistCtx], held: int) -> int:
    """The whole length of a full or latent cache holding ``held``
    positions on this rank: ``ctx.cache_room`` where set, else
    ``held``."""
    if ctx is None or ctx.cache_room is None:
        return held
    return ctx.cache_room


def write_rows(C: torch.Tensor, rows: torch.Tensor, val: torch.Tensor,
               lo: int) -> None:
    """``val`` (B, ...) written into ``C`` (B, n, ...) at row ``rows[b]
    - lo`` of each batch entry that holds it (0 <= rows[b] - lo < n),
    in place: masked index arithmetic on the device (no host sync), so
    that only the rank holding the row changes it."""
    B, n = C.shape[0], C.shape[1]
    r = rows.long() - lo
    own = ((r >= 0) & (r < n)).reshape((B,) + (1,) * (val.dim() - 1))
    r = torch.clamp(r, 0, n - 1)
    bidx = torch.arange(B, device=C.device)
    C[bidx, r] = torch.where(own, val.to(C.dtype), C[bidx, r])


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


def init_mla_cache(B: int, S: int, lora: int, rope: int, dtype, layers: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """The latent cache: each token's normalized kv latent (lora) and
    its rotated rope key (rope), per layer."""
    return {"latent": torch.zeros((layers, B, S, lora), dtype=dtype,
                                  device=device),
            "rope": torch.zeros((layers, B, S, rope), dtype=dtype,
                                device=device),
            "len": torch.zeros((B,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------- GQA block --

def gqa_shapes(cfg, qkv_bias: bool) -> Dict[str, tuple]:
    """The GQA leaves' whole shapes."""
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {"wq": (d, H * hd), "wk": (d, KVH * hd), "wv": (d, KVH * hd),
           "wo": (H * hd, d)}
    if qkv_bias:
        out.update(bq=(H * hd,), bk=(KVH * hd,), bv=(KVH * hd,))
    return out


def init_gqa(gen: torch.Generator, cfg, dtype,
             cut=None) -> Dict[str, torch.Tensor]:
    """``cfg`` has ``d_model``, ``n_heads``, ``n_kv_heads``, ``hd`` and
    ``qkv_bias``. ``cut(name, shape)`` gives the parts of a leaf this
    rank keeps (None: every leaf whole)."""
    shapes = gqa_shapes(cfg, cfg.qkv_bias)

    def part(name):
        return None if cut is None else cut(name, shapes[name])
    p = {name: dense_init(gen, shapes[name], dtype, part=part(name))
         for name in ("wq", "wk", "wv", "wo")}
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            p[name] = torch.zeros(SH.parts_shape(part(name), shapes[name]),
                                  dtype=dtype, device=gen.device)
    return p


def _gqa_use(p, cfg, ctx, heads, prefix: str = "attn"):
    """The GQA leaves (under ``prefix``: ``attn``, or a decoder layer's
    cross-attention ``xattn``) as this rank's work uses them
    (``launch/sharding.use``): on its heads where ``heads``
    (tensor-parallel), else whole; and the first kv head they hold (0
    where every kv head is)."""
    if ctx is None or ctx.mesh is None:
        return p, 0
    shapes = gqa_shapes(cfg, "bq" in p)
    local = heads is not None
    kv_local = local and cfg.n_kv_heads % ctx.tp_size == 0
    out = {}
    for name, shape in shapes.items():
        keep = local and (kv_local or name in ("wq", "wo", "bq"))
        out[name] = SH.use(p[name], cfg, ctx, (prefix, name), shape,
                           keep_tp=keep, tp_partial=local)
    kv_lo = 0
    if kv_local:
        n = cfg.n_kv_heads // ctx.tp_size
        kv_lo = ctx.mesh.index((ctx.tp,)) * n
    return out, kv_lo


def _qkv(p, x: torch.Tensor, cfg):
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


def _kv_for(k: torch.Tensor, v: torch.Tensor, heads, g: int, kv_lo: int):
    """The keys and values (B, S, *, D) that query heads ``heads``
    [h0, h1) read (every head where None), of ``k`` / ``v`` holding kv
    heads from ``kv_lo``, and their group size: the contiguous kv heads
    of whole groups, or one kv head per query head (group 1) where the
    heads split a group."""
    if heads is None:
        return k, v, g
    h0, h1 = heads
    n = h1 - h0
    if n % g == 0 and h0 % g == 0:
        a = h0 // g - kv_lo
        if a == 0 and n // g == k.shape[2]:
            return k, v, g
        return (k[:, :, a:a + n // g].contiguous(),
                v[:, :, a:a + n // g].contiguous(), g)
    idx = torch.arange(h0, h1, device=k.device) // g - kv_lo
    return k[:, :, idx], v[:, :, idx], 1


def gqa_self(p, x: torch.Tensor, cfg, ctx: DistCtx = None, *,
             causal: bool = True, want_cache: bool = False):
    """Prefill self-attention over positions 0..S-1, windowed by
    ``cfg.sliding_window``. x: (B, S, d) -> (B, S, d); under a
    tensor-parallel ``ctx`` (:func:`tp_heads`) x is replicated over
    ``tp`` and the result this rank's partial product. With
    ``want_cache`` returns (out, {"k", "v"}: the rotated keys and the
    values of the kv heads this rank holds)."""
    B, S, _ = x.shape
    heads = tp_heads(ctx, cfg.n_heads)
    pu, kv_lo = _gqa_use(p, cfg, ctx, heads)
    q, k, v = _qkv(pu, x, cfg)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    ka, va, _ = _kv_for(k, v, heads, cfg.n_heads // cfg.n_kv_heads, kv_lo)
    # A named range for torch.profiler (the attention's device time).
    with record_function("flash_attention"):
        o = flash_attention(q, ka, va, causal=causal,
                            window=cfg.sliding_window, cq=cfg.attn_chunk,
                            ck=cfg.attn_chunk)
    o = o.reshape(B, S, -1) @ pu["wo"]
    return (o, {"k": k, "v": v}) if want_cache else o


def gqa_decode(p, x1: torch.Tensor, cache_layer: Dict[str, torch.Tensor],
               cfg, ctx: DistCtx = None, *, lengths: torch.Tensor):
    """One-token decode. x1: (B, d); ``cache_layer`` holds this layer's
    k / v (B, S, KVH, hd) (full) or ring buffers (B, W, KVH, hd) with
    their positions ``pos`` (B, W). Position ``lengths[b]`` goes to row
    ``lengths[b]`` of a full cache, or to slot ``lengths[b] % W`` of a
    ring, in place. Returns (out (B, d), cache_layer): under a
    tensor-parallel ``ctx`` this rank's partial product, and the cache
    of the kv heads it holds. Under a context-parallel ``ctx`` the k / v
    hold this rank's block of the rows (the full cache's room is
    ``ctx.cache_room``) or of the ring's slots (``pos`` whole on every
    rank, every rank writing it): the rank holding the new token's row
    or slot writes its key and value, and the ranks' softmax states
    are merged (the ring's through ``swa_decode``'s partial and combine
    kernels)."""
    B, _ = x1.shape
    heads = tp_heads(ctx, cfg.n_heads)
    pu, kv_lo = _gqa_use(p, cfg, ctx, heads)
    q, k, v = _qkv(pu, x1[:, None, :], cfg)
    pos = lengths.long()                               # (B,)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0]      # (B,H,hd)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]      # (B,KVH,hd)
    v = v[:, 0]
    bidx = torch.arange(B, device=x1.device)
    K, V = cache_layer["k"], cache_layer["v"]
    g = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(cfg.hd)
    if "pos" in cache_layer:   # ring (sliding-window) cache
        PS = cache_layer["pos"]
        slot = pos % PS.shape[1]
        block = cache_block(ctx, B, K.shape[1], PS.shape[1])
        PS[bidx, slot] = pos.to(PS.dtype)
        if block is None:
            K[bidx, slot] = k
            V[bidx, slot] = v
            bias = torch.where(PS >= 0, 0.0, MASKED_SCORE).float()
            Ka, Va, _ = _kv_for(K, V, heads, g, kv_lo)
            o = ops.swa_decode_attention(q, Ka, Va, bias, scale)
        else:
            lo, hi = block
            write_rows(K, slot, k, lo)
            write_rows(V, slot, v, lo)
            bias = torch.where(PS[:, lo:hi] >= 0, 0.0, MASKED_SCORE).float()
            Ka, Va, _ = _kv_for(K, V, heads, g, kv_lo)
            part = ops.swa_decode_partial(q, Ka, Va, bias, scale,
                                          ranks=ctx.dp_size)
            o = ops.swa_combine(gather_states(ctx, part),
                                q.dtype).reshape(q.shape)
        new_cache = {"k": K, "v": V, "pos": PS}
    else:
        block = cache_block(ctx, B, K.shape[1], _room(ctx, K.shape[1]))
        lo = 0 if block is None else block[0]
        if block is None:
            K[bidx, pos] = k
            V[bidx, pos] = v
        else:
            write_rows(K, pos, k, lo)
            write_rows(V, pos, v, lo)
        valid = (lo + torch.arange(K.shape[1], device=x1.device)[None, :]
                 <= pos[:, None])
        Ka, Va, _ = _kv_for(K, V, heads, g, kv_lo)
        with record_function("decode_attention"):
            if block is None:
                o = decode_attention(q, Ka, Va, kv_valid=valid)
            else:
                o = split_decode_attention(q, Ka, Va, kv_valid=valid,
                                           ctx=ctx)
        new_cache = {"k": K, "v": V}
    return o.reshape(B, -1) @ pu["wo"], new_cache


# ---------------------------------------------------------- MLA block --

def mla_shapes(cfg) -> Dict[str, tuple]:
    """The MLA leaves' whole shapes."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {"wq_a": (d, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
            "wq_b": (m.q_lora_rank, H * qk),
            "wkv_a": (d, m.kv_lora_rank + m.qk_rope_dim),
            "kv_norm": (m.kv_lora_rank,),
            "wk_b": (m.kv_lora_rank, H * m.qk_nope_dim),
            "wv_b": (m.kv_lora_rank, H * m.v_dim),
            "wo": (H * m.v_dim, d)}


def init_mla(gen: torch.Generator, cfg, dtype,
             cut=None) -> Dict[str, torch.Tensor]:
    """``cfg`` has ``d_model``, ``n_heads`` and ``mla`` (q_lora_rank,
    kv_lora_rank, qk_nope_dim, qk_rope_dim, v_dim); the reference's
    names and shapes, the norms' weights as bare vectors. ``cut(name,
    shape)`` gives the parts of a leaf this rank keeps."""
    shapes = mla_shapes(cfg)
    out = {}
    for name, shape in shapes.items():     # the reference's draw order
        if name.endswith("norm"):
            out[name] = torch.ones(shape, dtype=dtype, device=gen.device)
        else:
            out[name] = dense_init(gen, shape, dtype, part=(
                None if cut is None else cut(name, shape)))
    return out


def _mla_use(p, cfg, ctx, heads):
    """The MLA leaves as this rank's work uses them: ``wq_b``, ``wk_b``,
    ``wv_b`` and ``wo`` on its heads where ``heads`` (tensor-parallel),
    the latent projections and norms whole (their cotangents summed over
    ``tp`` there), FSDP dims gathered."""
    if ctx is None or ctx.mesh is None:
        return p
    local = heads is not None
    return {name: SH.use(p[name], cfg, ctx, ("attn", name), shape,
                         keep_tp=local, tp_partial=local)
            for name, shape in mla_shapes(cfg).items()}


def _mla_q(p, x: torch.Tensor, cfg):
    """x (B, S, d) -> (qn (B, S, H, nope), qr (B, S, H, rope)), the
    rope part not yet rotated (H: the heads ``wq_b`` holds)."""
    B, S, _ = x.shape
    m = cfg.mla
    q = rms_norm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, S, -1, m.qk_nope_dim + m.qk_rope_dim)
    return torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)


def _mla_latent(p, x: torch.Tensor, cfg):
    """x (B, S, d) -> (normalized latent (B, S, lora), rope key
    (B, S, rope), not yet rotated)."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    latent, krope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    return rms_norm(latent, p["kv_norm"]), krope


def mla_self(p, x: torch.Tensor, cfg, ctx: DistCtx = None, *,
             want_cache: bool = False):
    """Prefill / training MLA over positions 0..S-1: the latent
    up-projected to per-head keys (nope + the rope key shared by every
    head) and values, then the chunked attention with Dk = nope + rope
    and Dv = v_dim. x: (B, S, d) -> (B, S, d); under a tensor-parallel
    ``ctx`` this rank's heads' partial product. With ``want_cache``
    returns (out, :func:`mla_cache_entries`' entries)."""
    B, S, _ = x.shape
    m = cfg.mla
    pu = _mla_use(p, cfg, ctx, tp_heads(ctx, cfg.n_heads))
    qn, qr = _mla_q(pu, x, cfg)
    H = qn.shape[2]
    latent, krope = _mla_latent(pu, x, cfg)
    pos = torch.arange(S, device=x.device)
    qr = apply_rope(qr, pos, cfg.rope_theta)
    krope = apply_rope(krope[:, :, None, :], pos, cfg.rope_theta)
    kn = (latent @ pu["wk_b"]).reshape(B, S, H, m.qk_nope_dim)
    v = (latent @ pu["wv_b"]).reshape(B, S, H, m.v_dim)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, krope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    o = flash_attention(q, k, v, causal=True, cq=cfg.attn_chunk,
                        ck=cfg.attn_chunk)
    o = o.reshape(B, S, -1) @ pu["wo"]
    if want_cache:
        return o, {"latent": latent, "rope": krope[:, :, 0]}
    return o


def mla_cache_entries(p, x: torch.Tensor, cfg):
    """The latent cache of a prefill: {"latent" (B, S, lora), "rope"
    (B, S, rope) rotated at positions 0..S-1}."""
    latent, krope = _mla_latent(p, x, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    krope = apply_rope(krope[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    return {"latent": latent, "rope": krope}


def mla_decode(p, x1: torch.Tensor, cache_layer: Dict[str, torch.Tensor],
               cfg, ctx: DistCtx = None, *, lengths: torch.Tensor):
    """Absorbed-form one-token MLA decode. x1: (B, d); ``cache_layer``
    {"latent": (B, S, lora), "rope": (B, S, rope)}; the new token's
    latent and rotated rope key go to row ``lengths[b]``, in place.
    The query's nope part is absorbed into ``wk_b`` (q_abs = qn . wk_b),
    scored against the latents plus the rope term, softmaxed over the
    rows <= lengths[b] (-1e30 elsewhere), the context taken in the
    latent space and up-projected by ``wv_b``: all in f32, as the
    reference. Returns (out (B, d), cache_layer); under a
    tensor-parallel ``ctx`` this rank's heads' partial product (the
    latent cache replicated over ``tp``). Under a context-parallel
    ``ctx`` the latent cache holds this rank's block of the rows (of
    ``ctx.cache_room``): the rank holding row ``lengths[b]`` writes it,
    and the ranks' states of the latent context (B, H, lora) are merged
    before the ``wv_b`` up-projection."""
    B, _ = x1.shape
    m = cfg.mla
    pu = _mla_use(p, cfg, ctx, tp_heads(ctx, cfg.n_heads))
    qn, qr = _mla_q(pu, x1[:, None, :], cfg)
    H = qn.shape[2]
    latent1, krope1 = _mla_latent(pu, x1[:, None, :], cfg)
    pos = lengths.long()
    qr = apply_rope(qr, pos[:, None], cfg.rope_theta)[:, 0]     # (B,H,rope)
    krope1 = apply_rope(krope1[:, :, None, :], pos[:, None],
                        cfg.rope_theta)[:, 0, 0]                # (B,rope)
    qn = qn[:, 0]                                               # (B,H,nope)
    bidx = torch.arange(B, device=x1.device)
    LC, RC = cache_layer["latent"], cache_layer["rope"]
    block = cache_block(ctx, B, LC.shape[1], _room(ctx, LC.shape[1]))
    lo = 0 if block is None else block[0]
    if block is None:
        LC[bidx, pos] = latent1[:, 0]
        RC[bidx, pos] = krope1
    else:
        write_rows(LC, pos, latent1[:, 0], lo)
        write_rows(RC, pos, krope1, lo)
    valid = (lo + torch.arange(LC.shape[1], device=x1.device)[None, :]
             <= pos[:, None])
    wk_b = pu["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    wv_b = pu["wv_b"].reshape(m.kv_lora_rank, H, m.v_dim)
    q_abs = torch.einsum("bhn,lhn->bhl", qn.float(), wk_b.float())
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    LCf = LC.float()
    s = (torch.einsum("bhl,bsl->bhs", q_abs, LCf)
         + torch.einsum("bhr,bsr->bhs", qr.float(), RC.float())) * scale
    s = torch.where(valid[:, None, :], s, torch.full_like(s, MASKED_SCORE))
    if block is None:
        pr = torch.softmax(s, dim=-1)
        ctx_l = torch.einsum("bhs,bsl->bhl", pr, LCf)
    else:
        ctx_l = merge_partial(ctx, _state(s, lambda pr: torch.einsum(
            "bhs,bsl->bhl", pr, LCf)))
    o = torch.einsum("bhl,lhv->bhv", ctx_l, wv_b.float())
    o = o.reshape(B, -1).to(x1.dtype)
    return o @ pu["wo"], {"latent": LC, "rope": RC}
