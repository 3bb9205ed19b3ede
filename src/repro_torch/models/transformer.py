"""Layer blocks and segments (counterpart of
``repro/models/transformer.py``), for the ``attn_ffn`` kind with GQA or
MLA attention and a dense FFN or a mixture of experts: the dense and
moe families (DeepSeek-V3's leading dense layers and its MoE layers
alike).

A model is a sequence of homogeneous segments whose per-layer
parameters are stacked on a leading layer axis, as in the reference;
where the reference scans a segment with ``lax.scan``, the port loops
over the layers in Python. RWKV, Mamba and decoder cross-attention are
not ported yet (ROADMAP item 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import moe as MoE
from repro_torch.models.common import (DistCtx, apply_norm, init_norm,
                                       tree_map)

_NOT_PORTED = ("is not ported yet (ROADMAP item 9): the port runs the "
               "attn_ffn kind with GQA or MLA attention, dense or MoE")


@dataclass(frozen=True)
class SegmentSpec:
    kind: str                 # attn_ffn | rwkv | mamba
    n_layers: int
    moe: bool = False
    causal: bool = True
    cross: bool = False       # decoder cross-attention (enc-dec)


def plan_segments(cfg) -> List[SegmentSpec]:
    """The dense family is one segment; the moe family a leading dense
    segment (``n_dense_layers``, if any) and the MoE segment."""
    if cfg.family == "moe":
        segs = []
        if cfg.n_dense_layers:
            segs.append(SegmentSpec("attn_ffn", cfg.n_dense_layers))
        segs.append(SegmentSpec("attn_ffn", cfg.n_layers - cfg.n_dense_layers,
                                moe=True))
        return segs
    if cfg.family == "dense":
        return [SegmentSpec("attn_ffn", cfg.n_layers)]
    raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) "
                              f"{_NOT_PORTED}")


def _check(cfg, spec: SegmentSpec) -> None:
    if spec.kind != "attn_ffn":
        raise NotImplementedError(f"layer kind {spec.kind!r} {_NOT_PORTED}")
    if cfg.attn not in ("gqa", "mla"):
        raise NotImplementedError(f"attention {cfg.attn!r} {_NOT_PORTED}")
    if spec.cross:
        raise NotImplementedError(f"cross-attention {_NOT_PORTED}")


def init_layer(gen: torch.Generator, cfg, spec: SegmentSpec, dtype):
    _check(cfg, spec)
    d = cfg.d_model
    dev = gen.device
    p = {"ln1": init_norm(cfg.norm, d, dtype, dev),
         "attn": (A.init_mla(gen, cfg, dtype) if cfg.attn == "mla"
                  else A.init_gqa(gen, cfg, dtype)),
         "ln2": init_norm(cfg.norm, d, dtype, dev)}
    if spec.moe:
        p["moe"] = MoE.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = F.init_ffn(gen, d, cfg.d_ff, cfg.activation, dtype)
    return p


def layer_params(seg_params, i: int):
    """Layer ``i`` of a segment's stacked parameters (views; the decode
    path's, which takes no gradient)."""
    return tree_map(lambda a: a[i], seg_params)


def init_segment(gen: torch.Generator, cfg, spec: SegmentSpec, dtype):
    """The segment's layers, each drawn on its own and stacked on a
    leading layer axis; the stack is allocated once and filled layer by
    layer, so a full-width segment never holds two copies. A segment of
    one layer is that layer's tensors with a leading axis of 1 (views)."""
    if spec.n_layers == 1:
        return tree_map(lambda a: a.unsqueeze(0),
                        init_layer(gen, cfg, spec, dtype))
    stacked = None
    for i in range(spec.n_layers):
        lp = init_layer(gen, cfg, spec, dtype)
        if stacked is None:
            stacked = tree_map(lambda a: a.new_empty(
                (spec.n_layers,) + tuple(a.shape)), lp)
        tree_map(lambda s, a: s[i].copy_(a), stacked, lp)
        del lp
    return stacked


# --------------------------------------------- full sequences (prefill) --

def block_seq(lp, x: torch.Tensor, cfg, ctx: DistCtx, spec: SegmentSpec, *,
              want_cache: bool = False):
    """One layer over a full sequence. Returns (x, aux, cache), cache
    (when ``want_cache``) {"k", "v"} (rotated keys, values) for GQA,
    {"latent", "rope"} (the latent and the rotated rope key) for MLA."""
    _check(cfg, spec)
    cache = None
    h = apply_norm(cfg.norm, lp["ln1"], x)
    if cfg.attn == "mla":
        o = A.mla_self(lp["attn"], h, cfg, ctx)
        if want_cache:
            cache = A.mla_cache_entries(lp["attn"], h, cfg)
    else:
        o = A.gqa_self(lp["attn"], h, cfg, ctx, causal=spec.causal)
        if want_cache:
            _, k, v = A._qkv(lp["attn"], h, cfg)
            pos = torch.arange(h.shape[1], device=h.device)
            k = A.apply_rope(k, pos, cfg.rope_theta)
            cache = {"k": k, "v": v}
    x = x + o
    h = apply_norm(cfg.norm, lp["ln2"], x)
    if spec.moe:
        y, aux = MoE.apply_moe(lp["moe"], h, cfg, ctx)
    else:
        y = F.apply_ffn(lp["ffn"], h, cfg.activation, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux, cache


def unbind_layers(seg_params, n_layers: int) -> List[dict]:
    """The segment's layers as a list of parameter dicts, from one
    ``torch.unbind`` per leaf: in a backward the unbind stacks the
    layers' gradients once, where a slice per layer (``a[i]``) would
    build a zero tensor the size of the whole stack for each layer. A
    segment of one layer is squeezed instead, whose gradient is a view:
    no copy of the layer's gradients (23 GB for a DeepSeek-V3 MoE
    layer)."""
    unbound = []
    tree_map(lambda a: unbound.append(a.unbind(0) if n_layers > 1
                                      else (a.squeeze(0),)), seg_params)

    def layer(i):
        parts = iter(unbound)
        return tree_map(lambda _: next(parts)[i], seg_params)
    return [layer(i) for i in range(n_layers)]


def run_segment(seg_params, x: torch.Tensor, cfg, ctx: DistCtx,
                spec: SegmentSpec, *, want_cache: bool = False):
    """The segment's layers in order. Returns (x, aux summed over the
    layers, caches stacked on a leading layer axis or None). With
    ``cfg.remat`` and gradients on, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
    the scanned body): its activations are recomputed in the backward
    instead of kept."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    remat = cfg.remat and torch.is_grad_enabled() and not want_cache
    for lp in unbind_layers(seg_params, spec.n_layers):
        if remat:
            x, a, cache = torch.utils.checkpoint.checkpoint(
                block_seq, lp, x, cfg, ctx, spec, use_reentrant=False)
        else:
            x, a, cache = block_seq(lp, x, cfg, ctx, spec,
                                    want_cache=want_cache)
        aux = aux + a
        caches.append(cache)
    stacked = (tree_map(lambda *c: torch.stack(c), *caches)
               if want_cache else None)
    return x, aux, stacked


# ------------------------------------------------------ one token (decode) --

def block_decode(lp, x1: torch.Tensor, cfg, ctx: DistCtx, spec: SegmentSpec,
                 *, cache: Dict[str, torch.Tensor],
                 lengths: torch.Tensor):
    """One layer, one token. ``cache`` is this layer's (views of the
    segment's stacked cache), updated in place. Returns (x1, cache)."""
    _check(cfg, spec)
    h = apply_norm(cfg.norm, lp["ln1"], x1)
    decode = A.mla_decode if cfg.attn == "mla" else A.gqa_decode
    o, nc = decode(lp["attn"], h, cache, cfg, ctx, lengths=lengths)
    x1 = x1 + o
    h = apply_norm(cfg.norm, lp["ln2"], x1)
    if spec.moe:
        y, _ = MoE.apply_moe(lp["moe"], h[:, None, :], cfg, ctx)
        y = y[:, 0]
    else:
        y = F.apply_ffn(lp["ffn"], h, cfg.activation, ctx)
    return x1 + y, nc


def run_segment_decode(seg_params, x1: torch.Tensor, cfg, ctx: DistCtx,
                       spec: SegmentSpec, *,
                       cache: Dict[str, torch.Tensor],
                       lengths: Optional[torch.Tensor] = None):
    """The segment's layers for one token; ``cache`` (stacked on the
    layer axis) is updated in place and returned."""
    for i in range(spec.n_layers):
        x1, _ = block_decode(layer_params(seg_params, i), x1, cfg, ctx, spec,
                             cache={k: v[i] for k, v in cache.items()},
                             lengths=lengths)
    return x1, cache
