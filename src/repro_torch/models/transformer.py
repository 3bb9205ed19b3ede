"""Layer blocks and segments (counterpart of
``repro/models/transformer.py``) for the layer kinds

* ``attn_ffn``: GQA or MLA attention and a dense FFN or a mixture of
  experts (the dense, moe and vlm families; DeepSeek-V3's leading dense
  layers and its MoE layers alike; Zamba2's shared block), causal or
  not (Whisper's encoder), with cross-attention over an encoder's
  output after the self-attention (Whisper's decoder, ``cross``);
* ``rwkv``: RWKV-6 time-mix and channel-mix (the ssm family);
* ``mamba``: the Mamba2 SSD block (the hybrid family's groups).

A model is a sequence of homogeneous segments whose per-layer
parameters are stacked on a leading layer axis, as in the reference;
where the reference scans a segment with ``lax.scan``, the port loops
over the layers in Python. The state-carrying kinds (rwkv, mamba) take
and return a per-layer state, stacked on the layer axis as the
reference stacks it.

Under a mesh (``launch/sharding.py``; every kind) the residual stream
between blocks is this rank's rows of the batch (where it is cut over
``dp``), replicated over ``tp``, or, with ``cfg.seq_shard`` and the
sequence dividing over ``tp`` (:func:`seq_parallel`, the reference's
``block_seq`` constraint), cut on the sequence over ``tp`` as well:
every norm, residual add and stash then runs on this rank's rows of the
sequence, each block's work (the attention, the cross-attention, the
FFN or the MoE layer, the RWKV-6 time-mix and channel-mix, the Mamba2
mixer) all-gathers the sequence on entry, and its tensor-parallel
partial products (of ``wo``, ``w2``, the RWKV-6 ``wo`` and channel-mix
``wv``) are reduce-scattered back onto it; a result the same on every
rank of ``tp`` (the MoE layer's, summed over ``tp`` inside the layer;
the Mamba2 mixer's) is cut. ``block_decode`` never cuts the sequence:
the partial products are psummed (its cache's sequence may be cut over
``dp``, the context-parallel cache of ``models/attention.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch.profiler import record_function

from repro_torch.launch import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv as R
from repro_torch.models.common import (DistCtx, apply_norm, enter_region,
                                       init_norm, leave_region, tp_heads,
                                       tree_map)

@dataclass(frozen=True)
class SegmentSpec:
    kind: str                 # attn_ffn | rwkv | mamba
    n_layers: int
    moe: bool = False
    causal: bool = True
    cross: bool = False       # decoder cross-attention (enc-dec)


def plan_segments(cfg) -> List[SegmentSpec]:
    """The dense and vlm families are one segment; the encdec family
    (Whisper) one segment with cross-attention (its encoder is the
    model's own, non-causal, segment); the moe family a leading dense
    segment (``n_dense_layers``, if any) and the MoE segment; the ssm
    family (RWKV-6) one rwkv segment; the hybrid family (Zamba2) groups
    of ``hybrid_attn_every`` Mamba2 layers and a remainder group, the
    shared attention block applied after each (by the model, outside
    the segments)."""
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        return [SegmentSpec("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        g = cfg.hybrid_attn_every
        segs = [SegmentSpec("mamba", g) for _ in range(cfg.n_layers // g)]
        if cfg.n_layers % g:
            segs.append(SegmentSpec("mamba", cfg.n_layers % g))
        return segs
    if cfg.family == "moe":
        segs = []
        if cfg.n_dense_layers:
            segs.append(SegmentSpec("attn_ffn", cfg.n_dense_layers))
        segs.append(SegmentSpec("attn_ffn", cfg.n_layers - cfg.n_dense_layers,
                                moe=True))
        return segs
    if cfg.family == "encdec":
        return [SegmentSpec("attn_ffn", cfg.n_layers, cross=True)]
    return [SegmentSpec("attn_ffn", cfg.n_layers)]


def seq_parallel(cfg, ctx: Optional[DistCtx], S: int) -> bool:
    """Whether the residual stream of a sequence of S tokens (the vlm
    family's patches included) is cut on the sequence over ``tp``
    (``cfg.seq_shard``, ``tp`` > 1 and S dividing over it)."""
    return (ctx is not None and ctx.mesh is not None and cfg.seq_shard
            and ctx.tp_size > 1 and S % ctx.tp_size == 0)


def layer_norm_of(lp, name: str, x: torch.Tensor, cfg, ctx: DistCtx,
                  seq: bool = False) -> torch.Tensor:
    """Norm ``lp[name]`` of x; under a mesh its weights' cotangent is
    summed over the ranks whose rows differ (``dp`` where the batch is
    cut, ``tp`` where the sequence is)."""
    p = lp[name]
    if ctx is not None and ctx.mesh is not None:
        p = {k: SH.use(v, cfg, ctx, (name, k), tuple(v.shape),
                       tp_partial=seq) for k, v in p.items()}
    return apply_norm(cfg.norm, p, x)


def _cut(cfg, ctx, prefix):
    """``init_*``'s ``cut``: the parts of a leaf under ``prefix`` this
    rank keeps (None without a mesh)."""
    if ctx is None or ctx.mesh is None:
        return None
    return lambda name, shape: SH.leaf_parts(cfg, ctx, (prefix, name), shape)


def init_layer(gen: torch.Generator, cfg, spec: SegmentSpec, dtype,
               ctx: DistCtx = None):
    """One layer's parameters; a cross segment's layer adds ``ln_x`` and
    ``xattn`` (a GQA parameter set) to the attn_ffn layer's. Under a
    mesh ``ctx`` each leaf keeps this rank's parts of its draw
    (``launch/sharding.leaf_parts``)."""
    d = cfg.d_model
    dev = gen.device
    if spec.kind == "rwkv":
        return {"ln1": init_norm(cfg.norm, d, dtype, dev),
                "tm": R.init_rwkv6(gen, cfg, dtype, _cut(cfg, ctx, "tm")),
                "ln2": init_norm(cfg.norm, d, dtype, dev),
                "cm": R.init_rwkv_channel_mix(gen, cfg, dtype,
                                              _cut(cfg, ctx, "cm"))}
    if spec.kind == "mamba":
        return {"ln1": init_norm(cfg.norm, d, dtype, dev),
                "mix": M.init_mamba2(gen, cfg, dtype, _cut(cfg, ctx, "mix"))}
    attn = _cut(cfg, ctx, "attn")
    p = {"ln1": init_norm(cfg.norm, d, dtype, dev),
         "attn": (A.init_mla(gen, cfg, dtype, attn) if cfg.attn == "mla"
                  else A.init_gqa(gen, cfg, dtype, attn)),
         "ln2": init_norm(cfg.norm, d, dtype, dev)}
    if spec.moe:
        p["moe"] = MoE.init_moe(gen, cfg, dtype, ctx)
    else:
        p["ffn"] = F.init_ffn(gen, d, cfg.d_ff, cfg.activation, dtype,
                              _cut(cfg, ctx, "ffn"))
    if spec.cross:
        p["ln_x"] = init_norm(cfg.norm, d, dtype, dev)
        p["xattn"] = A.init_gqa(gen, cfg, dtype, _cut(cfg, ctx, "xattn"))
    return p


def layer_params(seg_params, i: int):
    """Layer ``i`` of a segment's stacked parameters (views; the decode
    path's, which takes no gradient)."""
    return tree_map(lambda a: a[i], seg_params)


def init_segment(gen: torch.Generator, cfg, spec: SegmentSpec, dtype,
                 ctx: DistCtx = None):
    """The segment's layers, each drawn on its own and stacked on a
    leading layer axis; the stack is allocated once and filled layer by
    layer, so a full-width segment never holds two copies. A segment of
    one layer is that layer's tensors with a leading axis of 1 (views)."""
    if spec.n_layers == 1:
        return tree_map(lambda a: a.unsqueeze(0),
                        init_layer(gen, cfg, spec, dtype, ctx))
    stacked = None
    for i in range(spec.n_layers):
        lp = init_layer(gen, cfg, spec, dtype, ctx)
        if stacked is None:
            stacked = tree_map(lambda a: a.new_empty(
                (spec.n_layers,) + tuple(a.shape)), lp)
        tree_map(lambda s, a: s[i].copy_(a), stacked, lp)
        del lp
    return stacked


# --------------------------------------------- full sequences (prefill) --

def block_seq(lp, x: torch.Tensor, cfg, ctx: DistCtx, spec: SegmentSpec, *,
              state=None, enc_out: Optional[torch.Tensor] = None,
              want_cache: bool = False, seq: bool = False):
    """One layer over a full sequence. Returns (x, aux, new_state,
    cache): for the rwkv and mamba kinds the layer's new state from
    ``state`` (the layer's {"s", "shift", "shift2"} or {"h", "conv"})
    and no cache; for attn_ffn no state and, when ``want_cache``,
    {"k", "v"} (rotated keys, values; under a tensor-parallel mesh the
    kv heads this rank holds) for GQA, {"latent", "rope"} (the latent
    and the rotated rope key) for MLA. A cross segment's layer given
    ``enc_out`` (B, Se, d) attends over it after the self-attention.
    ``seq``: x (and the result) is this rank's rows of the sequence
    (:func:`seq_parallel`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind in ("rwkv", "mamba"):
        x, new_state = _mixers(lp, x, cfg, ctx, spec, state, seq)
        return x, aux, new_state, None
    cache = None
    h = layer_norm_of(lp, "ln1", x, cfg, ctx, seq)
    local = A.tp_heads(ctx, cfg.n_heads) is not None
    h = enter_region(h, ctx, seq=seq, local=local)
    if cfg.attn == "mla":
        o = A.mla_self(lp["attn"], h, cfg, ctx, want_cache=want_cache)
    else:
        o = A.gqa_self(lp["attn"], h, cfg, ctx, causal=spec.causal,
                       want_cache=want_cache)
    if want_cache:
        o, cache = o
    x = x + leave_region(o, ctx, seq=seq, local=local)
    if spec.cross and enc_out is not None:
        x = x + cross_attention(lp, x, enc_out, cfg, ctx, seq)
    h = layer_norm_of(lp, "ln2", x, cfg, ctx, seq)
    if spec.moe:
        # The layer takes the sequence whole and returns its sum.
        h = enter_region(h, ctx, seq=seq, local=False)
        y, aux = MoE.apply_moe(lp["moe"], h, cfg, ctx)
        y = leave_region(y, ctx, seq=seq, local=False)
    else:
        y = F.apply_ffn(lp["ffn"], h, cfg.activation, ctx, cfg=cfg, seq=seq)
    return x + y, aux, None, cache


def _mixers(lp, x: torch.Tensor, cfg, ctx: DistCtx, spec: SegmentSpec,
            state, seq: bool):
    """A rwkv or mamba layer over x (B, S, d: the residual's layout,
    ``seq`` as :func:`block_seq`'s) from the layer's ``state``: each
    mixer's work takes its input whole over ``tp`` and leaves as its
    result is laid out (a partial product summed, or reduce-scattered,
    over ``tp`` where the work is tensor-parallel; else replicated, and
    cut where ``seq``). Returns (x, the new state)."""
    h = layer_norm_of(lp, "ln1", x, cfg, ctx, seq)
    if spec.kind == "mamba":
        h = enter_region(h, ctx, seq=seq, local=False)
        o, new_state = M.mamba2_block(lp["mix"], h, state, cfg, ctx)
        return x + leave_region(o, ctx, seq=seq, local=False), new_state
    local = R.time_mix_heads(cfg, ctx) is not None
    h = enter_region(h, ctx, seq=seq, local=local)
    o, s_tm = R.rwkv6_time_mix(lp["tm"], h, {"s": state["s"],
                                             "shift": state["shift"]},
                               cfg, ctx)
    x = x + leave_region(o, ctx, seq=seq, local=local)
    h = layer_norm_of(lp, "ln2", x, cfg, ctx, seq)
    local = R.channel_mix_local(cfg, ctx)
    h = enter_region(h, ctx, seq=seq, local=local)
    o, shift2 = R.rwkv_channel_mix(lp["cm"], h, state["shift2"], cfg, ctx)
    x = x + leave_region(o, ctx, seq=seq, local=local)
    return x, {"s": s_tm["s"], "shift": s_tm["shift"], "shift2": shift2}


def cross_keys(xattn, enc_out: torch.Tensor, cfg):
    """The keys and values (B, Se, KVH, hd) of the encoder's output
    ``enc_out`` (B, Se, d): its products with ``wk`` and ``wv`` (KVH:
    the kv heads they hold), with no bias and no rotary positions."""
    B, Se, _ = enc_out.shape
    return ((enc_out @ xattn["wk"]).reshape(B, Se, -1, cfg.hd),
            (enc_out @ xattn["wv"]).reshape(B, Se, -1, cfg.hd))


def cross_use(lp, cfg, ctx: DistCtx):
    """A decoder layer's ``xattn`` leaves as this rank's work uses them:
    (leaves, this rank's query heads or None, the first kv head they
    hold), tensor-parallel where the heads divide over ``tp``, as the
    self-attention (``models/attention._gqa_use``)."""
    heads = tp_heads(ctx, cfg.n_heads)
    pu, kv_lo = A._gqa_use(lp["xattn"], cfg, ctx, heads, "xattn")
    return pu, heads, kv_lo


def cross_attention(lp, x: torch.Tensor, enc_out: torch.Tensor, cfg,
                    ctx: DistCtx = None, seq: bool = False):
    """Cross-attention of a decoder layer over a full sequence x
    (B, S, d; ``seq`` as :func:`block_seq`'s): the query from
    ``ln_x``-normed x (with the bias, if the set has one), the keys and
    values of ``cross_keys``, unmasked attention, then ``wo``. Returns
    the residual's addend, in x's layout. Under a tensor-parallel ``ctx``
    each rank runs its heads over ``enc_out`` (replicated over ``tp``:
    its cotangent is summed there) and ``wo``'s partial product is summed
    over ``tp``."""
    pu, heads, kv_lo = cross_use(lp, cfg, ctx)
    local = heads is not None
    # A named range for torch.profiler (the cross-attention's device
    # time, its projections included).
    with record_function("cross_attention"):
        h = layer_norm_of(lp, "ln_x", x, cfg, ctx, seq)
        h = enter_region(h, ctx, seq=seq, local=local)
        q, _, _ = A._qkv(pu, h, cfg)
        ek, ev = cross_keys(pu, enter_region(enc_out, ctx, seq=False,
                                             local=local), cfg)
        ek, ev, _ = A._kv_for(ek, ev, heads, cfg.n_heads // cfg.n_kv_heads,
                              kv_lo)
        o = A.plain_attention(q, ek, ev).reshape(h.shape[0], h.shape[1], -1)
        return leave_region(o @ pu["wo"], ctx, seq=seq, local=local)


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
                spec: SegmentSpec, *, state=None,
                enc_out: Optional[torch.Tensor] = None,
                want_cache: bool = False, seq: bool = False):
    """The segment's layers in order, layer i from ``state``'s slice i
    (the stacked states of a rwkv or mamba segment), a cross segment's
    each attending over ``enc_out``. Returns (x, aux summed over the
    layers, the new states stacked on a leading layer axis or None,
    caches stacked likewise or None). With ``cfg.remat`` and gradients
    on, each layer runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of the scanned body), the
    state-carrying kinds too: its activations are recomputed in the
    backward instead of kept, ``enc_out`` an argument of the recomputed
    layer, so that its gradient reaches the encoder. ``seq``: x is
    cut on the sequence over ``tp`` (:func:`block_seq`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    states, caches = [], []
    remat = cfg.remat and torch.is_grad_enabled() and not want_cache
    for i, lp in enumerate(unbind_layers(seg_params, spec.n_layers)):
        st = None if state is None else {k: v[i] for k, v in state.items()}
        if remat:
            x, a, ns, cache = torch.utils.checkpoint.checkpoint(
                block_seq, lp, x, cfg, ctx, spec, state=st, enc_out=enc_out,
                seq=seq, use_reentrant=False)
        else:
            x, a, ns, cache = block_seq(lp, x, cfg, ctx, spec, state=st,
                                        enc_out=enc_out,
                                        want_cache=want_cache, seq=seq)
        aux = aux + a
        states.append(ns)
        caches.append(cache)
    new_states = (tree_map(lambda *t: torch.stack(t), *states)
                  if state is not None else None)
    stacked = (tree_map(lambda *c: torch.stack(c), *caches)
               if want_cache and spec.kind == "attn_ffn" else None)
    return x, aux, new_states, stacked


# ------------------------------------------------------ one token (decode) --

def block_decode(lp, x1: torch.Tensor, cfg, ctx: DistCtx, spec: SegmentSpec,
                 *, cache: Optional[Dict[str, torch.Tensor]] = None,
                 state=None, lengths: Optional[torch.Tensor] = None):
    """One layer, one token. For attn_ffn, ``cache`` is this layer's
    (views of the segment's stacked cache), updated in place; returns
    (x1, cache). A cross segment's cache also holds the encoder's keys
    and values ``ck`` / ``cv`` (B, Se, KVH, hd) and their mask
    ``cvalid`` (B, Se), which the self-attention ignores and the step
    leaves as they are. For rwkv and mamba, ``state`` is the
    layer's; returns (x1, the new state), new tensors (the shifts and
    the conv state views of this step's activations)."""
    if spec.kind in ("rwkv", "mamba"):
        x, ns = _mixers(lp, x1[:, None, :], cfg, ctx, spec, state, False)
        return x[:, 0], ns
    h = layer_norm_of(lp, "ln1", x1, cfg, ctx)
    decode = A.mla_decode if cfg.attn == "mla" else A.gqa_decode
    o, _ = decode(lp["attn"], h, cache, cfg, ctx, lengths=lengths)
    x1 = x1 + leave_region(o, ctx, seq=False,
                           local=tp_heads(ctx, cfg.n_heads) is not None)
    if spec.cross and "ck" in cache:
        x1 = x1 + cross_decode(lp, x1, cache, cfg, ctx)
    h = layer_norm_of(lp, "ln2", x1, cfg, ctx)
    if spec.moe:
        y, _ = MoE.apply_moe(lp["moe"], h[:, None, :], cfg, ctx)
        y = y[:, 0]
    else:
        y = F.apply_ffn(lp["ffn"], h, cfg.activation, ctx, cfg=cfg)
    return x1 + y, cache


def cross_decode(lp, x1: torch.Tensor, cache: Dict[str, torch.Tensor], cfg,
                 ctx: DistCtx = None):
    """One token's cross-attention: the query ``ln_x``-normed x1 (B, d)
    times ``wq`` (no bias, as the reference's decode), the plain
    ``decode_attention`` over the cached ``ck`` / ``cv`` (the kv heads
    this rank holds) where ``cvalid``, then ``wo``. Under a
    context-parallel ``ctx`` ``ck`` / ``cv`` hold this rank's block of
    the encoder's frames (``cvalid`` whole): the rank attends over its
    block, masked by its block of ``cvalid``, and the ranks' softmax
    states are merged (``attention.split_decode_attention``). Returns
    the residual's addend (B, d), summed over ``tp`` where the heads are
    cut."""
    pu, heads, kv_lo = cross_use(lp, cfg, ctx)
    with record_function("cross_attention"):
        h = layer_norm_of(lp, "ln_x", x1, cfg, ctx)
        B = x1.shape[0]
        q = (h @ pu["wq"]).reshape(B, -1, cfg.hd)
        ck, cv, _ = A._kv_for(cache["ck"], cache["cv"], heads,
                              cfg.n_heads // cfg.n_kv_heads, kv_lo)
        cvalid = cache["cvalid"]
        block = A.cache_block(ctx, B, ck.shape[1], cvalid.shape[1])
        if block is None:
            o = A.decode_attention(q, ck, cv, kv_valid=cvalid)
        else:
            o = A.split_decode_attention(
                q, ck, cv, kv_valid=cvalid[:, block[0]:block[1]], ctx=ctx)
        return leave_region(o.reshape(x1.shape[0], -1) @ pu["wo"], ctx,
                            seq=False, local=heads is not None)


def run_segment_decode(seg_params, x1: torch.Tensor, cfg, ctx: DistCtx,
                       spec: SegmentSpec, *,
                       cache: Optional[Dict[str, torch.Tensor]] = None,
                       state=None,
                       lengths: Optional[torch.Tensor] = None):
    """The segment's layers for one token. The stacked ``cache`` (an
    attn_ffn segment's) or ``state`` (a rwkv or mamba segment's) is
    updated in place, each layer's new state copied into its slice, and
    returned."""
    held = cache if state is None else state
    for i in range(spec.n_layers):
        layer = {k: v[i] for k, v in held.items()}
        if state is None:
            x1, _ = block_decode(layer_params(seg_params, i), x1, cfg, ctx,
                                 spec, cache=layer, lengths=lengths)
        else:
            x1, ns = block_decode(layer_params(seg_params, i), x1, cfg, ctx,
                                  spec, state=layer, lengths=lengths)
            for k, v in ns.items():
                layer[k].copy_(v)
    return x1, held
