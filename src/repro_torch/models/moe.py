"""Mixture-of-experts layer with top-k token-choice routing (counterpart
of ``repro/models/moe.py``).

Dispatch is sort-based and of fixed capacity, as in the reference:
tokens are gathered into per-expert queues of C = ceil(T * k / E * cf)
slots (``ops.moe_dispatch``), every expert's SwiGLU runs as one batched
product over the queues, and the outputs are re-assembled with their
gates (``ops.moe_combine``); a token past its expert's capacity is
dropped and contributes zero. The only scatter is the int32 rank of
each (token, choice) entry, an index assignment: no float scatter-add
(DESIGN.md §15).

Under a ``DistCtx`` with a ``utils.mesh.Mesh`` the layer takes the path
the reference's ``apply_moe`` takes for that mesh and the global batch's
shape, with the layout of its ``shard_map`` at the layer's boundary: the
input is this rank's rows of the batch over the ``dp`` axes where the
batch is cut (``DistCtx.batch_cut``, as the model's entry points lay it
out), replicated over ``tp``; where the batch is whole on every rank
(it does not divide over ``dp``, or the caller gives the whole batch)
the layer takes its ``dp`` rows itself and all-gathers the output over
``dp``.

  * expert tensor parallelism (``_dense_shard_map``; Mixtral): each
    data shard dispatches its own tokens to every expert, whose FFN
    hidden dim is cut over ``tp``; one psum of the bf16 partials, added
    in shard order;
  * expert parallelism (``impl="alltoall"``; DeepSeek-V3): the data
    shard's tokens are cut over ``tp``, packed, exchanged by one tiled
    all_to_all so that each shard holds only its resident experts'
    queues, processed, and sent back by the reverse all_to_all; the
    experts are cut over ``tp`` (``ep="tp"``) or over the axes of
    ``_ep_axes_for`` (``ep="2d"``), padded to a multiple of the shards;
  * otherwise ``_local_moe`` on the whole batch.

Each rank holds only its part of the expert stacks (:func:`expert_part`,
and under ``cfg.fsdp`` the template's FSDP dim over ``dp``), of the
router (FSDP-cut) and of the shared experts (``launch/sharding.
held_spec``), cut as they are drawn or converted. Where the path needs
another layout than the one held (an ``alltoall`` layer whose batch
falls back to the tensor-parallel or the local path, an FSDP dim), the
leaves are gathered and cut again, as ``shard_map``'s ``in_specs``
reshard a GSPMD array. The local path on a batch cut over ``dp``
gathers the batch and runs on the whole of it, as the reference's
``_local_moe`` does on the global array (its capacity and its
load-balance loss are the whole batch's).

The gradient through a sharded path is the exact gradient of the loss,
whole on every rank for every replicated value, through the
differentiable collectives of ``utils/mesh.py``: the output's gather
backs off to this rank's rows and the ``tp`` psum passes its cotangent
through; what enters the shard-local work sums its cotangent over the
ranks whose work it feeds: ``x``'s over ``tp`` (``_dp_rows`` then
all-gathers it over ``dp``), the router's over ``dp`` and ``tp``, an
expert part's over the axes the part is replicated on, and a part
gathered into another layout by a reduce-scatter onto the part held.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.models.common import (DistCtx, Part, dense_init,
                                       parts_shape, relay)

EXPERT_LEAVES = ("w1", "w3", "w2")


def init_moe(gen: torch.Generator, cfg, dtype,
             ctx: DistCtx = None) -> Dict[str, object]:
    """The layer's parameters; under a mesh ``ctx`` each leaf keeps only
    this rank's parts of its draw (``launch/sharding.leaf_parts``: the
    experts as :func:`expert_part` cuts them, FSDP dims, the shared
    experts' tensor-parallel dims)."""
    m = cfg.moe
    d, E, dff = cfg.d_model, m.n_experts, m.d_expert

    def cut(*path):
        return lambda name, shape: SH.leaf_parts(cfg, ctx, path + (name,),
                                                 shape)
    c = cut("moe")
    p = {"router": dense_init(gen, (d, E), dtype, scale=0.006,
                              part=c("router", (d, E)))}
    for name in EXPERT_LEAVES:
        shape = _full_shape(m, d, name)
        p[name] = dense_init(gen, shape, dtype, part=c(name, shape))
    if m.n_shared:
        from repro_torch.models.ffn import init_ffn
        p["shared"] = init_ffn(gen, d, m.n_shared * dff, "swiglu", dtype,
                               cut=cut("moe", "shared"))
    return p


def _route(router_w: torch.Tensor, x2d: torch.Tensor, m):
    """Top-k routing. x2d: (T, d). Returns (ids (T, k) int32, gates
    (T, k) f32 renormalized, the switch load-balance aux loss). Equal
    probabilities go to the lower expert index first, as in
    ``lax.top_k`` (bf16 logits tie often); ``torch.topk`` promises no
    order among ties, so this is a stable descending sort."""
    logits = (x2d @ router_w).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :m.top_k], ids[:, :m.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    E = logits.shape[-1]
    me = torch.mean(probs, dim=0)
    choice = F.one_hot(ids, E).float().sum(1)
    fe = torch.mean(choice, dim=0)
    aux = E * torch.sum(me * fe)
    return ids.to(torch.int32), gates, aux


def _capacity(T: int, m) -> int:
    return max(1, int(math.ceil(T * m.top_k / m.n_experts *
                                m.capacity_factor)))


def _expert_ffn(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its queue, in the weights' dtype:
    (E, C, d) -> (E, C, d)."""
    xe = xe.to(w1.dtype)
    h = F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2)


def _plan(ids: torch.Tensor, m, C: int):
    """The queues of a routing: (src_tok (E*C,) int32, the token each
    queue slot pulls; valid (E*C,) bool; flat_e (T*k,) int32, the
    expert of each (token, choice) entry; pos_c (T*k,) int32, its slot
    in that queue, clipped; keep (T*k,) bool, whether it fit; src_entry
    (E*C,) int32, the entry that owns each valid slot)."""
    E = m.n_experts
    dev = ids.device
    flat_e = ids.reshape(-1).long()                    # (N = T*k,)
    N = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order].contiguous()
    experts = torch.arange(E, device=dev)
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    seg_end = torch.searchsorted(sorted_e, experts, side="right")
    pos_sorted = torch.arange(N, device=dev) - seg_start[sorted_e]
    pos = torch.zeros((N,), dtype=torch.int32, device=dev)
    pos[order] = pos_sorted.to(torch.int32)
    keep = pos < C
    pos_c = torch.clamp(pos, 0, C - 1)
    # slot (e, c) <- token row order[seg_start[e] + c] // top_k
    slot = seg_start[:, None] + torch.arange(C, device=dev)[None, :]
    valid = slot < seg_end[:, None]
    src_entry = order[torch.clamp(slot, 0, N - 1).reshape(-1)]
    src_tok = (src_entry // m.top_k).to(torch.int32)
    return (src_tok, valid.reshape(-1), flat_e.to(torch.int32), pos_c, keep,
            src_entry.to(torch.int32))


def _pack(x2d: torch.Tensor, ids: torch.Tensor, m, C: int):
    """Gather tokens into (E, C, d) queues. Returns (buf, plan), plan
    the :func:`_plan` tuple. Queue slot (e, c) pulls its token (a
    gather), so only the (T * k,) int32 rank of each entry is scattered;
    the gather's gradient is the combine of the queues' gradient
    (``ops.moe_dispatch`` given the routing's slots and keep mask)."""
    plan = _plan(ids, m, C)
    src_tok, valid, flat_e, pos_c, keep, _ = plan
    slot = (flat_e * C + pos_c).to(torch.int32)
    buf = ops.moe_dispatch(x2d, src_tok, valid, slot=slot, keep=keep,
                           top_k=m.top_k)
    return buf.reshape(m.n_experts, C, x2d.shape[1]), plan


def _unpack(ybuf: torch.Tensor, plan, gates: torch.Tensor,
            top_k: int) -> torch.Tensor:
    """The experts' outputs re-assembled with their gates, 0 for a
    dropped entry (the reference's ``where(keep, gates, 0)``, through
    which the router's gradient flows); the gradients of ybuf and the
    gates are read through the plan's slot -> entry map."""
    _, valid, flat_e, pos_c, keep, src_entry = plan
    C = ybuf.shape[1]
    slot = (flat_e * C + pos_c).to(torch.int32)        # (T*k,)
    w = torch.where(keep, gates.reshape(-1), 0.0).float()
    return ops.moe_combine(ybuf.reshape(-1, ybuf.shape[-1]), slot, w,
                           top_k=top_k, src_entry=src_entry, valid=valid)


def _local_moe(p, x2d: torch.Tensor, m):
    """Pack / compute / unpack with every expert on this device."""
    T, _ = x2d.shape
    C = _capacity(T, m)
    ids, gates, aux = _route(p["router"], x2d, m)
    buf, plan = _pack(x2d, ids, m, C)
    ye = _expert_ffn(p["w1"], p["w3"], p["w2"], buf)
    y = _unpack(ye.to(x2d.dtype), plan, gates, m.top_k)
    return y.to(x2d.dtype), aux


def _pad_to(E: int, nsh: int) -> int:
    return ((E + nsh - 1) // nsh) * nsh


def _ep_axes_for(E: int, ctx: DistCtx) -> Tuple[str, ...]:
    """The largest minor-first mesh-axis prefix (``tp``, then the
    ``dp`` axes inward) whose size product divides E; always holds
    ``tp``. Listed major to minor, as a ``PartitionSpec`` lists them."""
    axes = [ctx.tp]
    nsh = ctx.mesh.shape[ctx.tp]
    for a in reversed(tuple(ctx.dp)):
        s = ctx.mesh.shape[a]
        if nsh * s <= E and E % (nsh * s) == 0:
            axes.append(a)
            nsh *= s
        else:
            break
    return tuple(reversed(axes))


def _ep_axes(m, ctx: DistCtx) -> Tuple[str, ...]:
    """The axes the ``alltoall`` path's experts are cut over."""
    return (ctx.tp,) if m.ep == "tp" else _ep_axes_for(m.n_experts, ctx)


def _ep_part(m, ctx: DistCtx) -> Part:
    """This rank's experts on the ``alltoall`` path: its E_pad / nsh of
    the stack padded to E_pad (the padded experts are zeros)."""
    axes = _ep_axes(m, ctx)
    nsh = ctx.mesh.size(axes)
    e_loc = _pad_to(m.n_experts, nsh) // nsh
    s = ctx.mesh.index(axes)
    return Part(-3, s * e_loc, (s + 1) * e_loc, axes)


def _etp_part(m, ctx: DistCtx, name: str) -> Optional[Part]:
    """This rank's slice of every expert's FFN hidden dim on the tensor-
    parallel path (w1 / w3: (E, d, ff), w2: (E, ff, d)); None (whole)
    where the hidden dim does not divide over ``tp``."""
    tp = ctx.tp_size
    if m.d_expert % tp:
        return None
    f = m.d_expert // tp
    s = ctx.mesh.index((ctx.tp,))
    return Part(-1 if name in ("w1", "w3") else -2, s * f, (s + 1) * f,
                (ctx.tp,))


def expert_part(m, ctx: DistCtx, name: str) -> Optional[Part]:
    """The part of expert leaf ``name`` (w1, w3, w2) that this rank
    holds under ``ctx``'s mesh: the experts over the ``alltoall`` path's
    axes, else the hidden dim over ``tp`` (the JAX package's
    ``launch/sharding.param_specs`` for these leaves, with the padding
    of its ``apply_moe``); None for the whole leaf."""
    if ctx is None or ctx.mesh is None:
        return None
    if m.impl == "alltoall":
        return _ep_part(m, ctx)
    return _etp_part(m, ctx, name)


def _full_shape(m, d: int, name: str) -> Tuple[int, int, int]:
    if name == "w2":
        return (m.n_experts, m.d_expert, d)
    return (m.n_experts, d, m.d_expert)


def _check_parts(p, cfg, ctx: DistCtx, d: int) -> None:
    """Refuse a router or expert leaf that is not this rank's parts (a
    whole stack converted or drawn without the mesh), by name."""
    m = cfg.moe
    for name in ("router",) + EXPERT_LEAVES:
        full = (d, m.n_experts) if name == "router" else _full_shape(
            m, d, name)
        want = parts_shape(SH.leaf_parts(cfg, ctx, ("moe", name), full),
                           full)
        got = tuple(p[name].shape)
        if got != want:
            raise ValueError(
                f"apply_moe: leaf moe.{name} has shape {got}, but under "
                f"the mesh {dict(ctx.mesh.shape)} (impl={m.impl!r}, ep="
                f"{m.ep!r}) this rank holds {want} of the whole {full}; "
                f"draw the parameters with init_params(..., ctx=ctx) or "
                f"convert them with convert.model_params(..., cfg=cfg, "
                f"ctx=ctx)")


def _relaid(p, cfg, ctx: DistCtx, want, partial, d: int) -> dict:
    """``p`` with its router and expert leaves in the layout the path
    runs on: the router whole, each expert leaf as ``want(name)`` (a
    :class:`Part` or None for the whole leaf), gathered over the axes of
    the parts this rank holds and cut again where they differ (never
    without a mesh, where every leaf is whole).

    ``partial``: the mesh axes over which the path's work differs by
    rank (every axis on the tensor-parallel and alltoall paths, none on
    the local path, which runs the whole batch on every rank), so that
    each leaf's cotangent is summed over the ranks whose work it feeds
    (``models/common.relay``): the router's over the whole mesh, an
    expert leaf's over the axes its held part is replicated on and, when
    gathered, reduce-scattered onto that part. Otherwise each gathered
    leaf's replicated cotangent backs off to this rank's rows."""
    m = cfg.moe
    out = dict(p)
    out["router"] = relay(p["router"], SH.leaf_parts(
        cfg, ctx, ("moe", "router"), (d, m.n_experts)), (), ctx.mesh,
        partial)
    for name in EXPERT_LEAVES:
        have = SH.leaf_parts(cfg, ctx, ("moe", name), _full_shape(m, d, name))
        need = want(name)
        out[name] = relay(p[name], have, () if need is None else (need,),
                          ctx.mesh, partial, extent={-3: m.n_experts})
    return out


def _pmean(aux: torch.Tensor, ctx: DistCtx) -> torch.Tensor:
    """``lax.pmean`` of a scalar over the ``dp`` and ``tp`` axes (its
    cotangent passes through the psum)."""
    g = ctx.mesh.group(tuple(ctx.dp) + (ctx.tp,))
    return g.psum(aux.reshape(1))[0] / g.size


def _dp_rows(x: torch.Tensor, ctx: DistCtx) -> torch.Tensor:
    """This rank's rows of the batch over the ``dp`` axes (``P(dp)``
    in), as they enter the ``tp``-partial work: the backward sums the
    rows' cotangent over ``tp`` and, where the batch came whole, all-
    gathers it over ``dp``. A batch already cut over ``dp`` is taken as
    it is."""
    if not ctx.batch_cut:
        x = ctx.mesh.group(ctx.dp).shard_rows(x)
    return ctx.mesh.group(ctx.tp).psum_grad(x)


def _dense_shard_map(p, x: torch.Tensor, m, ctx: DistCtx):
    """Expert tensor parallelism for small E (Mixtral-class): every data
    shard dispatches only its own tokens into a local (E, C_loc, d)
    queue, each expert's FFN hidden dim cut over ``tp`` like a dense
    FFN, and the one collective of the layer is the psum of the bf16
    layer output over ``tp`` (in shard order). Capacity is per data
    shard. A whole batch's output is gathered over ``dp``."""
    xb = _dp_rows(x, ctx)
    x2 = xb.reshape(-1, x.shape[-1])
    ids, gates, aux = _route(p["router"], x2, m)
    C = _capacity(x2.shape[0], m)
    buf, plan = _pack(x2, ids, m, C)
    ye = _expert_ffn(p["w1"], p["w3"], p["w2"], buf)    # partial (ff)
    y = _unpack(ye, plan, gates, m.top_k)
    y = ctx.mesh.group(ctx.tp).psum(y.to(x.dtype))
    aux = _pmean(aux, ctx)
    if not ctx.batch_cut:
        y = ctx.mesh.group(ctx.dp).all_gather(y.reshape(xb.shape))
    return y.reshape(x.shape), aux


def _alltoall_local(p, x_my: torch.Tensor, m, group):
    """One shard's body: route and pack its T_my tokens into every
    expert's queue, send each queue to the shard that holds its expert
    (``group``: the experts' axes, in shard order), run the resident
    E_pad / nsh experts over the queues of every shard, and send the
    outputs back. ``p`` holds this shard's experts."""
    T, d = x_my.shape
    E = m.n_experts
    nsh = group.size
    E_pad = _pad_to(E, nsh)
    E_loc = E_pad // nsh
    C = _capacity(T, m)
    ids, gates, aux = _route(p["router"], x_my, m)
    buf, plan = _pack(x_my, ids, m, C)                  # (E, C, d)
    if E_pad > E:
        buf = F.pad(buf, (0, 0, 0, 0, 0, E_pad - E))
    recv = group.all_to_all(buf.reshape(nsh, E_loc * C, d))
    xe = recv.reshape(nsh, E_loc, C, d).transpose(0, 1)
    xe = xe.reshape(E_loc, nsh * C, d)
    ye = _expert_ffn(p["w1"], p["w3"], p["w2"], xe)
    ye = ye.reshape(E_loc, nsh, C, d).transpose(0, 1)
    back = group.all_to_all(ye.reshape(nsh, E_loc * C, d).to(x_my.dtype))
    ybuf = back.reshape(E_pad, C, d)[:E]
    y = _unpack(ybuf, plan, gates, m.top_k)
    return y.to(x_my.dtype), aux


def _alltoall(p, x: torch.Tensor, m, ctx: DistCtx):
    """Expert parallelism: this data shard's tokens cut over ``tp``
    (token resharding dp -> dp x tp: this rank's rows of the flat batch
    over (dp, tp)), :func:`_alltoall_local` over the experts' axes, and
    the output gathered over dp x tp. The reference's per-axis exchanges
    (``_grid_a2a``) compose to the one flat exchange over the experts'
    axes, and its gather over ``tp`` then over ``dp`` to one gather over
    (dp, tp). The rows' cotangent is gathered over (dp, tp) in the
    backward: each rank's tokens come back whole from the experts. A
    batch already cut over ``dp`` is cut and gathered over ``tp``
    alone."""
    B, S, d = x.shape
    grid = ctx.mesh.group((() if ctx.batch_cut else tuple(ctx.dp))
                          + (ctx.tp,))
    x_my = grid.shard_rows(x.reshape(B * S, d))
    y_my, aux = _alltoall_local(p, x_my, m,
                                ctx.mesh.group(_ep_axes(m, ctx)))
    aux = _pmean(aux, ctx)
    return grid.all_gather(y_my).reshape(B, S, d), aux


def moe_path(m, B: int, S: int, ctx: DistCtx) -> str:
    """The path the reference's ``apply_moe`` takes for a global batch of
    B rows of S tokens: ``"alltoall"``, ``"etp"`` (expert tensor
    parallelism) or ``"local"``."""
    if ctx is None or ctx.mesh is None:
        return "local"
    tp, dp = ctx.tp_size, ctx.dp_size
    T_shard = (B * S) // dp
    if (m.impl == "alltoall" and B % dp == 0 and T_shard % tp == 0
            and T_shard >= tp):
        return "alltoall"
    if B % dp == 0 and m.d_expert % tp == 0:
        return "etp"
    return "local"


def apply_moe(p, x: torch.Tensor, cfg, ctx: DistCtx = None):
    """x: (B, S, d) -> (y (B, S, d), weighted aux loss). Under a mesh
    ``p`` holds this rank's parts of each leaf, and x is this rank's
    rows where ``ctx.batch_cut`` (else the whole batch), replicated over
    ``tp``; so is y."""
    m = cfg.moe
    B, S, d = x.shape
    mesh = None if ctx is None else ctx.mesh
    if mesh is not None:
        _check_parts(p, cfg, ctx, d)
    Bg = B * ctx.dp_size if mesh is not None and ctx.batch_cut else B
    path = moe_path(m, Bg, S, ctx)
    every = () if mesh is None else tuple(mesh.axis_names)
    if path == "etp":
        y, aux = _dense_shard_map(
            _relaid(p, cfg, ctx, lambda n: _etp_part(m, ctx, n), every, d),
            x, m, ctx)
    elif path == "alltoall":
        y, aux = _alltoall(
            _relaid(p, cfg, ctx, lambda n: _ep_part(m, ctx), every, d), x,
            m, ctx)
    else:
        xl = x
        if mesh is not None and ctx.batch_cut:
            # The whole batch, as the reference's local path sees it.
            xl = mesh.group(ctx.dp).all_gather(x)
        y, aux = _local_moe(_relaid(p, cfg, ctx, lambda n: None, (), d)
                            if mesh is not None else p,
                            xl.reshape(-1, d), m)
        y = y.reshape(xl.shape)
        if xl is not x:
            y = mesh.group(ctx.dp).shard_rows(y)
    if m.n_shared:
        from repro_torch.models.ffn import apply_ffn
        y = y + apply_ffn(p["shared"], x, "swiglu", ctx, cfg=cfg,
                          name="shared")
    return y, aux * m.router_aux_weight
