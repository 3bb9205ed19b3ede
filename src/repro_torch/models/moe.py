"""Mixture-of-experts layer with top-k token-choice routing (counterpart
of ``repro/models/moe.py``), the single-device path.

Dispatch is sort-based and of fixed capacity, as in the reference:
tokens are gathered into per-expert queues of C = ceil(T * k / E * cf)
slots (``ops.moe_dispatch``), every expert's SwiGLU runs as one batched
product over the queues, and the outputs are re-assembled with their
gates (``ops.moe_combine``); a token past its expert's capacity is
dropped and contributes zero. The only scatter is the int32 rank of
each (token, choice) entry, an index assignment: no float scatter-add
(DESIGN.md §15).

The expert-parallel paths (``impl="alltoall"`` under a mesh, and the
shard_map expert tensor parallelism) need a device mesh; the port runs
on one device and refuses a sharded context (ROADMAP item 5b).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import DistCtx, dense_init


def init_moe(gen: torch.Generator, cfg, dtype) -> Dict[str, object]:
    m = cfg.moe
    d, E, dff = cfg.d_model, m.n_experts, m.d_expert
    p = {"router": dense_init(gen, (d, E), dtype, scale=0.006),
         "w1": dense_init(gen, (E, d, dff), dtype),
         "w3": dense_init(gen, (E, d, dff), dtype),
         "w2": dense_init(gen, (E, dff, d), dtype)}
    if m.n_shared:
        from repro_torch.models.ffn import init_ffn
        p["shared"] = init_ffn(gen, d, m.n_shared * dff, "swiglu", dtype)
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


def apply_moe(p, x: torch.Tensor, cfg, ctx: DistCtx = None):
    """x: (B, S, d) -> (y (B, S, d), weighted aux loss)."""
    if ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(
            "apply_moe: the expert-parallel paths (alltoall, shard_map "
            "expert tensor parallelism) need a device mesh and are not "
            "ported yet (ROADMAP item 5b); use DistCtx.local()")
    m = cfg.moe
    B, S, d = x.shape
    y, aux = _local_moe(p, x.reshape(-1, d), m)
    y = y.reshape(B, S, d)
    if m.n_shared:
        from repro_torch.models.ffn import apply_ffn
        y = y + apply_ffn(p["shared"], x, "swiglu", ctx)
    return y, aux * m.router_aux_weight
