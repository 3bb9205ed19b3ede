"""Dispatch over the port's kernels (counterpart of
``repro/kernels/ops.py``).

The device of the data decides, and nothing else: a CPU tensor goes to
the plain version in ``kernels/ref.py``; a CUDA tensor goes to the
hand-written kernel, which launches or raises. There is no fallback
from one to the other and no switch that routes CUDA tensors to the
plain version. Operands are made contiguous here, because the kernel
wrappers refuse strided tensors. The MoE layer's dispatch and combine
carry their gradients (``_Dispatch``, ``_Combine``), whose backward
follows the same rule: the plain formulas on the CPU, kernels on the
card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import kmeans_update as _ku
from repro_torch.kernels import moe_combine as _mc
from repro_torch.kernels import moe_combine_bwd as _mcb
from repro_torch.kernels import moe_dispatch as _md
from repro_torch.kernels import moe_dispatch_bwd as _mdb
from repro_torch.kernels import pdist_argmin as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import solve_attach as _sa
from repro_torch.kernels import swa_decode as _sw

# Row count above which assign_argmin streams fixed-size chunks through
# the kernel instead of one monolithic call (repro/kernels/ops.py).
CHUNK_ROWS = 1 << 18

_WRAPPERS = (_pa, _ku, _sa, _md, _mc, _sw, _mcb, _mdb, _sw.PARTIAL,
             _sw.COMBINE)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {m.NAME: m.LAUNCHES for m in _WRAPPERS}


def reset_launch_counts() -> None:
    for m in _WRAPPERS:
        m.LAUNCHES = 0


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    # The full distance matrix is a plain product outside any kernel.
    return _ref.pairwise_sq_dists(x, c)


def _assign_argmin_one(x, c, c_mask):
    if x.device.type == "cpu":
        return _ref.assign_argmin(x, c, c_mask)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _pa.pdist_argmin(x.contiguous(), c.to(x.dtype).contiguous(),
                            None if c_mask is None else c_mask.contiguous())


def assign_argmin(x: torch.Tensor, c: torch.Tensor,
                  c_mask: Optional[torch.Tensor] = None):
    """Nearest center of every point: (idx (..., n) int32,
    min_sq_dist (..., n) f32). Above ``CHUNK_ROWS`` rows the points
    stream through in fixed-size chunks, bounding the working set."""
    n = x.shape[-2]
    if n <= CHUNK_ROWS:
        return _assign_argmin_one(x, c, c_mask)
    parts = [_assign_argmin_one(x[..., lo:lo + CHUNK_ROWS, :], c, c_mask)
             for lo in range(0, n, CHUNK_ROWS)]
    return (torch.cat([p[0] for p in parts], dim=-1),
            torch.cat([p[1] for p in parts], dim=-1))


def kmeans_update(x: torch.Tensor, assign: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None):
    """Per-cluster sums and counts: (sums (..., k, d) f32,
    counts (..., k) f32)."""
    if x.device.type == "cpu":
        return _ref.kmeans_update(x, assign, k, weights)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _ku.kmeans_update(
        x.contiguous(), assign.to(torch.int32).contiguous(), k,
        None if weights is None else weights.float().contiguous())


def solve_attach(x: torch.Tensor, centers0: torch.Tensor, tau: torch.Tensor,
                 center_mask: Optional[torch.Tensor] = None,
                 point_mask: Optional[torch.Tensor] = None,
                 *, max_iters: int = 100, dtype: str = "f32"):
    """The fused serve step (bounded Lloyd, Theorem 3.2 attach,
    Definition 3.3 labels) for a (B, n, d) request batch. ``dtype``:
    "f32" or "bf16" storage, f32 accumulation either way."""
    if x.device.type == "cpu":
        return _ref.solve_attach(x, centers0, tau, center_mask, point_mask,
                                 max_iters=max_iters, dtype=dtype)
    store = _ref.store_dtype(dtype)
    B, n, _ = x.shape
    kp = centers0.shape[1]
    cm = (torch.ones((B, kp), dtype=torch.bool, device=x.device)
          if center_mask is None else center_mask)
    pm = (torch.ones((B, n), dtype=torch.bool, device=x.device)
          if point_mask is None else point_mask)
    return _sa.solve_attach(
        x.to(store).contiguous(), centers0.to(store).contiguous(),
        tau.to(store).contiguous(), cm.contiguous(), pm.contiguous(),
        max_iters=max_iters)


def _dispatch(x, src, valid):
    if x.device.type == "cpu":
        return _ref.moe_dispatch(x, src, valid)
    return _md.moe_dispatch(x.contiguous(), src.contiguous(),
                            valid.contiguous())


def _combine(ybuf, slot, gates, top_k):
    if ybuf.device.type == "cpu":
        return _ref.moe_combine(ybuf, slot, gates, top_k)
    return _mc.moe_combine(ybuf.contiguous(), slot.contiguous(),
                           gates.contiguous(), top_k)


def _dispatch_bwd(dbuf, slot, keep, T: int, top_k: int, dtype):
    """dx of the dispatch: each token's kept slot rows of dbuf summed in
    f32 in j order and rounded once to x's dtype (on the card the
    moe_dispatch_bwd kernel, one launch; dbuf, the gradient of the
    dispatch's output, is in x's dtype)."""
    if dbuf.device.type == "cpu":
        return _ref.moe_dispatch_bwd(dbuf, slot, keep, T, top_k, dtype)
    if dbuf.dtype != dtype:
        raise ValueError(f"moe_dispatch_bwd: dbuf is {dbuf.dtype}, x is "
                         f"{dtype}")
    return _mdb.moe_dispatch_bwd(dbuf.contiguous(), slot.contiguous(),
                                 keep.contiguous(), top_k)


def _combine_bwd(dout, ybuf, src_entry, valid, w, top_k: int):
    if ybuf.device.type == "cpu":
        return _ref.moe_combine_bwd(dout, ybuf, src_entry, valid, w, top_k)
    return _mcb.moe_combine_bwd(dout.float().contiguous(), ybuf.contiguous(),
                                src_entry.contiguous(), valid.contiguous(),
                                w.contiguous(), top_k)


class _Dispatch(torch.autograd.Function):
    """The MoE layer's dispatch with its gradient: forward
    ``moe_dispatch`` (the gather kernel); backward, for the routing's
    (T*top_k,) ``slot`` and ``keep``, :func:`_dispatch_bwd`."""

    @staticmethod
    def forward(ctx, x, src, valid, slot, keep, top_k):
        ctx.save_for_backward(slot, keep)
        ctx.top_k, ctx.T, ctx.dtype = int(top_k), x.shape[0], x.dtype
        return _dispatch(x, src, valid)

    @staticmethod
    def backward(ctx, dbuf):
        slot, keep = ctx.saved_tensors
        dx = _dispatch_bwd(dbuf, slot, keep, ctx.T, ctx.top_k, ctx.dtype)
        return dx, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """The MoE layer's combine with its gradient: forward
    ``moe_combine``; backward, through the slot -> entry map
    (``src_entry``, ``valid``), :func:`_combine_bwd`. The gradient of a
    gate whose entry owns no slot is returned as 0: the layer passes 0
    there (``where(keep, gates, 0)``), whose gradient is 0 anyway."""

    @staticmethod
    def forward(ctx, ybuf, slot, gates, src_entry, valid, top_k):
        ctx.save_for_backward(ybuf, gates, src_entry, valid)
        ctx.top_k = int(top_k)
        return _combine(ybuf, slot, gates, top_k)

    @staticmethod
    def backward(ctx, dout):
        ybuf, gates, src_entry, valid = ctx.saved_tensors
        dybuf, dgates = _combine_bwd(dout, ybuf, src_entry, valid, gates,
                                     ctx.top_k)
        return dybuf, None, dgates, None, None, None


def moe_dispatch(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor,
                 *, slot: Optional[torch.Tensor] = None,
                 keep: Optional[torch.Tensor] = None,
                 top_k: int = 1) -> torch.Tensor:
    """Queue-order row gather (the routed step's dispatch of whole
    requests into per-cluster head queues, and the MoE layer's): (S, d)
    in x's dtype, slot s holding row ``clip(src[s])`` of x, or zeros
    where not ``valid``. Given the routing's (T*top_k,) ``slot`` and
    ``keep`` (the MoE layer's), the result carries x's gradient
    (:class:`_Dispatch`); without them it carries none."""
    if slot is None:
        return _dispatch(x, src, valid)
    return _Dispatch.apply(x, src, valid, slot, keep, top_k)


def moe_combine(ybuf: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                top_k: int, *, src_entry: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted slot -> token re-assembly: (T, d) f32. The routed step
    uses top_k=1 with the keep mask as gates, so an overflowed request
    combines to exactly zero. Given the slot -> entry map (``src_entry``
    and ``valid``, the MoE layer's), the result carries the gradients of
    ybuf and gates (:class:`_Combine`); without it, none."""
    if src_entry is None:
        return _combine(ybuf, slot, gates, top_k)
    return _Combine.apply(ybuf, slot, gates, src_entry, valid, top_k)


def swa_decode_attention(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                         bias: torch.Tensor, scale: float) -> torch.Tensor:
    """One-token attention over a window of cached keys (the ring-cache
    decode of a sliding-window model): (b, h, dh) in q's dtype. bias
    (b, W) is added to the scaled scores: 0 where a slot holds a key,
    -1e30 where it does not."""
    if q.device.type == "cpu":
        return _ref.swa_decode_attention(q, kw, vw, bias, scale)
    return _sw.swa_decode_attention(q.contiguous(), kw.contiguous(),
                                    vw.contiguous(),
                                    bias.float().contiguous(), float(scale))


def swa_decode_partial(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                       bias: torch.Tensor, scale: float, *,
                       ranks: int = 1) -> torch.Tensor:
    """The softmax state of :func:`swa_decode_attention` over chunks of
    the window (a rank's block of a context-parallel ring): (b * h, S,
    dh + 2) f32, each chunk's m, l and acc. One chunk on the CPU; on the
    card the split kernel's chunks, at most 32 over the ``ranks`` whose
    states one :func:`swa_combine` merges."""
    if q.device.type == "cpu":
        return _ref.swa_decode_partial(q, kw, vw, bias, scale)
    return _sw.swa_decode_partial(q.contiguous(), kw.contiguous(),
                                  vw.contiguous(), bias.float().contiguous(),
                                  float(scale), ranks=ranks)


def swa_combine(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Chunk states (rows, S, D + 2) f32 merged in order over S
    (``ref.merge_states``): (rows, D) in ``dtype``."""
    if part.device.type == "cpu":
        return _ref.merge_states(part).to(dtype)
    return _sw.swa_combine(part.contiguous(), dtype)
