"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

These are the reference semantics: on a CPU tensor ``kernels/ops.py``
runs them, and every CUDA kernel in ``kernels/csrc`` is held against
them on the card. Each clustering function takes an optional leading
batch axis, so a batched caller makes one call instead of one per batch
entry. ``moe_dispatch_bwd`` and ``moe_combine_bwd`` are the MoE
functions' gradients (the JAX package differentiates its ``ref.py``
instead; there is no Pallas backward).
"""
from __future__ import annotations

from typing import Optional

import torch

MASKED_DIST = 1e30  # additive "infinity" that survives f32 matmul paths

SOLVE_ATTACH_DTYPES = ("f32", "bf16")


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. x: (..., n, d), c: (..., k, d) or a
    shared (k, d) -> (..., n, k), clamped at 0."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    d = x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2.unsqueeze(-2)
    return torch.clamp_min(d, 0.0)


def assign_argmin(x: torch.Tensor, c: torch.Tensor,
                  c_mask: Optional[torch.Tensor] = None):
    """Nearest-center assignment. Returns (idx (..., n) int32,
    min_sq_dist (..., n) f32). A masked center's distance is exactly
    ``MASKED_DIST``; with every center masked, idx=0 and val=1e30. Ties
    go to the smallest center index."""
    d = pairwise_sq_dists(x, c)
    if c_mask is not None:
        d = torch.where(c_mask.unsqueeze(-2), d,
                        torch.full_like(d, MASKED_DIST))
    # torch.argmin returns the first occurrence, like jnp.argmin.
    return torch.argmin(d, dim=-1).to(torch.int32), torch.amin(d, dim=-1)


def kmeans_update(x: torch.Tensor, assign: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None):
    """Per-cluster sums and counts. ``assign`` entries equal to -1
    contribute nothing. x: (..., n, d), assign: (..., n) ->
    (sums (..., k, d) f32, counts (..., k) f32)."""
    cols = torch.arange(k, device=assign.device, dtype=assign.dtype)
    oh = (assign.unsqueeze(-1) == cols).float()
    if weights is not None:
        oh = oh * weights.float().unsqueeze(-1)
    sums = oh.transpose(-1, -2) @ x.float()
    counts = torch.sum(oh, dim=-2)
    return sums, counts


def store_dtype(dtype: str) -> torch.dtype:
    if dtype not in SOLVE_ATTACH_DTYPES:
        raise ValueError(f"dtype={dtype!r} is invalid: accepted values "
                         f"are {list(SOLVE_ATTACH_DTYPES)}")
    return torch.float32 if dtype == "f32" else torch.bfloat16


def solve_attach(x: torch.Tensor, centers0: torch.Tensor,
                 tau: torch.Tensor,
                 center_mask: Optional[torch.Tensor] = None,
                 point_mask: Optional[torch.Tensor] = None,
                 *, max_iters: int = 100, dtype: str = "f32"):
    """The fused serve step: per request, the bounded Lloyd loop until
    the assignment is stable, the Theorem 3.2 attach of the converged
    centers against ``tau``, and the Definition 3.3 induced labels.

    x: (B, n, d); centers0: (B, k', d); tau: (k, d) shared;
    center_mask: (B, k') bool; point_mask: (B, n) bool. Returns
    (labels (B, n) i32, min_sq_dist (B, n) f32, centers (B, k', d) f32,
    center_labels (B, k') i32). ``dtype="bf16"`` stores x / centers /
    tau in bfloat16 between iterations and accumulates in f32.

    Each request's loop is its own: a request whose assignment is stable
    is frozen while the others go on, as under ``vmap`` of a while loop.
    """
    store = store_dtype(dtype)
    B, n, _ = x.shape
    kp = centers0.shape[1]
    dev = x.device
    cm = (torch.ones((B, kp), dtype=torch.bool, device=dev)
          if center_mask is None else center_mask)
    pm = (torch.ones((B, n), dtype=torch.bool, device=dev)
          if point_mask is None else point_mask)
    xs = x.to(store)
    taus = tau.to(store)

    def assign(centers):
        idx, mind = assign_argmin(xs, centers, cm)
        return (torch.where(pm, idx, torch.full_like(idx, -1)),
                torch.where(pm, mind, torch.zeros_like(mind)))

    centers = centers0.to(store)
    prev = torch.full((B, n), -2, dtype=torch.int32, device=dev)
    it = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    while it < max_iters and not bool(done.all()):
        a, _ = assign(centers)
        sums, cnt = kmeans_update(xs, a, kp)
        new = sums / torch.clamp_min(cnt, 1.0).unsqueeze(-1)
        new = torch.where((cnt > 0).unsqueeze(-1), new, centers.float())
        live = ~done
        centers = torch.where(live[:, None, None], new.to(store), centers)
        done = done | (live & torch.all(a == prev, dim=-1))
        prev = a
        it += 1
    a, mind = assign(centers)
    ctr, _ = assign_argmin(centers, taus)
    ctr = torch.where(cm, ctr, torch.full_like(ctr, -1))
    safe = torch.clamp(a, 0, kp - 1).long()
    lbl = torch.gather(ctr, 1, safe)
    lbl = torch.where(a >= 0, lbl, torch.full_like(lbl, -1))
    return lbl, mind, centers.float(), ctr


def moe_dispatch(x: torch.Tensor, src: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Queue-order row gather: slot s takes row ``clip(src[s], 0, T-1)``
    of x, or exact zeros where ``valid[s]`` is False. x: (T, d);
    src: (S,) int; valid: (S,) bool. Returns (S, d) in x's dtype."""
    rows = x[torch.clamp(src.long(), 0, x.shape[0] - 1)]
    return torch.where(valid.bool()[:, None], rows,
                       torch.zeros_like(rows)).to(x.dtype)


def moe_combine(ybuf: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                top_k: int) -> torch.Tensor:
    """Weighted re-assembly: ``y[t] = sum_{j < top_k} gates[t*top_k+j]
    * ybuf[clip(slot[t*top_k+j])]`` in f32 (f64 for f64 inputs), j in
    order. ybuf: (S, d); slot / gates: (T*top_k,). Returns (T, d)."""
    acc = _acc(ybuf)
    rows = ybuf[torch.clamp(slot.long(), 0, ybuf.shape[0] - 1)].to(acc)
    w = gates.to(acc)[:, None]
    T = slot.shape[0] // top_k
    return torch.sum((rows * w).reshape(T, top_k, -1), dim=1)


def sequential_combine(ybuf: torch.Tensor, slot: torch.Tensor,
                       gates: torch.Tensor, top_k: int) -> torch.Tensor:
    """``moe_combine`` summed as its kernel sums, for any top_k: each
    product rounded, then added to a sum that starts at 0, j in order
    (for top_k <= 2 the bits of :func:`moe_combine`). Returns (T, d)
    f32 (f64 for f64 inputs)."""
    S, d = ybuf.shape
    T = slot.shape[0] // top_k
    acc = _acc(ybuf)
    rows = (ybuf[torch.clamp(slot.long(), 0, S - 1)].to(acc)
            * gates.to(acc)[:, None]).view(T, top_k, d)
    out = torch.zeros((T, d), dtype=acc, device=ybuf.device)
    for j in range(top_k):
        out = out + rows[:, j]
    return out


def moe_dispatch_bwd(dbuf: torch.Tensor, slot: torch.Tensor,
                     keep: torch.Tensor, T: int, top_k: int,
                     dtype=None) -> torch.Tensor:
    """The gradient of :func:`moe_dispatch`'s x, for the queues of a
    routing: ``dx[t] = sum over the kept j of dbuf[slot[t*top_k+j]]``,
    summed in f32 (f64 for f64 inputs) from 0 in j order and cast to
    ``dtype`` (x's; dbuf's by default). A valid slot is owned by exactly
    one kept entry. A dropped entry's term is selected away
    (``where(keep, row, 0)``), as JAX's gradient of ``where(valid, rows,
    0)`` selects, so a non-finite row at its clamped slot (another
    token's) does not reach it. dbuf: (S, d); slot, keep: (T*top_k,).
    Returns (T, d)."""
    if slot.shape[0] != T * top_k:
        raise ValueError(f"moe_dispatch_bwd: {slot.shape[0]} entries for "
                         f"T={T} at top_k={top_k}")
    S, d = dbuf.shape
    acc = _acc(dbuf)
    rows = dbuf[torch.clamp(slot.long(), 0, S - 1)].to(acc)
    rows = torch.where(keep.bool()[:, None], rows, 0).view(T, top_k, d)
    dx = torch.zeros((T, d), dtype=acc, device=dbuf.device)
    for j in range(top_k):
        dx = dx + rows[:, j]
    return dx.to(dbuf.dtype if dtype is None else dtype)


def _acc(t: torch.Tensor) -> torch.dtype:
    """The type the MoE functions sum in: f32, or f64 for f64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def moe_combine_bwd(dout: torch.Tensor, ybuf: torch.Tensor,
                    src_entry: torch.Tensor, valid: torch.Tensor,
                    w: torch.Tensor, top_k: int):
    """The gradients of :func:`moe_combine` for the queues of a routing,
    in gather form over the slots. A valid slot s is owned by the entry
    e = ``src_entry[s]`` of token t = e // top_k:
    ``dybuf[s] = (w[e] * dout[t])`` cast to ybuf's dtype (0 where the
    slot is not valid) and ``dgates[e] = sum_c dout[t, c] * ybuf[s, c]``
    in f32; an entry that owns no slot (dropped) gets a gate gradient of
    0, as the forward's ``where(keep, gates, 0)`` gives it. dout: (T, d)
    f32; ybuf: (S, d); src_entry: (S,) int; valid: (S,) bool;
    w: (T*top_k,). Returns (dybuf (S, d), dgates (T*top_k,) f32; f64
    for f64 inputs)."""
    T = dout.shape[0]
    acc = _acc(ybuf)
    valid = valid.bool()
    e = torch.where(valid, src_entry.long(), 0)
    rows = dout.to(acc)[e // top_k]                    # (S, d)
    we = w.to(acc)[e]
    dybuf = torch.where(valid[:, None], rows * we[:, None],
                        torch.zeros_like(rows)).to(ybuf.dtype)
    dots = torch.sum(rows * ybuf.to(acc), dim=-1)
    # Each valid slot writes its owner's entry (unique); the others write
    # a sentinel entry past the end, sliced off: no data-dependent shape,
    # so a dry run on the meta device passes through.
    n = T * top_k
    dgates = torch.zeros((n + 1,), dtype=acc, device=ybuf.device)
    dgates[torch.where(valid, e, n)] = dots
    return dybuf, dgates[:n]


def swa_decode_attention(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                         bias: torch.Tensor, scale: float) -> torch.Tensor:
    """One-token attention over a window of cached keys, with GQA head
    groups. q: (b, h, dh); kw / vw: (b, W, kvh, dh); bias: (b, W) added
    to the scaled scores (0 valid, -1e30 not). Scores, softmax and the
    weighted sum in f32; returns (b, h, dh) in q's dtype."""
    b, h, dh = q.shape
    kvh = kw.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh).float()
    s = torch.einsum("bkgd,bwkd->bkgw", qg, kw.float()) * scale
    s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, vw.float())
    return o.reshape(b, h, dh).to(q.dtype)


def swa_decode_partial(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                       bias: torch.Tensor, scale: float,
                       splits: int = 1) -> torch.Tensor:
    """The softmax state of :func:`swa_decode_attention` over each of
    ``splits`` chunks of the window (chunk c the keys [c W / S,
    (c + 1) W / S), the split kernel's chunks): (b * h, splits, dh + 2)
    f32, each chunk's m (the row max of the biased, scaled scores, at
    least -1e30), l = sum exp(s - m) and acc = sum exp(s - m) v. Merged
    by :func:`merge_states`, the chunks give :func:`swa_decode_attention`
    (up to the order of the sums)."""
    b, h, dh = q.shape
    W, kvh = kw.shape[1], kw.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh).float()
    s = torch.einsum("bkgd,bwkd->bkgw", qg, kw.float()) * scale
    s = s + bias.float()[:, None, None, :]
    out = []
    for c in range(splits):
        lo, hi = c * W // splits, (c + 1) * W // splits
        sc = s[..., lo:hi]
        m = torch.clamp_min(torch.amax(sc, dim=-1), -1e30)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("bkgw,bwkd->bkgd", p, vw[:, lo:hi].float())
        out.append(torch.cat([m[..., None], torch.sum(p, dim=-1)[..., None],
                              acc], dim=-1).reshape(b * h, 1, dh + 2))
    return torch.cat(out, dim=1)


def merge_states(part: torch.Tensor) -> torch.Tensor:
    """Softmax states (..., S, D + 2) f32 (m, l, acc over disjoint key
    sets, as :func:`swa_decode_partial` lays them out) merged in order
    over S: M = max m_s, w_s = exp(m_s - M), sum w_s acc_s / max(sum w_s
    l_s, 1e-30) -> (..., D) f32. A state of masked keys only (m = -1e30)
    weighs 0 beside one that holds a key; where none does, every weight
    is 1 and the result averages V over every key."""
    m, l, acc = part[..., 0], part[..., 1], part[..., 2:]
    w = torch.exp(m - torch.amax(m, dim=-1, keepdim=True))
    lsum = l[..., 0] * w[..., 0]
    a = acc[..., 0, :] * w[..., 0, None]
    for s in range(1, part.shape[-2]):
        lsum = lsum + l[..., s] * w[..., s]
        a = a + acc[..., s, :] * w[..., s, None]
    return a / torch.clamp_min(lsum, 1e-30)[..., None]
