"""Mamba2 (SSD) blocks for the Zamba2 hybrid (counterpart of
``repro/models/mamba.py``; Mamba2 backbone blocks per arXiv:2411.15242,
SSD per arXiv:2405.21060).

The recurrence per head (scalar decay a_t = exp(A dt_t), state (P, N)):

    h_t = a_t h_{t-1} + dt_t x_t (outer) B_t
    y_t = C_t . h_t + D x_t

Two forms, with the reference's contract:

* :func:`ssd_scan`, the exact step recurrence, a Python loop over time
  (decode, and the oracle);
* :func:`ssd_chunked`, the chunkwise-parallel form: the intra-chunk
  decay L[t, i] = exp(cum_t - cum_i) is a scalar a head, computed
  directly, and the intra-chunk part is two products. Every term that
  does not read the carried state is computed for all chunks at once;
  the Python loop over the chunks carries the state alone.

Chunked where ``S % cfg.ssm_chunk == 0 and S > 1``, otherwise the scan;
decode always scans. The recurrence runs in f32.

State per layer: {"h": (B, H, P, N) f32, "conv": (B, conv_width - 1,
conv_dim)}, stacked on a leading layer axis by :func:`init_mamba_state`.
The functions return new tensors; the conv state they return is a view
of the last K - 1 rows of their padded input.

Under a mesh (``ctx``; ``launch/sharding.py`` lays the leaves out)
``in_proj`` and ``out_proj`` are FSDP-cut only: they are gathered over
the ``dp`` axes at use, and the projections, the convolution and the
gates run the same on every rank of ``tp``. Where the heads divide over
``tp`` (:func:`ssd_heads`) the scan runs on this rank's heads (its
channels of x, its ``dt``, decay and ``D``; ``B`` and ``C`` are shared
by every head, their cotangents summed over ``tp``), the state ``h``
holds those heads, and y is all-gathered over ``tp`` before the gated
RMSNorm, so that the block's result is the same on every rank of
``tp``. The conv state is whole.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.launch import sharding as SH
from repro_torch.models.common import DistCtx, dense_init, rms_norm, tp_heads


def _dims(cfg):
    d = cfg.d_model
    d_inner = cfg.ssm.expand * d
    P = cfg.ssm.head_dim
    H = d_inner // P
    N = cfg.ssm.state_dim
    return d, d_inner, H, P, N


def mamba_shapes(cfg):
    """The Mamba2 leaves' whole shapes, in the draw order."""
    d, d_inner, H, P, N = _dims(cfg)
    # xBC projection: x (d_inner) + B (N) + C (N); B / C shared across
    # heads (mamba2's default n_groups = 1).
    conv_dim = d_inner + 2 * N
    return {"in_proj": (d, 2 * d_inner + 2 * N + H),
            "conv_w": (cfg.ssm.conv_width, conv_dim), "conv_b": (conv_dim,),
            "A_log": (H,), "D": (H,), "dt_bias": (H,), "norm_w": (d_inner,),
            "out_proj": (d_inner, d)}


def init_mamba2(gen: torch.Generator, cfg, dtype, cut=None):
    """``cut(name, shape)`` gives the parts of a leaf this rank keeps
    (None: every leaf whole)."""
    shapes = mamba_shapes(cfg)
    dev = gen.device

    def w(name, scale=0.02):
        return dense_init(gen, shapes[name], dtype, scale, part=(
            None if cut is None else cut(name, shapes[name])))

    def full(name, v, dt=torch.float32):
        return torch.full(shapes[name], v, dtype=dt, device=dev)
    return {
        "in_proj": w("in_proj"),
        "conv_w": w("conv_w", scale=0.1),
        "conv_b": full("conv_b", 0.0, dtype),
        "A_log": full("A_log", 0.0),
        "D": full("D", 1.0),
        "dt_bias": full("dt_bias", -1.0),
        "norm_w": full("norm_w", 1.0, dtype),
        "out_proj": w("out_proj"),
    }


def ssd_heads(cfg, ctx: DistCtx = None):
    """This rank's heads [h0, h1) where the scan runs on a part of the
    heads under ``ctx``, else None."""
    return tp_heads(ctx, _dims(cfg)[2])


def _split_in(p, x: torch.Tensor, cfg):
    """(z (.., d_inner), xbc (.., d_inner + 2N), dt_raw (.., H))."""
    d, d_inner, H, P, N = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H],
                                 dim=-1)
    return z, xbc, dt_raw


def _causal_conv(xbc: torch.Tensor, conv_state: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal convolution over time. xbc: (B, S, C);
    conv_state: (B, K-1, C), the previous segment's trailing rows. The
    K terms are added in the reference's order, from 0. Returns
    (silu(conv + b), the last K-1 rows of [conv_state; xbc])."""
    K = w.shape[0]
    S = xbc.shape[1]
    full = torch.cat([conv_state, xbc], dim=1)
    out = 0
    for i in range(K):
        out = out + full[:, i:i + S] * w[i]
    new_state = full[:, -(K - 1):] if K > 1 else conv_state
    return torch.nn.functional.silu(out + b), new_state


def _gates(p, dt_raw: torch.Tensor):
    """dt (softplus written as the reference's ``logaddexp(x, 0)``,
    clipped to [1e-4, 10]) and the per-step log decay A dt, clipped to
    [-8, -1e-6], both (B, S, H) f32."""
    x = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(x, torch.zeros_like(x))
    dt = torch.clamp(dt, 1e-4, 10.0)
    A = -torch.exp(torch.clamp(p["A_log"], -8.0, 4.0))
    loga = torch.clamp(A * dt, -8.0, -1e-6)
    return dt, loga


def ssd_scan(xh, Bv, Cv, dt, loga, D, h0):
    """The exact recurrence. xh: (B, S, H, P); Bv / Cv: (B, S, N);
    dt / loga: (B, S, H); h0: (B, H, P, N). Returns (y (B, S, H, P)
    f32, final state)."""
    with record_function("ssd_scan"):
        xf, bf, cf = xh.float(), Bv.float(), Cv.float()
        h = h0.float()
        ys = []
        # One unbind a tensor: its backward stacks the steps' gradients
        # once, where a slice a step would fill a zero tensor of the
        # whole sequence for each.
        for xt, bt, ct, dtt, lat in zip(*(a.unbind(1) for a in
                                          (xf, bf, cf, dt, loga))):
            a = torch.exp(lat)[..., None, None]              # (B,H,1,1)
            upd = (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
            h = a * h + upd                                  # (B,H,P,N)
            ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
        y = torch.stack(ys, dim=1)
        return y + D[None, None, :, None] * xf, h


def ssd_chunked(xh, Bv, Cv, dt, loga, D, h0, chunk: int):
    """Chunkwise-parallel SSD; the contract of :func:`ssd_scan`. Per
    chunk, as the reference's chunk step: the inclusive cumulative log
    decay, the intra-chunk part (lower triangle including the diagonal:
    the scan updates h before its output), and the state update ``h' =
    e^ctot h + sum_i e^(ctot - cum_i) x_i B_i^T``; the state entering
    each chunk then adds ``e^cum_t C_t . h`` to its outputs."""
    B, S, H, P = xh.shape
    N = Bv.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    with record_function("ssd_chunked"):
        xf = (dt[..., None] * xh.float()).reshape(B, nc, chunk, H, P)
        bf = Bv.float().reshape(B, nc, chunk, N)
        cf = Cv.float().reshape(B, nc, chunk, N)
        la = loga.reshape(B, nc, chunk, H)
        cum = torch.cumsum(la, dim=2)                     # (B,nc,chunk,H)
        ctot = cum[:, :, -1]                              # (B,nc,H)
        Lm = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=xh.device))
        scores = torch.einsum("bctn,bcin->bcti", cf, bf)
        w = torch.where(tri[..., None], Lm, 0.0) * scores[..., None]
        intra = torch.einsum("bctih,bcihp->bcthp", w, xf)
        dec = torch.exp(ctot[:, :, None] - cum)           # (B,nc,chunk,H)
        upd = torch.einsum("bcih,bcihp,bcin->bchpn", dec, xf, bf)
        decay = torch.exp(ctot)[..., None, None]          # (B,nc,H,1,1)
        h = h0.float()
        entering = []
        # unbind, not a slice a chunk: see ssd_scan.
        for dc, uc in zip(decay.unbind(1), upd.unbind(1)):
            entering.append(h)
            h = dc * h + uc
        inter = torch.einsum("bcth,bcthp->bcthp", torch.exp(cum),
                             torch.einsum("bctn,bchpn->bcthp", cf,
                                          torch.stack(entering, dim=1)))
        y = (inter + intra).reshape(B, S, H, P)
        return y + D[None, None, :, None] * xh.float(), h


def mamba2_block(p, x: torch.Tensor, state, cfg, ctx: DistCtx = None):
    """x: (B, S, d); state {"h": (B, H, P, N), "conv": (B, K-1,
    conv_dim)}. Returns (out (B, S, d), {"h", "conv"}). Under a mesh x
    and ``out`` are replicated over ``tp``, and ``h`` holds this rank's
    heads (:func:`ssd_heads`)."""
    B, S, d = x.shape
    _, d_inner, H, P, N = _dims(cfg)
    if ctx is not None and ctx.mesh is not None:
        p = {name: SH.use(p[name], cfg, ctx, ("mix", name), shape)
             for name, shape in mamba_shapes(cfg).items()}
    z, xbc, dt_raw = _split_in(p, x, cfg)
    xbc, conv_state = _causal_conv(xbc, state["conv"], p["conv_w"],
                                   p["conv_b"])
    xin, Bv, Cv = torch.split(xbc, [d_inner, N, N], dim=-1)
    xh = xin.reshape(B, S, H, P)
    dt, loga = _gates(p, dt_raw)
    D = p["D"]
    heads = ssd_heads(cfg, ctx)
    if heads is not None:
        # Replicated values entering this rank's heads: a head's own
        # inputs are its rows (the backward gathers every rank's), the
        # shared B and C sum their cotangents over tp.
        g = ctx.mesh.group(ctx.tp)
        xh = g.shard_rows(xh, dim=2)
        dt, loga = g.shard_rows(dt, dim=-1), g.shard_rows(loga, dim=-1)
        D = g.shard_rows(D)
        Bv, Cv = g.psum_grad(Bv), g.psum_grad(Cv)
    if S % cfg.ssm_chunk == 0 and S > 1:
        y, h = ssd_chunked(xh, Bv, Cv, dt, loga, D, state["h"],
                           cfg.ssm_chunk)
    else:
        y, h = ssd_scan(xh, Bv, Cv, dt, loga, D, state["h"])
    y = y.reshape(B, S, -1).to(x.dtype)
    if heads is not None:
        y = g.all_gather(y, dim=-1)
    y = rms_norm(y * torch.nn.functional.silu(z), p["norm_w"])
    return y @ p["out_proj"], {"h": h, "conv": conv_state}


def init_mamba_state(B: int, cfg, dtype, layers: int, device=None,
                     ctx: DistCtx = None):
    """Zero states; under a mesh ``h`` holds this rank's heads
    (:func:`ssd_heads`)."""
    d, d_inner, H, P, N = _dims(cfg)
    heads = ssd_heads(cfg, ctx)
    if heads is not None:
        H = heads[1] - heads[0]
    conv_dim = d_inner + 2 * N
    return {"h": torch.zeros((layers, B, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((layers, B, cfg.ssm.conv_width - 1,
                                 conv_dim), dtype=dtype, device=device)}
