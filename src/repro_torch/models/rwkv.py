"""RWKV-6 ("Finch") blocks (counterpart of ``repro/models/rwkv.py``):
the time-mix with its data-dependent per-channel decay and the
channel-mix FFN (arXiv:2404.05892).

Two forms of the time-mix recurrence, with the reference's contract:

* :func:`rwkv6_scan`, the exact step recurrence, a Python loop over
  time (decode, and the oracle);
* :func:`rwkv6_chunked`, the chunkwise-parallel form: within a chunk
  the decay products enter a masked attention-like product in f32,
  factored through the chunk's midpoint decay; across chunks the
  (H, dh, dh) state is carried. Every term that does not read the
  carried state is computed for all chunks at once; the Python loop
  over the chunks carries the state alone, and the state's
  contribution to each chunk's output is one product after it.

The choice of form is the reference's: chunked where ``S %
cfg.ssm_chunk == 0 and S > 1``, otherwise the scan over the whole
sequence; decode always scans. Every product of the recurrence is in
f32 (TF32 is off in the port: ``exp(cexc - c_mid)`` reaches e^64 at a
chunk of 32).

State per layer: {"s": (B, H, dh, dh) f32, "shift": (B, d), and for the
channel-mix "shift2": (B, d)}, stacked on a leading layer axis by
:func:`init_rwkv_state`. The functions return new tensors; the
``shift`` they return is a view of their input's last token.

Under a mesh (``ctx``; ``launch/sharding.py`` lays the leaves out) the
time-mix is tensor-parallel where its heads divide over ``tp``
(:func:`time_mix_heads`): ``wr`` / ``wk`` / ``wv`` / ``wg`` and the
decay LoRA's ``wB`` hold this rank's columns, ``u`` its heads' rows and
``wo`` its rows, and the result is the partial product of ``wo``,
summed over ``tp`` by the caller (``models/transformer.py``); ``wA``
and the ``mu_*`` vectors are whole over ``tp``, and ``w0`` and
``ln_x``, whole leaves, are used on this rank's channels: the cotangent
of every whole leaf is summed over ``tp`` (for ``w0`` and ``ln_x`` each
rank's slice, zeros elsewhere), so that every rank holds the whole
gradient and the replicas stay the same bits. The state ``s`` holds
this rank's heads; the shifts are whole. The channel-mix is an FFN:
``wk`` holds this rank's columns of the hidden dim and ``wv`` its rows,
where the hidden dim divides over ``tp``. FSDP-cut dims are gathered
over the ``dp`` axes at use.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.launch import sharding as SH
from repro_torch.models.common import DistCtx, dense_init, tp_heads


def time_mix_shapes(cfg):
    """The time-mix leaves' whole shapes."""
    d, dh, r = cfg.d_model, cfg.ssm.head_dim, cfg.ssm.decay_lora
    out = {f"mu_{c}": (d,) for c in "rkvwg"}
    out.update(wr=(d, d), wk=(d, d), wv=(d, d), wg=(d, d), wo=(d, d),
               w0=(d,), wA=(d, r), wB=(r, d), u=(d // dh, dh), ln_x=(d,))
    return out


def channel_mix_shapes(cfg):
    """The channel-mix leaves' whole shapes."""
    d, dff = cfg.d_model, cfg.d_ff
    return {"mu": (d,), "wk": (d, dff), "wv": (dff, d)}


def _drawer(gen, dtype, shapes, cut):
    def draw(name, scale=0.02):
        return dense_init(gen, shapes[name], dtype, scale, part=(
            None if cut is None else cut(name, shapes[name])))
    return draw


def init_rwkv6(gen: torch.Generator, cfg, dtype, cut=None):
    """``cut(name, shape)`` gives the parts of a leaf this rank keeps
    (None: every leaf whole)."""
    w = _drawer(gen, dtype, time_mix_shapes(cfg), cut)

    def full(v):
        return torch.full((cfg.d_model,), v, dtype=dtype, device=gen.device)
    return {
        # time-mix interpolation vectors (token shift)
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        "wr": w("wr"), "wk": w("wk"), "wv": w("wv"), "wg": w("wg"),
        "wo": w("wo"),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-2.0),
        "wA": w("wA"),
        "wB": w("wB", scale=0.01),
        "u": w("u", scale=0.1),                            # bonus
        "ln_x": full(1.0),                                 # group norm
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg, dtype, cut=None):
    """``cut`` as :func:`init_rwkv6`'s."""
    w = _drawer(gen, dtype, channel_mix_shapes(cfg), cut)
    return {"mu": torch.full((cfg.d_model,), 0.5, dtype=dtype,
                             device=gen.device),
            "wk": w("wk"), "wv": w("wv")}


def time_mix_heads(cfg, ctx: DistCtx = None):
    """This rank's heads [h0, h1) where the time-mix runs
    tensor-parallel under ``ctx``, else None."""
    return tp_heads(ctx, cfg.d_model // cfg.ssm.head_dim)


def channel_mix_local(cfg, ctx: DistCtx = None) -> bool:
    """Whether the channel-mix runs tensor-parallel under ``ctx``
    (its hidden dim dividing over ``tp``)."""
    return tp_heads(ctx, cfg.d_ff) is not None


def _use(p, cfg, ctx, prefix: str, shapes, local: bool):
    """The leaves under ``prefix`` as this rank's work uses them
    (``launch/sharding.use``): their ``tp`` cuts kept where ``local``,
    the cotangents of those held whole then summed over ``tp``; every
    other cut gathered. Without a mesh ``p`` itself."""
    if ctx is None or ctx.mesh is None:
        return p
    return {name: SH.use(p[name], cfg, ctx, (prefix, name), shape,
                         keep_tp=local, tp_partial=local)
            for name, shape in shapes.items()}


def _token_shift(x: torch.Tensor, shift_state: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); shift_state: (B, d), the previous segment's last
    token. Returns x shifted right by one along S."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_inputs(p, x: torch.Tensor, shift_state: torch.Tensor, cfg):
    """r, k, v (B, S, H, dh) and g (B, S, H dh) in x's dtype (H: the
    heads the leaves hold); the per-step log decay (B, S, H, dh) in f32,
    clipped twice as in the reference (exp of [-8, 1.5], then [-4,
    -1e-4]); and x's last token."""
    B, S, _ = x.shape
    dh = cfg.ssm.head_dim
    xp = _token_shift(x, shift_state)

    def mix(mu):
        return x * mu + xp * (1.0 - mu)

    r = (mix(p["mu_r"]) @ p["wr"]).reshape(B, S, -1, dh)
    k = (mix(p["mu_k"]) @ p["wk"]).reshape(B, S, -1, dh)
    v = (mix(p["mu_v"]) @ p["wv"]).reshape(B, S, -1, dh)
    g = torch.nn.functional.silu(mix(p["mu_g"]) @ p["wg"])
    logw = -torch.exp(torch.clamp(
        (p["w0"] + torch.tanh(mix(p["mu_w"]) @ p["wA"]) @ p["wB"]).float(),
        -8.0, 1.5))
    logw = torch.clamp(logw, -4.0, -1e-4).reshape(B, S, -1, dh)
    return r, k, v, g, logw, x[:, -1, :]


def rwkv6_scan(r, k, v, logw, u, s0):
    """The exact recurrence. r / k / v / logw: (B, S, H, dh); u: (H, dh);
    s0: (B, H, dh, dh). Returns (out (B, S, H, dh) f32, final state)."""
    with record_function("rwkv6_scan"):
        rf, kf, vf = r.float(), k.float(), v.float()
        w = torch.exp(logw)
        s = s0.float()
        outs = []
        # One unbind a tensor: its backward stacks the steps' gradients
        # once, where a slice a step would fill a zero tensor of the
        # whole sequence for each.
        for rt, kt, vt, wt in zip(*(a.unbind(1) for a in (rf, kf, vf, w))):
            kv = kt[..., :, None] * vt[..., None, :]          # (B,H,dh,dh)
            outs.append(torch.einsum("bhi,bhij->bhj", rt,
                                     s + u[..., :, None] * kv))
            s = wt[..., :, None] * s + kv
        return torch.stack(outs, dim=1), s


def rwkv6_chunked(r, k, v, logw, u, s0, chunk: int):
    """Chunkwise-parallel RWKV-6; the contract of :func:`rwkv6_scan`.
    Per chunk, as the reference's chunk step: the inclusive and
    exclusive cumulative log decay, the strict-lower intra-chunk scores
    factored through the midpoint decay ``c_mid`` (each factor's
    exponent bounded by chunk / 2 times the largest |logw|), the bonus
    diagonal, and the state update ``s' = e^ctot s + sum_i e^(ctot -
    cinc_i) k_i v_i``; the state entering each chunk then adds ``(r_t
    e^cexc_t) . s`` to its outputs."""
    B, S, H, dh = r.shape
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    with record_function("rwkv6_chunked"):
        rf = r.float().reshape(B, nc, chunk, H, dh)
        kf = k.float().reshape(B, nc, chunk, H, dh)
        vf = v.float().reshape(B, nc, chunk, H, dh)
        lw = logw.reshape(B, nc, chunk, H, dh)
        cinc = torch.cumsum(lw, dim=2)                     # sum_{tau<=t}
        cexc = cinc - lw                                   # sum_{tau<t}
        ctot = cinc[:, :, -1:]                             # (B,nc,1,H,dh)
        c_mid = cinc[:, :, chunk // 2][:, :, None]         # (B,nc,1,H,dh)
        r_t = rf * torch.exp(cexc - c_mid)
        k_t = kf * torch.exp(c_mid - cinc)
        att = torch.einsum("bcthd,bcihd->bchti", r_t, k_t)
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=r.device), diagonal=-1)
        att = torch.where(tri, att, 0.0)
        intra = torch.einsum("bchti,bcihd->bcthd", att, vf)
        diag = torch.einsum("bcthd,bcthd->bcth", rf, u * kf)
        k_dec = kf * torch.exp(ctot - cinc)                # exp <= 1
        upd = torch.einsum("bcihd,bcihe->bchde", k_dec, vf)
        decay = torch.exp(ctot[:, :, 0])[..., None]        # (B,nc,H,dh,1)
        s = s0.float()
        entering = []
        # unbind, not a slice a chunk: see rwkv6_scan.
        for dc, uc in zip(decay.unbind(1), upd.unbind(1)):
            entering.append(s)
            s = dc * s + uc
        inter = torch.einsum("bcthi,bchij->bcthj", rf * torch.exp(cexc),
                             torch.stack(entering, dim=1))
        out = inter + intra + diag[..., None] * vf
        return out.reshape(B, S, H, dh), s


def _group_norm(x: torch.Tensor, w: torch.Tensor, dh: int) -> torch.Tensor:
    """Per-head RMS normalization of the time-mix output, in f32 (times
    w, the product f32)."""
    B, S, d = x.shape
    xh = x.reshape(B, S, d // dh, dh).float()
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-5)
    return xh.reshape(B, S, d) * w


def rwkv6_time_mix(p, x: torch.Tensor, state, cfg, ctx: DistCtx = None):
    """x: (B, S, d); state {"s": (B, H, dh, dh), "shift": (B, d)}.
    Returns (out (B, S, d), {"s", "shift"}). Under a tensor-parallel
    ``ctx`` (:func:`time_mix_heads`) x is replicated over ``tp``, ``s``
    holds this rank's heads and ``out`` is this rank's partial
    product."""
    B, S, _ = x.shape
    dh = cfg.ssm.head_dim
    heads = time_mix_heads(cfg, ctx)
    p = _use(p, cfg, ctx, "tm", time_mix_shapes(cfg), heads is not None)
    if heads is not None:      # this rank's channels of the whole w0, ln_x
        c = slice(heads[0] * dh, heads[1] * dh)
        p = dict(p, w0=p["w0"][c], ln_x=p["ln_x"][c])
    r, k, v, gate, logw, last = _time_mix_inputs(p, x, state["shift"], cfg)
    u = p["u"].float()
    if S % cfg.ssm_chunk == 0 and S > 1:
        o, s = rwkv6_chunked(r, k, v, logw, u, state["s"], cfg.ssm_chunk)
    else:
        o, s = rwkv6_scan(r, k, v, logw, u, state["s"])
    o = _group_norm(o.reshape(B, S, -1).to(x.dtype), p["ln_x"], dh)
    o = (o.to(x.dtype) * gate) @ p["wo"]
    return o, {"s": s, "shift": last}


def rwkv_channel_mix(p, x: torch.Tensor, shift_state: torch.Tensor, cfg,
                     ctx: DistCtx = None):
    """Returns (out (B, S, d), x's last token); under a tensor-parallel
    ``ctx`` (:func:`channel_mix_local`) x is replicated over ``tp`` and
    ``out`` is this rank's partial product."""
    p = _use(p, cfg, ctx, "cm", channel_mix_shapes(cfg),
             channel_mix_local(cfg, ctx))
    xp = _token_shift(x, shift_state)
    xk = x * p["mu"] + xp * (1.0 - p["mu"])
    h = torch.square(torch.relu(xk @ p["wk"]))
    return h @ p["wv"], x[:, -1, :]


def init_rwkv_state(B: int, cfg, dtype, layers: int, device=None,
                    ctx: DistCtx = None):
    """Zero states; under a tensor-parallel ``ctx`` ``s`` holds this
    rank's heads (:func:`time_mix_heads`)."""
    d = cfg.d_model
    dh = cfg.ssm.head_dim
    heads = time_mix_heads(cfg, ctx)
    H = d // dh if heads is None else heads[1] - heads[0]
    return {"s": torch.zeros((layers, B, H, dh, dh), dtype=torch.float32,
                             device=device),
            "shift": torch.zeros((layers, B, d), dtype=dtype, device=device),
            "shift2": torch.zeros((layers, B, d), dtype=dtype,
                                  device=device)}
