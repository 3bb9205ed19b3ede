"""The latent-space ingestion encoder of the serve plane (counterpart of
``repro/models/encoder.py``, DESIGN.md §17).

Devices that hold raw token or patch sequences, not latent points,
submit each point as a ``(seq, d)`` sequence of precomputed token
embeddings; the encoder maps it to one ``(d,)`` embedding, and the
unchanged solve and attach cluster the embeddings.

  * ``resolve_encoder_spec`` maps a plan's ``encoder`` name to an
    :class:`EncoderSpec`: a registered config name
    (``configs.list_archs()``) contributes its REDUCED variant's
    activation, FFN expansion ratio, head counts and depth (at most 2
    layers), re-dimensioned to the plan's feature width ``d``.
  * ``init_encoder`` builds one parameter set from one
    ``torch.Generator``: the layers stacked on a leading axis (leaves
    ``(n_layers, ...)``) plus ``norm_f``, the tree a schema v6 archive
    stores.
  * ``apply_encoder`` runs every item's sequence through ``n_layers``
    pre-norm blocks (non-causal masked self-attention, then the FFN
    block), a final RMSNorm, and a masked mean over the valid tokens.
    An item with no valid token embeds to exactly zero.

Precision (the §13 contract): every product accumulates in f32 with an
f32 result. With ``encode_dtype="bf16"`` the input, the parameters and
the activations fed to each product are stored in bfloat16, and the
operands are upcast before the product (a bf16 ``torch.matmul`` would
round its output to bf16); the product of two bf16 values is exact in
f32. The residual stream is f32. Every cast sits where the reference
has one. The products are ``torch.matmul`` in full f32 (the package
turns TF32 off at import): the reference computes them outside any
kernel too.

The encoder always uses RMSNorm, whatever the config's own ``norm``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, list_archs
from repro_torch.models.attention import init_gqa, plain_attention
from repro_torch.models.common import init_norm, rms_norm, tree_map
from repro_torch.models.ffn import init_ffn
from repro_torch.models.heads import _AttnDims, _stack

__all__ = ["ENCODE_DTYPES", "EncoderConfigError", "EncoderSpec",
           "apply_encoder", "encoder_param_count", "init_encoder",
           "resolve_encoder_spec"]

ENCODE_DTYPES = ("f32", "bf16")

Params = Dict[str, object]  # {"layers": {...(n_layers, ...)}, "norm_f"}


class EncoderConfigError(ValueError):
    """An encoder selection failed validation (named, with the accepted
    values)."""


class EncoderSpec(NamedTuple):
    """Static shape and flavor of the ingestion encoder."""
    name: str           # a registered configs name
    d: int              # feature width (the plan's d; also the token width)
    d_ff: int           # FFN hidden width (ratio-scaled from the config)
    activation: str     # swiglu | gelu | relu2
    n_layers: int       # stacked pre-norm blocks (the REDUCED depth, <= 2)
    n_heads: int
    n_kv_heads: int


def resolve_encoder_spec(name: str, d: int) -> EncoderSpec:
    """Validate and resolve a plan's ``encoder`` selection. Raises
    :class:`EncoderConfigError` naming the accepted values."""
    try:
        cfg = get_config(name, reduced=True)
    except KeyError:
        raise EncoderConfigError(
            f"encoder={name!r} is invalid: accepted values are 'off' or "
            f"a registered model config {list_archs()}") from None
    # Re-dimension the REDUCED config to the clustering feature width:
    # keep its FFN expansion ratio, activation, head counts and depth,
    # floor d_ff at d.
    d_ff = max(int(d), int(round(d * cfg.d_ff / cfg.d_model)))
    n_heads, n_kv = int(cfg.n_heads), int(cfg.n_kv_heads)
    if d % n_heads:
        raise EncoderConfigError(
            f"encoder={name!r} is invalid for d={d}: the config's "
            f"n_heads={n_heads} must divide the plan's feature "
            f"dimension (pick a different config or d)")
    n_layers = max(1, min(2, int(cfg.n_layers)))
    return EncoderSpec(str(name), int(d), d_ff, str(cfg.activation),
                       n_layers, n_heads, n_kv)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, spec: EncoderSpec, dtype) -> Params:
    return {"norm1": init_norm("rmsnorm", spec.d, dtype),
            "attn": init_gqa(gen, _AttnDims(
                d_model=spec.d, n_heads=spec.n_heads,
                n_kv_heads=spec.n_kv_heads, hd=spec.d // spec.n_heads,
                qkv_bias=False), dtype),
            "norm2": init_norm("rmsnorm", spec.d, dtype),
            "ffn": init_ffn(gen, spec.d, spec.d_ff, spec.activation, dtype)}


def init_encoder(gen: torch.Generator, spec: EncoderSpec,
                 dtype=torch.float32, device="cuda") -> Params:
    """The encoder's parameters drawn in turn from ``gen`` (a CPU
    generator): ``n_layers`` blocks stacked on a leading layer axis plus
    the final norm, on ``device`` (the card unless the caller asks for
    the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_encoder places the encoder on CUDA, but "
            "torch.cuda.is_available() is False: pass device='cpu' to "
            "keep it on the CPU")
    params = {"layers": _stack([_init_layer(gen, spec, dtype)
                                for _ in range(spec.n_layers)]),
              "norm_f": init_norm("rmsnorm", spec.d, dtype)}
    return tree_map(lambda a: a.to(device), params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., m) @ w (m, n) -> (..., n) f32: f32 operands and
    accumulation, whatever the storage dtype."""
    return torch.matmul(x.float(), w.float())


def _ffn_apply(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (..., d) storage dtype; returns (..., d) f32."""
    if activation == "swiglu":
        h = F.silu(_dot(x, p["w1"])) * _dot(x, p["w3"])
        return _dot(h.to(x.dtype), p["w2"])
    h = _dot(x, p["w1"]) + p["b1"].float()
    h = (torch.square(torch.relu(h)) if activation == "relu2"
         else F.gelu(h, approximate="tanh"))  # jax.nn.gelu's default
    return _dot(h.to(x.dtype), p["w2"]) + p["b2"].float()


def _attn_apply(p: Params, x: torch.Tensor, tmask: torch.Tensor,
                spec: EncoderSpec) -> torch.Tensor:
    """Non-causal masked self-attention over each item's token sequence.
    x: (R, S, d) storage dtype; tmask: (R, S) bool. Returns (R, S, d)
    f32."""
    R, S, d = x.shape
    H, KVH, hd = spec.n_heads, spec.n_kv_heads, d // spec.n_heads
    q = _dot(x, p["wq"]).reshape(R, S, H, hd).to(x.dtype)
    kk = _dot(x, p["wk"]).reshape(R, S, KVH, hd).to(x.dtype)
    v = _dot(x, p["wv"]).reshape(R, S, KVH, hd).to(x.dtype)
    o = plain_attention(q, kk, v, kv_mask=tmask)
    return _dot(o.reshape(R, S, H * hd), p["wo"])


def _block_fwd(p: Params, h: torch.Tensor, tmask: torch.Tensor,
               spec: EncoderSpec, store) -> torch.Tensor:
    """One pre-norm block (attention, then FFN, each residual). h:
    (R, S, d) f32; returns (R, S, d) f32."""
    a = rms_norm(h, p["norm1"]["w"].float()).to(store)
    h = h + _attn_apply(p["attn"], a, tmask, spec)
    f = rms_norm(h, p["norm2"]["w"].float()).to(store)
    return h + _ffn_apply(p["ffn"], f, spec.activation)


def apply_encoder(params: Params, x: torch.Tensor, tmask: torch.Tensor,
                  spec: EncoderSpec, encode_dtype: str = "f32"
                  ) -> torch.Tensor:
    """Encode raw token or patch sequences into latent points.

    ``x``: (..., S, d) float token embeddings; ``tmask``: (..., S) bool
    token validity (ragged lengths padded to ``S``). Returns (..., d)
    f32: the masked mean of the final-norm token states over each item's
    valid tokens, exactly zero for an item with none (so the serve
    step's point mask stays the one source of validity).
    ``encode_dtype``: "f32", or "bf16" storage with f32 accumulation."""
    store = torch.bfloat16 if encode_dtype == "bf16" else torch.float32
    lead = tuple(x.shape[:-2])
    S, d = x.shape[-2], x.shape[-1]
    # The input is rounded to the storage dtype before the f32 residual
    # stream takes it, as in the reference.
    xr = x.reshape(-1, S, d).to(store)
    mr = tmask.reshape(-1, S)
    ps = tree_map(lambda a: a.to(store), params)
    h = xr.float()
    for i in range(spec.n_layers):
        layer = tree_map(lambda a: a[i], ps["layers"])
        h = _block_fwd(layer, h, mr, spec, store)
    h = rms_norm(h, ps["norm_f"]["w"].float())
    mf = mr.float()
    tot = torch.clamp_min(torch.sum(mf, dim=-1, keepdim=True), 1.0)
    pooled = torch.einsum("rsd,rs->rd", h, mf) / tot
    pooled = torch.where(mr.any(dim=-1, keepdim=True), pooled,
                         torch.zeros_like(pooled))
    return pooled.reshape(lead + (d,))


def encoder_param_count(spec: EncoderSpec) -> int:
    """The encoder's parameter count (stats)."""
    d, ff, hd = spec.d, spec.d_ff, spec.d // spec.n_heads
    per = 2 * d                                    # norm1 + norm2
    per += (3 * d * ff if spec.activation == "swiglu"
            else 2 * d * ff + ff + d)
    per += d * spec.n_heads * hd + 2 * d * spec.n_kv_heads * hd \
        + spec.n_heads * hd * d
    return spec.n_layers * per + d                 # + final norm
