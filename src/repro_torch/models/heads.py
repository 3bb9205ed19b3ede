"""Per-cluster personalization heads for routed serving (counterpart of
``repro/models/heads.py``, DESIGN.md §16).

  * ``resolve_head_spec`` maps a plan's ``heads`` name to a
    :class:`HeadSpec`: ``"linear"`` is the reserved affine head; any
    registered config name (``configs.list_archs()``) contributes its
    REDUCED variant's activation, FFN expansion ratio and head counts,
    re-dimensioned to the plan's feature width ``d``.
  * ``init_heads`` builds ``k`` independent parameter sets, stacked on a
    leading cluster axis (leaf shapes ``(k, ...)``), from one
    ``torch.Generator``.
  * ``apply_heads`` runs every cluster's queue through ITS head: the
    JAX package's ``vmap`` over the stacked sets is the leading batch
    dimension of every product here. Per-point forward, then a masked
    mean-pool to one (d,) prediction per request.

Precision: every product accumulates in f32. With
``serve_dtype="bf16"`` the operands are stored in bfloat16 and upcast
to f32 before each product (a bf16 ``torch.matmul`` would round its
output to bf16); the product of two bf16 values is exact in f32, so
this is the reference's ``preferred_element_type=f32``. Every cast back
to the storage dtype sits where the reference has one. The head
products are plain matmuls outside any kernel, in full f32 (the
package turns TF32 off at import).

Architectures: ``"ffn"`` (pre-norm residual FFN block with the config's
activation) and ``"transformer"`` (non-causal masked self-attention
over the request's point set, then the FFN block).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, list_archs
from repro_torch.models.attention import init_gqa, plain_attention
from repro_torch.models.common import (dense_init, init_norm, rms_norm,
                                       tree_map)
from repro_torch.models.ffn import init_ffn

__all__ = ["HEAD_ARCHS", "HeadConfigError", "HeadSpec", "apply_heads",
           "head_param_count", "init_heads", "resolve_head_spec",
           "tree_map"]

HEAD_ARCHS = ("ffn", "transformer")

# The reserved non-zoo head: one affine map.
LINEAR = "linear"

Params = Dict[str, object]  # nested dicts of (k, ...) tensors


class HeadConfigError(ValueError):
    """A heads/head_arch selection failed validation (named, with the
    accepted values)."""


class HeadSpec(NamedTuple):
    """Static shape and flavor of one per-cluster head."""
    name: str           # "linear" | a registered configs name
    arch: str           # "ffn" | "transformer" (ignored for linear)
    d: int              # feature width (the plan's d)
    d_ff: int           # FFN hidden width (ratio-scaled from the config)
    activation: str     # swiglu | gelu | relu2
    n_heads: int        # transformer arch only
    n_kv_heads: int     # transformer arch only


class _AttnDims(NamedTuple):
    """The config ``models.attention.init_gqa`` reads."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    hd: int
    qkv_bias: bool


def resolve_head_spec(name: str, arch: str, d: int) -> HeadSpec:
    """Validate and resolve a plan's ``heads``/``head_arch`` selection.
    Raises :class:`HeadConfigError` naming the accepted values."""
    if arch not in HEAD_ARCHS:
        raise HeadConfigError(
            f"head_arch={arch!r} is invalid: accepted values are "
            f"{list(HEAD_ARCHS)}")
    if name == LINEAR:
        return HeadSpec(LINEAR, arch, int(d), int(d), "gelu", 1, 1)
    try:
        cfg = get_config(name, reduced=True)
    except KeyError:
        raise HeadConfigError(
            f"heads={name!r} is invalid: accepted values are 'off', "
            f"'{LINEAR}', or a registered model config "
            f"{list_archs()}") from None
    # Re-dimension the REDUCED config to the clustering feature width:
    # keep its FFN expansion ratio and activation, floor d_ff at d.
    d_ff = max(int(d), int(round(d * cfg.d_ff / cfg.d_model)))
    n_heads, n_kv = int(cfg.n_heads), int(cfg.n_kv_heads)
    if arch == "transformer" and d % n_heads:
        raise HeadConfigError(
            f"heads={name!r} with head_arch='transformer' is invalid "
            f"for d={d}: the config's n_heads={n_heads} must divide "
            f"the plan's feature dimension (pick a different config "
            f"or head_arch='ffn')")
    return HeadSpec(name, arch, int(d), d_ff, str(cfg.activation),
                    n_heads, n_kv)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_one(gen: torch.Generator, spec: HeadSpec, dtype) -> Params:
    if spec.name == LINEAR:
        return {"w": dense_init(gen, (spec.d, spec.d), dtype),
                "b": torch.zeros((spec.d,), dtype=dtype)}
    p = {"norm1": init_norm("rmsnorm", spec.d, dtype),
         "ffn": init_ffn(gen, spec.d, spec.d_ff, spec.activation, dtype)}
    if spec.arch == "transformer":
        p["norm2"] = init_norm("rmsnorm", spec.d, dtype)
        p["attn"] = init_gqa(gen, _AttnDims(
            d_model=spec.d, n_heads=spec.n_heads,
            n_kv_heads=spec.n_kv_heads, hd=spec.d // spec.n_heads,
            qkv_bias=False), dtype)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def init_heads(gen: torch.Generator, k: int, spec: HeadSpec,
               dtype=torch.float32, device="cuda") -> Params:
    """``k`` independent heads drawn in turn from ``gen`` (a CPU
    generator), stacked on a leading cluster axis, on ``device`` (the
    card unless the caller asks for the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_heads places the heads on CUDA, but "
            "torch.cuda.is_available() is False: pass device='cpu' to "
            "keep them on the CPU")
    params = _stack([_init_one(gen, spec, dtype) for _ in range(k)])
    return tree_map(lambda a: a.to(device), params)


# ---------------------------------------------------------------------------
# forward; every tensor carries the leading cluster axis k
# ---------------------------------------------------------------------------


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-cluster product over x's last axis: x (k, ..., m), w
    (k, m, n) -> (k, ..., n) f32, f32 operands and accumulation."""
    k, m = x.shape[0], x.shape[-1]
    y = torch.matmul(x.reshape(k, -1, m).float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _per_cluster(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (k, n) per-cluster vector in f32, broadcastable against a
    (k, ..., n) activation of ``ndim`` dimensions."""
    return v.float().reshape(v.shape[0], *([1] * (ndim - 2)), v.shape[-1])


def _ffn_apply(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (k, ..., d) storage dtype; returns (k, ..., d) f32."""
    if activation == "swiglu":
        h = F.silu(_dot(x, p["w1"])) * _dot(x, p["w3"])
        return _dot(h.to(x.dtype), p["w2"])
    h = _dot(x, p["w1"]) + _per_cluster(p["b1"], x.dim())
    h = (torch.square(torch.relu(h)) if activation == "relu2"
         else F.gelu(h, approximate="tanh"))  # jax.nn.gelu's default
    return _dot(h.to(x.dtype), p["w2"]) + _per_cluster(p["b2"], x.dim())


def _attn_apply(p: Params, x: torch.Tensor, pmask: torch.Tensor,
                spec: HeadSpec) -> torch.Tensor:
    """Non-causal masked self-attention over each request's point set.
    x: (k, C, n, d) storage dtype; pmask: (k, C, n) bool. Returns
    (k, C, n, d) f32."""
    k, C, n, d = x.shape
    H, KVH, hd = spec.n_heads, spec.n_kv_heads, d // spec.n_heads
    q = _dot(x, p["wq"]).reshape(k * C, n, H, hd).to(x.dtype)
    kk = _dot(x, p["wk"]).reshape(k * C, n, KVH, hd).to(x.dtype)
    v = _dot(x, p["wv"]).reshape(k * C, n, KVH, hd).to(x.dtype)
    o = plain_attention(q, kk, v, kv_mask=pmask.reshape(k * C, n))
    return _dot(o.reshape(k, C, n, H * hd), p["wo"])


def _head_fwd(p: Params, x: torch.Tensor, pmask: torch.Tensor,
              spec: HeadSpec) -> torch.Tensor:
    """Every cluster's per-point forward. x: (k, C, n, d) storage
    dtype; returns (k, C, n, d) f32 features."""
    if spec.name == LINEAR:
        return _dot(x, p["w"]) + _per_cluster(p["b"], x.dim())
    store = x.dtype
    h = x.float()
    if spec.arch == "transformer":
        a = rms_norm(h, _per_cluster(p["norm2"]["w"], h.dim())).to(store)
        h = h + _attn_apply(p["attn"], a, pmask, spec)
    f = rms_norm(h, _per_cluster(p["norm1"]["w"], h.dim())).to(store)
    return h + _ffn_apply(p["ffn"], f, spec.activation)


def apply_heads(params: Params, qdata: torch.Tensor, qmask: torch.Tensor,
                spec: HeadSpec, serve_dtype: str = "f32") -> torch.Tensor:
    """Run every cluster queue through its own head and pool.

    ``params``: ``init_heads`` layout (leading cluster axis k);
    ``qdata``: (k, C, n, d) f32 per-cluster request queues; ``qmask``:
    (k, C, n) bool point validity (all-False rows are empty or overflow
    slots). Returns (k, C, d) f32 pooled predictions, exactly zero for
    empty slots. ``serve_dtype``: "f32", or "bf16" storage with f32
    accumulation."""
    store = torch.bfloat16 if serve_dtype == "bf16" else torch.float32
    ps = tree_map(lambda a: a.to(store), params)
    y = _head_fwd(ps, qdata.to(store), qmask, spec)      # (k, C, n, d) f32
    mf = qmask.float()
    tot = torch.clamp_min(torch.sum(mf, dim=-1, keepdim=True), 1.0)
    return torch.einsum("kcnd,kcn->kcd", y, mf) / tot


def head_param_count(spec: HeadSpec) -> int:
    """Parameter count of one head."""
    d, ff = spec.d, spec.d_ff
    if spec.name == LINEAR:
        return d * d + d
    n = d  # norm1
    n += (3 * d * ff if spec.activation == "swiglu"
          else 2 * d * ff + ff + d)
    if spec.arch == "transformer":
        hd = d // spec.n_heads
        n += d + d * spec.n_heads * hd + 2 * d * spec.n_kv_heads * hd \
            + spec.n_heads * hd * d
    return n
