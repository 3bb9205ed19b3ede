"""Model assembly and the serving API (counterpart of
``repro/models/model.py``): ``build_model(cfg)`` -> ``Model`` with
``init``, ``loss``, ``prefill``, ``init_cache`` and ``serve_step``, for
every family of ``configs/``: dense and moe with GQA or MLA attention
(with DeepSeek-V3's multi-token-prediction (MTP) head in the loss), ssm
(RWKV-6), hybrid (Zamba2: groups of Mamba2 layers, the weight-tied
shared attention block after each group), encdec (Whisper: a
non-causal encoder over precomputed frame embeddings, a decoder with
cross-attention over its output) and vlm (InternVL2: projected patch
embeddings in front of the text tokens).

Inputs (a batch dict): ``tokens`` (B, S) int, and for training
``labels`` of the same shape (-1 masked); the encdec family adds
``enc_embeds`` (B, n_ctx, d), the vlm family ``patch_embeds`` (B, P, d),
P = ``encoder.n_prefix``, whose positions come first and take no loss.

Parameters are the reference's pytree as nested dicts of tensors
(``embed``, ``final_norm``, ``segments`` (a tuple, one dict of stacked
layers per segment), ``unembed`` unless the embeddings are tied, with
``cfg.mtp`` ``mtp_proj``, ``mtp_block`` (one layer, not stacked) and
``mtp_norm``, for the hybrid family ``shared_block`` (one layer, not
stacked), for the encdec family ``enc_segments`` (a one-tuple of the
encoder's stacked layers) and ``enc_norm``, and for the vlm family
``vis_proj`` (d, d)), so ``convert.model_params`` carries the JAX
package's parameters across one to one. The decode cache is
``{"len": (B,) int32, "segments": [...]}`` with, per segment, one dict
of layer-stacked k / v (and ring ``pos``), for MLA latent / rope, or for
a rwkv or mamba segment its layer-stacked state; a cross segment's adds
the encoder's keys and values ``ck`` / ``cv`` (L, B, Se, KVH, hd) and
``cvalid`` (L, B, Se); the hybrid family adds ``"shared"``, one
{"k", "v"} of (1, B, room, KVH, hd) per group. ``serve_step`` updates it
in place and returns it with ``len + 1``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models.common import (DistCtx, apply_norm, cross_entropy,
                                       dense_init, init_norm)
from repro_torch.models.transformer import (SegmentSpec, block_decode,
                                            block_seq, cross_keys,
                                            init_layer, init_segment,
                                            plan_segments, run_segment,
                                            run_segment_decode,
                                            unbind_layers)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

# The MTP block and the hybrid family's shared block: one attn_ffn layer
# with a dense FFN.
_BLOCK_SPEC = SegmentSpec("attn_ffn", 1)


class Model:
    def __init__(self, cfg):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                             f"the port serves {list(PORTED_FAMILIES)}")
        if cfg.attn not in ("gqa", "mla") and not (
                cfg.attn == "none" and cfg.family == "ssm"):
            raise ValueError(f"{cfg.name}: unknown attention {cfg.attn!r}; "
                             f"the port has GQA and MLA, and no attention "
                             f"in the ssm family")
        self.cfg = cfg
        self.segments = plan_segments(cfg)
        self.dtype = _DTYPES[cfg.dtype]
        # Decode steps the prefill cache makes room for (generate sets it).
        self.decode_room = 1

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator,
             ctx: DistCtx = None) -> Dict[str, Any]:
        """Parameters drawn from ``gen`` on its device (a CUDA generator
        draws a full-width model on the card). Under a mesh ``ctx`` each
        MoE layer keeps only this rank's part of its experts, cut as it
        is drawn (``models/moe.expert_part``); the generator advances
        as for the whole model, so every rank's parts are those of one
        uncut draw."""
        cfg, dtype = self.cfg, self.dtype
        p: Dict[str, Any] = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
            "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
            "segments": tuple(init_segment(gen, cfg, spec, dtype, ctx)
                              for spec in self.segments),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                      dtype)
        if cfg.family == "hybrid":
            p["shared_block"] = init_layer(gen, cfg, _BLOCK_SPEC, dtype)
        if cfg.family == "encdec":
            p["enc_segments"] = (init_segment(gen, cfg, self._enc_spec(),
                                              dtype),)
            p["enc_norm"] = init_norm(cfg.norm, cfg.d_model, dtype,
                                      gen.device)
        if cfg.family == "vlm":
            p["vis_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                       dtype)
        if cfg.mtp:
            p["mtp_proj"] = dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                       dtype)
            p["mtp_block"] = init_layer(gen, cfg, _BLOCK_SPEC, dtype)
            p["mtp_norm"] = init_norm(cfg.norm, cfg.d_model, dtype,
                                      gen.device)
        return p

    # ------------------------------------------------------- common bits --
    def _unembed(self, p, x: torch.Tensor, ctx: DistCtx = None):
        w = p["embed"].T if self.cfg.tie_embeddings else p["unembed"]
        return x @ w

    def _enc_spec(self) -> SegmentSpec:
        """The encdec family's encoder: one non-causal segment."""
        return SegmentSpec("attn_ffn", self.cfg.encoder.n_layers,
                           causal=False)

    def _encode(self, p, batch, ctx: DistCtx):
        """The encdec family's encoder over ``batch["enc_embeds"]``
        (B, Se, d), cast to the model's dtype, then ``enc_norm``; None
        for the other families."""
        cfg = self.cfg
        if cfg.family != "encdec":
            return None
        x, _, _, _ = run_segment(p["enc_segments"][0],
                                 batch["enc_embeds"].to(self.dtype), cfg, ctx,
                                 self._enc_spec())
        return apply_norm(cfg.norm, p["enc_norm"], x)

    def _backbone(self, p, x: torch.Tensor, ctx: DistCtx, *,
                  enc_out=None, want_cache: bool = False):
        """All segments, each from fresh (zero) states, a cross segment's
        layers attending over ``enc_out``, the hybrid family's shared
        block after each (not recomputed under ``cfg.remat``, as in the
        reference), then the final norm. Returns (x, aux, new states,
        caches, the shared block's caches)."""
        cfg = self.cfg
        states = self._fresh_states(x.shape[0], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_states, caches, shared_caches = [], [], []
        for i, spec in enumerate(self.segments):
            x, a, ns, cache = run_segment(p["segments"][i], x, cfg, ctx,
                                          spec, state=states[i],
                                          enc_out=enc_out,
                                          want_cache=want_cache)
            aux = aux + a
            new_states.append(ns)
            caches.append(cache)
            if cfg.family == "hybrid":
                x, a2, _, scache = block_seq(p["shared_block"], x, cfg, ctx,
                                             _BLOCK_SPEC,
                                             want_cache=want_cache)
                aux = aux + a2
                shared_caches.append(scache)
        x = apply_norm(cfg.norm, p["final_norm"], x)
        return x, aux, new_states, caches, shared_caches

    def _fresh_states(self, B: int, device=None) -> List[Any]:
        """Zero states of every rwkv and mamba segment (None for the
        others), stacked on the layer axis."""
        cfg, states = self.cfg, []
        for spec in self.segments:
            if spec.kind == "rwkv":
                s = R.init_rwkv_state(B, cfg, self.dtype, spec.n_layers,
                                      device)
            elif spec.kind == "mamba":
                s = M.init_mamba_state(B, cfg, self.dtype, spec.n_layers,
                                       device)
            else:
                s = None
            states.append(s)
        return states

    def _embed_inputs(self, p, batch, ctx: DistCtx = None):
        """Token embedding; for the vlm family the patch embeddings, cast
        to the model's dtype and projected by ``vis_proj``, in front.
        Returns (x, label_offset): the number of leading positions that
        are not text (P, or 0)."""
        tok = p["embed"][batch["tokens"].long()]
        if self.cfg.family == "vlm":
            vis = batch["patch_embeds"].to(self.dtype) @ p["vis_proj"]
            return torch.cat([vis, tok], dim=1), vis.shape[1]
        return tok, 0

    # -------------------------------------------------------------- loss --
    def loss(self, p, batch, ctx: DistCtx = None):
        """Next-token cross-entropy plus the MoE load-balance loss, and
        with ``cfg.mtp`` 0.3 times the MTP head's cross-entropy, for
        training: ``batch["tokens"]`` (B, S) and ``batch["labels"]``
        (B, S), -1 masked, with the family's ``enc_embeds`` or
        ``patch_embeds`` (the loss is taken on the text positions only).
        Returns (total, {"ce", "aux"} and "mtp_ce" with the head), f32
        scalars."""
        ctx = ctx or DistCtx.local()
        x, n_prefix = self._embed_inputs(p, batch, ctx)
        h, aux, _, _, _ = self._backbone(p, x, ctx,
                                         enc_out=self._encode(p, batch, ctx))
        h_text = h[:, n_prefix:]
        logits = self._unembed(p, h_text, ctx)
        labels = batch["labels"].long()
        ce = cross_entropy(logits, torch.clamp_min(labels, 0), labels >= 0)
        metrics = {"ce": ce, "aux": aux}
        total = ce + aux
        if self.cfg.mtp:
            mtp_ce = self._mtp_loss(p, h_text, batch, ctx)
            metrics["mtp_ce"] = mtp_ce
            total = total + 0.3 * mtp_ce
        return total, metrics

    def _mtp_loss(self, p, h: torch.Tensor, batch, ctx: DistCtx):
        """DeepSeek-V3's multi-token prediction: one more layer predicts
        token t+2 from [h_t ; embed(token_{t+1})] (the tokens and labels
        rolled left by one, the last position masked). With
        ``cfg.remat`` and gradients on, the layer is recomputed in the
        backward, as the segments' layers are (the same values)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"].long(), batch["labels"].long()
        nxt = p["embed"][torch.roll(tokens, -1, dims=1)]
        z = torch.cat([h, nxt], dim=-1) @ p["mtp_proj"]
        if cfg.remat and torch.is_grad_enabled():
            z, _, _, _ = torch.utils.checkpoint.checkpoint(
                block_seq, p["mtp_block"], z, cfg, ctx, _BLOCK_SPEC,
                use_reentrant=False)
        else:
            z, _, _, _ = block_seq(p["mtp_block"], z, cfg, ctx, _BLOCK_SPEC)
        z = apply_norm(cfg.norm, p["mtp_norm"], z)
        logits = self._unembed(p, z, ctx)
        lbl2 = torch.roll(labels, -1, dims=1)
        S = lbl2.shape[1]
        mask = (lbl2 >= 0) & (torch.arange(S, device=lbl2.device)
                              < S - 1)[None, :]
        return cross_entropy(logits, torch.clamp_min(lbl2, 0), mask)

    # ----------------------------------------------------------- prefill --
    def prefill(self, p, batch, ctx: DistCtx = None):
        """Full forward over ``batch["tokens"]`` (B, S) (after the vlm
        family's patches; the encdec family's decoder over the encoded
        ``enc_embeds``) from fresh states, building the decode cache.
        Returns (last-token logits (B, V), cache)."""
        ctx = ctx or DistCtx.local()
        x, _ = self._embed_inputs(p, batch, ctx)
        enc_out = self._encode(p, batch, ctx)
        h, _, new_states, caches, shared_caches = self._backbone(
            p, x, ctx, enc_out=enc_out, want_cache=True)
        logits = self._unembed(p, h[:, -1, :], ctx)
        return logits, self._pack_cache(p, caches, new_states, shared_caches,
                                        enc_out, x.shape[0], x.shape[1],
                                        x.device)

    def _pack_cache(self, p, caches: List[Any], new_states: List[Any],
                    shared_caches: List[Dict[str, torch.Tensor]], enc_out,
                    B: int, S: int, dev):
        """Prefill caches -> the decode layout. A rwkv or mamba
        segment's final state goes in as it stands (stacked: no view of
        an activation). A sliding-window model whose room exceeds its
        window gets a ring of W slots holding the last W positions at
        ring indices 0..W-1, as the reference lays it out
        (``repro/models/model.py`` ``_pack_cache``); otherwise the full
        cache (or MLA's latent cache) is padded to the room, a cross
        segment's with the encoder's keys and values (``_cross_cache``),
        and the hybrid family's shared-block caches likewise, each as
        (1, B, room, KVH, hd)."""
        cfg = self.cfg
        out = {"len": torch.full((B,), S, dtype=torch.int32, device=dev),
               "segments": []}
        room = S + self.decode_room
        for spec, cache, st in zip(self.segments, caches, new_states):
            if spec.kind in ("rwkv", "mamba"):
                entry = st
            elif cfg.attn == "mla":
                entry = {name: torch.nn.functional.pad(
                    cache[name], (0, 0, 0, room - S))
                    for name in ("latent", "rope")}
            elif cfg.sliding_window and room > cfg.sliding_window:
                W = cfg.sliding_window
                k = cache["k"][:, :, -W:].contiguous()
                v = cache["v"][:, :, -W:].contiguous()
                pos = torch.arange(S - W, S, dtype=torch.int32, device=dev)
                entry = {"k": k, "v": v,
                         "pos": torch.broadcast_to(
                             pos[None, None, :],
                             (k.shape[0], B, W)).contiguous()}
            else:
                pad = room - S
                entry = {name: torch.nn.functional.pad(
                    cache[name], (0, 0, 0, 0, 0, pad)) for name in ("k", "v")}
                if spec.cross:
                    entry.update(self._cross_cache(p, enc_out, spec))
            out["segments"].append(entry)
        if cfg.family == "hybrid":
            out["shared"] = [{name: torch.nn.functional.pad(
                c[name], (0, 0, 0, 0, 0, room - S))[None]
                for name in ("k", "v")} for c in shared_caches]
        return out

    def _cross_cache(self, p, enc_out: torch.Tensor, spec: SegmentSpec):
        """A cross segment's decode entries: per layer the encoder's keys
        and values, ``ck`` / ``cv`` (L, B, Se, KVH, hd), and ``cvalid``
        (L, B, Se), all True."""
        seg = p["segments"][self.segments.index(spec)]
        kv = [cross_keys(lp["xattn"], enc_out, self.cfg)
              for lp in unbind_layers(seg, spec.n_layers)]
        B, Se = enc_out.shape[0], enc_out.shape[1]
        return {"ck": torch.stack([k for k, _ in kv]),
                "cv": torch.stack([v for _, v in kv]),
                "cvalid": torch.ones((spec.n_layers, B, Se), dtype=torch.bool,
                                     device=enc_out.device)}

    # -------------------------------------------------------- init_cache --
    def init_cache(self, B: int, S: int, device=None):
        """Zeroed decode cache with room for S (+1) tokens (zero states
        for the rwkv and mamba segments; a cross segment's encoder keys
        and values zero for ``encoder.n_ctx`` frames, all valid)."""
        cfg, dtype = self.cfg, self.dtype
        room = S + 1
        out = {"len": torch.zeros((B,), dtype=torch.int32, device=device),
               "segments": []}
        for spec in self.segments:
            L = spec.n_layers
            if spec.kind == "rwkv":
                out["segments"].append(R.init_rwkv_state(B, cfg, dtype, L,
                                                         device))
                continue
            if spec.kind == "mamba":
                out["segments"].append(M.init_mamba_state(B, cfg, dtype, L,
                                                          device))
                continue
            if cfg.attn == "mla":
                c = A.init_mla_cache(B, room, cfg.mla.kv_lora_rank,
                                     cfg.mla.qk_rope_dim, dtype, L, device)
            elif cfg.sliding_window and room > cfg.sliding_window:
                c = A.init_ring_cache(B, cfg.sliding_window, cfg.n_kv_heads,
                                      cfg.hd, dtype, L, device)
            else:
                c = A.init_full_cache(B, room, cfg.n_kv_heads, cfg.hd, dtype,
                                      L, device)
                if spec.cross:
                    Se = cfg.encoder.n_ctx
                    for name in ("ck", "cv"):
                        c[name] = torch.zeros((L, B, Se, cfg.n_kv_heads,
                                               cfg.hd), dtype=dtype,
                                              device=device)
                    c["cvalid"] = torch.ones((L, B, Se), dtype=torch.bool,
                                             device=device)
            c.pop("len")
            out["segments"].append(c)
        if cfg.family == "hybrid":
            out["shared"] = [
                {name: torch.zeros((1, B, room, cfg.n_kv_heads, cfg.hd),
                                   dtype=dtype, device=device)
                 for name in ("k", "v")} for _ in self.segments]
        return out

    # --------------------------------------------------------- serve_step --
    def serve_step(self, p, cache, tokens: torch.Tensor,
                   ctx: DistCtx = None):
        """One decode step. tokens: (B,). Returns (logits (B, V), cache),
        the cache (states, KV caches and the shared block's) updated in
        place with ``len`` advanced by one (a cross segment's encoder
        keys and values kept as they are)."""
        ctx = ctx or DistCtx.local()
        cfg = self.cfg
        lengths = cache["len"]
        x1 = p["embed"][tokens.long()]
        segments = []
        for i, spec in enumerate(self.segments):
            held = cache["segments"][i]
            if spec.kind in ("rwkv", "mamba"):
                x1, ns = run_segment_decode(p["segments"][i], x1, cfg, ctx,
                                            spec, state=held,
                                            lengths=lengths)
            else:
                x1, ns = run_segment_decode(p["segments"][i], x1, cfg, ctx,
                                            spec, cache=held,
                                            lengths=lengths)
            segments.append(ns)
            if cfg.family == "hybrid":
                sc = cache["shared"][i]
                x1, _ = block_decode(p["shared_block"], x1, cfg, ctx,
                                     _BLOCK_SPEC,
                                     cache={k: v[0] for k, v in sc.items()},
                                     lengths=lengths)
        x1 = apply_norm(cfg.norm, p["final_norm"], x1)
        logits = self._unembed(p, x1, ctx)
        out = {"len": lengths + 1, "segments": segments}
        if cfg.family == "hybrid":
            out["shared"] = cache["shared"]
        return logits, out


def build_model(cfg) -> Model:
    return Model(cfg)
