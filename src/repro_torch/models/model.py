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

Under a mesh (``ctx``; ``launch/sharding.py`` lays out every family)
each leaf is this rank's parts, the batch this rank's rows where
``ctx.batch_cut`` (the entry points cut it: ``launch/serve.generate``,
``launch/train.make_train_step``), and the cache its rows, kv heads
(``k`` / ``v``, the hybrid family's shared caches, the encdec family's
``ck`` / ``cv``) and state heads (``s``, ``h``) as
``launch/sharding.cache_spec`` lays them out (where B does not divide
over ``dp``, a block of the sequence of each key, value and latent
leaf: the context-parallel cache). The embedding is a
vocab-parallel lookup where ``embed``'s vocab is cut over ``tp``: each
rank looks up the ids in its rows, the others give zeros, and the sum
over ``tp`` is the lookup (each entry is one rank's value plus zeros:
the same bits). The logits are cut on the vocab there: the loss is a
vocab-parallel cross-entropy (a max over ``tp``, then sums over ``tp``
of the exponentials and of the label's logit), its mean over the
global batch (sums over ``dp``), and ``prefill`` / ``serve_step``
gather the logits over ``tp`` for the sampler. ``vis_proj`` and
``mtp_proj`` hold their columns over ``tp``: the products are gathered
over ``tp``. Where ``cfg.seq_shard`` cuts the residual stream on the
sequence (``models/transformer.seq_parallel``; the encoder's own
sequence likewise) the embedding is reduce-scattered onto it (the vlm
family's patches and tokens cut together) and the final hidden states
gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.utils.checkpoint

from repro_torch.launch import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models.common import (DistCtx, ShapeOnly,
                                       cross_entropy, dense_init, init_norm,
                                       masked_mean, vocab_parallel_nll)
from repro_torch.models.transformer import (SegmentSpec, block_decode,
                                            block_seq, cross_keys, cross_use,
                                            init_layer, init_segment,
                                            layer_norm_of, plan_segments,
                                            run_segment, run_segment_decode,
                                            seq_parallel, unbind_layers)

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
        # The whole length of the last cache made (prefill, init_cache):
        # a rank of a context-parallel cache holds a block of it.
        self.cache_room = None

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator,
             ctx: DistCtx = None) -> Dict[str, Any]:
        """Parameters drawn from ``gen`` on its device (a CUDA generator
        draws a full-width model on the card). Under a mesh ``ctx`` each
        leaf keeps only this rank's parts, cut as it is drawn
        (``launch/sharding.leaf_parts``); the generator advances as for
        the whole model, so every rank's parts are those of one uncut
        draw."""
        cfg, dtype = self.cfg, self.dtype

        def part(name, shape):
            return SH.leaf_parts(cfg, ctx, (name,), shape)
        V, d = cfg.vocab_size, cfg.d_model
        p: Dict[str, Any] = {
            "embed": dense_init(gen, (V, d), dtype,
                                part=part("embed", (V, d))),
            "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
            "segments": tuple(init_segment(gen, cfg, spec, dtype, ctx)
                              for spec in self.segments),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(gen, (d, V), dtype,
                                      part=part("unembed", (d, V)))
        if cfg.family == "hybrid":
            p["shared_block"] = init_layer(gen, cfg, _BLOCK_SPEC, dtype, ctx)
        if cfg.family == "encdec":
            p["enc_segments"] = (init_segment(gen, cfg, self._enc_spec(),
                                              dtype, ctx),)
            p["enc_norm"] = init_norm(cfg.norm, cfg.d_model, dtype,
                                      gen.device)
        if cfg.family == "vlm":
            p["vis_proj"] = dense_init(gen, (d, d), dtype,
                                       part=part("vis_proj", (d, d)))
        if cfg.mtp:
            p["mtp_proj"] = dense_init(gen, (2 * d, d), dtype,
                                       part=part("mtp_proj", (2 * d, d)))
            p["mtp_block"] = init_layer(gen, cfg, _BLOCK_SPEC, dtype, ctx)
            p["mtp_norm"] = init_norm(cfg.norm, cfg.d_model, dtype,
                                      gen.device)
        return p

    def param_shapes(self) -> Dict[tuple, tuple]:
        """{path: whole shape} of every parameter (``launch/sharding.
        param_paths``' paths), without drawing any."""
        return SH.leaf_shapes(self.init(ShapeOnly()))

    # ------------------------------------------------------- common bits --
    def _unembed_w(self, p, ctx: DistCtx):
        """(the unembedding (d, V or this rank's vocab columns) as the
        work uses it, the first vocab id of those columns or None where
        every rank has the whole vocab)."""
        cfg = self.cfg
        V, d = cfg.vocab_size, cfg.d_model
        if cfg.tie_embeddings:
            path, shape, axis = ("embed",), (V, d), -2
        else:
            path, shape, axis = ("unembed",), (d, V), -1
        w = SH.use(p[path[0]], cfg, ctx, path, shape, keep_tp=True)
        vp = next((q for q in SH.leaf_parts(cfg, ctx, path, shape)
                   if q.axis == axis and q.axes == (ctx.tp,)), None)
        w = w.T if cfg.tie_embeddings else w
        return w, None if vp is None else vp.lo

    def _unembed(self, p, x: torch.Tensor, ctx: DistCtx = None):
        """Logits over the whole vocab (gathered over ``tp`` where it is
        cut; forward only: the serving path's)."""
        ctx = ctx or DistCtx.local()
        w, lo = self._unembed_w(p, ctx)
        logits = x @ w
        if lo is not None:
            logits = ctx.mesh.group(ctx.tp).all_gather(logits, dim=-1)
        return logits

    def _nll_mean(self, p, h: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, ctx: DistCtx):
        """The mean cross-entropy of the logits of ``h`` (B, S, d; whole
        over ``tp``) at ``labels`` over ``mask``: vocab-parallel where the
        vocab is cut over ``tp``, the mean over the global batch (the
        sums over ``dp`` where the batch is cut)."""
        w, lo = self._unembed_w(p, ctx)
        if lo is None and not ctx.batch_cut:
            return cross_entropy(h @ w, labels, mask)
        if lo is None:
            lf = (h @ w).float()
            nll = torch.logsumexp(lf, dim=-1) - torch.gather(
                lf, -1, labels.long()[..., None])[..., 0]
        else:
            g = ctx.mesh.group(ctx.tp)
            nll = vocab_parallel_nll(g.psum_grad(h) @ w, labels, lo, g)
        return masked_mean(nll, mask, ctx)

    def _embed(self, p, tokens: torch.Tensor, ctx: DistCtx,
               seq: bool = False) -> torch.Tensor:
        """The embedding of ``tokens`` (B, S) as the residual stream
        holds it: replicated over ``tp``, or this rank's rows of the
        sequence where ``seq``. A vocab cut over ``tp`` is a
        vocab-parallel lookup, summed (or reduce-scattered) over
        ``tp``."""
        cfg = self.cfg
        shape = (cfg.vocab_size, cfg.d_model)
        if ctx is None or ctx.mesh is None:
            return p["embed"][tokens.long()]
        w = SH.use(p["embed"], cfg, ctx, ("embed",), shape, keep_tp=True)
        vp = next((q for q in SH.leaf_parts(cfg, ctx, ("embed",), shape)
                   if q.axes == (ctx.tp,)), None)
        g = ctx.mesh.group(ctx.tp)
        if vp is None:
            x = w[tokens.long()]
            return g.shard_rows(x, dim=1) if seq else x
        ids = tokens.long() - vp.lo
        mine = (ids >= 0) & (ids < vp.hi - vp.lo)
        x = torch.where(mine[..., None], w[torch.where(mine, ids, 0)],
                        torch.zeros((), dtype=w.dtype, device=w.device))
        return g.reduce_scatter(x, dim=1) if seq else g.psum(x)

    def _enc_spec(self) -> SegmentSpec:
        """The encdec family's encoder: one non-causal segment."""
        return SegmentSpec("attn_ffn", self.cfg.encoder.n_layers,
                           causal=False)

    def _encode(self, p, batch, ctx: DistCtx):
        """The encdec family's encoder over ``batch["enc_embeds"]``
        (B, Se, d), cast to the model's dtype, then ``enc_norm``; None
        for the other families. The result is whole over ``tp``; the
        encoder's residual is cut on its own sequence where
        ``seq_parallel`` cuts Se."""
        cfg = self.cfg
        if cfg.family != "encdec":
            return None
        x = batch["enc_embeds"].to(self.dtype)
        seq = seq_parallel(cfg, ctx, x.shape[1])
        if seq:
            x = ctx.mesh.group(ctx.tp).shard_rows(x, dim=1)
        x, _, _, _ = run_segment(p["enc_segments"][0], x, cfg, ctx,
                                 self._enc_spec(), seq=seq)
        if seq:
            x = ctx.mesh.group(ctx.tp).all_gather(x, dim=1)
        return layer_norm_of(p, "enc_norm", x, cfg, ctx)

    def _backbone(self, p, x: torch.Tensor, ctx: DistCtx, *,
                  enc_out=None, want_cache: bool = False, seq: bool = False):
        """All segments, each from fresh (zero) states, a cross segment's
        layers attending over ``enc_out``, the hybrid family's shared
        block after each (not recomputed under ``cfg.remat``, as in the
        reference); x before the final norm (:meth:`_final`), in the
        residual's layout (``seq``: cut on the sequence over ``tp``).
        Returns (x, aux, new states, caches, the shared block's
        caches)."""
        cfg = self.cfg
        states = self._fresh_states(x.shape[0], x.device, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_states, caches, shared_caches = [], [], []
        for i, spec in enumerate(self.segments):
            x, a, ns, cache = run_segment(p["segments"][i], x, cfg, ctx,
                                          spec, state=states[i],
                                          enc_out=enc_out,
                                          want_cache=want_cache, seq=seq)
            aux = aux + a
            new_states.append(ns)
            caches.append(cache)
            if cfg.family == "hybrid":
                x, a2, _, scache = block_seq(p["shared_block"], x, cfg, ctx,
                                             _BLOCK_SPEC,
                                             want_cache=want_cache, seq=seq)
                aux = aux + a2
                shared_caches.append(scache)
        return x, aux, new_states, caches, shared_caches

    def _final(self, p, x: torch.Tensor, ctx: DistCtx) -> torch.Tensor:
        """The final norm of x (whole over ``tp``)."""
        return layer_norm_of(p, "final_norm", x, self.cfg, ctx)

    def _fresh_states(self, B: int, device=None,
                      ctx: DistCtx = None) -> List[Any]:
        """Zero states of every rwkv and mamba segment (None for the
        others), stacked on the layer axis; under a mesh the state heads
        this rank holds."""
        cfg, states = self.cfg, []
        for spec in self.segments:
            if spec.kind == "rwkv":
                s = R.init_rwkv_state(B, cfg, self.dtype, spec.n_layers,
                                      device, ctx)
            elif spec.kind == "mamba":
                s = M.init_mamba_state(B, cfg, self.dtype, spec.n_layers,
                                       device, ctx)
            else:
                s = None
            states.append(s)
        return states

    def _proj(self, p, name: str, x: torch.Tensor, ctx: DistCtx):
        """x (..., n) times the (n, d) leaf ``name`` (``vis_proj``,
        ``mtp_proj``), whole over ``tp``: where the leaf's columns are
        cut over ``tp`` each rank takes its columns of the product and
        they are gathered over ``tp``."""
        cfg = self.cfg
        shape = (x.shape[-1], cfg.d_model)
        parts = SH.leaf_parts(cfg, ctx, (name,), shape)
        local = any(q.axes == (ctx.tp,) for q in parts)
        w = SH.use(p[name], cfg, ctx, (name,), shape, keep_tp=local,
                   tp_partial=local)
        if not local:
            return x @ w
        g = ctx.mesh.group(ctx.tp)
        return g.all_gather(g.psum_grad(x) @ w, dim=-1)

    def _seq_len(self, batch) -> int:
        """The residual stream's sequence length: the tokens', after the
        vlm family's patches."""
        S = batch["tokens"].shape[1]
        if self.cfg.family == "vlm":
            S += batch["patch_embeds"].shape[1]
        return S

    def _embed_inputs(self, p, batch, ctx: DistCtx = None,
                      seq: bool = False):
        """Token embedding; for the vlm family the patch embeddings, cast
        to the model's dtype and projected by ``vis_proj``, in front.
        Returns (x, label_offset): the number of leading positions that
        are not text (P, or 0). ``seq``: x is this rank's rows of the
        sequence (:meth:`_embed`; the vlm family's patches and tokens
        cut together)."""
        if self.cfg.family != "vlm":
            return self._embed(p, batch["tokens"], ctx, seq), 0
        tok = self._embed(p, batch["tokens"], ctx)
        vis = self._proj(p, "vis_proj",
                         batch["patch_embeds"].to(self.dtype), ctx)
        x = torch.cat([vis, tok], dim=1)
        if seq:
            x = ctx.mesh.group(ctx.tp).shard_rows(x, dim=1)
        return x, vis.shape[1]

    # -------------------------------------------------------------- loss --
    def loss(self, p, batch, ctx: DistCtx = None):
        """Next-token cross-entropy plus the MoE load-balance loss, and
        with ``cfg.mtp`` 0.3 times the MTP head's cross-entropy, for
        training: ``batch["tokens"]`` (B, S) and ``batch["labels"]``
        (B, S), -1 masked, with the family's ``enc_embeds`` or
        ``patch_embeds`` (the loss is taken on the text positions only;
        under a mesh with ``ctx.batch_cut`` this rank's rows, the means
        over the global batch). Returns (total, {"ce", "aux"} and
        "mtp_ce" with the head), f32 scalars, the same on every rank."""
        ctx = ctx or DistCtx.local()
        seq = seq_parallel(self.cfg, ctx, self._seq_len(batch))
        x, n_prefix = self._embed_inputs(p, batch, ctx, seq)
        h, aux, _, _, _ = self._backbone(p, x, ctx, seq=seq,
                                         enc_out=self._encode(p, batch, ctx))
        if seq:
            h = ctx.mesh.group(ctx.tp).all_gather(h, dim=1)
        h_text = self._final(p, h, ctx)[:, n_prefix:]
        labels = batch["labels"].long()
        ce = self._nll_mean(p, h_text, torch.clamp_min(labels, 0),
                            labels >= 0, ctx)
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
        backward, as the segments' layers are (the same values). Under a
        mesh ``mtp_proj``'s output columns are cut over ``tp``: the
        projection is gathered over ``tp``."""
        cfg = self.cfg
        tokens, labels = batch["tokens"].long(), batch["labels"].long()
        nxt = self._embed(p, torch.roll(tokens, -1, dims=1), ctx)
        z = self._proj(p, "mtp_proj", torch.cat([h, nxt], dim=-1), ctx)
        seq = seq_parallel(cfg, ctx, z.shape[1])
        if seq:
            z = ctx.mesh.group(ctx.tp).shard_rows(z, dim=1)
        if cfg.remat and torch.is_grad_enabled():
            z, _, _, _ = torch.utils.checkpoint.checkpoint(
                block_seq, p["mtp_block"], z, cfg, ctx, _BLOCK_SPEC,
                seq=seq, use_reentrant=False)
        else:
            z, _, _, _ = block_seq(p["mtp_block"], z, cfg, ctx, _BLOCK_SPEC,
                                   seq=seq)
        if seq:
            z = ctx.mesh.group(ctx.tp).all_gather(z, dim=1)
        z = layer_norm_of(p, "mtp_norm", z, cfg, ctx)
        lbl2 = torch.roll(labels, -1, dims=1)
        S = lbl2.shape[1]
        mask = (lbl2 >= 0) & (torch.arange(S, device=lbl2.device)
                              < S - 1)[None, :]
        return self._nll_mean(p, z, torch.clamp_min(lbl2, 0), mask, ctx)

    # ----------------------------------------------------------- prefill --
    def prefill(self, p, batch, ctx: DistCtx = None):
        """Full forward over ``batch["tokens"]`` (B, S) (after the vlm
        family's patches; the encdec family's decoder over the encoded
        ``enc_embeds``) from fresh states, building the decode cache.
        Returns (last-token logits (B, V), cache)."""
        ctx = ctx or DistCtx.local()
        S = batch["tokens"].shape[1]
        seq = seq_parallel(self.cfg, ctx, self._seq_len(batch))
        x, n_prefix = self._embed_inputs(p, batch, ctx, seq)
        enc_out = self._encode(p, batch, ctx)
        h, _, new_states, caches, shared_caches = self._backbone(
            p, x, ctx, enc_out=enc_out, want_cache=True, seq=seq)
        last = h[:, -1, :]
        if seq:      # the last rank's last row
            last = ctx.mesh.group(ctx.tp).all_gather(last[None])[-1]
        logits = self._unembed(p, self._final(p, last, ctx), ctx)
        return logits, self._pack_cache(p, caches, new_states, shared_caches,
                                        enc_out, x.shape[0], n_prefix + S,
                                        x.device, ctx)

    def _pack_cache(self, p, caches: List[Any], new_states: List[Any],
                    shared_caches: List[Dict[str, torch.Tensor]], enc_out,
                    B: int, S: int, dev, ctx: DistCtx):
        """Prefill caches -> the decode layout. A rwkv or mamba
        segment's final state goes in as it stands (stacked: no view of
        an activation). A sliding-window model whose room exceeds its
        window gets a ring of W slots holding the last W positions at
        ring indices 0..W-1, as the reference lays it out
        (``repro/models/model.py`` ``_pack_cache``); otherwise the full
        cache (or MLA's latent cache) is padded to the room, a cross
        segment's with the encoder's keys and values (``_cross_cache``),
        and the hybrid family's shared-block caches likewise, each as
        (1, B, room, KVH, hd). Under a mesh whose ``dp`` does not divide
        B the prefill ran on the whole batch, as the reference's does;
        each key, value and latent leaf (the ring's slots, the encoder's
        frames and the shared block's too, not ``pos`` nor ``cvalid``)
        is then cut to this rank's block of its sequence where that
        divides (``launch/sharding.cut_cache_seq``: the context-parallel
        cache)."""
        cfg = self.cfg
        out = {"len": torch.full((B,), S, dtype=torch.int32, device=dev),
               "segments": []}
        room = S + self.decode_room
        self.cache_room = room
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
                    entry.update(self._cross_cache(p, enc_out, spec, ctx))
            out["segments"].append(entry)
        if cfg.family == "hybrid":
            out["shared"] = [{name: torch.nn.functional.pad(
                c[name], (0, 0, 0, 0, 0, room - S))[None]
                for name in ("k", "v")} for c in shared_caches]
        return SH.cut_cache_seq(out, ctx)

    def _cross_cache(self, p, enc_out: torch.Tensor, spec: SegmentSpec,
                     ctx: DistCtx):
        """A cross segment's decode entries: per layer the encoder's keys
        and values, ``ck`` / ``cv`` (L, B, Se, KVH, hd; the kv heads this
        rank holds), and ``cvalid`` (L, B, Se), all True."""
        seg = p["segments"][self.segments.index(spec)]
        kv = [cross_keys(cross_use(lp, self.cfg, ctx)[0], enc_out, self.cfg)
              for lp in unbind_layers(seg, spec.n_layers)]
        B, Se = enc_out.shape[0], enc_out.shape[1]
        return {"ck": torch.stack([k for k, _ in kv]),
                "cv": torch.stack([v for _, v in kv]),
                "cvalid": torch.ones((spec.n_layers, B, Se), dtype=torch.bool,
                                     device=enc_out.device)}

    # -------------------------------------------------------- init_cache --
    def init_cache(self, B: int, S: int, device=None, ctx: DistCtx = None):
        """Zeroed decode cache with room for S (+1) tokens (zero states
        for the rwkv and mamba segments; a cross segment's encoder keys
        and values zero for ``encoder.n_ctx`` frames, all valid); under
        a mesh ``ctx`` this rank's part of each leaf
        (``launch/sharding.cache_spec``: a block of the sequence of each
        key, value and latent leaf where B does not divide over ``dp``)."""
        cfg, dtype = self.cfg, self.dtype
        room = S + 1
        self.cache_room = room
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
        return SH.shard_cache(out, ctx)

    # --------------------------------------------------------- serve_step --
    def serve_step(self, p, cache, tokens: torch.Tensor,
                   ctx: DistCtx = None):
        """One decode step. tokens: (B,). Returns (logits (B, V), cache),
        the cache (states, KV caches and the shared block's) updated in
        place with ``len`` advanced by one (a cross segment's encoder
        keys and values kept as they are). ``cache`` is the last one
        this model made (:meth:`prefill`, :meth:`init_cache`): its room,
        which a rank of a context-parallel cache cannot read off its
        block, is the one recorded then."""
        ctx = dataclasses.replace(ctx or DistCtx.local(),
                                  cache_room=self.cache_room)
        cfg = self.cfg
        lengths = cache["len"]
        x1 = self._embed(p, tokens, ctx)
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
        logits = self._unembed(p, self._final(p, x1, ctx), ctx)
        out = {"len": lengths + 1, "segments": segments}
        if cfg.family == "hybrid":
            out["shared"] = cache["shared"]
        return logits, out


def build_model(cfg) -> Model:
    return Model(cfg)
