"""Serving entry points (counterpart of ``repro/launch/serve.py``):
batched prefill, the decode step, and ``generate``, a prefill followed
by a decode loop.

    model = build_model(get_config("mixtral-8x7b", reduced=True))
    params = init_params(model, seed=0)            # on the card
    tokens = generate(model, params, {"tokens": prompts}, steps=32)

``init_params`` draws on ``cuda`` unless it is given ``device="cpu"``,
and refuses to start without a card; ``generate`` runs where the
parameters are. A sliding-window model whose prompt plus steps exceed
its window decodes over a ring cache, through the ``swa_decode``
kernel; an MLA model (DeepSeek-V3) over its latent cache, in the
absorbed form.

Under a ``DistCtx`` with a ``utils.mesh.Mesh`` (``launch.sharding.
make_ctx``) every rank holds its parts of each leaf (``init_params(...,
ctx=ctx)``: every family's layers tensor-parallel and FSDP-cut, the MoE
layers' experts on the reference's expert-parallel paths), is given the
same global batch and runs ``generate`` on its rows of it (the family's
inputs too) where they divide over the ``dp`` axes (``launch.sharding.
cut_batch``; its decode cache holds those rows and the kv and state
heads of ``launch.sharding.cache_spec``), else on the whole batch, its
decode cache then context-parallel (one sequence at a long context:
each rank holds a block of the sequence of every key, value and latent
leaf, attends over it, and the ranks' softmax states are merged, so
that every rank gets the same logits); the tokens (and ``stats``'
logits) are gathered over ``dp`` at the end where the batch was cut,
so that every rank returns the same tokens.

The batch holds ``tokens`` (B, S) and the family's inputs: for the
encdec family (Whisper) ``enc_embeds`` (B, n_ctx, d), the frame
embeddings its encoder reads, and ``tokens`` (B, S_dec) the decoder's
prompt; for the vlm family (InternVL2) ``patch_embeds`` (B, P, d), the
projected patches in front of ``tokens`` (B, S - P). A cross-attention
model decodes over a full cache with the encoder's keys and values
beside it, through the plain ``decode_attention``.
"""
from __future__ import annotations

import time
from typing import Optional, Union

import torch

from repro_torch.launch.sharding import cut_batch
from repro_torch.models.common import DistCtx
from repro_torch.models.model import Model
from repro_torch.utils.prng import StepGumbel


def init_params(model: Model, seed: int = 0, device="cuda",
                ctx: Optional[DistCtx] = None):
    """The model's parameters drawn from a generator seeded with
    ``seed`` on ``device``; under a mesh ``ctx``, this rank's parts of
    each leaf (the same bits as those parts of the draw without a
    mesh)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_params runs on CUDA, but torch.cuda.is_available() is "
            "False: run it on a machine with an NVIDIA GPU, or pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return model.init(torch.Generator(device=dev).manual_seed(seed), ctx)


def make_serve_step(model: Model, ctx: Optional[DistCtx] = None):
    ctx = ctx or DistCtx.local()

    def serve_step(params, cache, tokens):
        return model.serve_step(params, cache, tokens, ctx)
    return serve_step


def make_prefill(model: Model, ctx: Optional[DistCtx] = None):
    ctx = ctx or DistCtx.local()

    def prefill(params, batch):
        return model.prefill(params, batch, ctx)
    return prefill


# The batch leaves a prefill reads: the tokens, the encdec family's frame
# embeddings and the vlm family's patch embeddings.
_INPUTS = ("tokens", "enc_embeds", "patch_embeds")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(model: Model, params, batch, *, steps: int,
             ctx: Optional[DistCtx] = None, greedy: bool = True,
             key: Union[int, StepGumbel, None] = None,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Prefill ``batch["tokens"]`` (B, S) (with the family's
    ``enc_embeds`` or ``patch_embeds``), then decode ``steps`` tokens.
    Returns (B, steps) int32: the prefill's next token, then each step's.

    Greedy decoding takes the argmax. Sampled decoding (``greedy=False``)
    draws each step's token from the softmax of its logits as
    ``jax.random.categorical`` does, ``argmax(gumbel + logits)`` in the
    logits' dtype, with the noise of step i from ``key``: an int seeds a
    ``utils.prng.StepGumbel``, and any object with its ``draw(step,
    shape, dtype, device)`` may stand in for it (the counterpart of the
    JAX package's ``key``). If ``stats`` is a dict, it receives the wall
    seconds of the prefill (``prefill_s``) and of the decode loop
    (``decode_s``), each ending in a device sync, the logits of the
    prefill and of every step (``logits``, the whole batch's) and the
    final ``cache`` (this rank's)."""
    ctx = ctx or DistCtx.local()
    device = params["embed"].device
    if not greedy and key is None:
        raise ValueError("generate: sampled decoding (greedy=False) needs "
                         "a key: an int seed or a noise source")
    noise = StepGumbel(key) if isinstance(key, int) else key
    model.decode_room = steps + 1
    inputs = {name: torch.as_tensor(batch[name]).to(device)
              for name in _INPUTS if name in batch}
    B = inputs["tokens"].shape[0]
    ctx, inputs = cut_batch(ctx, inputs)
    rows = slice(0, B)
    if ctx.batch_cut:
        n = B // ctx.dp_size
        i = ctx.mesh.index(tuple(ctx.dp))
        rows = slice(i * n, (i + 1) * n)
    prefill = make_prefill(model, ctx)
    step = make_serve_step(model, ctx)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {**batch, **inputs})
    seen = [logits]
    if stats is not None:
        _sync(device)
        stats["prefill_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    toks = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(steps):
        toks.append(tok)
        logits, cache = step(params, cache, tok)
        if stats is not None:
            seen.append(logits)
        if not greedy:
            logits = noise.draw(i, (B,) + tuple(logits.shape[1:]),
                                logits.dtype, device)[rows] + logits
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = torch.stack(toks, dim=1)
    if stats is not None:
        _sync(device)
        stats["decode_s"] = time.perf_counter() - t0
        stats["cache"] = cache
    if ctx.batch_cut:
        g = ctx.mesh.group(tuple(ctx.dp))
        out = g.all_gather(out)
        if stats is not None:
            seen = list(g.all_gather(torch.stack(seen), dim=1).unbind(0))
    if stats is not None:
        stats["logits"] = seen
    return out
