"""The four assigned input shapes' model inputs as ``meta`` tensors
(counterpart of ``repro/configs/shapes.py``): the shapes and dtypes a
dry run (``launch/dryrun.py``) traces on the meta device, with no
allocation, and random inputs of the same shapes for a smoke run."""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, *, with_labels=None):
    """Model inputs for one (arch, shape) pair, on the ``meta`` device.

    train / prefill: token batches (the encdec family's precomputed
    frame embeddings, ``encoder.n_ctx`` of them, and the rest of the
    sequence as decoder tokens; the vlm family's ``encoder.n_prefix``
    patch embeddings and the rest as tokens), with ``labels`` for
    training. decode: one new token a sequence; the cache comes from
    :func:`cache_specs`."""
    B, S = shape.global_batch, shape.seq_len
    dt = _DTYPES[cfg.dtype]
    want_labels = shape.mode == "train" if with_labels is None else with_labels
    if shape.mode == "decode":
        return {"tokens": _meta((B,), torch.int32)}
    if cfg.family == "encdec":
        Se = cfg.encoder.n_ctx
        Sd = max(S - Se, 1)
        spec = {"enc_embeds": _meta((B, Se, cfg.d_model), dt),
                "tokens": _meta((B, Sd), torch.int32)}
        if want_labels:
            spec["labels"] = _meta((B, Sd), torch.int32)
        return spec
    if cfg.family == "vlm":
        P = cfg.encoder.n_prefix
        spec = {"patch_embeds": _meta((B, P, cfg.d_model), dt),
                "tokens": _meta((B, S - P), torch.int32)}
        if want_labels:
            spec["labels"] = _meta((B, S - P), torch.int32)
        return spec
    spec = {"tokens": _meta((B, S), torch.int32)}
    if want_labels:
        spec["labels"] = _meta((B, S), torch.int32)
    return spec


def cache_specs(cfg: ModelConfig, shape: InputShape, ctx=None):
    """The decode cache for ``shape.seq_len`` tokens of context, on the
    ``meta`` device (under a mesh ``ctx``, this rank's part)."""
    from repro_torch.models.model import build_model
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta", ctx=ctx)


def dummy_inputs(gen: torch.Generator, cfg: ModelConfig, shape: InputShape,
                 **kw):
    """Random inputs of :func:`input_specs`' shapes and dtypes, drawn
    from ``gen`` on its device: token ids in [0, vocab - 1), embeddings
    normal * 0.02."""
    out = {}
    for name, s in input_specs(cfg, shape, **kw).items():
        if s.dtype.is_floating_point:
            out[name] = (torch.randn(s.shape, generator=gen,
                                     device=gen.device) * 0.02).to(s.dtype)
        else:
            out[name] = torch.randint(0, max(2, cfg.vocab_size - 1), s.shape,
                                      generator=gen, device=gen.device,
                                      dtype=s.dtype)
    return out
