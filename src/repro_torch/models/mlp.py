"""The one-hidden-layer classifier of the personalization and selection
experiments (counterpart of ``benchmarks/_models.py``; a structural
stand-in for the paper's one-hidden-layer CNN).

Parameters are a dict ``{"w1", "b1", "w2", "b2"}`` of f32 tensors, the
JAX package's layout, so ``convert.model_params`` carries a JAX
``init_mlp`` across. A client's data is a dict ``{"x": (n, d), "y":
(n,), "mask": (n,)}``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def init_mlp(gen: torch.Generator, d_in: int, d_hidden: int,
             n_classes: int, device="cuda") -> Params:
    """Normal weights scaled by 1/sqrt(fan-in), zero biases, drawn from
    ``gen`` (a CPU generator) and placed on ``device`` (the card unless
    the caller asks for the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_mlp places the parameters on CUDA, but "
            "torch.cuda.is_available() is False: pass device='cpu' to "
            "keep them on the CPU")
    w1 = torch.randn((d_in, d_hidden), generator=gen) / math.sqrt(d_in)
    w2 = torch.randn((d_hidden, n_classes), generator=gen) / math.sqrt(
        d_hidden)
    params = {"w1": w1, "b1": torch.zeros((d_hidden,)),
              "w2": w2, "b2": torch.zeros((n_classes,))}
    return {k: v.to(device) for k, v in params.items()}


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: Params, data) -> torch.Tensor:
    """Mean negative log-likelihood over the points of ``data["mask"]``
    (over every point without a mask)."""
    logits = mlp_logits(params, data["x"])
    lse = torch.logsumexp(logits, dim=-1)
    # A negative label (the -1 of a padded point) counts from the end,
    # as the reference's take_along_axis does; the mask drops it.
    y = data["y"].long()
    y = torch.where(y < 0, y + logits.shape[-1], y)
    gold = torch.gather(logits, 1, y[:, None])[:, 0]
    nll = lse - gold
    m = data.get("mask")
    if m is None:
        return torch.mean(nll)
    mf = m.float()
    return torch.sum(nll * mf) / torch.clamp(torch.sum(mf), min=1.0)


def mlp_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
                 mask=None) -> torch.Tensor:
    pred = torch.argmax(mlp_logits(params, x), dim=-1)
    ok = (pred == y).float()
    if mask is not None:
        mf = mask.float()
        return torch.sum(ok * mf) / torch.clamp(torch.sum(mf), min=1.0)
    return torch.mean(ok)
