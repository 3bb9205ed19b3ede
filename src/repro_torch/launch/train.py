"""Training (counterpart of ``repro/launch/train.py``): the train step
with microbatched gradient accumulation, global-norm clipping and the
optimizer, and a training loop, on one device or under a mesh.

    model = build_model(get_config("granite-3-2b", reduced=True))
    state, history = train_loop(model, batches, steps=200, lr=3e-3)

``train_loop`` trains on ``cuda`` unless it is given ``device="cpu"``,
and refuses to start without a card. On the card the MoE layer's
dispatch and combine, and their gradients, run as the port's CUDA
kernels (``kernels.ops``).

The step mirrors the reference: with ``cfg.microbatch`` = mb > 1 the
batch's leading rows are split into mb microbatches in order, their
gradients summed in the parameters' dtype and divided by mb, their
losses summed in f32 (and ``metrics`` is then empty); the gradients are
clipped to a global norm and the optimizer applied. The optimizer and
the clip write into the state's tensors (``optim.optimizers``), so the
returned state holds the same tensors as the one given.

Under a ``DistCtx`` with a ``utils.mesh.Mesh`` (``launch/sharding.
make_ctx``) every rank is given the same global batch and takes its
rows over the ``dp`` axes where they divide (``launch/sharding.
cut_batch``, the reference's ``batch_specs``), microbatch by microbatch:
microbatch i is rows i * B / mb to (i + 1) * B / mb of the global batch,
as the reference's jitted step splits its global array, and this rank
runs its ``dp`` rows of it (the whole microbatch where they do not
divide). The parameters hold this rank's parts of every leaf
(``init_params(..., ctx=)``, ``convert.train_state(..., cfg=, ctx=)``:
``launch/sharding.leaf_parts``); the collectives inside the model carry
the gradient (``utils/mesh.py``), so that each leaf's gradient is that
part of the whole leaf's, summed over the ranks whose rows fed it (a
leaf replicated over ``dp`` by a psum, an FSDP-cut one by the
reduce-scatter of its gather). The clip and the optimizer see the whole
leaves (``launch/sharding.param_shards``): the loss, the grad norm and
every replicated leaf are the same bits on every rank.

    ctx = make_ctx(make_mesh((2, 2), ("data", "model"), backend="nccl"))
    state, history = train_loop(model, batches, steps=200, ctx=ctx)
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.launch.serve import init_params
from repro_torch.launch.sharding import cut_batch, param_shards
from repro_torch.models.common import DistCtx
from repro_torch.models.model import Model
from repro_torch.optim import build_optimizer, clip_by_global_norm
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor        # 0-dim int32, on the parameters' device


def _state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32,
                                  device=params["embed"].device))


def init_state(model: Model, gen: torch.Generator, optimizer: Optimizer,
               ctx: Optional[DistCtx] = None) -> TrainState:
    """Parameters drawn from ``gen`` (on its device; under a mesh
    ``ctx``, this rank's parts of each leaf), the optimizer's initial
    state and step 0."""
    return _state(model.init(gen, ctx), optimizer)


def _split_microbatches(batch, n: int):
    """Each leaf (B, ...) as (n, B // n, ...): microbatch i holds rows
    i * B / n to (i + 1) * B / n of the global batch."""
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _value_and_grad(model: Model, ctx: DistCtx, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the
    gradients in the parameters' nesting and dtypes."""
    ps = leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in ps]
        loss, metrics = model.loss(unflatten(params, req), batch, ctx)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.contiguous()
             for p, g in zip(ps, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(model: Model, ctx: Optional[DistCtx],
                    optimizer: Optimizer, *, clip_norm: float = 1.0):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm",
    ...})``; batch leaves are tensors on the parameters' device (the
    global batch, the same on every rank, under a mesh ``ctx``: each
    rank takes its rows). Nothing in the step waits for the device, but
    a collective staged through the host."""
    ctx = ctx or DistCtx.local()
    mb = max(1, model.cfg.microbatch)
    cfg = model.cfg

    def train_step(state: TrainState, batch):
        shards = param_shards(state.params, cfg, ctx)
        if mb == 1:
            c, b = cut_batch(ctx, batch)
            loss, metrics, grads = _value_and_grad(model, c, state.params,
                                                   b)
        else:
            micro = _split_microbatches(batch, mb)
            grads, loss = None, torch.zeros(
                (), dtype=torch.float32, device=state.step.device)
            for i in range(mb):
                c, b = cut_batch(ctx, {k: v[i] for k, v in micro.items()})
                l, _, g = _value_and_grad(model, c, state.params, b)
                if grads is None:
                    grads = g      # 0 + g: the reference's first sum
                else:
                    for a, b in zip(leaves(grads), leaves(g)):
                        a.add_(b)
                    del g
                loss = loss + l
            for a in leaves(grads):
                a.div_(mb)
            loss = loss / mb
            metrics = {}
        # Named ranges for torch.profiler (the clip's and the
        # optimizer's share of a step's device time).
        with record_function("train_step/clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm, shards)
        with record_function("train_step/optimizer"):
            params, opt = optimizer.update(grads, state.opt, state.params,
                                           state.step, shards)
        del grads
        return (TrainState(params, opt, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, **metrics})

    return train_step


def train_loop(model: Model, batches, *, seed: int = 0, lr: float = 3e-4,
               steps: int = 100, ctx: Optional[DistCtx] = None,
               log_every: int = 10, device="cuda"):
    """The reference's ``train_loop``: parameters drawn from ``seed`` on
    ``device`` (under a mesh ``ctx``, this rank's parts of each leaf,
    cut as drawn), ``cfg.optimizer`` at a constant ``lr``, at most
    ``steps`` steps over ``batches`` (dicts of arrays or tensors: the
    global batch on every rank). The host reads the loss, and so waits
    for the device, only on the log cadence. Returns (state, [(step,
    loss), ...])."""
    ctx = ctx or DistCtx.local()
    optimizer = build_optimizer(model.cfg.optimizer, lr)
    state = _state(init_params(model, seed=seed, device=device, ctx=ctx),
                   optimizer)
    dev = state.step.device
    step_fn = make_train_step(model, ctx, optimizer)
    history = []
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(metrics["loss"])))
    return state, history
