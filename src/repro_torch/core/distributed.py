"""Distributed k-FED over a ``utils.mesh.Mesh`` (counterpart of
``repro/core/distributed.py``; DESIGN.md §4).

Every rank runs the same program on the same host inputs and moves only
its own shard to its device:

  * each shard of the mesh axes hosts a cohort of Z / shards federated
    devices and runs Algorithm 1 on them (devices never exchange raw
    data); its k-means++ draws are those of the devices' global ids, so
    a shard picks what the simulated round picks for them;
  * ``server="replicated"``: the one round of communication is one
    all-gather of the (Z, k', d) device centers (with their masks and
    weights), and the server (Algorithm 2 steps 2-8) runs on every shard;
  * ``server="sharded"``: the server itself is sharded: only scalars and
    (d,) rows cross shards in the greedy max-min loop, and one (k, d)
    psum in the Lloyd round (``core/server.aggregate_sharded``).

The (Z, n) labels are gathered, so every rank returns all of them; tau
is replicated, the same bits on every rank (the mesh's collectives add
in shard order). ``distributed_lloyd`` is the multi-round parallel Lloyd
baseline of the paper's §4.2.1: one psum of (k, d) sums and (k,) counts
a round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lloyd as L
from repro_torch.core import server as S
from repro_torch.core.local_kmeans import local_kmeans
from repro_torch.fed import engine as E
from repro_torch.kernels import ops
from repro_torch.utils.prng import GumbelSource

SERVERS = ("replicated", "sharded")


def _device(data, device) -> torch.device:
    """Where a rank computes: ``device``, else the data's."""
    if device is not None:
        return torch.device(device)
    return (data.device if isinstance(data, torch.Tensor)
            else torch.device("cpu"))


def _rows(x, lo: int, hi: int, device, dtype=None):
    """Rows [lo, hi) of a host or device array, on ``device``."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    t = x[lo:hi].to(device)
    return t if dtype is None else t.to(dtype)


def kfed_shard_map_impl(mesh, data, k: int, k_prime: int, *,
                        source: GumbelSource, axis="data",
                        server: str = "replicated",
                        participation=None,
                        weight_by_core_counts: bool = False,
                        k_valid=None, point_mask=None, device=None,
                        **local_kw):
    """One-shot k-FED over ``mesh`` (engine internal; the declarative
    surface is ``fed.api.Session`` with topology ``replicated`` |
    ``sharded``).

    data: (Z, n, d), on the host or a device, Z divisible by the shard
    count of ``axis`` (one mesh axis name or a tuple, sharded jointly,
    major to minor). ``source`` gives device z's k-means++ draws under
    id z. ``participation``: optional (Z,) bool; absent devices are left
    out of the aggregate and attached afterwards by Theorem 3.2.
    ``weight_by_core_counts`` weights the server's Lloyd round by the
    Algorithm 1 core-set sizes. ``device``: where this rank computes
    (default: the data's). Returns (labels (Z, n) int32, tau_centers
    (k, d)), both the same on every rank."""
    if server not in SERVERS:
        raise ValueError(f"kfed_shard_map server={server!r} is invalid: "
                         f"accepted values are {list(SERVERS)}")
    Z, n, d = data.shape
    group = mesh.group(axis)
    if Z % group.size:
        raise ValueError(f"Z={Z} devices do not divide over the "
                         f"{group.size} shards of axes {axis!r}")
    zloc = Z // group.size
    lo = group.index * zloc
    dev = _device(data, device)
    data_b = _rows(data, lo, lo + zloc, dev, torch.float32)
    kv_b = _rows(k_valid, lo, lo + zloc, dev, torch.int32)
    pm_b = _rows(point_mask, lo, lo + zloc, dev, torch.bool)
    part_b = _rows(participation, lo, lo + zloc, dev, torch.bool)

    # Stage 1: the local solves of this shard's cohort.
    cfg = E.EngineConfig(k=k, k_prime=k_prime,
                         weight_by_core_counts=weight_by_core_counts,
                         local_kw=dict(local_kw))
    loc = E.local_stage(source, data_b, cfg, k_valid=kv_b, point_mask=pm_b,
                        first_id=lo)
    # Stage 2: participation and weighting masks.
    cmask = (loc.center_mask if part_b is None
             else loc.center_mask & part_b[:, None])
    w_loc = S.core_weights(loc.core_counts) if weight_by_core_counts else None
    if server == "sharded":
        # Stage 3': the sharded server; only small reductions cross.
        kz_all = group.all_gather(torch.sum(cmask, dim=1).to(torch.int32))
        _, tau, my = S.aggregate_sharded(loc.centers, cmask, kz_all, k,
                                         group, lo * k_prime,
                                         weights_loc=w_loc)
    else:
        # The one-shot communication: the centers, masks and weights.
        all_c, all_m, all_w = group.all_gather_many([loc.centers, cmask,
                                                     w_loc])
        # Stage 3: the server, replicated on every shard.
        agg = S.aggregate(all_c, all_m, k, weights=all_w)
        tau = agg.tau_centers
        my = agg.center_labels[lo:lo + zloc]
    if part_b is not None:
        # Theorem 3.2 attachment of this shard's absent devices, local
        # against the replicated tau.
        my = S.attach_absent_devices(my, loc.centers, loc.center_mask, tau,
                                     part_b)
    # Stage 4: the induced labels (Definition 3.3), gathered.
    return group.all_gather(S.induced_labels(my, loc.assign)), tau


def assign_new_device_shard(new_data, tau_centers: torch.Tensor,
                            k_prime: int, *, source: GumbelSource,
                            **local_kw) -> torch.Tensor:
    """A device joining after the fact (Theorem 3.2): its local solve and
    the O(k'k) nearest-center match against the retained server centers,
    with no communication at all. new_data: (n, d); its k-means++ draws
    are ``source``'s id 0. Returns (n,) labels."""
    x = torch.as_tensor(np.asarray(new_data) if not isinstance(
        new_data, torch.Tensor) else new_data).to(tau_centers.device)
    x = x.float()[None]
    gumbel = source.draw([0], k_prime, x.shape[1], x.device)
    loc = local_kmeans(gumbel, x, k_max=k_prime, **local_kw)
    lbl = S.assign_new_device(loc.centers, loc.center_mask, tau_centers)
    return S.induced_labels(lbl, loc.assign)[0]


def distributed_lloyd(mesh, data, k: int, *, source: GumbelSource,
                      iters: int = 25, axis="data", init_sub: int = 64,
                      device=None):
    """The multi-round distributed k-means baseline (§4.2.1,
    "Communication-Efficiency"): parallel assignment and one psum of the
    per-cluster (sums, counts) a Lloyd round. data: (Z, n, d) on every
    rank; each shard moves and assigns its Z / shards devices. The
    initial centers are k-means++ (``source``'s id 0) on a fixed
    subsample of the gathered points, the same on every rank. Returns
    (labels (Z, n) int32, centers (k, d) f32)."""
    Z, n, d = data.shape
    group = mesh.group(axis)
    zloc = Z // group.size
    lo = group.index * zloc
    dev = _device(data, device)
    x = _rows(data, lo, lo + zloc, dev, torch.float32).reshape(-1, d)
    xg = group.all_gather(x)
    sub = xg[::max(1, xg.shape[0] // (init_sub * k))][:init_sub * k]
    gumbel = source.draw([0], k, sub.shape[0], dev)
    c, _ = L.kmeans_pp_init(gumbel, sub[None], k)
    c = c[0]
    for _ in range(iters):
        a, _ = L.assign_points(x, c)
        sums, cnt = ops.kmeans_update(x, a, k)
        sums = group.psum(sums)        # the per-round collective
        cnt = group.psum(cnt)
        new = sums / torch.clamp_min(cnt, 1.0)[:, None]
        c = torch.where((cnt > 0)[:, None], new, c)
    a, _ = L.assign_points(x, c)
    return group.all_gather(a.reshape(zloc, n)), c
