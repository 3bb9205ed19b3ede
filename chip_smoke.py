"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/kernels/csrc with
nvcc, holds each kernel against its plain PyTorch version on the card
at the shapes of the main path, then drives the main path through the
port's entry points: the one-shot k-FED round (Session.run) at the
largest setting of the paper's Table 1 (d=300, k=100, k'=10, m0=5,
40 points per component per device: 50 devices x 400 points), and the
Theorem 3.2 serve path (Session.from_round + serve_versioned) for 32
late devices of 1024 points with a sync refresh every 16 folds, and
the cluster-routed personalization serve path (Session.serve_predict
through per-cluster transformer heads) at the repository's routed
serving configuration (benchmarks/bench_route_serve.py: k=16, d=128,
k'=4, batches of 64 requests), and LM serving through
repro_torch.launch.serve.generate at Mixtral-8x7B's full width (d=4096,
32 heads over 8 KV heads of 128, 8 experts top-2 of 14336, vocab 32000,
sliding window 4096, bf16) cut to 8 of its 32 layers: 4 prompts of 4096
tokens, then 32 greedy steps over the ring cache, each through the
swa_decode kernel. It checks the launch counts of every kernel on each
path, the clustering accuracy, that the routed labels equal a heads-off
session's, that the decode leg's logits are finite, that solve_attach
gives each request alone the bits it gives it inside the batch and two
calls the same bits, and agreement with the CPU run of the plain
versions on small inputs. pdist_argmin is also timed at every shape
the round, serve and routed paths launch it at, on the paths' own inputs
(tallied in one more pass over each path), and at the Theorem 3.2
attach of the round's devices, and there held against the exact (f64)
distances: within the tolerance, and no farther from them than the f32
plain version. kmeans_update likewise, at every shape those paths launch
it at (tallied in the same pass): its rows at -1 and longest list, its
device time beside one index_add_ call's and two bounds (the rows whose
assignment is valid, and all of x), and its sums held against the sums
taken in f64 and against the f32 plain version within check_update's
tolerance, two calls bit for bit. moe_combine likewise, at every shape
the routed serve path and the decode leg (its prefill and its steps,
tallied in one more generate) launch it at: bit for bit equal to the
plain version, two calls bit for bit, its device time beside one
F.embedding_bag call's and the bound, and its launch plan. One more
prefill of the decode leg's batch runs under the profiler.

Between the routed leg and the pdist lines it drives the slice that
restores checkpoints and the paper's scenario layer, each leg once
between a reset and a read of the launch counts, its pdist_argmin and
kmeans_update launches tallied by shape (and those shapes timed and
held to f64 with the paths' own): the serve path cut by Session.save
and Session.restore after 16 of its 32 late devices, and the routed
leg after its first wave (schema v5), each equal to the uninterrupted
session bit for bit; an archive written on the CPU restored on the card
(and back); a small personalize and separation report on the card
against the CPU run; the paper's Table 2 (Global FedAvg, IFCA and k-FED
+ per-cluster FedAvg at Z in {100, 200}, k' in {1, 2},
benchmarks/bench_table2_personalization.py in full mode), Figure 4
(random, pow-d and k-FED pow-d client selection,
benchmarks/bench_fig4_selection.py in full mode) and Figure 1
(clustering accuracy and the median active c_rs against the separation
constant c, benchmarks/bench_fig1_separation.py in full mode, one seed
a c).

After those it drives the attachment server's slice: the attach plan at
k=12, d=24 (lru, async refresh, latency autoscaling) on the card against
the CPU run; the attach leg on the round of the run leg (Table 1's serve
plan with 64 fold slots, an async refresh every 16 admissions, 96 late
devices of 16-4096 points in bursts of 1 to 43, one flush a burst), once
under LRU folding and throughput autoscaling and once under the
weighted reservoir and latency autoscaling, each cut by save and restore
after six bursts and held to the uninterrupted session bit for bit, with
its decisions, tau versions, folds, step shapes and solve_attach
launches by shape; the attachment server's command line
(python -m repro_torch.launch.attach_server) in a process of its own;
and the paper's Figures 2 (the cost ratio of structured to IID
partitions, benchmarks/bench_fig2_heterogeneity.py) and 3 (one round
against 25 rounds of distributed Lloyd, in cost and bytes,
bench_fig3_communication.py), each in full mode. solve_attach is then
timed and held to its plain version at every shape the paths launched
it at.

Then the mesh legs (the replicated and sharded topologies and the
sharded serve plane over torch.distributed): the run leg's round under
the simulated, replicated and sharded topologies in a one-rank NCCL
world in this process (mesh1: the same labels, the replicated tau bit
for bit the simulated one's, the sharded one within 1e-4), then in a
two-rank gloo world whose two processes share cuda:0, with every
collective staged through the host (mesh2: the same labels, tau within
1e-4), which also serves the serve leg's 32 late devices with
serve_axes=("data",), and again under latency autoscaling in bursts
that take the active shard count to 1 and 2, each equal to one process
serving alone bit for bit (labels, tau versions, fold state). Their
launches are counted in each rank and their per-shard shapes join the
pdist, kmeans and solve lines. One card measures no multi-chip speed:
these legs report walls only.

Before the mesh legs come the drift legs: a small split_merge session
(heads off and on) on the card against the CPU run; the drift
benchmark (benchmarks/bench_drift.py in full mode on the port's draws:
frozen against split_merge, whose tail mislabel rate must be no higher);
Table 1's serve plan under decay and split_merge with its late devices
from a resampled mixture, each cut by save and restore and replayed bit
for bit, with a refresh timed with drift and without; and the routed
leg's plan under split_merge, whose re-seeded centers' heads must be
re-mapped and committed, with labels equal to a heads-off drift twin's.
The mesh legs then also serve the routed leg's plan with
serve_axes=("data",) (the sharded routed step: votes gathered, overflow
decided over the whole batch), at the full grant and under latency
autoscaling, and Table 1's split_merge plan, each equal to one process
alone bit for bit (labels, predictions, clusters, routing, fold state,
mass, moves). Their pdist_argmin, kmeans_update, solve_attach and
moe_combine shapes join those lines.

Between the drift legs and the mesh legs come the encoder legs
(DESIGN.md §17: raw token sequences encoded on the card ahead of the
unchanged serve step): tests/test_encode_serve.py's plan on its 7
ragged requests on the card against the CPU run (f32, bf16 storage, and
the granite-3-2b encoder with linear heads); the configuration of
benchmarks/bench_encode_serve.py, not cut (k=16, d=16, batches of 32
requests of 4 points of 8 tokens): the fused encode step against the
unbatched front end, device time and wall, a request alone against its
batch, and 6 waves through a session whose step shapes stay flat after
the first; Table 1's serve plan with the qwen1.5-0.5b encoder at d=300
(4 heads of 75, SwiGLU d_ff 600, 2 layers), in f32 and in bf16 storage:
the round on the 50 devices' encoded sequences of 16 tokens, 32 late
devices of 1024 points of 8-64 tokens (every sequence rung) served
twice and once cut by save and restore (schema v6), all the same bits,
one batch through the encode step equal to the serve step on the
encoder's output, and a profile line; and the routed leg's plan with
the granite-3-2b encoder, 2 waves of 64, labels equal an encoded
heads-off twin's. The mesh legs then also serve one wave of the encoded
Table 1 plan and of the encoded routed plan with serve_axes, bit for
bit against one process.

The second to last line is one JSON object with each kernel's launches,
error against its plain version, times (device_ms by CUDA graph replay)
and bound; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
Without a CUDA device, or without the repository's src/ next to this
file, it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# f32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# The paper's Table 1 at its largest setting
# (benchmarks/bench_table1_gaussian.py): d, k, m0, k' = sqrt(k).
D, K, KP, M0, N_PER, SEP = 300, 100, 10, 5, 40, 30.0
SERVE_N, SERVE_REQUESTS = 1024, 32
SERVE_PLAN = dict(bucket_sizes=(64, 256, 1024), batch_size=8,
                  refresh_every=16)
MIN_ACCURACY = 0.93

# The routed serving configuration of benchmarks/bench_route_serve.py
# (its _session_leg): the round, the plan and the traffic.
R_K, R_KP, R_D, R_M0, R_NPER, R_SEP = 16, 4, 128, 4, 25, 60.0
R_PLAN = dict(capacity=256, batch_size=64, bucket_sizes=(64,),
              heads="qwen1.5-0.5b", head_arch="transformer")
R_WAVES, R_N_RANGE = 5, (20, 60)

# The checkpoint legs: the serve path cut after RESTORE_HALF requests,
# the routed leg after its first wave.
RESTORE_HALF = SERVE_REQUESTS // 2

# The scenario legs, each as its benchmark runs it in full mode. Table 2
# (benchmarks/bench_table2_personalization.py): rotated-prototype tasks,
# an MLP of 200 hidden units, Global FedAvg, IFCA and k-FED + FedAvg.
P_ZS, P_KPS, P_N, P_D, P_K, P_CLASSES = (100, 200), (1, 2), 64, 32, 4, 10
P_HIDDEN, P_ROUNDS, P_LR, P_EPOCHS = 200, 12, 0.1, 3
# Figure 4 (benchmarks/bench_fig4_selection.py): client selection on a
# FEMNIST-like federation, k-FED with k=8, k'=1 on mean features.
S_Z, S_D, S_CLASSES, S_MEAN_N, S_ROUNDS = 100, 32, 10, 60, 30
S_M, S_DCAND, S_HIDDEN, S_K, S_TARGET = 10, 30, 64, 8, 0.75
# Figure 1 (benchmarks/bench_fig1_separation.py): accuracy against the
# separation constant c, one seed a c.
F_K, F_D, F_KP, F_M0, F_NPER = 64, 100, 8, 5, 30
F_CS = (0.25, 0.5, 1.0, 2.0, 4.0, 6.0, 10.0)
# What the Table 2 leg's clustering must reach (fixed before its first
# run on the card; the JAX bench's quick mode on the CPU gives 100%).
MIN_TABLE2_CLUSTER_ACC = 0.9

# The LM decode leg: Mixtral-8x7B as published (configs/mixtral_8x7b.py,
# arXiv:2401.04088) cut to 8 of its 32 layers (32 layers are about 93 GB
# in bf16, more than the card's 80 GB); 4 prompts of its own window,
# 4096 tokens, then 32 greedy steps: every step decodes over the ring.
MX_LAYERS, MX_BATCH, MX_PROMPT, MX_STEPS, MX_SEED = 8, 4, 4096, 32, 0

# The attachment server's leg: Table 1's serve plan with 64 fold slots
# (fewer than the round's 50 devices and the 96 late ones, so LRU
# evicts), the async refresh every 16 admissions, under (LRU,
# throughput) and then (weighted reservoir, latency). 96 late devices of
# 16-4096 points come in bursts that move the batch rung both ways; the
# ones above 1024 points fill the oversized rungs of 2048 and 4096,
# which throughput coalesces. A session saved after A_CUT bursts and
# restored serves the last two as the uninterrupted one does.
A_PLAN = dict(capacity=64, batch_size=8, bucket_sizes=(64, 256, 1024),
              refresh_every=16, refresh="async")
A_RUNS = (("lru", "throughput"), ("weighted_reservoir", "latency"))
A_BURSTS, A_CUT = (1, 2, 3, 5, 8, 13, 21, 43), 6
A_N_RANGE, A_SEED = (16, 4097), 11
# What the attach leg's mean served accuracy (a request's labels against
# its components, averaged over the 96) must reach; fixed before the
# leg's first run on the card (PERF.md §2).
MIN_ATTACH_ACCURACY = 0.9
# The attachment server's command line, as README.md shows it.
CLI_ARGS = ("--requests", "24", "--fold-policy", "lru", "--capacity", "20",
            "--refresh", "async", "--autoscale", "throughput")

# The mesh legs: the run leg's round (Table 1's largest setting, not
# cut) under the simulated, replicated and sharded topologies, in a
# one-rank NCCL world in this process (mesh1) and in a two-rank gloo
# world whose two processes share cuda:0, every collective staged
# through the host (mesh2), which then serves the serve leg's 32 late
# devices with serve_axes=("data",) (4 of each batch of 8 a rank), and
# again under latency autoscaling in bursts that take the active shard
# count to 1 and to 2. One card cannot measure multi-chip speed: these
# legs check the collectives and report walls only.
MESH_TOPOLOGIES = ("simulated", "replicated", "sharded")
MESH_BURSTS = (1, 7, 8, 16)

# The drift legs. benchmarks/bench_drift.py in full mode on the port's
# draws: its round (k=16, k'=4, d=24, m0=4, 25 points a component, sep
# 60), phase 1 (16 requests from the round's means) then phase 2 (96
# requests of 20-60 points from means resampled x40), batches of 8 in a
# bucket of 64, frozen (no refresh) against split_merge (a refresh every
# 8 folds, half-life 32, retire below 0.2 of the mean mass); the tail
# mislabel rate is the mean over phase 2's second half.
DR_K, DR_KP, DR_D, DR_P1, DR_P2, DR_CHUNK = 16, 4, 24, 16, 96, 8
DR_RUNS = (("frozen", dict(refresh_every=0)),
           ("split_merge", dict(refresh_every=8, drift="split_merge",
                                drift_half_life=32,
                                drift_retire_frac=0.2)))
# Table 1's serve plan (the serve leg's) under decay (half-life 16) and
# split_merge, its 32 late devices drawn from a resampled mixture of the
# same separation, so that the served clusters move; each run cut by a
# save and restore after DT_CUT devices.
DT_RUNS = (("decay", dict(drift="decay", drift_half_life=16)),
           ("split_merge", dict(drift="split_merge", drift_half_life=16,
                                drift_retire_frac=0.2)))
DT_CUT = SERVE_REQUESTS // 2
# The routed leg's plan with split_merge, a refresh every batch of 64:
# RD_WAVES waves from means resampled x40.
RD_DRIFT = dict(refresh_every=64, drift="split_merge", drift_half_life=64,
                drift_retire_frac=0.2)
RD_WAVES = 3
# The routed plan on the mesh legs: two waves of the routed leg's
# requests at the full grant, then under latency autoscaling in bursts
# that take 1 and 2 active shards.
MESH_R_WAVES, MESH_R_BURSTS = 2, (1, 15, 48, 64)

# The encoder legs (DESIGN.md §17). tests/test_encode_serve.py's plan.
E_PLAN = dict(k=8, k_prime=3, d=16, capacity=128, batch_size=2,
              bucket_sizes=(16, 32), encoder="qwen1.5-0.5b",
              encode_seq_len=16)
# benchmarks/bench_encode_serve.py's configuration, not cut.
EB_K, EB_KP, EB_D, EB_B, EB_N, EB_S, EB_WAVES = 16, 3, 16, 32, 4, 8, 6
# Table 1's serve plan with the qwen1.5-0.5b encoder re-dimensioned to
# d=300 (4 heads of 75, SwiGLU d_ff 600, 2 layers): the round's devices
# at ET_ROUND_SEQ tokens a point, the 32 late devices at 8-64 (every
# rung), each token its point plus N(0, ET_NOISE^2) noise; cut by save
# and restore after ET_CUT.
ET_ENC = dict(encoder="qwen1.5-0.5b", encode_seq_len=64)
ET_ROUND_SEQ, ET_SEQ_RANGE, ET_NOISE = 16, (8, 65), 0.1
ET_CUT = SERVE_REQUESTS // 2
# The routed leg's plan with the granite-3-2b encoder (GQA: 8 heads of
# 16 over 2): ER_WAVES waves of 64 requests of 8-32 tokens a point.
ER_ENC = dict(encoder="granite-3-2b", encode_seq_len=32)
ER_ROUND_SEQ, ER_SEQ_RANGE, ER_WAVES = 8, (8, 33), 2
# The mesh legs' encoded serves: one wave of the encode table1 leg's
# late devices and one of the encode route leg's requests.
MESH_E_DEVICES = 8


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call: CUDA events around the replay of a CUDA
    graph of ``n`` calls, the median of ``reps`` replays. Unlike
    time_ms, the host's enqueue of each call is not in the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def sync() -> None:
    torch.cuda.synchronize()


def bound(nbytes: float, flops: float):
    """The least time the card could take (ms) and what sets it."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dist_tol(x, c, idx):
    """The distance tolerance of the expanded form
    ||x||^2 - 2x.c + ||c||^2: 1e-6 (||x_i||^2 + ||c_{a_i}||^2) + 1e-6."""
    xn = torch.sum(x.double() ** 2, -1)
    cn = torch.sum(c.double() ** 2, -1)
    i = idx.long().clamp_min(0)
    cni = torch.gather(cn, -1, i) if cn.dim() == i.dim() else cn[i]
    return 1e-6 * (xn + cni) + 1e-6


def cancellation_err(got, want, x, c, idx):
    """(max |got - want|, worst ratio of |got - want| to dist_tol)."""
    err = (got.double() - want.double()).abs()
    return float(err.max()), float((err / dist_tol(x, c, idx)).max())


# --------------------------------------------------------------- kernels --

def cdist_min(x, c):
    """The library yardstick of pdist_argmin: torch.cdist squared, then
    the minimum over the centers (index and value)."""
    if c.dim() < x.dim():
        c = c.expand(x.shape[0], *c.shape)
    return torch.min(torch.cdist(x, c) ** 2, dim=-1)


def pdist_work(x, c, cm):
    """(bytes, flops) of one pdist_argmin call: each input read once
    (x, the centers, the mask), each output written once (idx and the
    distance), and the products, norms and distances."""
    esz = x.element_size()
    B = x.shape[0] if x.dim() == 3 else 1
    n, d = x.shape[-2:]
    k = c.shape[-2]
    bc = c.shape[0] if c.dim() == 3 else 1
    nbytes = (esz * (B * n * d + bc * k * d)
              + (0 if cm is None else cm.numel()) + 8 * B * n)
    flops = 2 * B * n * k * d + 2 * B * n * d + 2 * bc * k * d
    return nbytes, flops


class Tally:
    """Counts the launches of one kernel's wrapper function
    (``repro_torch.kernels.<name>.<name>``) over one pass of a path by
    the shape key that ``key`` gives its arguments, by wrapping the
    function for the length of a ``with`` block, and keeps a copy of the
    first inputs of each shape, so that they can be checked and timed."""

    def __init__(self, name: str, key):
        self.name, self.key = name, key
        self.shapes = {}

    def __enter__(self):
        import importlib
        self._module = importlib.import_module(
            f"repro_torch.kernels.{self.name}")
        self._fn = getattr(self._module, self.name)

        def counted(*args, **kw):
            key = self.key(*args)
            if key not in self.shapes:
                self.shapes[key] = [0, tuple(
                    a.clone() if torch.is_tensor(a) else a
                    for a in args + tuple(kw.values()))]
            self.shapes[key][0] += 1
            return self._fn(*args, **kw)

        setattr(self._module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self._module, self.name, self._fn)
        return False


def pdist_key(x, c, c_mask=None):
    return (x.shape[0] if x.dim() == 3 else 1, x.shape[-2], x.shape[-1],
            c.shape[-2], c.dim() == 2, c_mask is not None,
            str(x.dtype).replace("torch.", ""))


def kmeans_key(x, assign, k, weights=None):
    return (tuple(x.shape), int(k), weights is not None,
            str(x.dtype).replace("torch.", ""))


def combine_key(ybuf, slot, gates, top_k):
    return (tuple(ybuf.shape), slot.shape[0] // int(top_k), int(top_k),
            str(ybuf.dtype).replace("torch.", ""))


def solve_key(x, centers0, tau, center_mask, point_mask):
    return (tuple(x.shape), centers0.shape[1], tau.shape[0],
            str(x.dtype).replace("torch.", ""))


def tallied(fn):
    """Run ``fn`` once with the launches of pdist_argmin, kmeans_update,
    moe_combine and solve_attach tallied by shape: {kernel name:
    Tally}."""
    with Tally("pdist_argmin", pdist_key) as pd, \
            Tally("kmeans_update", kmeans_key) as km, \
            Tally("moe_combine", combine_key) as mc, \
            Tally("solve_attach", solve_key) as sa:
        fn()
        sync()
    return {"pdist_argmin": pd, "kmeans_update": km, "moe_combine": mc,
            "solve_attach": sa}


def counted(fn):
    """Run ``fn`` once between a reset and a read of the launch counts,
    with the launches of pdist_argmin, kmeans_update, moe_combine and
    solve_attach tallied by shape: (fn's result, {kernel: launches},
    tallies)."""
    from repro_torch.kernels import ops
    out = {}

    def run():
        ops.reset_launch_counts()
        out["result"] = fn()
        sync()
        out["counts"] = ops.launch_counts()

    tallies = tallied(run)
    return out["result"], out["counts"], tallies


def merged(tallies, name):
    """{shape key: {"launches": {path: count}, "inputs": first inputs}}
    of kernel ``name`` over the paths' tallies (a path that did not
    tally it is left out), the most launched first."""
    shapes = {}
    for path, by_kernel in tallies.items():
        if name not in by_kernel:
            continue
        for key, (count, inputs) in by_kernel[name].shapes.items():
            entry = shapes.setdefault(key, {"launches": {}, "inputs": inputs})
            entry["launches"][path] = count
    return dict(sorted(shapes.items(),
                       key=lambda kv: -sum(kv[1]["launches"].values())))


def tally_line(tallies, name, shape_name) -> str:
    return "; ".join(
        f"{path} " + json.dumps({shape_name(key): v[0] for key, v
                                 in by_kernel[name].shapes.items()})
        for path, by_kernel in tallies.items() if name in by_kernel)


def shape_name(key) -> str:
    B, n, d, k, shared, masked, dtype = key
    x = f"({n},{d})" if B == 1 and shared else f"({B},{n},{d})"
    c = f"({k},{d}) shared" if shared else f"({B},{k},{d})"
    return f"{x}x{c}{' +mask' if masked else ''} {dtype}"


def pdist_shapes(tallies, attach) -> None:
    """pdist_argmin at every shape that the round, serve and routed
    paths launched, on the first inputs the path gave it at that shape,
    and at the Theorem 3.2 attach of a round's devices (``attach``: the
    round's device centers (Z, k', d) against its tau (k, d); no path
    here drops a device): the device time by graph replay of the kernel
    and of cdist**2 + min beside the bound, and the kernel held against
    the exact (f64) distances (check_pdist_exact). Every shape is timed
    and printed before any check is required; the kernel's plans come
    last."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    shapes = merged(tallies, "pdist_argmin")
    x, c = attach
    key = (x.shape[0], x.shape[1], x.shape[2], c.shape[0], True, False,
           str(x.dtype).replace("torch.", ""))
    shapes.setdefault(key, {"launches": {}, "inputs": (x, c, None)})
    print("pdist tally: " + tally_line(tallies, "pdist_argmin", shape_name),
          flush=True)
    order = list(shapes)
    faults = []
    for key in order:
        launches = shapes[key]["launches"]
        x, c, cm = shapes[key]["inputs"]
        err, ratio, plain_ratio, vs_plain, ties, fault = check_pdist_exact(
            x, c, cm, shape_name(key))
        faults += fault
        bms, by = bound(*pdist_work(x, c, cm))
        dev_ms = graph_ms(lambda: pdist_argmin(x, c, cm))
        lib_ms = graph_ms(lambda: cdist_min(x, c))
        print(f"pdist {shape_name(key)}: launches {json.dumps(launches)}; "
              f"against the exact (f64) distances max_abs_err={err:.3e} "
              f"(x{ratio:.3f} of tol, {ties} ties) match={not fault}; the "
              f"f32 plain version x{plain_ratio:.3f} of tol from them, the "
              f"kernel x{vs_plain:.3f} from it | device ms={dev_ms:.4f} "
              f"cdist_min device ms={lib_ms:.4f} bound_ms={bms:.5f} ({by})",
              flush=True)
    from repro_torch.kernels.pdist_argmin import plan
    for key in order:
        B, n, d, k, shared = key[:5]
        x = shapes[key]["inputs"][0]
        p = plan(B, n, k, d, shared, x.dtype, x.device)
        print(f"pdist plan {shape_name(key)}: TK={p.tk} R={p.rows} "
              f"S={p.slices} F={p.parts} groups={p.groups}: {p.blocks} "
              f"blocks of {p.threads} threads, {p.smem_bytes} bytes of "
              f"shared memory, {p.per_sm} blocks an SM", flush=True)
    require(not faults, "; ".join(faults))


def check_pdist(x, c, cm, label):
    """The kernel against the plain version on the same inputs: indices
    exact except where the kernel's pick ties the plain minimum within
    the distance tolerance; distances within the tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    idx, val = pdist_argmin(x, c, cm)
    ridx, rval = ref.assign_argmin(x, c, cm)
    sync()
    diff = idx != ridx
    ties = int(diff.sum())
    if ties:
        d = ref.pairwise_sq_dists(x, c)
        at_k = torch.gather(d, -1, idx.long().unsqueeze(-1)).squeeze(-1)
        gap = (at_k - rval).abs().double()
        require(bool((gap <= dist_tol(x, c, ridx))[diff].all()),
                f"pdist_argmin {label}: {ties} indices differ beyond a tie")
    err, ratio = cancellation_err(val, rval, x, c, ridx)
    require(ratio <= 1.0, f"pdist_argmin {label}: distance error {err} "
                          f"above the tolerance (x{ratio:.2f})")
    return err, ratio, ties


def exact_sq_dists(x, c, cm):
    """The plain version's distances (ref.pairwise_sq_dists and the
    mask) evaluated in float64: exact up to f64 rounding."""
    from repro_torch.kernels import ref
    xd, cd = x.double(), c.double()
    d = (torch.sum(xd * xd, -1, keepdim=True)
         - 2.0 * (xd @ cd.transpose(-1, -2))
         + torch.sum(cd * cd, -1).unsqueeze(-2)).clamp_min(0.0)
    if cm is not None:
        d = torch.where(cm.unsqueeze(-2), d,
                        torch.full_like(d, ref.MASKED_DIST))
    return d


def check_pdist_exact(x, c, cm, label):
    """The kernel against the plain version's formula in float64 on the
    same inputs: indices exact except where the kernel's pick is within
    the distance tolerance of the exact minimum; distances within the
    tolerance of the exact ones, and no farther from them than the f32
    plain version's. At the paths' own inputs the f32 plain version is
    itself off by more than the tolerance on a few rows (its own
    rounding of 300-term products at these norms), so the exact
    distances are the yardstick there. Returns (max |kernel - exact|,
    its worst ratio to the tolerance, the f32 plain version's worst
    ratio, the kernel's worst ratio to the f32 plain version, ties, the
    list of faults found)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    idx, val = pdist_argmin(x, c, cm)
    ridx, rval = ref.assign_argmin(x, c, cm)
    sync()
    d = exact_sq_dists(x, c, cm)
    emin, eidx = torch.min(d, dim=-1)
    diff = idx.long() != eidx
    ties = int(diff.sum())
    tol = dist_tol(x, c, eidx)
    faults = []
    if ties:
        at_k = torch.gather(d, -1, idx.long().unsqueeze(-1)).squeeze(-1)
        if not bool(((at_k - emin).abs() <= tol)[diff].all()):
            faults.append(f"pdist_argmin {label}: {ties} indices differ "
                          f"beyond a tie")
    err = (val.double() - emin).abs()
    ratio = float((err / tol).max())
    plain_ratio = float(((rval.double() - emin).abs() / tol).max())
    if ratio > 1.0:
        faults.append(f"pdist_argmin {label}: distance error "
                      f"{float(err.max())} from the exact distance above "
                      f"the tolerance (x{ratio:.2f})")
    if ratio > plain_ratio:
        faults.append(f"pdist_argmin {label}: x{ratio:.3f} of the "
                      f"tolerance from the exact distances, farther than "
                      f"the f32 plain version's x{plain_ratio:.3f}")
    _, vs_plain = cancellation_err(val, rval, x, c, ridx)
    return float(err.max()), ratio, plain_ratio, vs_plain, ties, faults


def update_tol(x, w, sums):
    """check_update's tolerance of sums against ``sums``: 1e-5 relative
    + n * 1e-7 * max|x| * max w absolute (f32 summation of n terms in
    another order)."""
    n = x.shape[-2]
    scale = float(x.float().abs().max()) * (1.0 if w is None
                                            else float(w.max()))
    return 1e-5 * sums.abs() + n * 1e-7 * scale


def count_tol(x, counts) -> float:
    return 1e-5 * float(counts.abs().max()) + x.shape[-2] * 1e-7


def check_update(x, a, k, w, label):
    """Sums within update_tol of the plain version's, counts likewise."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_update import kmeans_update
    s, cnt = kmeans_update(x, a, k, w)
    rs, rc = ref.kmeans_update(x, a, k, w)
    sync()
    err = float((s - rs).abs().max())
    require(bool(((s - rs).abs() <= update_tol(x, w, rs)).all()),
            f"kmeans_update {label}: sums differ by {err}")
    cerr = float((cnt - rc).abs().max())
    require(cerr <= count_tol(x, rc),
            f"kmeans_update {label}: counts differ by {cerr}")
    return max(err, cerr)


def exact_update(x, a, k, w):
    """The plain version's one-hot product evaluated in float64."""
    cols = torch.arange(k, device=a.device, dtype=a.dtype)
    oh = (a.unsqueeze(-1) == cols).double()
    if w is not None:
        oh = oh * w.double().unsqueeze(-1)
    return oh.transpose(-1, -2) @ x.double(), torch.sum(oh, dim=-2)


def check_update_exact(x, a, k, w, label):
    """The kernel against the sums and counts taken in float64 and
    against the f32 plain version, each within check_update's tolerance,
    and two calls bit for bit. Returns {err: max |sums - f64|, ratio:
    its worst ratio to the tolerance, plain_ratio: the f32 plain
    version's, vs_plain: the kernel's worst ratio to the f32 plain
    version, cerr: max |counts - f64|, same: two calls equal bit for
    bit, faults: the list of faults found}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_update import kmeans_update
    s, cnt = kmeans_update(x, a, k, w)
    s2, cnt2 = kmeans_update(x, a, k, w)
    rs, rc = ref.kmeans_update(x, a, k, w)
    es, ec = exact_update(x, a, k, w)
    sync()
    err = (s.double() - es).abs()
    ratio = float((err / update_tol(x, w, es)).max())
    plain_ratio = float(((rs.double() - es).abs()
                         / update_tol(x, w, es)).max())
    vs_plain = float(((s - rs).abs() / update_tol(x, w, rs)).max())
    cerr = float((cnt.double() - ec).abs().max())
    same = (torch.equal(s.view(torch.int32), s2.view(torch.int32))
            and torch.equal(cnt.view(torch.int32), cnt2.view(torch.int32)))
    faults = []
    if ratio > 1.0:
        faults.append(f"kmeans_update {label}: sums x{ratio:.3f} of the "
                      f"tolerance from the f64 sums")
    if vs_plain > 1.0:
        faults.append(f"kmeans_update {label}: sums x{vs_plain:.3f} of the "
                      f"tolerance from the f32 plain version")
    if cerr > count_tol(x, ec) or float((cnt - rc).abs().max()) > count_tol(
            x, rc):
        faults.append(f"kmeans_update {label}: counts differ by {cerr}")
    if not same:
        faults.append(f"kmeans_update {label}: two calls differ")
    return dict(err=float(err.max()), ratio=ratio, plain_ratio=plain_ratio,
                vs_plain=vs_plain, cerr=cerr, same=same, faults=faults)


def index_add_update(x, a, k, w):
    """The library yardstick of kmeans_update: a call computing the same
    sums and counts with index_add_ (a weighted x first where there are
    weights); rows at -1 go to a spare row. The index is made here,
    outside the timed call."""
    B = x.shape[0] if x.dim() == 3 else 1
    d = x.shape[-1]
    base = (torch.arange(B, device=a.device, dtype=a.dtype) * k).view(
        *a.shape[:-1], 1) if x.dim() == 3 else 0
    idx = torch.where(a >= 0, a + base, B * k).reshape(-1)
    flat = x.reshape(-1, d)
    ww = (torch.ones(idx.shape, device=x.device) if w is None
          else w.reshape(-1))

    def call():
        rows = flat if w is None else flat * ww.unsqueeze(-1)
        s = torch.zeros((B * k + 1, d), device=x.device,
                        dtype=rows.dtype).index_add_(0, idx, rows)
        c = torch.zeros((B * k + 1,), device=x.device).index_add_(0, idx, ww)
        return s, c

    return call


def update_work(x, a, k, w, valid_only: bool):
    """(bytes, flops) of one kmeans_update call: the assignment and the
    weights read once, the rows of x (only those whose assignment is
    valid with ``valid_only``, else all of x) read once, the sums and
    counts written once; one add (an FMA with weights) an element."""
    B = x.shape[0] if x.dim() == 3 else 1
    n, d = x.shape[-2:]
    rows = int(((a >= 0) & (a < k)).sum()) if valid_only else B * n
    nbytes = (4 * B * n * (1 if w is None else 2)
              + x.element_size() * rows * d + 4 * B * k * (d + 1))
    return nbytes, rows * d * (1 if w is None else 2)


def kmeans_name(key) -> str:
    shape, k, weighted, dtype = key
    return (f"({','.join(map(str, shape))}) k={k}"
            f"{' weighted' if weighted else ''} {dtype}")


def kmeans_shapes(tallies) -> None:
    """kmeans_update at every shape that the round, serve and routed
    paths launched, on the first inputs the path gave it there: the
    rows at -1, the device time by graph replay of the kernel and of the
    index_add_ call beside two bounds (the rows whose assignment is
    valid, and all of x), and the kernel held against the f64 sums and
    the f32 plain version (check_update_exact). Every shape is timed and
    printed before any check is required; the kernel's plans come
    last."""
    from repro_torch.kernels.kmeans_update import kmeans_update
    shapes = merged(tallies, "kmeans_update")
    print("kmeans tally: " + tally_line(tallies, "kmeans_update",
                                        kmeans_name), flush=True)
    faults = []
    for key, entry in shapes.items():
        x, a, k, w = entry["inputs"]
        invalid = int((a < 0).sum())
        flat = (a + k * torch.arange(a.numel() // a.shape[-1], device=a.device
                                     ).view(*a.shape[:-1], 1))[a >= 0]
        longest = int(torch.bincount(flat).max()) if flat.numel() else 0
        r = check_update_exact(x, a, k, w, kmeans_name(key))
        faults += r["faults"]
        bms, by = bound(*update_work(x, a, k, w, True))
        bms_all, _ = bound(*update_work(x, a, k, w, False))
        dev_ms = graph_ms(lambda: kmeans_update(x, a, k, w))
        lib_ms = graph_ms(index_add_update(x, a, k, w))
        print(f"kmeans {kmeans_name(key)}: launches "
              f"{json.dumps(entry['launches'])}; {invalid} of {a.numel()} "
              f"rows at -1, the longest list {longest} rows; against the f64 sums max_abs_err="
              f"{r['err']:.3e} (x{r['ratio']:.3f} of tol), counts "
              f"max_abs_err={r['cerr']:.3e}, two calls bitwise equal="
              f"{r['same']}, match={not r['faults']}; the f32 plain version "
              f"x{r['plain_ratio']:.3f} of tol from them, the kernel "
              f"x{r['vs_plain']:.3f} from it | device ms={dev_ms:.4f} "
              f"index_add "
              f"device ms={lib_ms:.4f} bound_ms={bms:.5f} ({by}, valid rows)"
              f" bound_ms all of x={bms_all:.5f}", flush=True)
    from repro_torch.kernels.kmeans_update import plan
    for key, entry in shapes.items():
        x, a, k, w = entry["inputs"]
        B = x.shape[0] if x.dim() == 3 else 1
        n, d = x.shape[-2:]
        p = plan(B, n, k, d, w is not None, x.device)
        print(f"kmeans plan {kmeans_name(key)}: {p.describe()}", flush=True)
    require(not faults, "; ".join(faults))


def combine_name(key) -> str:
    (S, d), tokens, top_k, dtype = key
    return f"({S},{d}) {dtype} top_k={top_k} tokens={tokens}"


def embedding_bag_combine(ybuf, slot, gates, top_k):
    """The library yardstick of moe_combine: one F.embedding_bag over
    the clipped slots with the gates as per-sample weights (in ybuf's
    dtype, so its output is ybuf's dtype), timed only."""
    import torch.nn.functional as F
    T = slot.shape[0] // top_k
    idx = torch.clamp(slot, 0, ybuf.shape[0] - 1).long().view(T, top_k)
    w = gates.to(ybuf.dtype).view(T, top_k)
    return lambda: F.embedding_bag(idx, ybuf, per_sample_weights=w,
                                   mode="sum")


def combine_work(ybuf, slot, top_k):
    """(bytes, flops) of one moe_combine call: each distinct row that a
    choice names read once (zero gates included: 0 * inf must give
    NaN), slot and gates read once, the f32 output written once; a
    multiply and an add an element of each choice."""
    S, d = ybuf.shape
    N = slot.shape[0]
    rows = int(torch.unique(torch.clamp(slot, 0, S - 1)).numel())
    nbytes = ybuf.element_size() * rows * d + 4 * (N // top_k) * d + 8 * N
    return nbytes, 2 * N * d


def combine_shapes(tallies) -> None:
    """moe_combine at every shape that the routed serve path and the
    decode leg (its prefill and its steps) launched, on the first inputs
    the path gave it there: the kernel against the plain version bit for
    bit (the paths launch top_k <= 2, where the kernel's sum in j order
    is the plain version's), two calls bit for bit, the device time by
    graph replay of the kernel and of one F.embedding_bag (each the
    median of three captures) beside the bound. Every shape is timed and
    printed before any check is required; the kernel's plans come
    last."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_combine import moe_combine
    shapes = merged(tallies, "moe_combine")
    print("combine tally: " + tally_line(tallies, "moe_combine",
                                         combine_name), flush=True)
    faults = []
    for key, entry in shapes.items():
        ybuf, slot, gates, top_k = entry["inputs"]
        got = moe_combine(ybuf, slot, gates, top_k)
        again = moe_combine(ybuf, slot, gates, top_k)
        want = ref.moe_combine(ybuf, slot, gates, top_k)
        sync()
        exact = same_bits((got,), (want,))
        twice = same_bits((got,), (again,))
        err = float((got - want).abs().nan_to_num(0.0).max())
        if not (exact and twice):
            faults.append(f"moe_combine {combine_name(key)}: bitwise equal "
                          f"to the plain version={exact}, two calls={twice}")
        nbytes, flops = combine_work(ybuf, slot, top_k)
        bms, by = bound(nbytes, flops)
        # Each the median of three graph captures: after the decode leg,
        # a single capture at the prefill shape can read far slower.
        dev = sorted(graph_ms(lambda: moe_combine(ybuf, slot, gates, top_k))
                     for _ in range(3))
        lib = sorted(graph_ms(embedding_bag_combine(ybuf, slot, gates, top_k))
                     for _ in range(3))
        print(f"combine {combine_name(key)}: launches "
              f"{json.dumps(entry['launches'])}; {slot.shape[0] // top_k} "
              f"tokens, {int((gates == 0).sum())} of {slot.shape[0]} gates "
              f"0; bitwise equal to the plain version={exact}, two calls "
              f"bitwise equal={twice}, max_abs_err={err:.3e} | device "
              f"ms={dev[1]:.5f} ({dev[0]:.5f}-{dev[2]:.5f} over three "
              f"captures) embedding_bag device ms={lib[1]:.5f} "
              f"({lib[0]:.5f}-{lib[2]:.5f}; "
              f"{str(ybuf.dtype).replace('torch.', '')} out) "
              f"bound_ms={bms:.5f} ({by}, {nbytes} bytes)", flush=True)
    from repro_torch.kernels.moe_combine import plan
    for key, entry in shapes.items():
        ybuf, slot, _, top_k = entry["inputs"]
        p = plan(slot.shape[0] // top_k, ybuf.shape[1], top_k, ybuf.dtype,
                 ybuf.device)
        print(f"combine plan {combine_name(key)}: {p.describe()}",
              flush=True)
    require(not faults, "; ".join(faults))


def check_solve(x, c0, tau, cm, pm, dtype, max_iters):
    """Labels and center labels exact; centers within 1e-5 relative to
    their largest entry; distances within the cancellation tolerance."""
    from repro_torch.kernels import ops, ref
    got = ops.solve_attach(x, c0, tau, cm, pm, max_iters=max_iters,
                           dtype=dtype)
    want = ref.solve_attach(x, c0, tau, cm, pm, max_iters=max_iters,
                            dtype=dtype)
    sync()
    nlab = int((got[0] != want[0]).sum())
    require(nlab == 0, f"solve_attach {dtype}: {nlab} labels differ")
    require(bool((got[3] == want[3]).all()),
            f"solve_attach {dtype}: center labels differ")
    cerr = float((got[2] - want[2]).abs().max())
    require(cerr <= 1e-5 * float(want[2].abs().max()),
            f"solve_attach {dtype}: centers differ by {cerr}")
    xs = x.to(ref.store_dtype(dtype)).float()
    a, _ = ref.assign_argmin(xs, want[2], cm)
    err, ratio = cancellation_err(got[1], want[1], xs, want[2], a)
    require(ratio <= 1.0, f"solve_attach {dtype}: distance error {err} "
                          f"above the tolerance (x{ratio:.2f})")
    return max(err, cerr)


def same_bits(got, want) -> bool:
    """All outputs of two solve_attach calls equal bit for bit."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def solve_work(x, c0, tau, cm, pm, max_iters: int):
    """(each request's Lloyd iterations, (bytes, flops)) of one
    solve_attach call: each input read once, each output written once,
    and the products of the iterations these inputs need (the work
    depends on the data)."""
    from repro_torch.core.lloyd import lloyd
    iters = lloyd(x, c0, center_mask=cm, point_mask=pm,
                  max_iters=max_iters).iters
    it = int(iters.sum())
    esz = x.element_size()
    (B, n, d), kp, k = x.shape, c0.shape[1], tau.shape[0]
    nbytes = (esz * (B * n * d + B * kp * d + k * d) + B * (kp + n)
              + 4 * (2 * B * n + B * kp * d + B * kp))
    flops = ((it + B) * 2 * n * kp * d + it * n * d + B * 2 * n * d
             + B * 2 * kp * k * d)
    return iters, (nbytes, flops)


def solve_kernel(fm, dev, rounds: int):
    """solve_attach at the serve shape (8 late devices of 1024 points,
    started from their Algorithm 1 steps 1-3 core-set means, against
    the round's k = 100 tau) in f32 and bf16, and at the routed shape (64
    requests of 64 points, d = 128, k' = 4, k = 16): each against its
    plain version; at the serve shape also each request alone against
    the batch and two calls against each other, bit for bit. Times: CUDA
    events over back-to-back wrapper calls, and the device time. Returns
    the f32 serve-shape row."""
    from repro_torch.core.local_kmeans import local_prepare
    from repro_torch.data.gaussian import late_device_stream
    from repro_torch.kernels import ref
    from repro_torch.kernels.solve_attach import plan, solve_attach
    from repro_torch.utils.prng import GumbelSource
    reqs = late_device_stream(fm.means, KP, 8, 99,
                              n_range=(SERVE_N, SERVE_N + 1))
    sx = torch.as_tensor(np.stack([r[0] for r in reqs]), device=dev)
    skv = torch.as_tensor([r[2] for r in reqs], dtype=torch.int32,
                          device=dev)
    spm = torch.ones(sx.shape[:2], dtype=torch.bool, device=dev)
    g = GumbelSource(0).draw(range(8), KP, SERVE_N, dev)
    prep = local_prepare(g, sx, k_max=KP, k_valid=skv, point_mask=spm)
    c0, scm = prep.theta.contiguous(), prep.center_mask.contiguous()
    stau = torch.as_tensor(fm.means, device=dev)
    out = {}
    for dtype in ("f32", "bf16"):
        err = check_solve(sx, c0, stau, scm, spm, dtype, 100)
        store = ref.store_dtype(dtype)
        args = (sx.to(store), c0.to(store), stau.to(store), scm, spm)

        def call(lo=0, hi=8):
            return solve_attach(args[0][lo:hi], args[1][lo:hi], args[2],
                                args[3][lo:hi], args[4][lo:hi],
                                max_iters=100)

        whole, again = call(), call()
        sync()
        require(same_bits(whole, again),
                f"solve_attach {dtype}: two calls differ")
        for b in range(8):
            require(same_bits(call(b, b + 1), [w[b:b + 1] for w in whole]),
                    f"solve_attach {dtype}: request {b} alone differs from "
                    f"the batch")
        ms = time_ms(call, rounds)
        dev_ms = graph_ms(call)
        plain = time_ms(lambda: ref.solve_attach(
            sx, c0, stau, scm, spm, max_iters=100, dtype=dtype),
            max(2, rounds // 4))
        iters, work = solve_work(*args, 100)
        bms, by = bound(*work)
        sb, sn = sx.shape[:2]
        pl = plan(sn, KP, D, store, dev)
        groups = min(sb, pl.groups)
        print(f"kernel solve_attach {dtype}: {tuple(sx.shape)} k'={KP} k={K} "
              f"iterations={iters.tolist()} max_abs_err={err:.3e} "
              f"match=True; each request alone equals the batch and two "
              f"calls are equal, bit for bit | ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bms:.5f} ({by}) | device "
              f"time by CUDA graph replay {dev_ms:.4f} ms | P={pl.slices} "
              f"slices of "
              f"R={pl.rows} rows, mode "
              f"{'resident' if pl.resident else 'streaming'}, "
              f"{pl.smem_bytes} bytes of shared memory a block, "
              f"{pl.per_sm} blocks an SM: {groups} groups of {pl.slices} "
              f"({pl.groups} fit at once), {groups * pl.slices} blocks on "
              f"{pl.sms} SMs", flush=True)
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=None,
                          device_ms=dev_ms)

    # The routed shape: one batch of the routed leg's plan.
    gen = torch.Generator(device=dev).manual_seed(4)
    B, n = R_PLAN["batch_size"], R_PLAN["bucket_sizes"][0]
    rtau = torch.randn(R_K, R_D, generator=gen, device=dev) * 20
    lab = torch.randint(0, R_K, (B, n), generator=gen, device=dev)
    rx = rtau[lab] + torch.randn(B, n, R_D, generator=gen, device=dev)
    rc0 = rx[:, :R_KP].contiguous()
    rcm = torch.ones((B, R_KP), dtype=torch.bool, device=dev)
    rpm = torch.rand(B, n, generator=gen, device=dev) < 0.7
    err = check_solve(rx, rc0, rtau, rcm, rpm, "f32", 100)
    ms = time_ms(lambda: solve_attach(rx, rc0, rtau, rcm, rpm,
                                      max_iters=100), rounds)
    dev_ms = graph_ms(lambda: solve_attach(rx, rc0, rtau, rcm, rpm,
                                           max_iters=100))
    plain = time_ms(lambda: ref.solve_attach(rx, rc0, rtau, rcm, rpm,
                                             max_iters=100), rounds)
    pl = plan(n, R_KP, R_D, torch.float32, dev)
    print(f"kernel solve_attach routed f32: {tuple(rx.shape)} k'={R_KP} "
          f"k={R_K} max_abs_err={err:.3e} match=True | ms={ms:.4f} "
          f"plain_ms={plain:.4f} | device time by CUDA graph replay "
          f"{dev_ms:.4f} ms | "
          f"P={pl.slices}, {min(B, pl.groups)} groups, "
          f"{min(B, pl.groups) * pl.slices} blocks", flush=True)
    return out["f32"]


def kernel_phase(fm, dev, rounds: int):
    """Each kernel against its plain version on the card at the main
    path's shapes, then its time, the plain version's, one library
    call's, and its bound. Returns the rows of the kernels line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_update import kmeans_update
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    rows = {}

    # pdist_argmin: Algorithm 1's assignment (50 devices x 400 points
    # against their 10 centers) and the server's (500 device centers
    # against the k = 100 seeds).
    x = torch.as_tensor(fm.data, device=dev)
    B, n, d = x.shape
    c = x[:, ::N_PER].contiguous()                 # one point per component
    cm = torch.ones((B, KP), dtype=torch.bool, device=dev)
    cm[::7, -1] = False
    xs = c.reshape(-1, d).contiguous()             # server: 500 x 300
    means = torch.as_tensor(fm.means, device=dev)
    e1, r1, t1 = check_pdist(x, c, cm, "local")
    e2, r2, t2 = check_pdist(xs, means, None, "server")
    ms = time_ms(lambda: pdist_argmin(x, c, cm), rounds)
    plain = time_ms(lambda: ref.assign_argmin(x, c, cm), rounds)
    lib = time_ms(lambda: cdist_min(x, c), rounds)
    dev_ms = graph_ms(lambda: pdist_argmin(x, c, cm))
    ms_s = time_ms(lambda: pdist_argmin(xs, means), rounds)
    bms, by = bound(*pdist_work(x, c, cm))
    print(f"kernel pdist_argmin: local {tuple(x.shape)}x{tuple(c.shape)} "
          f"max_abs_err={e1:.3e} (x{r1:.3f} of tol, {t1} ties) "
          f"server {tuple(xs.shape)}x{tuple(means.shape)} "
          f"max_abs_err={e2:.3e} "
          f"(x{r2:.3f}, {t2} ties) match=True | local ms={ms:.4f} "
          f"plain_ms={plain:.4f} cdist_min_ms={lib:.4f} bound_ms={bms:.5f} "
          f"({by}) | device time by CUDA graph replay {dev_ms:.4f} ms | "
          f"server ms={ms_s:.4f}; every path shape: the pdist line",
          flush=True)
    rows["pdist_argmin"] = dict(
        max_abs_err=max(e1, e2), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, device_ms=dev_ms)

    # kmeans_update: the local update (assignments of the check above)
    # and the server's weighted one-round update.
    a, _ = ref.assign_argmin(x, c, cm)
    sa, _ = ref.assign_argmin(xs, means)
    w = torch.as_tensor(np.random.default_rng(0).integers(
        1, 40, size=xs.shape[0]).astype(np.float32), device=dev)
    e1 = check_update(x, a, KP, None, "local")
    e2 = check_update(xs, sa, K, w, "server")
    ms = time_ms(lambda: kmeans_update(x, a, KP), rounds)
    plain = time_ms(lambda: ref.kmeans_update(x, a, KP), rounds)
    flat_idx = (a + KP * torch.arange(B, device=dev)[:, None]).reshape(-1)
    flat_x = x.reshape(-1, d)
    ones = torch.ones(B * n, device=dev)

    def library_update():
        s = torch.zeros((B * KP, d), device=dev).index_add_(0, flat_idx,
                                                            flat_x)
        cnt = torch.zeros((B * KP,), device=dev).index_add_(0, flat_idx, ones)
        return s, cnt

    lib = time_ms(library_update, rounds)
    dev_ms = graph_ms(lambda: kmeans_update(x, a, KP))
    dev_lib = graph_ms(library_update)
    ms_s = time_ms(lambda: kmeans_update(xs, sa, K, w), rounds)
    dev_s = graph_ms(lambda: kmeans_update(xs, sa, K, w))
    nbytes = 4 * (B * n * d + B * n + B * KP * d + B * KP)
    flops = 2 * B * n * d
    bms, by = bound(nbytes, flops)
    print(f"kernel kmeans_update: local {tuple(x.shape)} k={KP} "
          f"max_abs_err={e1:.3e} server {tuple(xs.shape)} k={K} weighted "
          f"max_abs_err={e2:.3e} match=True | local ms={ms:.4f} "
          f"plain_ms={plain:.4f} index_add_ms={lib:.4f} "
          f"bound_ms={bms:.5f} ({by}) | server ms={ms_s:.4f} | device time "
          f"by CUDA graph replay: local ms={dev_ms:.4f} "
          f"index_add_ms={dev_lib:.4f} server ms={dev_s:.4f}", flush=True)
    rows["kmeans_update"] = dict(
        max_abs_err=max(e1, e2), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, device_ms=dev_ms)

    rows["solve_attach"] = solve_kernel(fm, dev, rounds)
    rows.update(routing_kernels(dev, rounds))
    moe_prefill_kernels(dev, rounds)
    rows["swa_decode"] = swa_kernel(dev, rounds)
    return rows


def routing_inputs(rng, B: int, k: int, C: int):
    """The routed step's routing of B requests voting at random among k
    clusters with C queue slots each: (src (k*C,) int32, valid (k*C,)
    bool, slot (B,) int32, gates (B,) f32), as fed/plane.py builds
    them."""
    cluster = rng.integers(0, k, size=B)
    pos = np.zeros(B, np.int64)
    seen = np.zeros(k, np.int64)
    for i, c in enumerate(cluster):
        pos[i] = seen[c]
        seen[c] += 1
    kept = pos < C
    slot = cluster * C + pos
    src = np.zeros(k * C, np.int32)
    valid = np.zeros(k * C, bool)
    src[slot[kept]] = np.nonzero(kept)[0]
    valid[slot[kept]] = True
    return (src, valid, np.where(kept, slot, 0).astype(np.int32),
            kept.astype(np.float32))


def routing_kernels(dev, rounds: int):
    """moe_dispatch and moe_combine at the shapes of the routed leg's
    step (64 requests of 64 points x 128 features, k=16 queues of C=5):
    the data dispatch (64, 8192) -> (80, 8192), the mask dispatch
    (64, 64) -> (80, 64), the combine (80, 128) -> (64, 128) at top_k=1;
    plus a top_k=2 and a bf16 check. The library call is one
    F.embedding_bag (a weighted row gather-sum), timed only."""
    import torch.nn.functional as F

    from repro_torch.fed.plane import route_capacity
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_combine import moe_combine
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    rng = np.random.default_rng(3)
    B, n, k = R_PLAN["batch_size"], R_PLAN["bucket_sizes"][0], R_K
    C = route_capacity(B, k, 1.25)
    S = k * C
    src, valid, slot, gates = (torch.as_tensor(a, device=dev)
                               for a in routing_inputs(rng, B, k, C))
    x = torch.as_tensor(rng.normal(size=(B, n * R_D)).astype(np.float32),
                        device=dev)
    pm = torch.as_tensor(rng.random((B, n)) < 0.7, device=dev).float()
    rows = {}

    derr = 0.0
    for label, xx in (("data f32", x), ("mask f32", pm),
                      ("data bf16", x.to(torch.bfloat16))):
        got, want = moe_dispatch(xx, src, valid), ref.moe_dispatch(xx, src,
                                                                   valid)
        sync()
        require(torch.equal(got, want), f"moe_dispatch {label}: differs "
                                        f"from the plain version")
        derr = max(derr, float((got.float() - want.float()).abs().max()))
    ms = time_ms(lambda: moe_dispatch(x, src, valid), rounds)
    plain = time_ms(lambda: ref.moe_dispatch(x, src, valid), rounds)
    idx = torch.clamp(src, 0, B - 1).long().view(-1, 1)
    w = valid.float().view(-1, 1)
    lib = time_ms(lambda: F.embedding_bag(idx, x, per_sample_weights=w,
                                          mode="sum"), rounds)
    ms_mask = time_ms(lambda: moe_dispatch(pm, src, valid), rounds)
    dev_ms = graph_ms(lambda: moe_dispatch(x, src, valid))
    dev_lib = graph_ms(lambda: F.embedding_bag(idx, x, per_sample_weights=w,
                                               mode="sum"))
    rows_read = int(torch.unique(src[valid]).numel())
    d = x.shape[1]
    nbytes = 4 * (rows_read * d + S * d) + 5 * S
    bms, by = bound(nbytes, 0)
    print(f"kernel moe_dispatch: data {tuple(x.shape)} -> ({S}, {d}) f32, "
          f"{int(valid.sum())} valid slots; mask {tuple(pm.shape)}; data "
          f"bf16; max_abs_err={derr:.1e} (bitwise) match=True | data "
          f"ms={ms:.4f} "
          f"plain_ms={plain:.4f} embedding_bag_ms={lib:.4f} "
          f"bound_ms={bms:.5f} ({by}, {nbytes} bytes) | mask "
          f"ms={ms_mask:.4f} | device time by CUDA graph replay: data "
          f"ms={dev_ms:.4f} embedding_bag_ms={dev_lib:.4f}", flush=True)
    rows["moe_dispatch"] = dict(max_abs_err=derr, ms=ms, plain_ms=plain,
                                bound_ms=bms, bound_by=by, library_ms=lib,
                                device_ms=dev_ms)

    ybuf = torch.as_tensor(rng.normal(size=(S, R_D)).astype(np.float32),
                           device=dev)
    err = 0.0
    for label, yy, sl, g, top_k in (
            ("f32 top_k=1", ybuf, slot, gates, 1),
            ("bf16 top_k=1", ybuf.to(torch.bfloat16), slot, gates, 1),
            ("f32 top_k=2", ybuf,
             torch.as_tensor(rng.integers(0, S, 2 * B), dtype=torch.int32,
                             device=dev),
             torch.as_tensor(rng.random(2 * B), dtype=torch.float32,
                             device=dev), 2)):
        got = moe_combine(yy, sl, g, top_k)
        want = ref.moe_combine(yy, sl, g, top_k)
        sync()
        require(same_bits((got,), (want,)),
                f"moe_combine {label}: differs from the plain version")
        err = max(err, float((got - want).abs().max()))
    ms = time_ms(lambda: moe_combine(ybuf, slot, gates, 1), rounds)
    plain = time_ms(lambda: ref.moe_combine(ybuf, slot, gates, 1), rounds)
    cidx = torch.clamp(slot, 0, S - 1).long().view(-1, 1)
    lib = time_ms(lambda: F.embedding_bag(cidx, ybuf,
                                          per_sample_weights=gates.view(-1, 1),
                                          mode="sum"), rounds)
    dev_ms = graph_ms(lambda: moe_combine(ybuf, slot, gates, 1))
    dev_lib = graph_ms(lambda: F.embedding_bag(
        cidx, ybuf, per_sample_weights=gates.view(-1, 1), mode="sum"))
    rows_read = int(torch.unique(cidx).numel())
    nbytes = 4 * (rows_read * R_D + B * R_D) + 8 * B
    bms, by = bound(nbytes, 2 * B * R_D)
    print(f"kernel moe_combine: ybuf {tuple(ybuf.shape)} -> ({B}, {R_D}) "
          f"top_k=1 f32 and bf16, top_k=2 f32, each bitwise; "
          f"max_abs_err={err:.3e} match=True | ms={ms:.4f} "
          f"plain_ms={plain:.4f} embedding_bag_ms={lib:.4f} "
          f"bound_ms={bms:.6f} ({by}, {nbytes} bytes) | device time by CUDA "
          f"graph replay: ms={dev_ms:.4f} embedding_bag_ms={dev_lib:.4f}",
          flush=True)
    rows["moe_combine"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bms, bound_by=by, library_ms=lib,
                               device_ms=dev_ms)
    return rows


def moe_prefill_kernels(dev, rounds: int) -> None:
    """moe_dispatch and moe_combine at the decode leg's prefill shape:
    16384 tokens (4 x 4096) of d=4096 bf16 routed top-2 among Mixtral's
    8 experts into queues of C=5120 slots (capacity factor 1.25), by the
    model's own routing (models/moe.py _route and _plan)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_combine import moe_combine
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x7b")
    m, d = cfg.moe, cfg.d_model
    T = MX_BATCH * MX_PROMPT
    C = moe._capacity(T, m)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(T, d, generator=g, device=dev).to(torch.bfloat16)
    router = (torch.randn(d, m.n_experts, generator=g, device=dev)
              * 0.006).to(torch.bfloat16)
    ids, gates, _ = moe._route(router, x, m)
    src, valid, flat_e, pos_c, keep = moe._plan(ids, m, C)
    S = src.shape[0]
    got, want = moe_dispatch(x, src, valid), ref.moe_dispatch(x, src, valid)
    sync()
    require(torch.equal(got, want), "moe_dispatch prefill: differs from the "
                                    "plain version")
    ms = time_ms(lambda: moe_dispatch(x, src, valid), rounds)
    plain = time_ms(lambda: ref.moe_dispatch(x, src, valid), rounds)
    idx = torch.clamp(src, 0, T - 1).long().view(-1, 1)
    w = valid.to(x.dtype).view(-1, 1)
    lib = time_ms(lambda: F.embedding_bag(idx, x, per_sample_weights=w,
                                          mode="sum"), rounds)
    dev_ms = graph_ms(lambda: moe_dispatch(x, src, valid))
    dev_lib = graph_ms(lambda: F.embedding_bag(idx, x, per_sample_weights=w,
                                               mode="sum"))
    nbytes = 2 * (int(torch.unique(src[valid]).numel()) * d + S * d) + 5 * S
    bms, by = bound(nbytes, 0)
    print(f"kernel moe_dispatch mixtral prefill: x {tuple(x.shape)} bf16 -> "
          f"({S}, {d}) = {m.n_experts} experts x C={C}, "
          f"{int(valid.sum())} valid slots; bitwise match=True | "
          f"ms={ms:.4f} plain_ms={plain:.4f} embedding_bag_ms={lib:.4f} "
          f"bound_ms={bms:.5f} ({by}, {nbytes} bytes) | device time by CUDA "
          f"graph replay: ms={dev_ms:.4f} embedding_bag_ms={dev_lib:.4f}",
          flush=True)

    ybuf = torch.randn(S, d, generator=g, device=dev).to(torch.bfloat16)
    slot = (flat_e * C + pos_c).to(torch.int32)
    wk = torch.where(keep, gates.reshape(-1), 0.0).float()
    got = moe_combine(ybuf, slot, wk, m.top_k)
    want = ref.moe_combine(ybuf, slot, wk, m.top_k)
    sync()
    require(same_bits((got,), (want,)),
            "moe_combine prefill: differs from the plain version")
    err = (got - want).abs()
    ms = time_ms(lambda: moe_combine(ybuf, slot, wk, m.top_k), rounds)
    plain = time_ms(lambda: ref.moe_combine(ybuf, slot, wk, m.top_k), rounds)
    cidx = torch.clamp(slot, 0, S - 1).long().view(T, m.top_k)
    cw = wk.to(ybuf.dtype).view(T, m.top_k)
    lib = time_ms(lambda: F.embedding_bag(cidx, ybuf, per_sample_weights=cw,
                                          mode="sum"), rounds)
    dev_ms = graph_ms(lambda: moe_combine(ybuf, slot, wk, m.top_k))
    dev_lib = graph_ms(lambda: F.embedding_bag(cidx, ybuf,
                                               per_sample_weights=cw,
                                               mode="sum"))
    rows_read = int(torch.unique(slot[keep]).numel())
    nbytes = 2 * rows_read * d + 4 * T * d + 8 * T * m.top_k
    bms, by = bound(nbytes, 2 * T * m.top_k * d)
    print(f"kernel moe_combine mixtral prefill: ybuf {tuple(ybuf.shape)} bf16 "
          f"-> ({T}, {d}) f32, top_k={m.top_k}, {int(keep.sum())} of "
          f"{T * m.top_k} choices kept; max_abs_err={float(err.max()):.3e} "
          f"(bitwise) match=True | ms={ms:.4f} "
          f"plain_ms={plain:.4f} embedding_bag_ms={lib:.4f} (bf16 out) "
          f"bound_ms={bms:.5f} ({by}, {nbytes} bytes) | device time by CUDA "
          f"graph replay: ms={dev_ms:.4f} embedding_bag_ms={dev_lib:.4f}",
          flush=True)


def swa_inputs(g, dev, b, h, kvh, dh, W, dtype):
    """q, kw, vw drawn on the card, and a ring's bias: about a quarter of
    the slots empty, scattered, and row 0's first 64 slots all empty."""
    q = torch.randn(b, h, dh, generator=g, device=dev).to(dtype)
    kw = torch.randn(b, W, kvh, dh, generator=g, device=dev).to(dtype)
    vw = torch.randn(b, W, kvh, dh, generator=g, device=dev).to(dtype)
    valid = torch.rand(b, W, generator=g, device=dev) < 0.75
    valid[0, :min(W - 1, 64)] = False
    valid[:, -1] = True
    bias = torch.where(valid, 0.0, -1e30).float()
    return q, kw, vw, bias


def swa_kernel(dev, rounds: int):
    """swa_decode at the decode leg's shape: q (4, 32, 128) against the
    ring of one layer, kw / vw (4, 4096, 8, 128), in bf16 and in f32,
    plus a ragged window (W=200, g=1), a window of 8192 keys, and a
    window short enough for one chunk (S = 1, the split kernel writes
    the output itself). The library call is
    F.scaled_dot_product_attention on the (b, kvh, W, dh) views with
    enable_gqa and the bias as its mask, timed only."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_decode import splits
    from repro_torch.kernels.swa_decode import swa_decode_attention as swa
    g = torch.Generator(device=dev).manual_seed(5)
    cases = [("leg bf16", (MX_BATCH, 32, 8, 128, 4096), torch.bfloat16),
             ("leg f32", (MX_BATCH, 32, 8, 128, 4096), torch.float32),
             ("ragged bf16", (MX_BATCH, 8, 8, 128, 200), torch.bfloat16),
             ("ragged f32", (MX_BATCH, 8, 8, 128, 200), torch.float32),
             ("W=8192 bf16", (MX_BATCH, 32, 8, 128, 8192), torch.bfloat16),
             ("S=1 bf16", (MX_BATCH, 32, 8, 128, 100), torch.bfloat16)]
    errs, rels, plans = [], [], []
    for label, (b, h, kvh, dh, W), dtype in cases:
        q, kw, vw, bias = swa_inputs(g, dev, b, h, kvh, dh, W, dtype)
        scale = 1.0 / math.sqrt(dh)
        got = swa(q, kw, vw, bias, scale)
        want = ref.swa_decode_attention(q, kw, vw, bias, scale)
        sync()
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        require(rel <= tol, f"swa_decode {label}: error {err} is {rel:.2e} of "
                            f"the largest output (tolerance {tol})")
        S = splits(b, h, W, kvh, dev)
        require((S == 1) == label.startswith("S=1"),
                f"swa_decode {label}: {S} chunks")
        errs.append(err)
        rels.append(f"{label} {err:.3e} ({rel:.1e} rel)")
        plans.append(f"{label} S={S}")
    q, kw, vw, bias = swa_inputs(g, dev, MX_BATCH, 32, 8, 128, 8192,
                                 torch.bfloat16)
    ms_8k = time_ms(lambda: swa(q, kw, vw, bias, 1.0 / math.sqrt(128)),
                    rounds)
    q, kw, vw, bias = swa_inputs(g, dev, MX_BATCH, 32, 8, 128, 4096,
                                 torch.bfloat16)
    scale = 1.0 / math.sqrt(128)
    ms = time_ms(lambda: swa(q, kw, vw, bias, scale), rounds)
    plain = time_ms(lambda: ref.swa_decode_attention(q, kw, vw, bias, scale),
                    rounds)
    qs, ks, vs = q[:, :, None, :], kw.transpose(1, 2), vw.transpose(1, 2)
    mask = bias[:, None, None, :].to(q.dtype)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), rounds)
    dev_ms = graph_ms(lambda: swa(q, kw, vw, bias, scale))
    dev_lib = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True))
    b, h, dh = q.shape
    W, kvh = kw.shape[1], kw.shape[2]
    nbytes = 2 * (2 * q.numel() + kw.numel() + vw.numel()) + 4 * bias.numel()
    flops = 4 * b * h * W * dh
    bms, by = bound(nbytes, flops)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = splits(b, h, W, kvh, dev)
    print(f"kernel swa_decode: q {tuple(q.shape)} kw/vw {tuple(kw.shape)} "
          f"bf16, scattered ring; errors {'; '.join(rels)} match=True | "
          f"leg bf16 ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
          f"bound_ms={bms:.5f} ({by}, {nbytes} bytes, {flops} flops) | "
          f"device time by CUDA graph replay: ms={dev_ms:.4f} "
          f"sdpa_ms={dev_lib:.4f} | "
          f"W=8192 bf16 ms={ms_8k:.4f} | split: S={S} chunks of "
          f"{W // S} keys, {b * kvh * S} split blocks (one per sequence, "
          f"kv head and chunk) + {b * h} combine blocks "
          f"on {sms} SMs ({'; '.join(plans)})", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, device_ms=dev_ms)


# ------------------------------------------------------------ main path --

def small_agreement(device):
    """The port on ``device`` against its plain versions on the CPU, on
    a small input: the same round labels and tau, the same served labels
    and tau versions."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(5, k=12, d=24, k_prime=3, m0=2,
                            n_per_comp_dev=12, sep=30.0)
    reqs = late_device_stream(fm.means, 3, 6, 6, n_range=(10, 60))
    outs = []
    for dev in (device, "cpu"):
        plan = FederationPlan(k=12, k_prime=3, d=24, device=str(dev),
                              batch_size=4, bucket_sizes=(32, 64),
                              refresh_every=4)
        sess = Session(plan, seed=2)
        out = sess.run(7, fm.data)
        served = sess.serve_versioned([r[0] for r in reqs],
                                      [r[2] for r in reqs])
        outs.append((out.labels.cpu(), out.tau_centers.cpu(), served,
                     sess.tau_centers.cpu()))
    (l1, t1, s1, u1), (l0, t0, s0, u0) = outs
    require(torch.equal(l1, l0), "small round: labels differ from the CPU")
    scale = float(t0.abs().max())
    require(float((t1 - t0).abs().max()) <= 1e-4 * scale,
            "small round: tau differs from the CPU")
    for (a, va), (b, vb) in zip(s1, s0):
        require(np.array_equal(a, b) and va == vb,
                "small serve: labels or tau versions differ from the CPU")
    require(float((u1 - u0).abs().max()) <= 1e-4 * float(u0.abs().max()),
            "small serve: refreshed tau differs from the CPU")
    return len(s1)


def small_routed_agreement(device):
    """A small routed serve on ``device`` against the CPU run of the
    plain versions: labels, clusters and routing exact, predictions
    within 1e-5 of their largest magnitude."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(6, k=12, d=24, k_prime=3, m0=2,
                            n_per_comp_dev=12, sep=30.0)
    reqs = late_device_stream(fm.means, 3, 10, 8, n_range=(10, 60))
    outs = []
    for dev in (device, "cpu"):
        plan = FederationPlan(k=12, k_prime=3, d=24, device=str(dev),
                              batch_size=4, bucket_sizes=(32, 64),
                              refresh_every=4, heads="granite-3-2b",
                              head_arch="transformer")
        sess = Session(plan, seed=2)
        sess.run(7, fm.data)
        outs.append(sess.serve_predict([r[0] for r in reqs],
                                       [r[2] for r in reqs]))
    got, want = outs
    for g, w in zip(got, want):
        require(np.array_equal(g.labels, w.labels)
                and (g.tau_version, g.cluster, g.routed)
                == (w.tau_version, w.cluster, w.routed),
                "small routed serve: labels, versions, clusters or routing "
                "differ from the CPU")
    gp = np.stack([g.prediction for g in got])
    wp = np.stack([w.prediction for w in want])
    err = float(np.abs(gp - wp).max())
    require(err <= 1e-5 * float(np.abs(wp).max()),
            f"small routed serve: predictions differ by {err}")
    return len(got), sum(g.routed for g in got), err


def main_path(fm, device):
    """The one-shot round and the serve path at full width, each run
    between a reset and a read of the launch counts."""
    from repro_torch.data.gaussian import late_device_stream
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.kernels import ops
    from repro_torch.utils.metrics import clustering_accuracy

    plan = FederationPlan(k=K, k_prime=KP, d=D, device=str(device),
                          **SERVE_PLAN)
    Session(plan).run(1, fm.data)            # warm-up: library handles
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = Session(plan).run(0, fm.data)
    sync()
    run_s = time.perf_counter() - t0
    run_counts = ops.launch_counts()
    labels = out.labels.cpu().numpy()
    require(labels.shape == fm.labels.shape, "round: label shape")
    require(bool(torch.isfinite(out.tau_centers).all()), "round: tau")
    require(tuple(out.tau_centers.shape) == (K, D), "round: tau shape")
    acc = clustering_accuracy(labels, fm.labels, K)
    print(f"run: Session.run d={D} k={K} k'={KP} m0={M0} Z={fm.data.shape[0]}"
          f" n={fm.data.shape[1]} sep={SEP}: {run_s:.3f} s, clustering "
          f"accuracy {acc:.4f} (>= {MIN_ACCURACY}), launches {run_counts}",
          flush=True)
    require(acc >= MIN_ACCURACY, f"round: accuracy {acc} < {MIN_ACCURACY}")

    reqs = late_device_stream(fm.means, KP, SERVE_REQUESTS, 7,
                              n_range=(SERVE_N, SERVE_N + 1))
    datas = [r[0] for r in reqs]
    kvs = [r[2] for r in reqs]
    warm = Session.from_round(plan, out.detail, seed=1)
    warm.serve(datas[:plan.batch_size], kvs[:plan.batch_size])
    sync()
    sess = Session.from_round(plan, out.detail, seed=0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served = sess.serve_versioned(datas, kvs)
    sync()
    serve_s = time.perf_counter() - t0
    serve_counts = ops.launch_counts()
    st = sess.stats()
    require(st["served_devices"] == SERVE_REQUESTS, "serve: count")
    require(sess.tau_version == SERVE_REQUESTS // SERVE_PLAN["refresh_every"],
            f"serve: tau version {sess.tau_version}")
    lab = np.concatenate([s[0] for s in served])
    require(lab.shape == (SERVE_REQUESTS * SERVE_N,), "serve: label shape")
    sacc = clustering_accuracy(lab, np.concatenate([r[1] for r in reqs]), K)
    versions = sorted({s[1] for s in served})
    print(f"serve: {SERVE_REQUESTS} late devices n={SERVE_N} batch="
          f"{plan.batch_size} refresh_every={plan.refresh_every} (sync): "
          f"{serve_s:.3f} s, {SERVE_REQUESTS / serve_s:.2f} requests/s, "
          f"{SERVE_REQUESTS * SERVE_N / serve_s:.1f} points/s, label "
          f"accuracy {sacc:.4f}, tau versions served {versions}, final "
          f"version {sess.tau_version}, launches {serve_counts}", flush=True)
    require(sacc >= MIN_ACCURACY, f"serve: accuracy {sacc}")

    # One more pass over each path, the shapes of pdist_argmin and
    # kmeans_update tallied.
    run_tally = tallied(lambda: Session(plan).run(0, fm.data))
    serve_tally = tallied(lambda: Session.from_round(
        plan, out.detail, seed=0).serve_versioned(datas, kvs))

    # Where the time goes: the same two calls under torch.profiler.
    # Device time is the sum of the kernels' own times; the busy share is
    # taken against the unprofiled wall time above.
    profile("run", lambda: Session(plan).run(0, fm.data), run_s)
    profile("serve", lambda: Session.from_round(plan, out.detail, seed=0)
            .serve_versioned(datas, kvs), serve_s)
    attach = (out.detail.device_centers, out.detail.agg.tau_centers)
    return (run_counts, serve_counts, {"run": run_tally, "serve": serve_tally},
            attach, out.detail)


def route_path(device):
    """The routed personalization serve path at the routed serving
    configuration of benchmarks/bench_route_serve.py: one warm-up wave,
    then R_WAVES waves of 64 late devices through Session.serve_predict,
    between a reset and a read of the launch counts. The labels must
    equal a heads-off session's on the same requests."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.kernels import ops
    from repro_torch.utils.metrics import clustering_accuracy

    fm = structured_devices(0, k=R_K, d=R_D, k_prime=R_KP, m0=R_M0,
                            n_per_comp_dev=R_NPER, sep=R_SEP)
    base = FederationPlan(k=R_K, k_prime=R_KP, d=R_D, device=str(device))
    rr = Session(base).run(1, fm.data).detail
    plan = base.with_options(**R_PLAN)
    B = plan.batch_size
    stream = late_device_stream(fm.means, R_KP, (R_WAVES + 1) * B, 3,
                                n_range=R_N_RANGE)
    reqs, kvs = [r[0] for r in stream], [r[2] for r in stream]
    waves = [(reqs[lo:lo + B], kvs[lo:lo + B])
             for lo in range(B, (R_WAVES + 1) * B, B)]

    def warm_session(p):
        sess = Session.from_round(p, rr, seed=0)
        sess.serve(reqs[:B], kvs[:B])            # warm-up wave
        sync()
        return sess

    sess = warm_session(plan)
    steps0 = sess.service.plane.steps
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served = [p for w in waves for p in sess.serve_predict(*w)]
    sync()
    route_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    batches = sess.service.plane.steps - steps0
    st = sess.stats()["heads"]
    npts = sum(p.labels.shape[0] for p in served)
    routed = sum(p.routed for p in served)
    require(len(served) == R_WAVES * B, "route: count")
    require(all(p.prediction.shape == (R_D,)
                and bool(np.isfinite(p.prediction).all()) for p in served),
            "route: predictions of the wrong shape or not finite")
    require(all(p.routed or not p.prediction.any() for p in served),
            "route: an overflowed request has a non-zero prediction")
    require(routed > 0, "route: no request was routed")
    require(counts["moe_dispatch"] >= 2 * batches
            and counts["moe_combine"] >= batches and batches >= R_WAVES,
            f"route: {batches} routed batches launched {counts}")
    off = warm_session(base.with_options(**{**R_PLAN, "heads": "off"}))
    off_labels = [lbl for w in waves for lbl in off.serve(*w)]
    require(all(np.array_equal(p.labels, lbl)
                for p, lbl in zip(served, off_labels)),
            "route: labels differ from the heads-off session's")
    acc = clustering_accuracy(
        np.concatenate([p.labels for p in served]),
        np.concatenate([r[1] for r in stream[B:]]), R_K)
    require(acc >= MIN_ACCURACY, f"route: accuracy {acc}")
    print(f"route: Session.serve_predict k={R_K} k'={R_KP} d={R_D} heads="
          f"{plan.heads}/{plan.head_arch} batch={B} queue C="
          f"{st['queue_capacity']} x {R_K}: {R_WAVES} waves of {B} late "
          f"devices n in [{R_N_RANGE[0]}, {R_N_RANGE[1]}) in "
          f"{route_s:.3f} s, {len(served) / route_s:.2f} requests/s, "
          f"{npts / route_s:.1f} points/s; routed {routed}, overflowed "
          f"{len(served) - routed} (stats: {st['routed_served']} / "
          f"{st['overflowed']} incl. warm-up); label accuracy {acc:.4f}, "
          f"labels equal the heads-off session's; {batches} batches, "
          f"launches {counts}", flush=True)
    again = warm_session(plan)
    tally = tallied(lambda: [again.serve_predict(*w) for w in waves])
    prof = warm_session(plan)
    profile("route", lambda: [prof.serve_predict(*w) for w in waves],
            route_s)
    return counts, tally


def restore_path(fm, device, tmp: Path):
    """The serve path at Table 1's largest setting, cut by a checkpoint.
    An uninterrupted session serves the 32 late devices in two halves;
    another serves the first half and saves, and a session restored from
    the archive serves the second half (between a reset and a read of the
    launch counts, tallied). The labels, tau versions, fold state and tau
    must equal the uninterrupted session's bit for bit."""
    from repro_torch.data.gaussian import late_device_stream
    from repro_torch.fed.api import FederationPlan, Session
    plan = FederationPlan(k=K, k_prime=KP, d=D, device=str(device),
                          **SERVE_PLAN)
    rr = Session(plan).run(0, fm.data).detail
    reqs = late_device_stream(fm.means, KP, SERVE_REQUESTS, 7,
                              n_range=(SERVE_N, SERVE_N + 1))
    datas, kvs, h = [r[0] for r in reqs], [r[2] for r in reqs], RESTORE_HALF
    live = Session.from_round(plan, rr, seed=0)
    want = (live.serve_versioned(datas[:h], kvs[:h])
            + live.serve_versioned(datas[h:], kvs[h:]))
    first = Session.from_round(plan, rr, seed=0)
    got = first.serve_versioned(datas[:h], kvs[:h])
    sync()
    t0 = time.perf_counter()
    path = first.save(str(tmp / "serve.npz"))
    save_s = time.perf_counter() - t0
    walls = {}

    def restore_and_serve():
        t0 = time.perf_counter()
        sess = Session.restore(path, plan)
        sync()
        walls["restore"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = sess.serve_versioned(datas[h:], kvs[h:])
        sync()
        walls["serve"] = time.perf_counter() - t0
        return sess, out

    (restored, rest), counts, tally = counted(restore_and_serve)
    got += rest
    require(all(np.array_equal(g, w) and gv == wv
                for (g, gv), (w, wv) in zip(got, want)),
            "restore: labels or tau versions differ from the uninterrupted "
            "session's")
    require(all(torch.equal(a, b) for a, b in zip(restored.service.state,
                                                    live.service.state))
            and torch.equal(restored.tau_centers, live.tau_centers),
            "restore: fold state or tau differs from the uninterrupted "
            "session's")
    require(restored.stats()["served_devices"] == SERVE_REQUESTS,
            "restore: served count")
    versions = sorted({v for _, v in got})
    print(f"restore: serve path d={D} k={K} k'={KP}, {h} late devices of "
          f"n={SERVE_N}, save ({Path(path).stat().st_size} bytes, "
          f"{save_s:.3f} s), Session.restore ({walls['restore']:.3f} s), "
          f"{SERVE_REQUESTS - h} more in {walls['serve']:.3f} s: labels, tau "
          f"versions {versions} (final {restored.tau_version}), fold state "
          f"and tau equal the uninterrupted session's bit for bit; "
          f"launches {counts}", flush=True)
    return counts, tally


def route_restore_path(device, tmp: Path):
    """The routed leg's configuration cut by a checkpoint (schema v5):
    an uninterrupted session serves two waves of 64; another serves the
    first and saves, and the restored session serves the second (counted
    and tallied). Labels, versions, clusters, routing and the routed
    counters exact, predictions within 1e-5 of their largest magnitude."""
    from repro_torch.checkpoint.store import npz_keys
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(0, k=R_K, d=R_D, k_prime=R_KP, m0=R_M0,
                            n_per_comp_dev=R_NPER, sep=R_SEP)
    base = FederationPlan(k=R_K, k_prime=R_KP, d=R_D, device=str(device))
    rr = Session(base).run(1, fm.data).detail
    plan = base.with_options(**R_PLAN)
    B = plan.batch_size
    stream = late_device_stream(fm.means, R_KP, 2 * B, 4, n_range=R_N_RANGE)
    w1 = ([r[0] for r in stream[:B]], [r[2] for r in stream[:B]])
    w2 = ([r[0] for r in stream[B:]], [r[2] for r in stream[B:]])
    live = Session.from_round(plan, rr, seed=0)
    live.serve_predict(*w1)
    want = live.serve_predict(*w2)
    first = Session.from_round(plan, rr, seed=0)
    first.serve_predict(*w1)
    path = first.save(str(tmp / "route.npz"))
    require({"heads_tag", "heads_counters"} <= npz_keys(path),
            "route restore: the archive is not of schema v5")
    (restored, got), counts, tally = counted(
        lambda: (lambda s: (s, s.serve_predict(*w2)))(
            Session.restore(path, plan)))
    require(all(np.array_equal(g.labels, w.labels)
                and (g.tau_version, g.cluster, g.routed)
                == (w.tau_version, w.cluster, w.routed)
                for g, w in zip(got, want)),
            "route restore: labels, versions, clusters or routing differ "
            "from the uninterrupted session's")
    gp = np.stack([g.prediction for g in got])
    wp = np.stack([w.prediction for w in want])
    err = float(np.abs(gp - wp).max())
    require(err <= 1e-5 * float(np.abs(wp).max()),
            f"route restore: predictions differ by {err}")
    st, lst = restored.stats()["heads"], live.stats()["heads"]
    require(st == lst, f"route restore: routed counters {st} != {lst}")
    print(f"route restore: k={R_K} d={R_D} {plan.heads}/{plan.head_arch}, "
          f"save after a wave of {B} ({Path(path).stat().st_size} bytes, "
          f"schema v5), restore, a wave of {B}: labels, versions, clusters, "
          f"routing and counters (routed {st['routed_served']}, overflowed "
          f"{st['overflowed']}) equal the uninterrupted session's; "
          f"predictions max error {err:.3e}; launches {counts}", flush=True)
    return counts, tally


def cpu_to_card_restore(device, tmp: Path):
    """An archive the port writes on the CPU restores on the card (and
    the card's archive on the CPU): the same state bit for bit, then the
    same labels and tau versions as the CPU session serving on."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(5, k=12, d=24, k_prime=3, m0=2,
                            n_per_comp_dev=12, sep=30.0)
    reqs = late_device_stream(fm.means, 3, 12, 6, n_range=(10, 60))
    datas, kvs = [r[0] for r in reqs], [r[2] for r in reqs]
    plan = FederationPlan(k=12, k_prime=3, d=24, device="cpu", batch_size=4,
                          bucket_sizes=(32, 64), refresh_every=4)
    cpu = Session(plan, seed=2)
    cpu.run(7, fm.data)
    cpu.serve(datas[:6], kvs[:6])
    path = cpu.save(str(tmp / "cpu.npz"))
    card = Session.restore(path, plan, device=device)
    require(all(a.device.type == torch.device(device).type
                and torch.equal(a.cpu(), b)
                for a, b in zip(card.service.state, cpu.service.state)),
            "cpu -> card: the restored fold state is not the CPU's on the "
            "card")
    back = Session.restore(card.save(str(tmp / "card.npz")), plan)
    require(all(torch.equal(a, b) for a, b in zip(back.service.state,
                                                    cpu.service.state)),
            "card -> cpu: the restored fold state differs")
    want = cpu.serve_versioned(datas[6:], kvs[6:])
    got = card.serve_versioned(datas[6:], kvs[6:])
    require(all(np.array_equal(g, w) and gv == wv
                for (g, gv), (w, wv) in zip(got, want)),
            "cpu -> card: labels or tau versions differ from the CPU's")
    return len(got)


def table2_features(x, y, kp: int, n_cls: int = P_CLASSES) -> np.ndarray:
    """The Table 2 bench's clustering features: each chunk's per-class
    prototype means, concatenated over the classes: (Z, kp, n_cls * d)."""
    feats = np.zeros((x.shape[0], kp, n_cls * x.shape[2]), np.float32)
    for z in range(x.shape[0]):
        for ci, idx in enumerate(np.array_split(np.arange(x.shape[1]), kp)):
            cx, cy = x[z, idx], y[z, idx]
            proto = np.zeros((n_cls, x.shape[2]), np.float32)
            for c in range(n_cls):
                if (cy == c).any():
                    proto[c] = cx[cy == c].mean(0)
            feats[z, ci] = proto.reshape(-1)
    return feats


def device_accuracy(models, pick, x, y):
    """Each device's accuracy over its points under model ``pick[z]`` of
    the stacked ``models``: (Z,)."""
    from torch.func import vmap

    from repro_torch.models.common import tree_map
    from repro_torch.models.mlp import mlp_accuracy
    return vmap(mlp_accuracy)(tree_map(lambda leaf: leaf[pick], models), x, y)


def personalize_run(device, Z: int, kp: int, *, n=P_N, hidden=P_HIDDEN,
                    rounds=P_ROUNDS, key=2):
    """One row of Table 2 on ``device``: Global FedAvg, IFCA and k-FED +
    per-cluster FedAvg (per chunk at k' > 1), as the bench runs them.
    Returns (accuracies and walls, the k-FED models and assignment, IFCA's
    choices, k-FED's cluster accuracy)."""
    from repro_torch.data.synthetic_tasks import rotation_tasks
    from repro_torch.fed.fedavg import FedAvgConfig, fedavg_round
    from repro_torch.fed.ifca import ifca_round
    from repro_torch.fed.personalize import kfed_personalize
    from repro_torch.models.common import tree_map
    from repro_torch.models.mlp import init_mlp, mlp_loss
    from repro_torch.utils.metrics import clustering_accuracy
    data = rotation_tasks(np.random.default_rng(Z + kp), Z=Z, n_per_dev=n,
                          d=P_D, k=P_K, k_prime=kp)
    x = torch.as_tensor(data.x, device=device)
    y = torch.as_tensor(data.y, device=device)
    mask = torch.as_tensor(data.point_mask, device=device)
    dev_data = {"x": x, "y": y, "mask": mask}
    cfg = FedAvgConfig(lr=P_LR, local_epochs=P_EPOCHS, rounds=rounds)

    def init(seed):
        return init_mlp(torch.Generator().manual_seed(seed), P_D, hidden,
                        P_CLASSES, device=device)

    out = {}
    t0 = time.perf_counter()
    gp = init(0)
    for _ in range(rounds):
        gp, _ = fedavg_round(mlp_loss, gp, dev_data, cfg, point_mask=mask)
    zeros = torch.zeros((Z,), dtype=torch.long, device=device)
    out["global"] = 100 * float(device_accuracy(
        tree_map(lambda a: a[None], gp), zeros, x, y).mean())
    out["global_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inits = [init(1 + j) for j in range(P_K)]
    models = tree_map(lambda *xs: torch.stack(xs), *inits)
    for _ in range(rounds):
        models, choice, _ = ifca_round(mlp_loss, models, dev_data, cfg,
                                       point_mask=mask)
    out["ifca"] = 100 * float(device_accuracy(models, choice, x, y).mean())
    out["ifca_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = torch.as_tensor(table2_features(data.x, data.y, kp),
                            device=device)
    models_kf, assign, _ = kfed_personalize(
        key, mlp_loss, init(0), dev_data, feats, P_K, cfg, k_prime=kp,
        point_mask=mask, per_chunk=kp > 1)
    if kp > 1:
        chunks = [torch.as_tensor(idx, device=device) for idx in
                  np.array_split(np.arange(n), kp)]
        accs = torch.stack([device_accuracy(
            models_kf, assign[:, c].long(), x[:, idx], y[:, idx])
            for c, idx in enumerate(chunks)])
        first = assign[:, 0]
    else:
        accs = device_accuracy(models_kf, assign.long(), x, y)
        first = assign
    out["kfed"] = 100 * float(accs.mean())
    out["kfed_s"] = time.perf_counter() - t0
    clu = clustering_accuracy(first.cpu().numpy(), data.cluster, P_K)
    return out, models_kf, assign, choice, clu


def personalize_leg(device):
    """Table 2 in full: Z in {100, 200} x k' in {1, 2}, each row between a
    reset and a read of the launch counts (tallied)."""
    rows, counts, tallies = [], {}, {}
    for Z in P_ZS:
        for kp in P_KPS:
            (out, _, assign, _, clu), c, tally = counted(
                lambda: personalize_run(device, Z, kp))
            for name, v in c.items():
                counts[name] = counts.get(name, 0) + v
            tallies[f"table2_Z{Z}_kp{kp}"] = tally
            accs = (out["global"], out["ifca"], out["kfed"])
            require(all(np.isfinite(a) and 0 <= a <= 100 for a in accs),
                    f"personalize Z={Z} k'={kp}: accuracies {accs}")
            require(tuple(assign.shape) == ((Z,) if kp == 1 else (Z, kp)),
                    f"personalize: assignment shape {tuple(assign.shape)}")
            require(clu >= MIN_TABLE2_CLUSTER_ACC,
                    f"personalize Z={Z} k'={kp}: k-FED cluster accuracy "
                    f"{clu} < {MIN_TABLE2_CLUSTER_ACC}")
            print(f"personalize table2_Z{Z}_kprime{kp}: global "
                  f"{out['global']:.2f}% ({out['global_s']:.3f} s), IFCA "
                  f"{out['ifca']:.2f}% ({out['ifca_s']:.3f} s), k-FED + "
                  f"FedAvg {out['kfed']:.2f}% ({out['kfed_s']:.3f} s), "
                  f"k-FED cluster accuracy {100 * clu:.2f}%; launches {c}",
                  flush=True)
            rows.append(out)
    return counts, tallies


def selection_leg(device):
    """Figure 4 in full: random, pow-d and k-FED-filtered pow-d, 30
    rounds each (counted and tallied together with the k-FED round)."""
    from torch.func import vmap

    from repro_torch.data.partition import _pack
    from repro_torch.data.synthetic_tasks import femnist_like
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.fed.fedavg import (FedAvgConfig, cohort_sgd,
                                        weighted_average)
    from repro_torch.fed.selection import kfed_pow_d, pow_d, random_selection
    from repro_torch.models.mlp import init_mlp, mlp_accuracy, mlp_loss
    xs, ys, _ = femnist_like(np.random.default_rng(3), Z=S_Z, d=S_D,
                             n_classes=S_CLASSES, mean_n=S_MEAN_N)
    part = _pack(xs, ys, S_CLASSES)
    X = torch.as_tensor(part.data, device=device)
    Y = torch.as_tensor(part.labels, device=device)
    M = torch.as_tensor(part.point_mask, device=device)
    data = {"x": X, "y": Y, "mask": M}
    cfg = FedAvgConfig(lr=0.1, local_epochs=3)
    rows = {}

    def run_all():
        t0 = time.perf_counter()
        feats = (X * M[..., None]).sum(1) / torch.clamp(
            M.sum(1), min=1)[:, None]
        res = Session(FederationPlan(k=S_K, k_prime=1, d=S_D,
                                     device=str(device))).run(
            5, feats[:, None, :])
        clusters = res.labels[:, 0].cpu().numpy()
        rows["kfed_round_s"] = time.perf_counter() - t0
        for strat in ("random", "pow_d", "kfed_pow_d"):
            t0 = time.perf_counter()
            params = init_mlp(torch.Generator().manual_seed(0), S_D,
                              S_HIDDEN, S_CLASSES, device=device)
            rng = np.random.default_rng(11)
            accs = []
            for _ in range(S_ROUNDS):
                losses = vmap(mlp_loss, in_dims=(None, 0))(
                    params, data).cpu().numpy()
                if strat == "random":
                    sel = random_selection(rng, S_Z, S_M)
                elif strat == "pow_d":
                    sel = pow_d(rng, losses, S_M, S_DCAND)
                else:
                    sel = kfed_pow_d(rng, losses, clusters, S_M, S_DCAND)
                idx = torch.as_tensor(np.asarray(sel), device=device)
                sub = {k: v[idx] for k, v in data.items()}
                upd = cohort_sgd(mlp_loss, params, sub, cfg, sub["mask"])
                params = weighted_average(upd.params,
                                          M[idx].sum(1).float())
                accs.append(vmap(mlp_accuracy, in_dims=(None, 0, 0, 0))(
                    params, X, Y, M))
            accs = torch.stack(accs).cpu().numpy()      # (rounds, Z)
            hit = np.where(accs.mean(1) >= S_TARGET)[0]
            rows[strat] = (100 * accs[-1].mean(), float(np.var(
                100 * accs[-1])), int(hit[0]) + 1 if len(hit) else -1,
                time.perf_counter() - t0)

    _, counts, tally = counted(run_all)
    for strat in ("random", "pow_d", "kfed_pow_d"):
        acc, var, t2t, wall = rows[strat]
        require(np.isfinite(acc) and 0 <= acc <= 100 and np.isfinite(var),
                f"selection {strat}: accuracy {acc}, variance {var}")
        print(f"selection fig4_{strat}: final accuracy {acc:.2f}%, variance "
              f"{var:.2f}, rounds to {int(100 * S_TARGET)}% {t2t} "
              f"({wall:.3f} s)", flush=True)
    print(f"selection: Z={S_Z} d={S_D} mean_n={S_MEAN_N} rounds={S_ROUNDS} "
          f"m={S_M} d_cand={S_DCAND} hidden={S_HIDDEN}, k-FED k={S_K} k'=1 "
          f"round {rows['kfed_round_s']:.3f} s; launches {counts}",
          flush=True)
    return counts, tally


def separation_leg(device):
    """Figure 1 in full, one seed a c: the one-shot round's clustering
    accuracy and the separation report's median active c_rs at each c
    (counted and tallied together)."""
    from repro_torch.core.separation import separation_report
    from repro_torch.data.gaussian import structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.utils.metrics import clustering_accuracy
    rows = []

    def run_all():
        for c in F_CS:
            fm = structured_devices(0, k=F_K, d=F_D, k_prime=F_KP, m0=F_M0,
                                    n_per_comp_dev=F_NPER,
                                    sep=c * np.sqrt(F_D))
            t0 = time.perf_counter()
            out = Session(FederationPlan(k=F_K, k_prime=F_KP, d=F_D,
                                         device=str(device))).run(
                100, fm.data)
            labels = out.labels.cpu().numpy()
            run_s = time.perf_counter() - t0
            rep = separation_report(
                torch.as_tensor(fm.data.reshape(-1, F_D), device=device),
                torch.as_tensor(fm.labels.reshape(-1), device=device), F_K,
                torch.as_tensor(fm.presence, device=device),
                fm.data.shape[1], k_prime=F_KP, m0=F_M0, c=c)
            c_rs = rep.c_rs.cpu().numpy()[rep.active.cpu().numpy()]
            rows.append((c, clustering_accuracy(labels, fm.labels, F_K),
                         float(np.median(c_rs)), run_s,
                         bool(torch.isfinite(rep.c_rs).all())))

    _, counts, tally = counted(run_all)
    for c, acc, c_eff, run_s, finite in rows:
        require(finite and np.isfinite(c_eff),
                f"separation c={c}: the report is not finite")
        print(f"separation fig1_c{c}: Z={F_K // F_KP * F_M0} n="
              f"{F_KP * F_NPER} d={F_D} k={F_K} k'={F_KP}: accuracy "
              f"{100 * acc:.2f}%, median active c_rs {c_eff:.4f} "
              f"(round {run_s:.3f} s)", flush=True)
    print(f"separation: launches {counts}", flush=True)
    return counts, tally


def small_scenario_agreement(device):
    """A small personalize (Z=16, k' = 1 and 2, two rounds) and a small
    separation report on ``device`` against the CPU run of the port:
    assignments and IFCA choices exact, parameters within atol 2e-5 +
    rtol 1e-4, the report's counts and flags exact and its norms within
    rtol 1e-4 (the CPU tests' tolerances)."""
    from repro_torch.core.separation import separation_report
    from repro_torch.data.gaussian import structured_devices
    for kp in (1, 2):
        runs = [personalize_run(dev, 16, kp, n=12, hidden=16, rounds=2)
                for dev in (device, torch.device("cpu"))]
        (_, m1, a1, c1, _), (_, m0, a0, c0, _) = runs
        require(torch.equal(a1.cpu(), a0) and torch.equal(c1.cpu(), c0),
                f"small personalize k'={kp}: assignments or IFCA choices "
                f"differ from the CPU")
        for name in m0:
            require(torch.allclose(m1[name].cpu(), m0[name], rtol=1e-4,
                                   atol=2e-5),
                    f"small personalize k'={kp}: {name} differs from the "
                    f"CPU")
    fm = structured_devices(3, k=8, d=12, k_prime=2, m0=3,
                            n_per_comp_dev=15, sep=4.0)
    reps = [separation_report(
        torch.as_tensor(fm.data.reshape(-1, 12), device=dev),
        torch.as_tensor(fm.labels.reshape(-1), device=dev), 8,
        torch.as_tensor(fm.presence, device=dev), fm.data.shape[1],
        k_prime=2, m0=3, c=0.3) for dev in (device, torch.device("cpu"))]
    got, want = ([t.cpu() for t in r] for r in reps)
    for i in (1, 6, 7, 8):        # sizes, active, the two fractions
        require(torch.equal(got[i], want[i]),
                f"small separation: field {i} differs from the CPU")
    for i in (0, 2, 3, 4):        # norm, means, deltas, lambda
        require(torch.allclose(got[i], want[i], rtol=1e-4,
                               atol=1e-4 * float(want[i].abs().max())),
                f"small separation: field {i} differs from the CPU")


def serve_bursts(sess, bursts):
    """Submit each burst and flush it: ({rid: (labels, tau version)},
    [(batch rung, ladder) of each flush])."""
    served, decisions = {}, []
    for burst in bursts:
        for data, _, kv in burst:
            sess.submit(data, kv)
        served.update(sess.flush_versioned())
        d = sess.service.autoscaler.decision
        decisions.append((d.batch_size, d.ladder))
    return served, decisions


def same_served(got, want) -> bool:
    return sorted(got) == sorted(want) and all(
        np.array_equal(got[r][0], want[r][0]) and got[r][1] == want[r][1]
        for r in want)


def same_pairs(got, want) -> bool:
    """Served (labels, version) lists bit for bit."""
    return len(got) == len(want) and all(
        np.array_equal(a, b) and va == vb
        for (a, va), (b, vb) in zip(got, want))


def solve_line(tally) -> str:
    """solve_attach's launches by shape: {"(B,n,d) k'=.. k=..": count}."""
    return json.dumps({f"({','.join(map(str, key[0]))}) k'={key[1]} "
                       f"k={key[2]} {key[3]}": v[0]
                       for key, v in tally.shapes.items()})


def attach_run(rr, device, policy, autoscale, bursts, tmp: Path):
    """One run of the attach leg under (policy, autoscale): the
    uninterrupted session over every burst (counted and tallied), then a
    session cut by save / restore after A_CUT bursts whose last bursts
    must equal the uninterrupted session's bit for bit (labels, versions,
    decisions; then the fold state and the tau buffers)."""
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.utils.metrics import clustering_accuracy
    plan = FederationPlan(k=K, k_prime=KP, d=D, device=str(device),
                          fold_policy=policy, autoscale=autoscale, **A_PLAN)
    walls = {}

    def uninterrupted():
        sess = Session.from_round(plan, rr, seed=0)
        t0 = time.perf_counter()
        out = serve_bursts(sess, bursts)
        sync()
        walls["serve"] = time.perf_counter() - t0
        return sess, out

    (live, (served, decisions)), counts, tally = counted(uninterrupted)
    first = Session.from_round(plan, rr, seed=0)
    got, got_dec = serve_bursts(first, bursts[:A_CUT])
    pending = first.service._taubuf.pending
    t0 = time.perf_counter()
    path = first.save(str(tmp / f"attach_{policy}.npz"))
    walls["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = Session.restore(path, plan)
    sync()
    walls["restore"] = time.perf_counter() - t0
    rest, rest_dec = serve_bursts(restored, bursts[A_CUT:])
    got.update(rest)
    require(same_served(got, served) and got_dec + rest_dec == decisions,
            f"attach {policy}/{autoscale}: the restored session's labels, "
            f"tau versions or decisions differ from the uninterrupted one's")
    require(all(torch.equal(a, b) for a, b in zip(restored.service.state,
                                                    live.service.state))
            and torch.equal(restored.service._taubuf.bufs,
                            live.service._taubuf.bufs),
            f"attach {policy}/{autoscale}: the restored fold state or tau "
            f"buffers differ from the uninterrupted session's")
    reqs = [r for b in bursts for r in b]
    rids = sorted(served)
    accs = [clustering_accuracy(served[rid][0], r[1], K)
            for rid, r in zip(rids, reqs)]
    acc = float(np.mean(accs))
    npts = sum(r[0].shape[0] for r in reqs)
    st = live.stats()
    require(st["served_devices"] == len(reqs),
            f"attach {policy}: served {st['served_devices']}")
    require(acc >= MIN_ATTACH_ACCURACY,
            f"attach {policy}/{autoscale}: mean accuracy {acc} < "
            f"{MIN_ATTACH_ACCURACY}")
    versions = sorted({v for _, v in served.values()})
    print(f"attach {policy}/{autoscale}: {len(reqs)} late devices n in "
          f"[{A_N_RANGE[0]}, {A_N_RANGE[1]}) in bursts {list(A_BURSTS)}, "
          f"capacity {A_PLAN['capacity']}, async refresh every "
          f"{A_PLAN['refresh_every']}: {walls['serve']:.3f} s, "
          f"{len(reqs) / walls['serve']:.2f} devices/s, "
          f"{npts / walls['serve']:.1f} points/s; mean accuracy {acc:.4f} "
          f"(>= {MIN_ATTACH_ACCURACY}); decisions (batch, ladder) "
          f"{decisions}; tau versions served {versions} (final "
          f"{live.tau_version}, refresh pending {st['refresh_pending']}); "
          f"{st['folded']} slots folded, {st['served_devices']} served; "
          f"plane_compiles {st['plane_compiles']}; solve_attach launches by "
          f"shape {solve_line(tally['solve_attach'])}; launches {counts}",
          flush=True)
    print(f"attach restore {policy}/{autoscale}: save after {A_CUT} bursts "
          f"({len(got) - len(rest)} devices; {Path(path).stat().st_size} "
          f"bytes, {walls['save']:.3f} s, refresh staged {pending}), "
          f"Session.restore {walls['restore']:.3f} s, {len(rest)} more "
          f"devices: labels, tau versions, decisions, fold state and tau "
          f"buffers equal the uninterrupted session's bit for bit",
          flush=True)
    return counts, tally, walls["serve"], (plan, bursts)


def attach_leg(fm, rr, device, tmp: Path):
    """The attach leg's two runs on the round the run leg computed, then
    the first run's session under the profiler."""
    from repro_torch.data.gaussian import late_device_stream
    from repro_torch.fed.api import Session
    reqs = late_device_stream(fm.means, KP, sum(A_BURSTS), A_SEED,
                              n_range=A_N_RANGE)
    bursts, lo = [], 0
    for b in A_BURSTS:
        bursts.append(reqs[lo:lo + b])
        lo += b
    counts, tallies, profiled = {}, {}, None
    for policy, autoscale in A_RUNS:
        c, tally, wall, run = attach_run(rr, device, policy, autoscale,
                                         bursts, tmp)
        for name, v in c.items():
            counts[name] = counts.get(name, 0) + v
        tallies[f"attach_{policy}"] = tally
        profiled = profiled or (run, wall)
    (plan, bursts), wall = profiled
    profile("attach", lambda: serve_bursts(Session.from_round(
        plan, rr, seed=0), bursts), wall)
    return counts, tallies


def cli_leg(tmp: Path):
    """The attachment server's command line on the card, as a process of
    its own: it must exit 0 and find the restored session bit for bit
    equal. Returns its launches, which it prints."""
    cmd = [sys.executable, "-m", "repro_torch.launch.attach_server",
           *CLI_ARGS, "--checkpoint", str(tmp / "cli.npz")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=HERE, env={**os.environ,
                                         "PYTHONPATH": str(HERE / "src")})
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0,
            f"cli: exit code {proc.returncode}: {proc.stderr[-2000:]}")
    require(any(ln.endswith("uninterrupted session: True") for ln in lines),
            "cli: the restored session did not serve bit for bit alike")
    counts = json.loads(lines[-1].split("launches: ", 1)[1])
    require(counts["solve_attach"] > 0, "cli: solve_attach not launched")
    print(f"cli: python -m repro_torch.launch.attach_server "
          f"{' '.join(CLI_ARGS)} --checkpoint <tmp>: exit 0 in {wall:.1f} s "
          f"| " + " | ".join(lines), flush=True)
    return counts


def figures_leg(device):
    """The paper's Figures 2 and 3 in full mode, each once, counted and
    tallied: Figure 2's cost ratios of structured to IID partitions and
    Figure 3's cost ratio and bytes of one round against 25 rounds of
    distributed Lloyd."""
    from repro_torch.launch import figures
    rows2, c2, t2 = counted(lambda: figures.fig2(full=True, device=device))
    for r in rows2:
        require(np.isfinite(r["ratio"]) and r["phi_star"] > 0,
                f"{r['name']}: ratio {r['ratio']}")
        print(f"figure {r['name']}: cost ratio (phi(k') - phi*) / (phi(k) -"
              f" phi*) {r['ratio']:.4f}, per seed "
              f"{[round(v, 4) for v in r['ratios']]}; phi* "
              f"{r['phi_star']:.1f}, (phi(k'), phi(k)) "
              f"{[(round(a, 1), round(b, 1)) for a, b in r['costs']]} "
              f"({r['wall_s']:.3f} s)", flush=True)
    print(f"figure 2: launches {c2}", flush=True)
    rows3, c3, t3 = counted(lambda: figures.fig3(full=True, device=device))
    for r in rows3:
        require(np.isfinite(r["ratio"]) and r["bytes_lloyd"]
                > r["bytes_kfed"] > 0, f"{r['name']}: {r}")
        print(f"figure {r['name']}: Z={r['Z']} cost ratio k-FED / Lloyd "
              f"{r['ratio']:.4f} (phi {r['phi_kfed']:.1f} / "
              f"{r['phi_lloyd']:.1f}); bytes k-FED {r['bytes_kfed']}, Lloyd "
              f"{r['bytes_lloyd']} ({r['bytes_lloyd'] / r['bytes_kfed']:.1f}"
              f"x); k-FED round {r['kfed_s']:.3f} s, 25 Lloyd rounds "
              f"{r['lloyd_s']:.3f} s", flush=True)
    print(f"figure 3: launches {c3}", flush=True)
    return c2, t2, c3, t3


def small_attach_agreement(device):
    """The attach leg's plan at k=12, d=24 under lru, async and latency,
    on ``device`` and on the CPU from the same round inputs: labels,
    tau versions and the decision sequence exact."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(5, k=12, d=24, k_prime=3, m0=2,
                            n_per_comp_dev=12, sep=30.0)
    reqs = late_device_stream(fm.means, 3, 32, 9, n_range=(10, 150))
    bursts, lo = [], 0
    for b in (1, 2, 3, 5, 8, 13):
        bursts.append(reqs[lo:lo + b])
        lo += b
    runs = []
    for dev in (device, "cpu"):
        plan = FederationPlan(k=12, k_prime=3, d=24, device=str(dev),
                              capacity=10, batch_size=4,
                              bucket_sizes=(32, 64), refresh_every=4,
                              refresh="async", fold_policy="lru",
                              autoscale="latency")
        sess = Session(plan, seed=2)
        sess.run(7, fm.data)
        runs.append(serve_bursts(sess, bursts))
    (got, gdec), (want, wdec) = runs
    require(same_served(got, want) and gdec == wdec,
            "small attach: labels, tau versions or decisions differ from "
            "the CPU")
    return len(got), len({v for _, v in got.values()})


def solve_shapes(tallies) -> None:
    """solve_attach at every shape the attach leg launched it at, on the
    first inputs there: held against its plain version (check_solve),
    its device time by graph replay beside the bound, and its plan."""
    from repro_torch.kernels.solve_attach import plan, solve_attach
    shapes = merged(tallies, "solve_attach")
    for key, entry in shapes.items():
        x, c0, tau, cm, pm, max_iters = entry["inputs"]
        err = check_solve(x, c0, tau, cm, pm, "f32", max_iters)
        iters, work = solve_work(x, c0, tau, cm, pm, max_iters)
        bms, by = bound(*work)
        dev_ms = graph_ms(lambda: solve_attach(x, c0, tau, cm, pm,
                                               max_iters=max_iters))
        B, n, d = x.shape
        pl = plan(n, c0.shape[1], d, x.dtype, x.device)
        print(f"solve ({B},{n},{d}) k'={key[1]} k={key[2]} {key[3]}: "
              f"launches {json.dumps(entry['launches'])}; iterations "
              f"{iters.tolist()}; max_abs_err={err:.3e} match=True | "
              f"device ms={dev_ms:.4f} bound_ms={bms:.5f} ({by}) | "
              f"P={pl.slices} slices of R={pl.rows} rows, "
              f"{'resident' if pl.resident else 'streaming'}, "
              f"{min(B, pl.groups)} groups ({pl.groups} fit at once), "
              f"{min(B, pl.groups) * pl.slices} blocks on {pl.sms} SMs",
              flush=True)


def small_lm_agreement(device):
    """Reduced Mixtral (f32; 2 layers, d=256, W=64) through
    launch.serve.generate on ``device`` and on the CPU from the same
    parameters: 2 prompts of 64 tokens, 8 greedy steps over the ring.
    Tokens exact, logits within 1e-4 of their largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    cfg = get_config("mixtral-8x7b", reduced=True).replace(dtype="float32")
    model = build_model(cfg)
    params = init_params(model, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64)), dtype=torch.int32)
    runs = []
    for dev in (device, torch.device("cpu")):
        stats = {}
        out = generate(model, tree_map(lambda a: a.to(dev), params),
                       {"tokens": toks}, steps=8, stats=stats)
        runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                             for lg in stats["logits"]])))
    (t1, l1), (t0, l0) = runs
    require(torch.equal(t1, t0), "small LM: tokens differ from the CPU")
    err = float((l1 - l0).abs().max())
    require(err <= 1e-4 * float(l0.abs().max()),
            f"small LM: logits differ from the CPU by {err}")
    return err


def decode_leg(device):
    """LM serving at Mixtral-8x7B's full width, 8 of 32 layers: a
    warm-up, then 4 prompts of 4096 tokens and 32 greedy steps through
    launch.serve.generate between a reset and a read of the launch
    counts. Every step takes the ring branch (4096 + 33 > W = 4096), so
    each layer launches swa_decode once a step; each MoE layer launches
    moe_dispatch and moe_combine once in the prefill and once a step.
    Then swa_decode is held against its plain version on the leg's own
    layer-0 ring and last query; one more generate tallies moe_combine
    by shape (returned beside the counts); one more prefill of the same
    batch is timed, then profiled, and 8 more steps run under the
    profiler."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.swa_decode import swa_decode_attention as swa
    from repro_torch.launch.serve import (generate, init_params,
                                          make_prefill, make_serve_step)
    from repro_torch.models.common import apply_norm, apply_rope, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_params
    t_leg = time.perf_counter()
    full = get_config("mixtral-8x7b")
    cfg = full.replace(n_layers=MX_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=MX_SEED, device=device)
    sync()
    init_s = time.perf_counter() - t0
    leaves = []
    tree_map(leaves.append, params)
    pbytes = sum(a.numel() * a.element_size() for a in leaves)
    prompts = torch.as_tensor(np.random.default_rng(MX_SEED).integers(
        0, cfg.vocab_size, size=(MX_BATCH, MX_PROMPT)), dtype=torch.int32)
    batch = {"tokens": prompts}
    generate(model, params, batch, steps=2)           # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    stats = {}
    toks = generate(model, params, batch, steps=MX_STEPS, stats=stats)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    cache = stats["cache"]
    B, V = MX_BATCH, cfg.vocab_size
    require(tuple(toks.shape) == (B, MX_STEPS)
            and bool(((toks >= 0) & (toks < V)).all()), "decode: tokens")
    require(all(tuple(lg.shape) == (B, V) and bool(torch.isfinite(lg).all())
                for lg in stats["logits"]), "decode: logits not finite")
    require(all("pos" in seg for seg in cache["segments"]),
            "decode: the cache is not a ring")
    want = {"swa_decode": MX_LAYERS * MX_STEPS,
            "moe_dispatch": MX_LAYERS * (MX_STEPS + 1),
            "moe_combine": MX_LAYERS * (MX_STEPS + 1)}
    require(all(counts[k] == n for k, n in want.items()),
            f"decode: launches {counts}, expected {want}")

    # swa_decode on the leg's own layer-0 ring and the last step's query.
    seg, lp = cache["segments"][0], layer_params(params["segments"][0], 0)
    pos = cache["len"].long() - 1
    require(bool((seg["pos"][0].amax(dim=-1) == pos).all()),
            "decode: the ring does not hold the last position")
    h = apply_norm(cfg.norm, lp["ln1"], params["embed"][toks[:, -1].long()])
    q = (h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0].contiguous()
    bias = torch.where(seg["pos"][0] >= 0, 0.0, -1e30).float()
    scale = 1.0 / math.sqrt(cfg.hd)
    got = swa(q, seg["k"][0], seg["v"][0], bias, scale)
    ref_out = ref.swa_decode_attention(q, seg["k"][0], seg["v"][0], bias,
                                       scale)
    sync()
    serr = float((got.float() - ref_out.float()).abs().max())
    require(serr <= 2e-2 * float(ref_out.float().abs().max()),
            f"decode: swa_decode on the leg's ring differs by {serr}")

    # Bounds. Decode: every parameter but the embedding table is read
    # each step (every expert's queue has C >= 1 slots), plus B embedding
    # rows and the rings' keys and values. Prefill: the products the
    # model needs (bf16 on the tensor cores; attention scores and
    # weighted sums in f32), counting only the routed (token, expert)
    # pairs.
    emb = params["embed"]
    kv_bytes = sum(seg[n].numel() * seg[n].element_size()
                   for seg in cache["segments"] for n in ("k", "v"))
    step_bytes = (pbytes - emb.numel() * emb.element_size()
                  + B * cfg.d_model * emb.element_size() + kv_bytes)
    step_bound_ms = step_bytes / PEAK_HBM_BYTES * 1e3
    T, d, H, KVH, hd = B * MX_PROMPT, cfg.d_model, cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    m = cfg.moe
    pairs = sum(min(i + 1, cfg.sliding_window) for i in range(MX_PROMPT))
    bf16_flops = MX_LAYERS * (2 * T * d * (2 * H + 2 * KVH) * hd
                              + 2 * T * d * m.n_experts
                              + 2 * T * m.top_k * 3 * d * m.d_expert) \
        + 2 * B * d * V
    f32_flops = MX_LAYERS * 4 * B * H * hd * pairs
    prefill_bound_s = bf16_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS
    prefill_s, decode_s = stats["prefill_s"], stats["decode_s"]
    step_ms = decode_s / MX_STEPS * 1e3
    print(f"decode: Mixtral-8x7B (d={d}, {H} heads / {KVH} kv heads of {hd}, "
          f"{m.n_experts} experts top-{m.top_k} of {m.d_expert}, vocab {V}, "
          f"W={cfg.sliding_window}, bf16) cut to {MX_LAYERS} of "
          f"{full.n_layers} layers ({full.n_layers} layers are about "
          f"{pbytes / MX_LAYERS * full.n_layers / 1e9:.0f} GB in bf16, more "
          f"than the card's 80 GB; {MX_LAYERS} are {pbytes / 1e9:.2f} GB, "
          f"drawn on the card in {init_s:.2f} s): {B} prompts of {MX_PROMPT} "
          f"tokens, {MX_STEPS} greedy steps through launch.serve.generate "
          f"over the ring cache | prefill {prefill_s:.3f} s, "
          f"{T / prefill_s:.1f} tokens/s (bound {prefill_bound_s:.3f} s, "
          f"operations: {bf16_flops:.3e} bf16 + {f32_flops:.3e} f32 flops) | "
          f"decode {decode_s:.3f} s, {B * MX_STEPS / decode_s:.1f} tokens/s, "
          f"{step_ms:.3f} ms per step (bound {step_bound_ms:.3f} ms, bytes: "
          f"{step_bytes / 1e9:.2f} GB per step) | peak memory "
          f"{peak_gb:.2f} GB | logits finite, swa_decode on the leg's layer-0 "
          f"ring max_abs_err={serr:.3e} | launches {counts} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)

    # One more pass, moe_combine's launches tallied by shape (the
    # prefill's and the steps').
    with Tally("moe_combine", combine_key) as combine_tally:
        generate(model, params, batch, steps=MX_STEPS)
        sync()

    # One more prefill of the same batch, timed alone, then profiled.
    prefill = make_prefill(model)
    dev_batch = {"tokens": prompts.to(device)}
    with torch.no_grad():
        t0 = time.perf_counter()
        prefill(params, dev_batch)
        sync()
        prefill_wall = time.perf_counter() - t0
        profile("prefill", lambda: prefill(params, dev_batch), prefill_wall)

    step = make_serve_step(model)
    tok = toks[:, -1].to(device)

    def eight_steps():
        c = cache
        for _ in range(8):
            _, c = step(params, c, tok)

    profile("decode", eight_steps, decode_s * 8 / MX_STEPS)
    del params, cache, stats
    torch.cuda.empty_cache()
    return counts, {"moe_combine": combine_tally}


def drift_stats(sess):
    """A drift session's state to replay: (events, moves, last moves),
    the mass and the staged head re-map."""
    svc = sess.service
    return ((svc._drift_events, svc._drift_moves, svc._drift_last),
            svc._drift_mass.copy(),
            None if svc._heads_perm is None else svc._heads_perm.copy())


def same_drift(a, b) -> bool:
    (ca, ma, pa), (cb, mb, pb) = a, b
    return ca == cb and np.array_equal(ma, mb) and (
        (pa is None and pb is None)
        or (pa is not None and pb is not None and np.array_equal(pa, pb)))


def same_predictions(got, want) -> bool:
    """Routed results bit for bit: labels, versions, clusters, routing
    and predictions."""
    return len(got) == len(want) and all(
        np.array_equal(g.labels, w.labels)
        and np.array_equal(g.prediction, w.prediction)
        and (g.tau_version, g.cluster, g.routed)
        == (w.tau_version, w.cluster, w.routed) for g, w in zip(got, want))


def small_drift_agreement(device):
    """A small split_merge session, heads off and on (linear heads), on
    ``device`` against the CPU run of the plain versions: labels,
    versions, clusters, routing, drift events and moves exact, mass
    and predictions within 1e-5 relative."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(0, k=DR_K, d=DR_D, k_prime=DR_KP, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    means = np.random.default_rng(3).normal(size=(DR_K, DR_D)).astype(
        np.float32) * 40.0
    reqs = late_device_stream(means, DR_KP, 24, 19, n_range=(15, 50))
    datas, kvs = [r[0] for r in reqs], [r[2] for r in reqs]
    moves = {}
    for heads in ("off", "linear"):
        outs = []
        for dev in (device, "cpu"):
            plan = FederationPlan(k=DR_K, k_prime=DR_KP, d=DR_D,
                                  device=str(dev), capacity=512,
                                  batch_size=4, bucket_sizes=(32, 64, 128),
                                  refresh_every=4, drift="split_merge",
                                  drift_half_life=24, drift_retire_frac=0.2,
                                  heads=heads)
            sess = Session(plan, seed=2)
            sess.run(7, fm.data)
            served = []
            for lo in range(0, 24, 6):
                if heads == "off":
                    served += sess.serve_versioned(datas[lo:lo + 6],
                                                   kvs[lo:lo + 6])
                else:
                    served += sess.serve_predict(datas[lo:lo + 6],
                                                 kvs[lo:lo + 6])
            outs.append((served, drift_stats(sess)))
        (got, (gc, gm, _)), (want, (wc, wm, _)) = outs
        if heads == "off":
            same = all(np.array_equal(a, b) and va == vb
                       for (a, va), (b, vb) in zip(got, want))
        else:
            same = all(np.array_equal(g.labels, w.labels)
                       and (g.tau_version, g.cluster, g.routed)
                       == (w.tau_version, w.cluster, w.routed)
                       for g, w in zip(got, want))
            gp = np.stack([g.prediction for g in got])
            wp = np.stack([w.prediction for w in want])
            require(float(np.abs(gp - wp).max())
                    <= 1e-5 * float(np.abs(wp).max()),
                    "small routed drift: predictions differ from the CPU")
        require(same and gc == wc, f"small drift (heads {heads}): labels, "
                f"versions or drift counters {gc} differ from the CPU's {wc}")
        require(float(np.abs(gm - wm).max()) <= 1e-5 * float(np.abs(wm).max()),
                f"small drift (heads {heads}): mass differs from the CPU")
        moves[heads] = gc[1]
    require(moves["off"] > 0, "small drift: no center moved")
    return moves


def drift_leg(device):
    """benchmarks/bench_drift.py in full mode on the port's draws:
    frozen against split_merge, between a reset and a read of the launch
    counts. split_merge must mislabel no more than frozen (the
    benchmark's own bar)."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.utils.metrics import clustering_accuracy
    fm = structured_devices(0, k=DR_K, d=DR_D, k_prime=DR_KP, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    base = FederationPlan(k=DR_K, k_prime=DR_KP, d=DR_D, device=str(device))
    rr = Session(base).run(1, fm.data).detail
    new_means = np.random.default_rng(7).normal(size=(DR_K, DR_D)).astype(
        np.float32) * 40.0

    def phase(means, count, seed):
        st = late_device_stream(means, DR_KP, count, seed, n_range=(20, 60))
        return [r[0] for r in st], [r[1] for r in st], [r[2] for r in st]

    reqs1, _, kvs1 = phase(fm.means, DR_P1, 5)
    reqs2, truths2, kvs2 = phase(new_means, DR_P2, 11)
    runs = {}

    def drive():
        for name, kw in DR_RUNS:
            sess = Session.from_round(base.with_options(
                capacity=512, batch_size=DR_CHUNK, bucket_sizes=(64,), **kw),
                rr)
            # Phase 1: the stale evidence the drift layer must decay
            # away (and the first launches of each shape), untimed.
            for lo in range(0, DR_P1, DR_CHUNK):
                sess.serve(reqs1[lo:lo + DR_CHUNK], kvs1[lo:lo + DR_CHUNK])
            sync()
            labels = []
            t0 = time.perf_counter()
            for lo in range(0, DR_P2, DR_CHUNK):
                labels += sess.serve(reqs2[lo:lo + DR_CHUNK],
                                     kvs2[lo:lo + DR_CHUNK])
            sync()
            wall = time.perf_counter() - t0
            errs = [1.0 - clustering_accuracy(lbl, tr, DR_K)
                    for lbl, tr in zip(labels, truths2)]
            st = sess.stats()["drift"]
            runs[name] = dict(
                mislabel=float(np.mean(errs[len(errs) // 2:])), wall=wall,
                pps=sum(r.shape[0] for r in reqs2) / wall,
                version=sess.tau_version, events=st["events"],
                moves=st["moves"])

    _, counts, tally = counted(drive)
    gain = (runs["frozen"]["mislabel"] + 1e-3) / (
        runs["split_merge"]["mislabel"] + 1e-3)
    print(f"drift: bench_drift full mode k={DR_K} k'={DR_KP} d={DR_D}, "
          f"{DR_P1} + {DR_P2} requests, batch {DR_CHUNK}: "
          + "; ".join(f"{n} tail mislabel {r['mislabel']:.4f}, "
                      f"{r['pps']:.1f} pts/s ({r['wall']:.3f} s for phase 2),"
                      f" tau_version {r['version']}, drift events "
                      f"{r['events']}, moves {r['moves']}"
                      for n, r in runs.items())
          + f"; mislabel_gain {gain:.2f}; launches {counts}", flush=True)
    require(runs["split_merge"]["mislabel"] <= runs["frozen"]["mislabel"],
            f"drift: split_merge mislabels {runs['split_merge']['mislabel']}"
            f" > frozen {runs['frozen']['mislabel']}")
    require(runs["split_merge"]["moves"] > 0, "drift: no center moved")
    return counts, tally


def drift_table1_inputs(fm):
    """Table 1's 32 late devices of n=1024, drawn from a resampled
    mixture of the same separation."""
    from repro_torch.data.gaussian import late_device_stream, make_mixture_means
    means = make_mixture_means(np.random.default_rng(7), K, D, sep=SEP)
    reqs = late_device_stream(means, KP, SERVE_REQUESTS, 7,
                              n_range=(SERVE_N, SERVE_N + 1))
    return [r[0] for r in reqs], [r[2] for r in reqs]


def drift_table1_leg(fm, rr, device, tmp: Path):
    """Table 1's serve plan under decay and split_merge on the run leg's
    round, between a reset and a read of the launch counts: an
    uninterrupted session serves the 32 late devices in two halves,
    another the first half, saves, and a restored session the second;
    labels, versions, fold state, mass, moves and the staged head
    re-map must replay bit for bit. Then a refresh of each is timed
    beside a refresh without drift on the same fold state."""
    from repro_torch.core import server
    from repro_torch.fed.api import FederationPlan, Session
    datas, kvs = drift_table1_inputs(fm)
    h = DT_CUT
    out = {}

    def drive():
        for name, kw in DT_RUNS:
            plan = FederationPlan(k=K, k_prime=KP, d=D, device=str(device),
                                  **SERVE_PLAN, **kw)
            live = Session.from_round(plan, rr, seed=0)
            t0 = time.perf_counter()
            want = (live.serve_versioned(datas[:h], kvs[:h])
                    + live.serve_versioned(datas[h:], kvs[h:]))
            sync()
            wall = time.perf_counter() - t0
            first = Session.from_round(plan, rr, seed=0)
            got = first.serve_versioned(datas[:h], kvs[:h])
            path = first.save(str(tmp / f"drift_{name}.npz"))
            restored = Session.restore(path, plan)
            got += restored.serve_versioned(datas[h:], kvs[h:])
            sync()
            out[name] = (live, restored, want, got, wall)

    _, counts, tally = counted(drive)
    lines = []
    for name, (live, restored, want, got, wall) in out.items():
        require(all(np.array_equal(g, w) and gv == wv
                    for (g, gv), (w, wv) in zip(got, want)),
                f"drift {name}: the restored session's labels or versions "
                f"differ from the uninterrupted session's")
        require(all(torch.equal(a, b) for a, b in
                    zip(restored.service.state, live.service.state))
                and same_drift(drift_stats(restored), drift_stats(live)),
                f"drift {name}: the restored fold state, mass, moves or "
                f"head re-map differ")
        st = live.stats()["drift"]
        svc = live.service
        sync()
        t0 = time.perf_counter()
        server.finalize(svc.state, K)
        sync()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc._refinalize()
        sync()
        drift_s = time.perf_counter() - t0
        lines.append(f"{name} {wall:.3f} s for {SERVE_REQUESTS} devices "
                     f"({SERVE_REQUESTS / wall:.2f} requests/s), tau "
                     f"versions {sorted({v for _, v in want})}, drift "
                     f"events {st['events']}, moves {st['moves']}, a "
                     f"refresh {1e3 * drift_s:.2f} ms with drift against "
                     f"{1e3 * plain_s:.2f} ms without")
    moves = out["split_merge"][0].stats()["drift"]["moves"]
    print(f"drift table1: serve plan d={D} k={K} k'={KP} batch "
          f"{SERVE_PLAN['batch_size']} refresh every "
          f"{SERVE_PLAN['refresh_every']}, late devices from a resampled "
          f"mixture: " + "; ".join(lines) + f"; each cut by save and "
          f"restore after {h}: labels, versions, fold state, mass, moves "
          f"and head re-map equal the uninterrupted session's bit for bit;"
          f" launches {counts}", flush=True)
    require(moves >= 1, "drift table1: split_merge moved no center")
    return counts, tally


def route_drift_leg(device):
    """The routed leg's configuration under split_merge, between a reset
    and a read of the launch counts: RD_WAVES waves of 64 from resampled
    means through serve_predict. At least one center moves and its
    re-map commits (a head now holds another's parameters), none is
    left pending, and the labels and versions equal a heads-off drift
    twin's."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.models.heads import tree_map
    fm = structured_devices(0, k=R_K, d=R_D, k_prime=R_KP, m0=R_M0,
                            n_per_comp_dev=R_NPER, sep=R_SEP)
    base = FederationPlan(k=R_K, k_prime=R_KP, d=R_D, device=str(device))
    rr = Session(base).run(1, fm.data).detail
    plan = base.with_options(**R_PLAN, **RD_DRIFT)
    B = plan.batch_size
    means = np.random.default_rng(3).normal(size=(R_K, R_D)).astype(
        np.float32) * 40.0
    stream = late_device_stream(means, R_KP, RD_WAVES * B, 5,
                                n_range=R_N_RANGE)
    waves = [([r[0] for r in stream[lo:lo + B]],
              [r[2] for r in stream[lo:lo + B]])
             for lo in range(0, RD_WAVES * B, B)]
    sess = Session.from_round(plan, rr, seed=0)
    heads0 = tree_map(lambda a: a.clone(), sess.service.heads)
    walls = {}

    def drive():
        t0 = time.perf_counter()
        out = [p for w in waves for p in sess.serve_predict(*w)]
        sync()
        walls["serve"] = time.perf_counter() - t0
        return out

    served, counts, tally = counted(drive)
    twin = Session.from_round(plan.with_options(heads="off"), rr, seed=0)
    plain = [x for w in waves for x in twin.serve_versioned(*w)]
    require(all(np.array_equal(p.labels, lbl) and p.tau_version == v
                for p, (lbl, v) in zip(served, plain)),
            "route drift: labels or versions differ from the heads-off "
            "drift twin's")
    st = sess.stats()
    moved = sorted({c for a, b in zip(_leaves(heads0),
                                      _leaves(sess.service.heads))
                    for c in range(R_K) if not torch.equal(a[c], b[c])})
    require(st["drift"]["moves"] > 0 and moved,
            f"route drift: no committed head re-map ({st['drift']})")
    require(not st["heads"]["remap_pending"],
            "route drift: a head re-map is left pending")
    require(twin.stats()["drift"]["moves"] == st["drift"]["moves"],
            "route drift: the twin moved other centers")
    print(f"route drift: Session.serve_predict k={R_K} k'={R_KP} d={R_D} "
          f"heads={plan.heads}/{plan.head_arch} split_merge refresh every "
          f"{RD_DRIFT['refresh_every']} (half-life "
          f"{RD_DRIFT['drift_half_life']}): {RD_WAVES} waves of {B} from "
          f"resampled means in {walls['serve']:.3f} s "
          f"({len(served) / walls['serve']:.2f} requests/s); drift events "
          f"{st['drift']['events']}, moves {st['drift']['moves']}, heads "
          f"of centers {moved} re-mapped and committed, none pending; "
          f"labels and versions equal the heads-off drift twin's; routed "
          f"{sum(p.routed for p in served)} of {len(served)}; launches "
          f"{counts}", flush=True)
    return counts, tally


# ------------------------------------------------------------ encoder --

def token_sequences(points, seqs, seed: int, device, first: int = 0):
    """Each point's raw token sequence: the point plus N(0, ET_NOISE^2)
    noise per token, drawn on ``device`` (request i from the generator
    seeded seed * 1000 + first + i, so any subset draws the same bits);
    host arrays (n, s, d)."""
    out = []
    for i, (x, s) in enumerate(zip(points, seqs)):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1000 + first + i)
        xt = torch.as_tensor(x, device=device)
        t = xt[:, None, :] + ET_NOISE * torch.randn(
            (xt.shape[0], int(s), xt.shape[1]), generator=gen,
            device=device)
        out.append(t.cpu().numpy())
    return out


def service_encoder(plan, seed: int = 0):
    """The encoder parameters a session of ``plan`` draws from ``seed``
    (the service's own salted stream)."""
    from repro_torch.fed.api import Session
    return Session.from_tau(plan.with_options(refresh_every=0),
                            np.zeros((plan.k, plan.d), np.float32),
                            seed=seed).service.encoder


def encoded_round(data, plan, seq: int, seed: int, device):
    """The round on the devices' encoded sequences: every point becomes
    ``seq`` tokens (token_sequences), encoded by the encoder the plan's
    service draws from seed 0 so that tau lives where the served
    embeddings do, then Session.run. Returns (round, encode seconds)."""
    from repro_torch.fed.api import Session
    from repro_torch.models.encoder import apply_encoder
    spec = plan.stream_config().encoder_spec()
    params = service_encoder(plan)
    Z, n, d = data.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.as_tensor(data, device=device)
    sync()
    t0 = time.perf_counter()
    tok = x[:, :, None, :] + ET_NOISE * torch.randn(
        (Z, n, seq, d), generator=gen, device=device)
    tmask = torch.ones(tok.shape[:-1], dtype=torch.bool, device=device)
    emb = apply_encoder(params, tok, tmask, spec, plan.encode_dtype)
    sync()
    enc_s = time.perf_counter() - t0
    del tok, tmask
    return Session(plan).run(0, emb).detail, enc_s


def small_encode_agreement(device):
    """tests/test_encode_serve.py's plan on its 7 ragged requests, on the
    card against the CPU run: f32, bf16 storage, and the granite-3-2b
    encoder (GQA) with linear heads. Embeddings within rtol 1e-5 / atol
    1e-5 (bf16: 1e-2 of max(max|y|, 1)); labels, versions, encoder stats
    (and clusters and routing) exact; predictions within 1e-5 of their
    largest magnitude."""
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.models.encoder import apply_encoder
    rng = np.random.default_rng(1)
    reqs = []
    for _ in range(7):
        n, s = int(rng.integers(4, 14)), int(rng.integers(2, 17))
        reqs.append(np.asarray(rng.normal(size=(n, s, 16)), np.float32))
    tau = np.asarray(np.random.default_rng(0).normal(size=(8, 16)) * 4,
                     np.float32)
    errs = {}
    for name, opts in (("f32", {}), ("bf16", dict(encode_dtype="bf16")),
                       ("granite+heads", dict(encoder="granite-3-2b",
                                              heads="linear"))):
        outs = []
        for dev in (device, "cpu"):
            plan = FederationPlan(**{**E_PLAN, **opts}, device=str(dev))
            sess = Session.from_tau(plan, tau, seed=0)
            served = (sess.serve_predict(reqs) if "heads" in opts
                      else sess.serve_versioned(reqs))
            spec = plan.stream_config().encoder_spec()
            embs = [apply_encoder(sess.service.encoder,
                                  torch.as_tensor(r, device=dev),
                                  torch.ones(r.shape[:2], dtype=torch.bool,
                                             device=dev),
                                  spec, plan.encode_dtype).cpu()
                    for r in reqs]
            outs.append((served, sess.stats()["encoder"], embs))
        (got, gst, gemb), (want, wst, wemb) = outs
        require(gst == wst, f"encode small {name}: encoder stats differ: "
                            f"{gst} != {wst}")
        g, w = torch.cat(gemb), torch.cat(wemb)
        err = float((g - w).abs().max())
        bound = (1e-5 + 1e-5 * w.abs() if name != "bf16"
                 else 1e-2 * max(float(w.abs().max()), 1.0))
        require(bool(((g - w).abs() <= bound).all()),
                f"encode small {name}: embeddings differ by {err}")
        if "heads" in opts:
            require(all(np.array_equal(a.labels, b.labels)
                        and (a.tau_version, a.cluster, a.routed)
                        == (b.tau_version, b.cluster, b.routed)
                        for a, b in zip(got, want)),
                    f"encode small {name}: labels, versions, clusters or "
                    f"routing differ from the CPU")
            gp = np.stack([a.prediction for a in got])
            wp = np.stack([b.prediction for b in want])
            require(np.abs(gp - wp).max() <= 1e-5 * np.abs(wp).max(),
                    f"encode small {name}: predictions differ")
        else:
            require(all(np.array_equal(a, b) and va == vb
                        for (a, va), (b, vb) in zip(got, want)),
                    f"encode small {name}: labels or versions differ from "
                    f"the CPU")
        errs[name] = err
    return len(reqs), errs


def wall_ms(fn, reps: int = 11, warmup: int = 2) -> float:
    """Median wall of one call, synchronized, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return 1e3 * sorted(ts)[reps // 2]


def device_ms(fn):
    """Device time of one call: the sum of its kernels' own times under
    torch.profiler (None where the profiler records none)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    t = sum(e.self_device_time_total for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA"))
    return t / 1e3 if t else None


def encode_bench_leg(device):
    """benchmarks/bench_encode_serve.py's configuration, not cut: the
    fused encode_step against the unbatched front end (B encode calls,
    then one serve step) on identical inputs, device time and wall;
    each request's embedding alone within 1e-5 of the batch's, its
    labels equal wherever the gap between its two nearest tau centers
    is above 10x that tolerance (times sqrt(d), the most a move within
    the tolerance can change a distance); then the session part, 6 waves
    of 32 requests, whose step shapes must stay flat after the first."""
    from repro_torch.fed import plane as plane_mod
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.models.encoder import apply_encoder, init_encoder
    from repro_torch.utils.prng import GumbelSource
    cfg = StreamConfig(k=EB_K, k_prime=EB_KP, d=EB_D, capacity=64,
                       batch_size=EB_B, bucket_sizes=(EB_N,),
                       encoder=E_PLAN["encoder"], encode_seq_len=EB_S)
    spec = cfg.encoder_spec()
    gen = torch.Generator(device=device).manual_seed(0)
    tau = torch.randn((EB_K, EB_D), generator=gen, device=device) * 8.0
    data = torch.randn((EB_B, EB_N, EB_S, EB_D), generator=gen,
                       device=device)
    pmask = torch.ones((EB_B, EB_N), dtype=torch.bool, device=device)
    tmask = torch.ones((EB_B, EB_N, EB_S), dtype=torch.bool, device=device)
    kv = torch.full((EB_B,), EB_KP, dtype=torch.int32, device=device)
    g = GumbelSource(0).draw(list(range(EB_B)), EB_KP, EB_N, device)
    params = init_encoder(torch.Generator().manual_seed(0), spec,
                          device=device)
    fused_step = plane_mod._make_encode_step(cfg)
    step = plane_mod._make_step(cfg)

    def fused():
        return fused_step(tau, params, g, data, pmask, kv, tmask)

    def unbatched():
        embs = [apply_encoder(params, data[i], tmask[i], spec)
                for i in range(EB_B)]
        return step(tau, g, torch.stack(embs), pmask, kv)

    times = {name: (wall_ms(fn), device_ms(fn))
             for name, fn in (("fused", fused), ("unbatched", unbatched))}
    emb = apply_encoder(params, data, tmask, spec)
    alone = torch.stack([apply_encoder(params, data[i], tmask[i], spec)
                         for i in range(EB_B)])
    tol = 1e-5 + 1e-5 * emb.abs()
    err = float((alone - emb).abs().max())
    require(bool(((alone - emb).abs() <= tol).all()),
            f"encode bench: a request alone embeds {err} off its batch")
    exact = int(torch.equal(alone, emb))
    lf, lu = fused()[0], unbatched()[0]
    d2 = torch.cdist(emb.reshape(-1, EB_D).double(), tau.double())
    two = torch.topk(d2, 2, largest=False).values
    gap = (two[:, 1] - two[:, 0]).reshape(EB_B, EB_N)
    sure = gap > 10 * float(tol.max()) * EB_D ** 0.5
    require(torch.equal(lf[sure], lu[sure]),
            "encode bench: labels of a request alone differ from the "
            "batch's where the gap is wide")
    near = int((~sure).sum())
    # The session part.
    rng = np.random.default_rng(0)
    plan = FederationPlan(k=EB_K, k_prime=EB_KP, d=EB_D, capacity=256,
                          batch_size=EB_B, bucket_sizes=(EB_N,),
                          encoder=E_PLAN["encoder"], encode_seq_len=EB_S,
                          device=str(device))
    stau = np.asarray(rng.normal(size=(EB_K, EB_D)) * 8, np.float32)
    reqs = [np.asarray(rng.normal(size=(EB_N, EB_S, EB_D)), np.float32)
            for _ in range(EB_WAVES * EB_B)]

    def drive():
        sess = Session.from_tau(plan, stau)
        sess.serve(reqs[:EB_B])
        warm = sess.stats()["plane_compiles"]
        sync()
        t0 = time.perf_counter()
        served = sum(lbl.shape[0] for lo in range(EB_B, len(reqs), EB_B)
                     for lbl in sess.serve(reqs[lo:lo + EB_B]))
        sync()
        return sess, warm, served, time.perf_counter() - t0

    (sess, warm, served, wall), counts, tally = counted(drive)
    steady = sess.stats()["plane_compiles"] - warm
    require(steady == 0, f"encode bench: {steady} new step shapes after "
                         f"the first wave")
    (fw, fd), (uw, ud) = times["fused"], times["unbatched"]
    fmt = (lambda v: "not measured" if v is None else f"{v:.4f} ms")
    print(f"encode bench: bench_encode_serve.py's configuration k={EB_K} "
          f"k'={EB_KP} d={EB_D} B={EB_B} N={EB_N} S={EB_S} "
          f"{E_PLAN['encoder']}: fused encode_step wall {fw:.4f} ms "
          f"(device {fmt(fd)}), unbatched front end ({EB_B} encode calls "
          f"+ one step) wall {uw:.4f} ms (device {fmt(ud)}); unbatched / "
          f"fused wall {uw / fw:.2f}x"
          + ("" if fd is None or ud is None else
             f", device {ud / fd:.2f}x")
          + f" (the JAX bench's CPU bar is >= 3x; not gated here); a "
          f"request alone embeds within 1e-5 of its batch (max |diff| "
          f"{err:.3e}, bit for bit: {bool(exact)}), labels equal where the"
          f" gap is wide, {near} of {EB_B * EB_N} points under the gap; "
          f"session {EB_WAVES - 1} waves of {EB_B} after a warm-up in "
          f"{wall:.3f} s ({served / wall:.1f} points/s), plane_compiles "
          f"flat after the first wave ({warm}); launches {counts}",
          flush=True)
    return counts, tally


def rung_lengths(rng, count: int, span) -> np.ndarray:
    """``count`` sequence lengths in [span[0], span[1]): a power-of-two
    rung drawn uniformly from those the span reaches, then a length
    uniformly among the lengths that pad to it, so every rung occurs."""
    lo, hi = span
    rungs = [r for r in (8, 16, 32, 64, 128, 256) if lo <= r < hi]
    r = np.asarray(rungs)[rng.integers(0, len(rungs), size=count)]
    first = np.maximum(r // 2 + 1, lo)
    return (first + (rng.random(count) * (r - first + 1))).astype(np.int64)


def encode_table1_inputs(fm, device, count: int = SERVE_REQUESTS):
    """Table 1's late devices (n=1024, the serve leg's) as raw token
    sequences of ET_SEQ lengths: (datas, kvs, labels, seqs)."""
    from repro_torch.data.gaussian import late_device_stream
    reqs = late_device_stream(fm.means, KP, SERVE_REQUESTS, 7,
                              n_range=(SERVE_N, SERVE_N + 1))[:count]
    seqs = rung_lengths(np.random.default_rng(17), SERVE_REQUESTS,
                        ET_SEQ_RANGE)[:count]
    datas = token_sequences([r[0] for r in reqs], seqs, 23, device)
    return datas, [r[2] for r in reqs], [r[1] for r in reqs], seqs


def encode_profile(label: str, fn, wall_s: float):
    """Runs ``fn`` once under torch.profiler and prints its device time
    split by the operators that launched it: GEMMs (aten::mm,
    aten::addmm), the attention's batched products and softmax
    (aten::bmm, which also takes the pool's small product, and
    aten::_softmax), the local solve's SVD (aten::_linalg_svd, cuSOLVER
    and its QR), the port's kernels (by name), and the rest (elementwise
    work, norms, casts, copies). Returns fn's result."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    ka = prof.key_averages()
    dev = [e for e in ka if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in dev) / 1e3
    if not total:
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)", flush=True)
        return out
    port = sum(e.self_device_time_total for e in dev
               if "repro_torch" in e.key) / 1e3
    ops_ = {e.key: e.self_device_time_total / 1e3 for e in ka
            if not str(e.device_type).endswith("CUDA")}
    gemm = ops_.get("aten::mm", 0.0) + ops_.get("aten::addmm", 0.0)
    attn = ops_.get("aten::bmm", 0.0) + ops_.get("aten::_softmax", 0.0)
    svd = ops_.get("aten::_linalg_svd", 0.0)
    other = total - gemm - attn - svd - port
    print(f"profile {label}: device time {total:.2f} ms of "
          f"{wall_s * 1e3:.1f} ms unprofiled wall (busy "
          f"{100 * total / (wall_s * 1e3):.1f}%): GEMMs {gemm:.2f} ms "
          f"({100 * gemm / total:.1f}%), attention and pool products and "
          f"softmax {attn:.2f} ms ({100 * attn / total:.1f}%), SVD "
          f"{svd:.2f} ms ({100 * svd / total:.1f}%), port kernels "
          f"{port:.2f} ms ({100 * port / total:.1f}%), other elementwise "
          f"{other:.2f} ms ({100 * other / total:.1f}%)", flush=True)
    return out


def encode_table1_leg(fm, device, tmp: Path):
    """Table 1's serve plan with the qwen1.5-0.5b encoder at d=300 (4
    heads of 75, SwiGLU d_ff 600, 2 layers), f32 then bf16 storage. The
    round runs on the 50 devices' encoded sequences of ET_ROUND_SEQ
    tokens; 32 late devices of 1024 points, ET_SEQ_RANGE tokens each
    (every rung of 8/16/32/64), are served in two halves twice (the two
    runs must be the same bits; the f32 one's second run under the
    profiler) and once cut by save and restore after the first half
    (schema v6; the same bits again). One batch of the
    longest rung through the plane's encode step gives the labels of the
    serve step on apply_encoder's output, bit for bit. Returns ({dtype:
    counts}, {dtype: tally}, the f32 round)."""
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.fed.plane import _make_encode_step, _make_step
    from repro_torch.models.encoder import apply_encoder
    from repro_torch.utils.metrics import clustering_accuracy
    from repro_torch.utils.prng import GumbelSource
    datas, kvs, labels, seqs = encode_table1_inputs(fm, device)
    rungs = sorted({min(64, max(8, 1 << (int(s) - 1).bit_length()))
                    for s in seqs})
    require(rungs == [8, 16, 32, 64], f"encode table1: rungs {rungs}")
    truth = np.concatenate(labels)
    h = ET_CUT
    counts_by, tallies, rounds = {}, {}, {}
    for dtype in ("f32", "bf16"):
        plan = FederationPlan(k=K, k_prime=KP, d=D, device=str(device),
                              **SERVE_PLAN, **ET_ENC, encode_dtype=dtype)
        (rr, enc_s), rcounts, rtally = counted(lambda: encoded_round(
            fm.data, plan, ET_ROUND_SEQ, 29, device))
        rounds[dtype] = rr
        racc = clustering_accuracy(rr.labels.cpu().numpy(), fm.labels, K)
        Session.from_round(plan, rr, seed=1).serve(datas[:2], kvs[:2])
        sync()                          # warm-up: the libraries' handles

        def run_once():
            sess = Session.from_round(plan, rr, seed=0)
            t0 = time.perf_counter()
            served = (sess.serve_versioned(datas[:h], kvs[:h])
                      + sess.serve_versioned(datas[h:], kvs[h:]))
            sync()
            return sess, served, time.perf_counter() - t0

        (live, want, wall), counts, tally = counted(run_once)
        again, twice, _ = (run_once() if dtype != "f32" else encode_profile(
            f"encode table1 {dtype}", run_once, wall))
        first = Session.from_round(plan, rr, seed=0)
        cut = first.serve_versioned(datas[:h], kvs[:h])
        path = first.save(str(tmp / f"encode_{dtype}.npz"))
        restored = Session.restore(path, plan)
        cut += restored.serve_versioned(datas[h:], kvs[h:])
        sync()
        for name, other, sess in (("second run", twice, again),
                                  ("restored run", cut, restored)):
            require(same_pairs(other, want)
                    and all(torch.equal(a, b) for a, b in
                            zip(sess.service.state, live.service.state))
                    and torch.equal(sess.tau_centers, live.tau_centers)
                    and sess.stats()["encoder"] == live.stats()["encoder"],
                    f"encode table1 {dtype}: the {name}'s labels, versions, "
                    f"fold state, tau or encoder stats differ")
        acc = clustering_accuracy(np.concatenate([s[0] for s in want]),
                                  truth, K)
        st = live.stats()["encoder"]
        require(st["encoded_points"] == SERVE_REQUESTS * SERVE_N,
                f"encode table1 {dtype}: {st}")
        # One batch of the longest rung through the encode step, against
        # the serve step on apply_encoder's output.
        cfg = plan.stream_config()
        spec = cfg.encoder_spec()
        idx = [i for i, s in enumerate(seqs) if s > 32][:SERVE_PLAN[
            "batch_size"]]
        B = len(idx)
        x = torch.zeros((B, SERVE_N, 64, D), device=device)
        tm = torch.zeros((B, SERVE_N, 64), dtype=torch.bool, device=device)
        for j, i in enumerate(idx):
            x[j, :, :seqs[i]] = torch.as_tensor(datas[i], device=device)
            tm[j, :, :seqs[i]] = True
        pm = torch.ones((B, SERVE_N), dtype=torch.bool, device=device)
        kv = torch.as_tensor([kvs[i] for i in idx], dtype=torch.int32,
                             device=device)
        g = GumbelSource(0).draw(idx, KP, SERVE_N, device)
        enc = live.service.encoder
        tau = live.tau_centers
        got = _make_encode_step(cfg)(tau, enc, g, x, pm, kv, tm)
        emb = apply_encoder(enc, x, tm, spec, dtype)
        ref = _make_step(cfg)(tau, g, emb, pm, kv)
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"encode table1 {dtype}: the encode step's labels differ "
                f"from the serve step on the encoder's output")
        del x, tm, emb, got, ref
        counts = {k: v + rcounts[k] for k, v in counts.items()}
        counts_by[dtype] = counts
        tallies[f"encode_table1_{dtype}"] = tally
        tallies[f"encode_round_{dtype}"] = rtally
        print(f"encode table1 {dtype}: Table 1's serve plan d={D} k={K} "
              f"k'={KP} batch {SERVE_PLAN['batch_size']} refresh every "
              f"{SERVE_PLAN['refresh_every']} with encoder="
              f"{ET_ENC['encoder']} (layers {st['layers']}, heads "
              f"{spec.n_heads} of {D // spec.n_heads}, {spec.activation} "
              f"d_ff {spec.d_ff}, {st['params']} parameters), "
              f"encode_seq_len {ET_ENC['encode_seq_len']}: round on the "
              f"encoded sequences ({fm.data.shape[0]} devices x "
              f"{fm.data.shape[1]} points x {ET_ROUND_SEQ} tokens, encoded "
              f"in {enc_s:.3f} s) accuracy {racc:.4f}; {SERVE_REQUESTS} late "
              f"devices n={SERVE_N} with {ET_SEQ_RANGE[0]}-"
              f"{ET_SEQ_RANGE[1] - 1} tokens (rungs {rungs}) in {wall:.3f} s"
              f" ({SERVE_REQUESTS * SERVE_N / wall:.1f} points/s, "
              f"{SERVE_REQUESTS / wall:.2f} requests/s), Hungarian accuracy "
              f"{acc:.4f} (information only), tau versions "
              f"{sorted({v for _, v in want})}; two runs and the run cut by "
              f"save and restore (schema v6) after {h} are the same bits; "
              f"a batch of {B} at rung 64 through encode_step equals step "
              f"on apply_encoder's output bit for bit; launches (round and "
              f"serve) {counts}",
              flush=True)
    return counts_by, tallies, rounds["f32"]


def encode_route_inputs(rfm, device, count: int):
    """The routed leg's late devices as raw token sequences of
    ER_SEQ_RANGE tokens: (datas, kvs)."""
    from repro_torch.data.gaussian import late_device_stream
    stream = late_device_stream(rfm.means, R_KP, count, 3,
                                n_range=R_N_RANGE)
    seqs = np.random.default_rng(19).integers(*ER_SEQ_RANGE, size=count)
    return (token_sequences([r[0] for r in stream], seqs, 31, device),
            [r[2] for r in stream])


def encode_route_leg(device):
    """The routed leg's plan (qwen1.5-0.5b transformer heads) with the
    granite-3-2b encoder (GQA, 8 heads of 16 over 2): the round on the
    devices' encoded sequences, then ER_WAVES waves of 64 requests of
    ER_SEQ_RANGE tokens through serve_predict (the encoded routed step),
    between a reset and a read of the launch counts. The labels and
    versions must equal an encoded heads-off twin's; moe_dispatch and
    moe_combine must be launched. Returns (counts, tally, round)."""
    from repro_torch.data.gaussian import structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    rfm = structured_devices(0, k=R_K, d=R_D, k_prime=R_KP, m0=R_M0,
                             n_per_comp_dev=R_NPER, sep=R_SEP)
    plan = FederationPlan(k=R_K, k_prime=R_KP, d=R_D, device=str(device),
                          **R_PLAN, **ER_ENC)
    (rr, _), rcounts, rtally = counted(lambda: encoded_round(
        rfm.data, plan, ER_ROUND_SEQ, 37, device))
    B = plan.batch_size
    datas, kvs = encode_route_inputs(rfm, device, ER_WAVES * B)
    waves = [(datas[lo:lo + B], kvs[lo:lo + B])
             for lo in range(0, ER_WAVES * B, B)]
    Session.from_round(plan, rr, seed=1).serve_predict(*waves[0])
    sync()                              # warm-up: the libraries' handles
    sess = Session.from_round(plan, rr, seed=0)
    walls = {}

    def drive():
        t0 = time.perf_counter()
        out = [p for w in waves for p in sess.serve_predict(*w)]
        sync()
        walls["serve"] = time.perf_counter() - t0
        return out

    served, counts, tally = counted(drive)
    twin = Session.from_round(plan.with_options(heads="off"), rr, seed=0)
    plain = [x for w in waves for x in twin.serve_versioned(*w)]
    require(all(np.array_equal(p.labels, lbl) and p.tau_version == v
                for p, (lbl, v) in zip(served, plain)),
            "encode route: labels or versions differ from the encoded "
            "heads-off twin's")
    require(rcounts["pdist_argmin"] > 0 and rcounts["kmeans_update"] > 0,
            f"encode route: the round launched {rcounts}")
    require(all(p.prediction.shape == (R_D,)
                and bool(np.isfinite(p.prediction).all()) for p in served),
            "encode route: predictions of the wrong shape or not finite")
    require(counts["moe_dispatch"] > 0 and counts["moe_combine"] > 0
            and counts["solve_attach"] > 0,
            f"encode route: launches {counts}")
    st = sess.stats()
    npts = sum(p.labels.shape[0] for p in served)
    print(f"encode route: Session.serve_predict k={R_K} k'={R_KP} d={R_D} "
          f"heads={plan.heads}/{plan.head_arch} encoder={plan.encoder} "
          f"({st['encoder']['layers']} layers, "
          f"{st['encoder']['params']} parameters): {ER_WAVES} waves of "
          f"{B} late devices n in [{R_N_RANGE[0]}, {R_N_RANGE[1]}) with "
          f"{ER_SEQ_RANGE[0]}-{ER_SEQ_RANGE[1] - 1} tokens in "
          f"{walls['serve']:.3f} s ({len(served) / walls['serve']:.2f} "
          f"requests/s, {npts / walls['serve']:.1f} points/s); routed "
          f"{sum(p.routed for p in served)} of {len(served)}; labels and "
          f"versions equal the encoded heads-off twin's; launches (round "
          f"{rcounts}, serve) {counts}", flush=True)
    return ({k: v + rcounts[k] for k, v in counts.items()},
            {"encode_route_round": rtally, "encode_route": tally}, rr)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def tau_error(got, want) -> float:
    """max |got - want| over the largest |want|: within 1e-4 is the
    round's tau tolerance (tests/test_torch_session.py's _tau_close)."""
    return float((got - want).abs().max() / want.abs().max())


def mesh_rounds(mesh, fm, walls, key: int = 0):
    """Session.run of the round under each topology: {topology:
    RunResult}; ``walls`` gets each run's wall."""
    from repro_torch.fed.api import FederationPlan, Session
    outs = {}
    for t in MESH_TOPOLOGIES:
        plan = FederationPlan(k=K, k_prime=KP, d=D, topology=t)
        t0 = time.perf_counter()
        outs[t] = Session(plan, mesh=mesh).run(key, fm.data)
        sync()
        walls[t] = time.perf_counter() - t0
    return outs


def mesh_more_inputs(fm, device, route_rr=None, enc_rrs=None):
    """The routed leg's round (``route_rr``, or run on ``device``) and
    MESH_R_WAVES waves of its requests, the drift Table 1 leg's late
    devices, and the encoded rounds of the encode table1 and encode
    route legs (``enc_rrs``) with a wave of each leg's raw sequences."""
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    rfm = structured_devices(0, k=R_K, d=R_D, k_prime=R_KP, m0=R_M0,
                             n_per_comp_dev=R_NPER, sep=R_SEP)
    if route_rr is None:
        route_rr = Session(FederationPlan(k=R_K, k_prime=R_KP, d=R_D,
                                          device=str(device))).run(
            1, rfm.data).detail
    stream = late_device_stream(rfm.means, R_KP,
                                MESH_R_WAVES * R_PLAN["batch_size"], 3,
                                n_range=R_N_RANGE)
    dreqs, dkvs = drift_table1_inputs(fm)
    ereqs, ekvs, _, _ = encode_table1_inputs(fm, device, MESH_E_DEVICES)
    rereqs, rekvs = encode_route_inputs(rfm, device, R_PLAN["batch_size"])
    return dict(route_rr=route_rr, rreqs=[r[0] for r in stream],
                rkvs=[r[2] for r in stream], dreqs=dreqs, dkvs=dkvs,
                enc_rr=enc_rrs[0], ereqs=ereqs, ekvs=ekvs,
                renc_rr=enc_rrs[1], rereqs=rereqs, rekvs=rekvs)


def mesh_serve_more(mesh, serve_axes, rr, more, walls):
    """The routed leg's plan at the full grant and under latency
    autoscaling, and Table 1's split_merge plan, with ``serve_axes`` on
    ``mesh`` (None, None: one process alone). Returns what must equal
    one process alone, bit for bit."""
    from repro_torch.fed.api import FederationPlan, Session
    rplan = FederationPlan(k=R_K, k_prime=R_KP, d=R_D, serve_axes=serve_axes,
                           **R_PLAN)
    rreqs, rkvs, B = more["rreqs"], more["rkvs"], rplan.batch_size
    sess = Session.from_round(rplan, more["route_rr"], mesh=mesh, seed=0)
    t0 = time.perf_counter()
    routed = [p for lo in range(0, len(rreqs), B)
              for p in sess.serve_predict(rreqs[lo:lo + B], rkvs[lo:lo + B])]
    sync()
    walls["routed"] = time.perf_counter() - t0
    auto = Session.from_round(rplan.with_options(autoscale="latency"),
                              more["route_rr"], mesh=mesh, seed=0)
    a_routed, decisions, at = [], [], 0
    t0 = time.perf_counter()
    for nb in MESH_R_BURSTS:
        a_routed += auto.serve_predict(rreqs[at:at + nb], rkvs[at:at + nb])
        d = auto.service.autoscaler.decision
        decisions.append((d.shards, d.batch_size))
        at += nb
    sync()
    walls["routed_autoscale"] = time.perf_counter() - t0
    dplan = FederationPlan(k=K, k_prime=KP, d=D, serve_axes=serve_axes,
                           **SERVE_PLAN, **dict(DT_RUNS)["split_merge"])
    ds = Session.from_round(dplan, rr, mesh=mesh, seed=0)
    t0 = time.perf_counter()
    drift = ds.serve_versioned(more["dreqs"], more["dkvs"])
    sync()
    walls["drift"] = time.perf_counter() - t0
    eplan = FederationPlan(k=K, k_prime=KP, d=D, serve_axes=serve_axes,
                           **SERVE_PLAN, **ET_ENC)
    es = Session.from_round(eplan, more["enc_rr"], mesh=mesh, seed=0)
    t0 = time.perf_counter()
    encoded = es.serve_versioned(more["ereqs"], more["ekvs"])
    sync()
    walls["encoded"] = time.perf_counter() - t0
    erplan = rplan.with_options(**ER_ENC)
    ers = Session.from_round(erplan, more["renc_rr"], mesh=mesh, seed=0)
    t0 = time.perf_counter()
    enc_routed = ers.serve_predict(more["rereqs"], more["rekvs"])
    sync()
    walls["enc_routed"] = time.perf_counter() - t0
    return {"encoded": encoded,
            "encoded_state": [t.cpu() for t in es.service.state],
            "encoded_stats": es.stats()["encoder"],
            "enc_routed": enc_routed,
            "enc_routed_state": [t.cpu() for t in ers.service.state],
            "routed": routed, "routed_state": [t.cpu() for t in
                                               sess.service.state],
            "auto": a_routed, "decisions": decisions,
            "auto_state": [t.cpu() for t in auto.service.state],
            "drift": drift, "drift_state": [t.cpu() for t in
                                            ds.service.state],
            "drift_stats": drift_stats(ds)}


def check_serve_more(got, want, label) -> None:
    """The sharded routed, autoscaled routed and drift serves against one
    process alone, bit for bit."""
    require(same_predictions(got["routed"], want["routed"])
            and same_predictions(got["auto"], want["auto"]),
            f"{label}: the routed serve's labels, versions, clusters, "
            f"routing or predictions differ from one process alone")
    require(all(np.array_equal(a, b) and va == vb for (a, va), (b, vb)
                in zip(got["drift"], want["drift"]))
            and len(got["drift"]) == len(want["drift"]),
            f"{label}: the drift serve's labels or versions differ")
    for key in ("routed_state", "auto_state", "drift_state"):
        require(all(torch.equal(a, b) for a, b in zip(got[key], want[key])),
                f"{label}: the {key} differs from one process alone")
    require(same_drift(got["drift_stats"], want["drift_stats"]),
            f"{label}: drift mass or moves differ from one process alone")
    require(got["drift_stats"][0][1] > 0, f"{label}: no center moved")
    require(same_pairs(got["encoded"], want["encoded"])
            and got["encoded_stats"] == want["encoded_stats"]
            and same_predictions(got["enc_routed"], want["enc_routed"]),
            f"{label}: the encoded serve's or the encoded routed serve's "
            f"labels, versions, predictions or encoder stats differ from "
            f"one process alone")
    for key in ("encoded_state", "enc_routed_state"):
        require(all(torch.equal(a, b) for a, b in zip(got[key], want[key])),
                f"{label}: the {key} differs from one process alone")


def mesh_more_line(got, walls) -> str:
    return (f"routed plan (k={R_K} d={R_D} {R_PLAN['heads']}/"
            f"{R_PLAN['head_arch']}, {len(got['routed'])} requests in "
            f"batches of {R_PLAN['batch_size']}) {walls['routed']:.3f} s, "
            f"routed {sum(p.routed for p in got['routed'])}; under latency "
            f"autoscaling in bursts {list(MESH_R_BURSTS)} "
            f"{walls['routed_autoscale']:.3f} s, decisions (shards, batch) "
            f"{got['decisions']}; Table 1 split_merge plan "
            f"{walls['drift']:.3f} s, moves {got['drift_stats'][0][1]}; "
            f"encoded Table 1 plan ({MESH_E_DEVICES} devices of raw "
            f"sequences) {walls['encoded']:.3f} s; encoded routed plan "
            f"({len(got['enc_routed'])} requests, {ER_ENC['encoder']}) "
            f"{walls['enc_routed']:.3f} s; labels, predictions, clusters, "
            f"routing, fold state, mass, moves and encoder stats equal one "
            f"process alone bit for bit")


def mesh1_leg(fm, rr, tmp: Path, more, want):
    """The round in a one-rank NCCL world in this process: the real
    collectives, the same labels under every topology (and the run
    leg's), the replicated tau bit for bit the simulated one's and the
    sharded one within tolerance; then the routed plan and Table 1's
    split_merge plan with serve_axes, equal to one process alone."""
    import torch.distributed as dist
    from repro_torch.utils.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "mesh1_store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), backend="nccl")
        # A warm-up run of each topology: NCCL's communicator.
        mesh_rounds(mesh, fm, {}, key=1)
        walls, mwalls = {}, {}
        (outs, got), counts, tally = counted(lambda: (
            mesh_rounds(mesh, fm, walls),
            mesh_serve_more(mesh, ("data",), rr, more, mwalls)))
        describe = mesh.describe()
    finally:
        dist.destroy_process_group()
    check_serve_more(got, want, "mesh1")
    sim = outs["simulated"]
    for t in MESH_TOPOLOGIES:
        require(torch.equal(outs[t].labels, rr.labels),
                f"mesh1: the {t} round's labels differ from the run leg's")
    require(torch.equal(outs["replicated"].tau_centers, sim.tau_centers),
            "mesh1: the replicated tau is not the simulated one bit for bit")
    err = tau_error(outs["sharded"].tau_centers, sim.tau_centers)
    require(err <= 1e-4, f"mesh1: the sharded tau is {err:.3e} off")
    print(f"mesh1: {describe}; Session.run d={D} k={K} k'={KP} "
          f"Z={fm.data.shape[0]} n={fm.data.shape[1]} walls "
          + ", ".join(f"{t} {walls[t]:.3f} s" for t in MESH_TOPOLOGIES)
          + f"; labels equal under every topology and the run leg's; "
          f"replicated tau = simulated bit for bit; sharded tau max "
          f"|diff| / max|tau| = {err:.3e} (<= 1e-4); serve_axes=data: "
          + mesh_more_line(got, mwalls) + f"; launches {counts}",
          flush=True)
    return counts, tally, {t: o.tau_centers for t, o in outs.items()}


def mesh_decisions(sess, bursts):
    """serve_bursts with each flush's (shards, batch) decision."""
    served, decisions = {}, []
    for burst in bursts:
        for data, _, kv in burst:
            sess.submit(data, kv)
        served.update(sess.flush_versioned())
        d = sess.service.autoscaler.decision
        decisions.append((d.shards, d.batch_size))
    return served, decisions


def mesh_serve_inputs(fm):
    from repro_torch.data.gaussian import late_device_stream
    reqs = late_device_stream(fm.means, KP, SERVE_REQUESTS, 7,
                              n_range=(SERVE_N, SERVE_N + 1))
    bursts, lo = [], 0
    for b in MESH_BURSTS:
        bursts.append(reqs[lo:lo + b])
        lo += b
    return [r[0] for r in reqs], [r[2] for r in reqs], bursts


def mesh_plans(serve_axes):
    from repro_torch.fed.api import FederationPlan
    base = dict(k=K, k_prime=KP, d=D, serve_axes=serve_axes, **SERVE_PLAN)
    return (FederationPlan(**base),
            FederationPlan(**base, autoscale="latency"))


def _cpu(t):
    return t.cpu() if torch.is_tensor(t) else t


def mesh2_rank(rank: int, tmp: str) -> None:
    """One rank of the mesh2 leg (spawned): joins the gloo world, runs
    the round under each topology, the sharded serve and the autoscaled
    one between a reset and a read of the launch counts, and saves what
    it got for the parent to check."""
    import torch.distributed as dist
    from repro_torch.data.gaussian import structured_devices
    from repro_torch.fed.api import Session
    from repro_torch.utils.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "mesh2_store"), 2), rank=rank, world_size=2)
    try:
        mesh = make_mesh((2,), ("data",), backend="gloo")
        fm = structured_devices(0, k=K, d=D, k_prime=KP, m0=M0,
                                n_per_comp_dev=N_PER, sep=SEP)
        rr = tree_to(torch.load(os.path.join(tmp, "round.pt"),
                                weights_only=False), "cuda")
        more = mesh_more_inputs(fm, "cuda", route_rr=tree_to(torch.load(
            os.path.join(tmp, "route_round.pt"), weights_only=False),
            "cuda"), enc_rrs=tuple(tree_to(torch.load(
                os.path.join(tmp, f"{name}.pt"), weights_only=False), "cuda")
                for name in ("enc_round", "renc_round")))
        datas, kvs, bursts = mesh_serve_inputs(fm)
        plan, scaled = mesh_plans(("data",))
        # Warm-up: the libraries' handles in this process.
        mesh_rounds(mesh, fm, {}, key=1)
        Session.from_round(plan, rr, mesh=mesh, seed=1).serve(
            datas[:plan.batch_size], kvs[:plan.batch_size])
        walls = {}

        def drive():
            outs = mesh_rounds(mesh, fm, walls)
            sess = Session.from_round(plan, rr, mesh=mesh, seed=0)
            t0 = time.perf_counter()
            served = sess.serve_versioned(datas, kvs)
            sync()
            walls["serve"] = time.perf_counter() - t0
            auto = Session.from_round(scaled, rr, mesh=mesh, seed=0)
            t0 = time.perf_counter()
            a_served, decisions = mesh_decisions(auto, bursts)
            sync()
            walls["autoscale"] = time.perf_counter() - t0
            mwalls = {}
            got = mesh_serve_more(mesh, ("data",), rr, more, mwalls)
            return (outs, sess, served, auto, a_served, decisions, got,
                    mwalls)

        ((outs, sess, served, auto, a_served, decisions, more_got, mwalls),
         counts, tally) = counted(drive)
        out = {
            "describe": mesh.describe(), "walls": walls, "counts": counts,
            "labels": {t: o.labels.cpu() for t, o in outs.items()},
            "tau": {t: o.tau_centers.cpu() for t, o in outs.items()},
            "served": served, "state": [t.cpu() for t in sess.service.state],
            "stats": {k: v for k, v in sess.stats().items()
                      if k in ("serve_shards", "serve_axes", "tau_version",
                               "plane_compiles")},
            "a_served": a_served, "decisions": decisions,
            "a_state": [t.cpu() for t in auto.service.state],
            "more": more_got, "more_walls": mwalls,
            "tally": ({name: {key: [c, tuple(_cpu(a) for a in inputs)]
                              for key, (c, inputs) in t.shapes.items()}
                       for name, t in tally.items()} if rank == 0 else None),
        }
        torch.save(out, os.path.join(tmp, f"mesh2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tree_to(t, device):
    """A round's (nested NamedTuple) tensors on ``device``."""
    if torch.is_tensor(t):
        return t.to(device)
    return type(t)(*(tree_to(x, device) for x in t))


class Shapes:
    """A Tally's shapes brought back from another process."""

    def __init__(self, shapes):
        self.shapes = {key: [c, tuple(a.cuda() if torch.is_tensor(a) else a
                                      for a in inputs)]
                       for key, (c, inputs) in shapes.items()}


def mesh2_leg(fm, rr, taus, tmp: Path, more, want_more):
    """The two-rank gloo world on one card: the round's labels equal the
    run leg's and its tau is within tolerance under both mesh
    topologies; the sharded serve and the autoscaled one equal one
    process serving alone bit for bit (labels, tau versions, fold
    state), on both ranks; the autoscaled decisions take 1 and 2
    shards. Kernels were built before the spawn, so the ranks only load
    them."""
    import torch.multiprocessing as mp
    from repro_torch.fed.api import Session
    datas, kvs, bursts = mesh_serve_inputs(fm)
    plan, scaled = mesh_plans(None)
    ref = Session.from_round(plan, rr, seed=0)
    want = ref.serve_versioned(datas, kvs)
    aref = Session.from_round(scaled, rr, seed=0)
    a_want, a_dec = mesh_decisions(aref, bursts)
    torch.save(tree_to(rr, "cpu"), tmp / "round.pt")
    torch.save(tree_to(more["route_rr"], "cpu"), tmp / "route_round.pt")
    torch.save(tree_to(more["enc_rr"], "cpu"), tmp / "enc_round.pt")
    torch.save(tree_to(more["renc_rr"], "cpu"), tmp / "renc_round.pt")
    t0 = time.perf_counter()
    mp.spawn(mesh2_rank, args=(str(tmp),), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"mesh2_rank{r}.pt", weights_only=False)
             for r in range(2)]
    for r, got in enumerate(ranks):
        for t in MESH_TOPOLOGIES:
            require(torch.equal(got["labels"][t], rr.labels.cpu()),
                    f"mesh2 rank {r}: the {t} round's labels differ")
            err = tau_error(got["tau"][t], taus[t].cpu())
            require(err <= 1e-4, f"mesh2 rank {r}: the {t} tau is {err:.3e}"
                                 f" off mesh1's")
        require(torch.equal(got["tau"]["sharded"],
                            ranks[0]["tau"]["sharded"]),
                "mesh2: the ranks' sharded tau differ")
        require(len(got["served"]) == len(want) and all(
            np.array_equal(a, b) and va == vb
            for (a, va), (b, vb) in zip(got["served"], want)),
            f"mesh2 rank {r}: the sharded serve's labels or tau versions "
            f"differ from one process serving alone")
        require(all(torch.equal(a, b.cpu()) for a, b in
                    zip(got["state"], ref.service.state)),
                f"mesh2 rank {r}: the sharded fold state differs")
        require(same_served(got["a_served"], a_want)
                and all(torch.equal(a, b.cpu()) for a, b in
                        zip(got["a_state"], aref.service.state))
                and [b for _, b in got["decisions"]]
                == [b for _, b in a_dec],
                f"mesh2 rank {r}: the autoscaled serve differs from one "
                f"process serving alone")
        require(got["stats"]["serve_shards"] == 2,
                f"mesh2 rank {r}: {got['stats']}")
        check_serve_more(got["more"], want_more, f"mesh2 rank {r}")
    shards = sorted({s for s, _ in ranks[0]["decisions"]})
    require(shards == [1, 2], f"mesh2: active shard counts {shards}")
    rshards = sorted({s for s, _ in ranks[0]["more"]["decisions"]})
    require(rshards == [1, 2],
            f"mesh2: routed active shard counts {rshards}")
    w = ranks[0]["walls"]
    counts = {name: ranks[0]["counts"][name] + ranks[1]["counts"][name]
              for name in ranks[0]["counts"]}
    print(f"mesh2: {ranks[0]['describe']} (two processes on cuda:0); "
          f"Session.run walls "
          + ", ".join(f"{t} {w[t]:.3f} s" for t in MESH_TOPOLOGIES)
          + f"; labels equal the run leg's, tau within 1e-4 of mesh1's "
          f"(sharded tau the same bits on both ranks); serve_axes=data: "
          f"{SERVE_REQUESTS} late devices n={SERVE_N} batch="
          f"{plan.batch_size} (4 a rank) {w['serve']:.3f} s, "
          f"{SERVE_REQUESTS / w['serve']:.2f} requests/s, labels, tau "
          f"versions and fold state equal one process serving alone bit "
          f"for bit; latency autoscaling in bursts {list(MESH_BURSTS)}: "
          f"{w['autoscale']:.3f} s, decisions (shards, batch) "
          f"{ranks[0]['decisions']}, equal to one process alone; "
          + mesh_more_line(ranks[0]["more"], ranks[0]["more_walls"])
          + f" on both ranks; "
          f"{spawn_s:.1f} s from spawn to join; launches by rank "
          f"{ranks[0]['counts']} {ranks[1]['counts']}", flush=True)
    return counts, {name: Shapes(shapes)
                    for name, shapes in ranks[0]["tally"].items()}


def profile(label: str, fn, wall_s: float, top: int = 8) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    # Device-side events only: an operator's own row would count its
    # kernels a second time.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)", flush=True)
        return
    tops = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in rows[:top])
    # The port's own kernels, wherever they rank: device time per launch.
    ours = "; ".join(f"{re.search(r'\w+_kernel(<[^()]*>)?', k).group(0)} "
                     f"{ms:.4f} ms x{n} ({1e3 * ms / n:.2f} us each)"
                     for k, ms, n in rows if "repro_torch" in k)
    print(f"profile {label}: device time {dev_ms:.2f} ms of {wall_s * 1e3:.1f}"
          f" ms unprofiled wall (busy {100 * dev_ms / (wall_s * 1e3):.1f}%); "
          f"top by device time: {tops} | port kernels: {ours}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    src = HERE / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing; run this "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    t_all = time.perf_counter()
    from repro_torch.data.gaussian import structured_devices
    from repro_torch.kernels import _build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    regs = {name: [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                   if "registers" in ln] for name, (_, log) in logs.items()}
    print(f"card: {kind} x{count}; nvidia-smi: {smi}", flush=True)
    print(f"build: {len(logs)} kernels with nvcc for sm_90a in "
          f"{build_s:.2f} s (parallel); ptxas: {json.dumps(regs)}",
          flush=True)
    for name in _build.KERNELS:
        _build.load(name)

    fm = structured_devices(0, k=K, d=D, k_prime=KP, m0=M0,
                            n_per_comp_dev=N_PER, sep=SEP)
    rows = kernel_phase(fm, torch.device("cuda"), rounds=20)
    nsmall = small_agreement(torch.device("cuda"))
    print(f"reference: a small round (Z=8, d=24, k=12) and {nsmall} served "
          f"devices on the card equal the CPU run of the plain versions "
          f"(labels, tau versions; tau within 1e-4)", flush=True)
    run_counts, serve_counts, tallies, attach, rr = main_path(
        fm, torch.device("cuda"))
    nreq, nrouted, perr = small_routed_agreement(torch.device("cuda"))
    print(f"reference: a small routed serve (k=12, d=24, granite-3-2b "
          f"transformer heads, {nreq} requests, {nrouted} routed) on the "
          f"card equals the CPU run (labels, versions, clusters, routing "
          f"exact; predictions within 1e-5 relative, max error "
          f"{perr:.3e})", flush=True)
    route_counts, tallies["route"] = route_path(torch.device("cuda"))
    t_legs = time.perf_counter()
    cuda = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        restore_counts, tallies["restore"] = restore_path(fm, cuda, Path(tmp))
        rroute_counts, tallies["route_restore"] = route_restore_path(
            cuda, Path(tmp))
        nmoved = cpu_to_card_restore(cuda, Path(tmp))
    print(f"reference: an archive written on the CPU (k=12, d=24) restores "
          f"on the card with the same fold state, and the card's on the CPU;"
          f" {nmoved} more devices served on the card equal the CPU "
          f"session's (labels, tau versions)", flush=True)
    small_scenario_agreement(cuda)
    print("reference: a small personalize (Z=16, k'=1 and 2 per chunk, 2 "
          "rounds) and a small separation report (k=8, d=12) on the card "
          "equal the CPU run (assignments and IFCA choices exact; "
          "parameters within atol 2e-5 + rtol 1e-4; the report's counts "
          "exact, norms within rtol 1e-4)", flush=True)
    pers_counts, pers_tallies = personalize_leg(cuda)
    tallies.update(pers_tallies)
    sel_counts, tallies["selection"] = selection_leg(cuda)
    sep_counts, tallies["separation"] = separation_leg(cuda)
    print(f"legs: restore, route restore, cpu -> card, scenario agreement, "
          f"personalize, selection and separation in "
          f"{time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    t_legs = time.perf_counter()
    nattach, nversions = small_attach_agreement(cuda)
    print(f"reference: the attach plan at k=12, d=24 (lru, async, latency; "
          f"{nattach} devices in 6 bursts, {nversions} tau versions) on the "
          f"card equals the CPU run (labels, tau versions and decisions "
          f"exact)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        attach_counts, attach_tallies = attach_leg(fm, rr, cuda, Path(tmp))
        cli_counts = cli_leg(Path(tmp))
    tallies.update(attach_tallies)
    fig2_counts, tallies["fig2"], fig3_counts, tallies["fig3"] = \
        figures_leg(cuda)
    print(f"legs: attach agreement, attach (2 runs), cli, figures 2 and 3 "
          f"in {time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    t_legs = time.perf_counter()
    dmoves = small_drift_agreement(cuda)
    print(f"reference: a small split_merge session (k={DR_K}, d={DR_D}, 24 "
          f"requests from resampled means, heads off and linear; moves "
          f"{dmoves}) on the card equals the CPU run (labels, versions, "
          f"clusters, routing, drift events and moves exact; mass and "
          f"predictions within 1e-5 relative)", flush=True)
    drift_counts, tallies["drift"] = drift_leg(cuda)
    with tempfile.TemporaryDirectory() as tmp:
        dt_counts, tallies["drift_table1"] = drift_table1_leg(fm, rr, cuda,
                                                              Path(tmp))
    rdrift_counts, tallies["route_drift"] = route_drift_leg(cuda)
    print(f"legs: small drift agreement, drift, drift table1, route drift "
          f"in {time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    t_legs = time.perf_counter()
    nenc, eerrs = small_encode_agreement(cuda)
    print(f"reference: tests/test_encode_serve.py's plan (k=8, d=16, "
          f"{E_PLAN['encoder']}, {nenc} ragged requests) on the card equals "
          f"the CPU run in f32, bf16 and with the granite-3-2b encoder and "
          f"linear heads (labels, versions, encoder stats, clusters and "
          f"routing exact; embeddings within rtol 1e-5 / atol 1e-5, bf16 "
          f"within 1e-2 of max(max|y|, 1), max errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in eerrs.items())
          + "; predictions within 1e-5 relative)", flush=True)
    ebench_counts, tallies["encode_bench"] = encode_bench_leg(cuda)
    with tempfile.TemporaryDirectory() as tmp:
        et_counts, et_tallies, enc_rr = encode_table1_leg(fm, cuda,
                                                          Path(tmp))
    tallies.update(et_tallies)
    eroute_counts, er_tallies, renc_rr = encode_route_leg(cuda)
    tallies.update(er_tallies)
    print(f"legs: encode small, encode bench, encode table1 (f32, bf16), "
          f"encode route in {time.perf_counter() - t_legs:.1f} s of wall",
          flush=True)
    t_legs = time.perf_counter()
    more = mesh_more_inputs(fm, cuda, enc_rrs=(enc_rr, renc_rr))
    want_more = mesh_serve_more(None, None, rr, more, {})
    with tempfile.TemporaryDirectory() as tmp:
        mesh1_counts, tallies["mesh1"], taus = mesh1_leg(fm, rr, Path(tmp),
                                                         more, want_more)
        mesh2_counts, tallies["mesh2"] = mesh2_leg(fm, rr, taus, Path(tmp),
                                                   more, want_more)
    print(f"legs: mesh1, mesh2 in {time.perf_counter() - t_legs:.1f} s of "
          f"wall", flush=True)
    for name in ("pdist_argmin", "kmeans_update", "solve_attach"):
        require(drift_counts[name] > 0 and dt_counts[name] > 0
                and rdrift_counts[name] > 0,
                f"{name} was not launched on every drift leg")
    for name in ("moe_dispatch", "moe_combine"):
        require(rdrift_counts[name] > 0 and mesh1_counts[name] > 0
                and mesh2_counts[name] > 0,
                f"{name} was not launched on the routed drift and mesh legs")
    for name in ("pdist_argmin", "kmeans_update"):
        require(mesh1_counts[name] > 0 and mesh2_counts[name] > 0,
                f"{name} was not launched on the mesh1 and mesh2 legs")
    require(mesh2_counts["solve_attach"] > 0,
            "solve_attach was not launched on the mesh2 leg")
    enc_counts = (ebench_counts, et_counts["f32"], et_counts["bf16"],
                  eroute_counts)
    for name in ("pdist_argmin", "kmeans_update", "solve_attach"):
        require(all(c[name] > 0 for c in enc_counts[1:]),
                f"{name} was not launched on every encode table1 and route "
                f"leg")
    require(ebench_counts["solve_attach"] > 0,
            "solve_attach was not launched on the encode bench leg")
    for name in ("pdist_argmin", "kmeans_update"):
        require(pers_counts[name] > 0 and sel_counts[name] > 0
                and sep_counts[name] > 0,
                f"{name} was not launched on every scenario leg")
    require(restore_counts["solve_attach"] > 0
            and rroute_counts["solve_attach"] > 0,
            "solve_attach was not launched on both restored serve paths")
    for name in ("pdist_argmin", "kmeans_update", "solve_attach"):
        require(attach_counts[name] > 0 and cli_counts[name] > 0,
                f"{name} was not launched on the attach and cli legs")
    for name in ("pdist_argmin", "kmeans_update"):
        require(fig2_counts[name] > 0 and fig3_counts[name] > 0,
                f"{name} was not launched on the figure 2 and 3 legs")
    new_counts = (restore_counts, rroute_counts, pers_counts, sel_counts,
                  sep_counts, attach_counts, cli_counts, fig2_counts,
                  fig3_counts, mesh1_counts, mesh2_counts, drift_counts,
                  dt_counts, rdrift_counts) + enc_counts
    pdist_shapes(tallies, attach)
    kmeans_shapes(tallies)
    solve_shapes(tallies)
    lerr = small_lm_agreement(torch.device("cuda"))
    print(f"reference: reduced Mixtral (f32, 2 layers, d=256, W=64) through "
          f"generate, 2 prompts of 64 tokens and 8 steps over the ring, on "
          f"the card equals the CPU run (tokens exact; logits within 1e-4 "
          f"relative, max error {lerr:.3e})", flush=True)
    decode_counts, tallies["decode"] = decode_leg(torch.device("cuda"))
    combine_shapes(tallies)
    for name in ("pdist_argmin", "kmeans_update", "solve_attach"):
        require(run_counts[name] + serve_counts[name] > 0,
                f"{name} was not launched on the round and serve paths")
        require(serve_counts[name] > 0 and route_counts[name] > 0,
                f"{name} was not launched on every serve path")
    for name in ("moe_dispatch", "moe_combine"):
        require(route_counts[name] > 0 and decode_counts[name] > 0,
                f"{name} was not launched on the routed serve path and the "
                f"decode leg")
    require(decode_counts["swa_decode"] > 0,
            "swa_decode was not launched on the decode leg")

    replaces = {
        "pdist_argmin": "src/repro/kernels/pdist_argmin.py:101",
        "kmeans_update": "src/repro/kernels/kmeans_update.py:90",
        "solve_attach": "src/repro/kernels/solve_attach.py:155",
        "moe_dispatch": "src/repro/kernels/moe_dispatch.py:57",
        "moe_combine": "src/repro/kernels/moe_dispatch.py:146",
        "swa_decode": "src/repro/kernels/swa_decode.py:65",
    }
    kernels = []
    for name in _build.KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": (run_counts[name] + serve_counts[name]
                         + route_counts[name] + decode_counts[name]
                         + sum(c[name] for c in new_counts)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"]})
    print("launches: run " + json.dumps(run_counts) + " serve "
          + json.dumps(serve_counts) + " route " + json.dumps(route_counts)
          + " decode " + json.dumps(decode_counts)
          + " restore " + json.dumps(restore_counts) + " route_restore "
          + json.dumps(rroute_counts) + " personalize "
          + json.dumps(pers_counts) + " selection " + json.dumps(sel_counts)
          + " separation " + json.dumps(sep_counts)
          + " attach " + json.dumps(attach_counts) + " cli "
          + json.dumps(cli_counts) + " figure2 " + json.dumps(fig2_counts)
          + " figure3 " + json.dumps(fig3_counts)
          + " mesh1 " + json.dumps(mesh1_counts) + " mesh2 "
          + json.dumps(mesh2_counts) + " drift " + json.dumps(drift_counts)
          + " drift_table1 " + json.dumps(dt_counts) + " route_drift "
          + json.dumps(rdrift_counts) + " encode_bench "
          + json.dumps(ebench_counts) + " encode_table1_f32 "
          + json.dumps(et_counts["f32"]) + " encode_table1_bf16 "
          + json.dumps(et_counts["bf16"]) + " encode_route "
          + json.dumps(eroute_counts)
          + "; every kernel matched its plain version", flush=True)
    print(f"card: {smi}; chip_smoke wall {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
