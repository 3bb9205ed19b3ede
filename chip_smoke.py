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

Last come the train legs (LM training through repro_torch.launch.train,
Model.loss and the optimizers): the MoE layer's backward on the card
(moe_dispatch's gradient through the moe_dispatch_bwd kernel,
moe_combine's through the moe_combine_bwd kernel) at the full-width
leg's routing and at small shapes (top_k 1, 2, 3 and 4, dropped
entries, a token all dropped, f32 and bf16, d not a multiple of 8),
against the plain versions' autograd and f64, timed beside index_add_,
gather + mul + sum and the dispatch backward's old route (moe_combine
with 0/1 gates, then a cast); 3
steps of reduced Mixtral-8x7B and granite-3-2b (f32, microbatch 2) on
the card against the CPU from one state; Mixtral-8x7B at its published
widths cut to 2 of its 32 layers, with its remat, microbatch 4 and
adamw, 1 warm-up and 3 timed steps of 4 x 4096 tokens (tokens/s, peak
memory, loss and grad norm, launches a step, a profile line); and
examples/train_lm.py (reduced granite-3-2b, 200 steps, then generate),
whose loss must fall.

After the train legs come the DeepSeek-V3 legs (configs/
deepseek_v3_671b.py at its published widths: MLA with the absorbed
latent decode, the MTP head, 256 experts at top-8 plus a shared one):
the MoE kernels at its routings (the serve leg's prefill of 16384 tokens
and decode step of 4, the train leg's 4096 tokens; d=7168 bf16),
moe_dispatch bit for bit with its plain version, moe_combine bit for
bit with the sequential sum over the 8 choices and within 1e-6 of its
terms of the plain version, both backward paths by the train legs'
checks, each timed beside its plain version, a library call and the
bound; reduced DeepSeek-V3 (f32) through generate and 3 adafactor steps
on the card against the CPU; serving at 5 of 61 layers (the 3 dense
and 2 MoE, about 55 GB), 4 prompts of 4096 tokens and 32 greedy steps
over the latent cache (prefill s, decode ms a step, peak memory,
launches by shape, a decode profile); and training at 2 of 61 layers
with the MTP head, remat and adafactor at microbatch 1, 1 x 4096 tokens
a step (s a step, loss, ce, mtp_ce, grad norm, peak memory, a profile,
the clip and the update timed alone).

Last come the state-carrying legs (configs/rwkv6_7b.py and
configs/zamba2_1_2b.py at their published widths; no kernel of the port
is on these paths): reduced RWKV6-7B and Zamba2-1.2B (5 layers in groups
of 2: three uses of the shared block), f32 on the card against the CPU,
through generate (prompts of 48 and 50 tokens: the chunked and the scan
prefill; 4 steps) and 3 adamw steps at microbatch 2 (tokens exact;
logits, cache leaves, loss, grad norm and weights within 1e-5); then
each model served at full depth (RWKV's 32 layers, Zamba2's 38 in groups
of 6 and 2 with the shared block after each), 4 prompts of 4096 tokens
and 32 greedy steps (prefill s, decode ms a step, tokens/s, peak memory,
the bounds) with a profile of a prefill and of 8 steps that splits the
device time into the chunk loop, the step scan, the shared block's
attention, GEMMs and the rest; and trained with the configs' adamw,
remat and microbatch 2 on 4 x 4096 tokens a step (Zamba2 at its 38
layers, RWKV cut to SMT_RWKV_LAYERS), with a profiled step.

Last of all come the encdec and vlm legs (configs/whisper_base.py and
configs/internvl2_26b.py at their published widths): reduced Whisper,
InternVL2 and InternVL2's sliding-window variant (f32) on the card
against the CPU, through generate with the family's inputs (frame or
patch embeddings) and 3 adamw steps; Whisper served at its 6 + 6
layers (16 clips of 1500 frame embeddings, prompts of 224 tokens, 32
steps; no kernel of the port on its path) and trained (16 x (1500
frames, 448 tokens)); InternVL2 served at all 48 layers (4 x (256
patches + 3840 tokens), 32 steps) over the full cache, then with the
same parameters over the ring of with_sliding_window(4096), every step
of every layer through swa_decode at a group width of 6, and trained
at FT_INTERNVL_LAYERS of 48 layers; each with a profile split into the
flash_attention, cross_attention and decode_attention ranges.

After the decode leg come the expert-parallel legs (ROADMAP 5b: the MoE
layer under a DistCtx with a mesh, every rank on the whole batch with
its part of the experts): ep1, a one-rank NCCL world in this process,
mesh (data=1, model=1), where Mixtral-8x7B through generate with the
decode leg's parameters, prompts and steps (expert tensor parallelism)
gives the decode leg's tokens and logits bit for bit, and one
DeepSeek-V3 MoE layer at its published widths (256 experts top-8 of
2048, one shared, alltoall over ("data", "model")) the local path's
output bit for bit, each timed beside the local path; ep2, two gloo
ranks on cuda:0, mesh (1, 2): Mixtral with its experts' hidden dim cut
in two as drawn, the same tokens and logits on both ranks, within the
bf16 tolerance of the decode leg's, with the count of equal tokens,
and a reduced f32 twin equal to the CPU's sharded run; ep4, four gloo
ranks on cuda:0, mesh (2, 2): the DeepSeek-V3 layer with 64 experts a
rank, dropless against the single-device layer, at 1.25 for its wall.
Each prints its walls and the share of its all_to_all, psum and
all_gather calls.

After the train legs come the legs that train under a mesh (ROADMAP 5b's
training half: launch/train.py under a DistCtx whose mesh cuts the MoE
layers' experts, the gradient carried by the mesh's collectives): ept1,
a one-rank NCCL world in this process, mesh (1, 1), where Mixtral-8x7B at
the train full leg's width, depth and tokens takes EPT_STEPS steps, bit
for bit (loss, grad norm, every parameter) the local make_train_step's,
and one DeepSeek-V3 MoE layer at its published widths takes a forward
and backward bit for bit the local layer's gradient; ept2, two gloo
ranks on cuda:0, mesh (1, 2): Mixtral at EPT2_LAYERS layers, its
experts' hidden dim cut in two, the ranks' replicated leaves the same
bits after every step, each rank's expert half within the bf16
tolerance of the same half of ept1's local run, and a reduced f32 twin
equal to the CPU's sharded run; ept4, four gloo ranks on cuda:0, mesh
(2, 2): the DeepSeek-V3 layer's forward and backward with 64 experts a
rank, every gradient within the bf16 tolerance of the single-device
layer's at a dropless factor (that reference computed once the ranks
have exited, so the card never holds both), and reduced f32 DeepSeek-V3
twins (adafactor, MTP, ep="2d" and "tp") equal to the CPU's sharded
run. Each prints its walls, device time, collective share and peaks.

Last of all comes the cp2 leg (the context-parallel decode cache: one
sequence under a (data=2, model=1) mesh of two gloo ranks on cuda:0,
whose batch does not divide over data, so each rank holds a block of the
sequence of every key, value and latent leaf and the ranks' softmax
states are merged): Mistral-NeMo-12B's with_sliding_window(4096) ring
(2048 slots a rank; every step through swa_decode's partial and combine
entry points), the same model over its full cache of 5128 positions and
DeepSeek-V3's MLA latent cache of 4104, at the published widths cut to
2 layers with the weights whole on each rank, 7 greedy steps each:
the prefill's logits within TP_TOL of one device's, each rank's cache
its block of one device's, both ranks the same bits, the partial and
combine held to their plain versions at the ranks' inputs and timed
beside SDPA over the rank's keys, and reduced f32 twins on the card
equal to the CPU under the same mesh within CP_TWIN_TOL.

The second to last line is one JSON object with each kernel's launches,
error against its plain version, times (device_ms by CUDA graph replay)
and bound; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
Without a CUDA device, or without the repository's src/ next to this
file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Every bound's peaks: launch/roofline.py's profile of one H100 SXM
# (NVIDIA's data sheet, dense, 700 W), through compute_s and memory_s.
HW_PROFILE = "h100"

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
# The route allk line: the seed of its inputs and heads, and the timed
# calls of each step.
RA_SEED, RA_REPS = 0, 7
# The perf_probe line: the ops it lists.
PP_TOP = 8

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
# ep2's depth: cut from the decode leg's 8 layers, so that the script
# stays within its time limit with the tp2 leg (ep2_leg).
EP2_LAYERS = 2
# The expert-parallel legs (ROADMAP 5b): Mixtral as the decode leg runs
# it under a (1, 1) NCCL mesh (ep1) and a (1, 2) gloo mesh of two ranks
# on cuda:0 (ep2), and one DeepSeek-V3 MoE layer at its published widths
# under (1, 1) and a (2, 2) gloo mesh of four ranks (ep4): EP_DS_DROPLESS
# tokens at a dropless capacity factor (E / top_k: C = T) against the
# single-device layer, EP_DS_WALL tokens (the DeepSeek serve leg's
# prefill) at the config's 1.25 for its wall. Tolerances, fixed before
# the legs' first run on the card, each of the single-device run's
# largest magnitude: one bf16 MoE layer sharded (ep2's first layer,
# ep4's layer) within EP_BF16_TOL, the CPU tests' bf16 tolerance (the
# tensor-parallel path rounds each output twice more: its partials and
# their sum); the reduced f32 twin within EP_TWIN_TOL of the CPU's
# sharded run; ep2's prefill logits at a dropless capacity factor within
# EP_LOGIT_TOL of a single-device dropless run of the same depth (with
# the dense layers tensor-parallel too, 8 layers put them 4.359 off a
# largest 5.469 on an H100 80GB HBM3 at 700.00 W: routing choices over
# the near-uniform random router flip where a bf16 rounding step moves a
# token's input, and at 8 layers such flips reach the last position).
EP_AXES = ("data", "model")
EP_LOGIT_TOL = 1e-1
EP_DS_DROPLESS, EP_DS_WALL, EP_DS_SEED = (4, 256), (4, 4096), 3
# The legs that train under a mesh (ept1, ept2, ept4), EPT_STEPS steps
# each. ept2 runs Mixtral-8x7B at EPT2_LAYERS layers on two ranks sharing
# the card: a layer is about 1.41 GB of bf16 experts a rank (half of
# every expert's hidden dim), as much again in gradients (and once more
# while a microbatch's gradients are added), 5.6 GB of adamw state, 0.5
# GB for the replicated attention with its gradient and state; the
# embeddings with theirs 3.1 GB and the activations of a 4096-token
# microbatch about 6 GB: 2 layers about 31 GB a rank, 3 layers about 41
# GB, which two ranks on an 80 GB card do not hold. The reduced f32
# twins within EPT_TWIN_TOL (relative) of the CPU's sharded run.
EPT_STEPS, EPT2_LAYERS, EPT_TWIN_TOL = 3, 2, 1e-5
# The tp2 leg: the dense layers' layouts on two gloo ranks sharing the
# card, Mixtral-8x7B at EPT2_LAYERS layers: serving under (1, 2) (tensor
# and sequence parallelism), one train step under (2, 1) (FSDP, the
# batch cut over data) of TP2_BATCH rows in TP2_MICROBATCH microbatches
# (the config's 4 cut to 2: see TP2_TRAIN_LAYERS), so that each
# microbatch cuts its 2 rows over data. In bf16, within TP_TOL of the
# single-device runs' largest magnitude (the tolerance of one sharded
# bf16 MoE layer, EP_BF16_TOL): the prefill's logits, the first layer's
# attention block as generate ran it, the loss and grad norm
# (relative), and every parameter part after the step (of its leaf's
# largest magnitude); the decode steps' logits are reported (`tp2_leg`).
# The f32 twin of the serving run, TP_F32_STEPS steps after the same
# prompts (which fill the 4096-slot ring, so that every step wraps it):
# its tokens equal and its logits within TP_F32_TOL of the single-device
# f32 run's largest (fixed before its first run on the card).
TP2_BATCH, TP2_MICROBATCH, TP_TOL = 4, 2, 2e-2
TP_F32_STEPS, TP_F32_TOL = 8, 1e-3
# The train step's gradient (adamw's first moment after the step) part by
# part, of each slice's largest magnitude: a bf16 gradient goes through
# the layer and back, rounding twice as often as one layer's output (at
# the reduced width in bf16 on the CPU 1.6e-2; with the gradient summed
# over the wrong ranks or rows it is off by O(1)).
TP_GRAD_TOL = 5e-2
# tp2's train step depth: 1 of 32 layers (at 2 its FSDP gathers through
# the host took 126-150 s of the script's limit on an H100 80GB HBM3 at
# 700.00 W). Its gathers run once a microbatch (81.2 s at 4 microbatches
# of 8 rows): 2 microbatches of 4 rows halve them, so that the script,
# with the cp2 leg, stays near 1000 s.
TP2_TRAIN_LAYERS = 1
EP_BF16_TOL, EP_TWIN_TOL = 2e-2, 1e-6
# The tpf leg: the ssm, hybrid, encdec and vlm families' layouts on two
# gloo ranks sharing the card. Serving under (1, 2) (tensor parallel) at
# the published widths, cut in depth: RWKV6-7B at 1 layer, Zamba2-1.2B at
# one group of 6 Mamba2 layers and the shared block after it, Whisper-base
# at 2 + 2 layers (16 clips of 1500 frames, 224 tokens), InternVL2-26B's
# ring (with_sliding_window(4096)) at 2 layers over 4 x (256 patches +
# 3840 tokens), whose decode runs swa_decode on 24 query heads over 4 kv
# heads a rank; TPF_STEPS greedy steps each, the prefill's logits held to
# one device's within TP_TOL. One train step under (2, 1) (FSDP, the
# batch cut over data) of RWKV6-7B and InternVL2-26B at 1 layer
# (tpf_train_cfg) on TPF_BATCH x TF_SEQ positions, held as tp2's. The
# reduced f32 twins of all four (TPF_TWIN: the CPU tests' options) on the
# card against the CPU under the same mesh, within EPT_TWIN_TOL.
# name -> (depth and variant, batch, positions)
TPF_SERVE = {"rwkv6-7b": (dict(n_layers=1), 4, 4096),
             "zamba2-1.2b": (dict(n_layers=6), 4, 4096),
             "whisper-base": (dict(n_layers=2, enc_layers=2), 16, 224),
             "internvl2-26b": (dict(n_layers=2, window=4096), 4, 4096)}
TPF_TRAIN = ("rwkv6-7b", "internvl2-26b")
TPF_TWIN = {"rwkv6-7b": dict(fsdp=True, seq_shard=True),
            "zamba2-1.2b": dict(fsdp=True, seq_shard=True),
            "whisper-base": dict(fsdp=True),
            "internvl2-26b": dict(fsdp=True)}
TPF_STEPS, TPF_BATCH = 8, 2
# swa_decode at the InternVL2 ring leg's shape (b, h, kvh, dh, W): 48
# query heads over 8 KV heads, groups of 6.
IV_SWA = (4, 48, 8, 128, 4096)
# The cp2 leg: the context-parallel decode cache on two gloo ranks sharing
# the card, mesh (2, 1): one sequence (B = 1, the reference's long_500k
# shape, repro/configs/base.py, which launch/dryrun.py runs for the dense
# archs as their with_sliding_window(4096) variant) does not divide over
# data = 2, so each rank holds its block of the sequence of every key,
# value and latent leaf and the ranks' softmax states are merged. At the
# published widths, cut to 2 layers, with the weights whole on each rank
# (fsdp off: at (2, 1) FSDP would gather every weight through the host on
# every step, which the tp2 and tpf legs already drive): Mistral-NeMo-12B's
# sliding-window variant (the ring of 4096 slots, 2048 a rank; the prompt
# of CP_PROMPT tokens wraps it; every step through the partial swa_decode
# entry point and the combine), the same model over its full cache
# (CP_PROMPT + CP_STEPS + 1 = 5128 positions, 2564 a rank), and
# DeepSeek-V3's MLA latent cache at its first 2 layers (CP_DS_DENSE) over
# a prompt of CP_DS_PROMPT (4104 positions). CP_STEPS greedy steps each;
# the prefill's logits within TP_TOL of one device's; the reduced f32
# twins (CP_TWIN: window 16 over 43 + 4 + 1 positions) on the card
# against the CPU under the same mesh within CP_TWIN_TOL (fixed before the
# leg's first run on the card; 1e-6 expected).
# DeepSeek-V3's first 2 layers are dense (of its 3): the config's plan
# puts the MoE segment after them, which at 2 layers would be empty (and
# neither package builds an empty segment), so they run as a model of the
# dense family: MLA, the dense FFN of d_ff 18432, the MTP head drawn.
# label -> (config, published widths cut as given, window, prompt)
CP_PROMPT, CP_DS_PROMPT, CP_STEPS, CP_SEED = 5120, 4096, 7, 11
CP_DS_DENSE = dict(family="dense", moe=None, n_layers=2, n_dense_layers=0)
CP_SERVE = {
    "nemo ring": ("mistral-nemo-12b", dict(n_layers=2, fsdp=False), 4096,
                  CP_PROMPT),
    "nemo full": ("mistral-nemo-12b", dict(n_layers=2, fsdp=False), None,
                  CP_PROMPT),
    "deepseek mla": ("deepseek-v3-671b", dict(CP_DS_DENSE, fsdp=False),
                     None, CP_DS_PROMPT)}
CP_TWIN = {"nemo ring": ("mistral-nemo-12b", {}, 16, 43),
           "nemo full": ("mistral-nemo-12b", {}, None, 43),
           "deepseek mla": ("deepseek-v3-671b", CP_DS_DENSE, None, 43)}
CP_TWIN_STEPS, CP_TWIN_TOL = 4, 1e-5
CP_KERNELS = (("swa_decode", "swa_decode_partial"),
              ("swa_decode", "swa_combine"))

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

# The train legs. The backward kernels at the full-width leg's routing
# (a microbatch of 4096 tokens of d=4096 bf16, 8 experts top-2, C=1280:
# 10240 slots) and at small shapes: (T, d, E, top_k, capacity factor,
# dtype), top_k 1, 2, 3 and 4, dropped entries, f32 and bf16, d of 12,
# 13 and 20 (not multiples of 8).
TK_SHAPES = [(64, 128, 4, 1, 1.0, torch.float32),
             (100, 12, 8, 2, 0.5, torch.bfloat16),
             (100, 12, 8, 2, 0.5, torch.float32),
             (70, 36, 6, 4, 0.75, torch.bfloat16),
             (70, 36, 6, 4, 0.75, torch.float32),
             (33, 13, 4, 2, 0.6, torch.bfloat16),
             (50, 20, 6, 3, 0.5, torch.bfloat16),
             (50, 20, 6, 3, 0.5, torch.float32)]
# Train small: reduced Mixtral-8x7B and granite-3-2b in f32, microbatch
# 2, 3 steps of make_train_step (adamw, lr 1e-3, eps 1e-4) on the card
# against the CPU from one state; batches of 4 x 32 tokens.
TS_CONFIGS, TS_STEPS, TS_BATCH, TS_SEQ, TS_MB = (
    ("mixtral-8x7b", "granite-3-2b"), 3, 4, 32, 2)
# Train full: Mixtral-8x7B at its published widths (configs/
# mixtral_8x7b.py) cut to 2 of 32 layers (a layer is about 1.45 B
# parameters: 17 GB as bf16 weights and gradients plus adamw's f32 m and
# v; two and the embeddings about 38 GB), with the config's own remat,
# microbatch 4 and adamw: batches of 4 x 4096 tokens of the synthetic
# stream, 1 warm-up step, 3 timed steps and 1 profiled.
TF_LAYERS, TF_BATCH, TF_SEQ, TF_WARM, TF_STEPS, TF_LR, TF_SEED = (
    2, 4, 4096, 1, 3, 1e-4, 0)
# Train example: examples/train_lm.py on the card (reduced granite-3-2b,
# 200 adamw steps at lr 3e-3 on batches of 8 x 65 tokens, a loss logged
# every 20 steps, then 8 tokens generated for 4 prompts).
TE_STEPS, TE_LR, TE_BATCH, TE_SEQ, TE_LOG = 200, 3e-3, 8, 65, 20

# The DeepSeek-V3 legs: configs/deepseek_v3_671b.py (arXiv:2412.19437)
# at its published widths (d=7168, 128 heads, MLA with q_lora 1536,
# kv_lora 512, rope 64, nope 128, v 128; 256 experts of 2048 at top-8
# plus 1 shared; dense d_ff 18432; vocab 129280; bf16), depth cut (61
# layers are about 1.3 TB in bf16). Serve: the 3 dense and 2 MoE layers
# (about 55 GB with the MTP head), 4 prompts of 4096 tokens, 32 greedy
# steps. Train: 1 dense and 1 MoE layer (n_dense_layers cut to 1) with
# the MTP head, the config's remat and adafactor, microbatch 1 (the
# config's 8 would hold a third gradient copy: launch/train.py sums the
# microbatches' gradients into the first's), 1 x 4096 tokens a step.
DS_LAYERS, DS_DENSE, DS_BATCH, DS_PROMPT, DS_STEPS, DS_SEED = (
    5, 3, 4, 4096, 32, 0)
DST_LAYERS, DST_DENSE, DST_BATCH, DST_SEQ, DST_WARM, DST_STEPS, DST_LR = (
    2, 1, 1, 4096, 1, 3, 1e-4)
# Reference: reduced DeepSeek-V3 (f32) on the card against the CPU:
# generate (2 prompts of 48 tokens, DSR_DECODE steps), then DSR_TRAIN
# adafactor steps at microbatch 2 on batches of 4 x 32 tokens.
DSR_DECODE, DSR_TRAIN = 4, 3
# The state-carrying legs: RWKV6-7B (configs/rwkv6_7b.py,
# arXiv:2404.05892: 32 layers, d=4096, 64 heads of 64, d_ff 14336, vocab
# 65536) and Zamba2-1.2B (configs/zamba2_1_2b.py, arXiv:2411.15242: 38
# Mamba2 layers in 6 groups of 6 and one of 2, d=2048, d_inner 4096, 64
# heads of 64 over a state of 64, the shared block's 32 heads of 64 and
# d_ff 8192, vocab 32000), bf16 at their published widths. Serve: every
# layer, 4 prompts of 4096 tokens (a multiple of ssm_chunk = 32: the
# chunked prefill), 32 greedy steps. Train: the configs' adamw, remat
# and microbatch 2 on 4 x 4096 tokens a step, 1 warm-up step, 2 timed
# and 1 profiled; Zamba2 at its 38 layers, RWKV cut to SMT_RWKV_LAYERS of
# 32 (the deepest whose peak stays under about 72 GB: bf16 weights and
# gradients, a second gradient copy for the microbatch sum and adamw's
# f32 m and v take 14 bytes a parameter, a layer 202 M of them).
SM_BATCH, SM_PROMPT, SM_STEPS, SM_SEED = 4, 4096, 32, 0
SMT_BATCH, SMT_SEQ, SMT_WARM, SMT_STEPS, SMT_LR = 4, 4096, 1, 2, 1e-4
SMT_RWKV_LAYERS = 20
# Reference: reduced RWKV6-7B and Zamba2-1.2B (Zamba2 at 5 layers in
# groups of 2: two groups and a remainder, three uses of the shared
# block), f32 on the card against the CPU: generate over 2 prompts of
# each of SMR_PROMPTS tokens (48: the chunked prefill, 50: the scan),
# SMR_DECODE steps; then SMR_TRAIN adamw steps (lr 1e-3, eps 1e-4) at
# microbatch 2 on batches of 4 x 32 tokens.
SMR_PROMPTS, SMR_DECODE, SMR_TRAIN = (48, 50), 4, 3
SMR_CONFIGS = {"rwkv6-7b": {},
               "zamba2-1.2b": dict(n_layers=5, hybrid_attn_every=2)}
# The record_function ranges of the recurrences (models/rwkv.py,
# models/mamba.py) and of the attention (models/attention.py) whose
# device time the state legs' profiles report.
STATE_LEGS = {"rwkv6-7b": "rwkv", "zamba2-1.2b": "zamba2"}
STATE_RANGES = {"rwkv6-7b": ("rwkv6_chunked", "rwkv6_scan"),
                "zamba2-1.2b": ("ssd_chunked", "ssd_scan",
                                "flash_attention", "decode_attention")}
# The encdec and vlm legs. Whisper-base (configs/whisper_base.py,
# arXiv:2212.04356: 6 encoder and 6 decoder layers, d=512, 8 heads of 64,
# d_ff 2048 GeLU, LayerNorm, vocab 51865 tied, 1500 frames) and
# InternVL2-26B (configs/internvl2_26b.py, arXiv:2404.16821: 48 layers,
# d=6144, 48 heads over 8 KV heads of 128, d_ff 16384 SwiGLU, vocab 92553,
# 256 patch embeddings), bf16 at their published widths. Serve, every
# layer: Whisper 16 clips of 1500 frame embeddings and prompts of 224
# tokens (inside its 448-token decoder context); InternVL2 4 x (256
# patches + 3840 tokens), over the full cache and, with the same
# parameters, over the ring of its sliding-window variant (the config's
# with_sliding_window(4096), its long-context form; 4096 a multiple of W,
# so the reference's ring layout holds); FS_STEPS greedy steps each.
# Train: the configs' adamw and remat at their microbatch (Whisper 1,
# InternVL2 4), Whisper at its 6 + 6 layers on 16 x (1500 frames, 448
# tokens), InternVL2 cut to FT_INTERNVL_LAYERS of 48 layers on 4 x (256 +
# 3840) tokens (the deepest whose peak stays under about 72 GB: bf16
# weights and gradients, the microbatch sum's second gradient copy and
# adamw's f32 m and v take 14 bytes a parameter, a layer 390 M of them,
# the embeddings, unembedding and vis_proj 1.17 B more); 1 warm-up step,
# FT_STEPS timed and 1 profiled.
FAMILY_LEGS = {"whisper": ("whisper-base", 16, 224, None),
               "internvl": ("internvl2-26b", 4, 4096, None),
               "internvl ring": ("internvl2-26b", 4, 4096, 4096)}
FAMILY_TRAIN = {"whisper": ("whisper-base", 16, 448),
                "internvl": ("internvl2-26b", 4, 4096)}
FS_STEPS, FS_SEED = 32, 0
FT_WARM, FT_STEPS, FT_LR, FT_INTERNVL_LAYERS = 1, 2, 1e-4, 9
# Reference: reduced whisper-base and internvl2-26b, and internvl2-26b's
# sliding-window variant at W=32 (16 patches and FR_PROMPT = 16 tokens:
# S = W, aligned), f32 on the card against the CPU: generate over 2
# prompts of FR_PROMPT tokens with the family's inputs, FR_DECODE steps;
# then FR_TRAIN adamw steps at microbatch 2 (not for the ring variant).
FR_PROMPT, FR_DECODE, FR_TRAIN = 16, 4, 3
FR_CONFIGS = {"whisper-base": ("whisper-base", {}),
              "internvl2-26b": ("internvl2-26b", {}),
              "internvl2-26b ring": ("internvl2-26b",
                                     dict(sliding_window=32))}
# The attention ranges (models/attention.py, models/transformer.py)
# whose device time the family legs' profiles report.
FAMILY_RANGES = ("flash_attention", "cross_attention", "decode_attention")


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


def compute_s(bf16: float = 0.0, f32: float = 0.0) -> float:
    """The least seconds the card takes for ``bf16`` flops on the tensor
    cores and ``f32`` flops outside them (``HW_PROFILE``'s peaks)."""
    from repro_torch.launch.flops import effective_flops
    from repro_torch.launch.roofline import roofline_terms
    fl = effective_flops({"bf16": bf16, "f32": f32}, HW_PROFILE)
    return roofline_terms(fl, 0.0, 0.0, HW_PROFILE)["compute_s"]


def memory_s(nbytes: float) -> float:
    """The least seconds the card takes to move ``nbytes`` through HBM
    (``HW_PROFILE``'s bandwidth)."""
    from repro_torch.launch.roofline import roofline_terms
    return roofline_terms(0.0, nbytes, 0.0, HW_PROFILE)["memory_s"]


def meta_count(cfg, shapes, train: bool):
    """``launch.flops.flops_by_dtype`` of a step on the meta device
    (shapes only, nothing runs): the prefill of a batch of ``shapes``
    ({name: (shape, dtype)}), or with ``train`` one train step on it.
    Returns (the count, seconds). Runs in MetaCounts' worker process."""
    sys.path.insert(0, str(HERE / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.flops import flops_by_dtype
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.common import ShapeOnly
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    t0 = time.perf_counter()
    model = build_model(cfg)
    meta = {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in shapes.items()}
    if train:
        opt = build_optimizer(cfg.optimizer, 1e-4)
        fl = flops_by_dtype(make_train_step(model, None, opt),
                            init_state(model, ShapeOnly(), opt), meta)
    else:
        with torch.no_grad():
            fl = flops_by_dtype(model.prefill, model.init(ShapeOnly()), meta)
    return fl, time.perf_counter() - t0


class MetaCounts:
    """The legs' steps counted on the meta device (:func:`meta_count`)
    in one CPU worker process while the card runs the later legs (the
    counts take about a minute of one core at the legs' depths), each
    printed by :meth:`report` beside the leg's hand count of the same
    step and their difference."""

    def __init__(self):
        self.pool = None
        self.jobs = []

    def submit(self, label: str, cfg, batch, bf16: float, f32: float, *,
               train: bool = False) -> None:
        if self.pool is None:
            import concurrent.futures
            import multiprocessing
            self.pool = concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn"))
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        self.jobs.append((label, bf16, f32, self.pool.submit(
            meta_count, cfg, shapes, train)))

    def report(self) -> None:
        for label, bf16, f32, job in self.jobs:
            fl, secs = job.result()
            print(f"{label} flops: hand count {bf16:.3e} bf16 + {f32:.3e} "
                  f"f32 | flops_by_dtype on meta {fl['bf16']:.3e} bf16 + "
                  f"{fl['f32']:.3e} f32 | difference (meta - hand) "
                  f"{fl['bf16'] - bf16:+.3e} bf16, {fl['f32'] - f32:+.3e} "
                  f"f32 | counted in {secs:.1f} s of the worker",
                  flush=True)
        self.jobs = []

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


META = MetaCounts()


def bound(nbytes: float, flops: float):
    """The least time the card could take (ms) and what sets it."""
    t_bytes = memory_s(nbytes) * 1e3
    t_ops = compute_s(f32=flops) * 1e3
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
    (``repro_torch.kernels.<name>.<fn>``, ``fn`` the name unless given)
    over one pass of a path by
    the shape key that ``key`` gives its arguments, by wrapping the
    function for the length of a ``with`` block, and (unless ``keep`` is
    False) keeps a copy of the first inputs of each shape, so that they
    can be checked and timed."""

    def __init__(self, name: str, key, keep: bool = True,
                 fn: Optional[str] = None):
        self.name, self.key, self.keep = name, key, keep
        self.fn = fn or name
        self.shapes = {}

    def __enter__(self):
        import importlib
        self._module = importlib.import_module(
            f"repro_torch.kernels.{self.name}")
        self._fn = getattr(self._module, self.fn)

        def counted(*args, **kw):
            key = self.key(*args)
            if key not in self.shapes:
                self.shapes[key] = [0, tuple(
                    a.clone() if torch.is_tensor(a) else a
                    for a in args + tuple(kw.values())) if self.keep
                    else None]
            self.shapes[key][0] += 1
            return self._fn(*args, **kw)

        setattr(self._module, self.fn, counted)
        return self

    def __exit__(self, *exc):
        setattr(self._module, self.fn, self._fn)
        return False


def pdist_key(x, c, c_mask=None):
    return (x.shape[0] if x.dim() == 3 else 1, x.shape[-2], x.shape[-1],
            c.shape[-2], c.dim() == 2, c_mask is not None,
            str(x.dtype).replace("torch.", ""))


def kmeans_key(x, assign, k, weights=None):
    return (tuple(x.shape), int(k), weights is not None,
            str(x.dtype).replace("torch.", ""))


def dispatch_key(x, src, valid):
    return (tuple(x.shape), src.shape[0], str(x.dtype).replace("torch.", ""))


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
    src, valid, flat_e, pos_c, keep, _ = moe._plan(ids, m, C)
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
    plus a ragged window (W=200, g=1), a window of 8192 keys, a window
    short enough for one chunk (S = 1, the split kernel writes the
    output itself), and the InternVL2 ring leg's shape, q (4, 48, 128)
    over kw / vw (4, 4096, 8, 128): groups of 6 query rows, which the
    kernel rounds up to 8 (the 2 past the group must be skipped), in
    bf16 and in f32, timed too. The library call is
    F.scaled_dot_product_attention on the (b, kvh, W, dh) views with
    enable_gqa and the bias as its mask, timed only."""
    import math

    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_decode import splits
    from repro_torch.kernels.swa_decode import swa_decode_attention as swa
    g = torch.Generator(device=dev).manual_seed(5)
    cases = [("leg bf16", (MX_BATCH, 32, 8, 128, 4096), torch.bfloat16),
             ("leg f32", (MX_BATCH, 32, 8, 128, 4096), torch.float32),
             ("ragged bf16", (MX_BATCH, 8, 8, 128, 200), torch.bfloat16),
             ("ragged f32", (MX_BATCH, 8, 8, 128, 200), torch.float32),
             ("W=8192 bf16", (MX_BATCH, 32, 8, 128, 8192), torch.bfloat16),
             ("S=1 bf16", (MX_BATCH, 32, 8, 128, 100), torch.bfloat16),
             ("g=6 bf16", IV_SWA, torch.bfloat16),
             ("g=6 f32", IV_SWA, torch.float32)]
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
    leg = swa_times(*swa_inputs(g, dev, MX_BATCH, 32, 8, 128, 4096,
                                torch.bfloat16), rounds)
    g6 = swa_times(*swa_inputs(g, dev, *IV_SWA, torch.bfloat16), rounds)
    ib, ih, ikvh, idh, iW = IV_SWA
    b, h, kvh, dh, W = MX_BATCH, 32, 8, 128, 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = leg["S"]
    print(f"kernel swa_decode: q ({b}, {h}, {dh}) kw/vw ({b}, {W}, {kvh}, "
          f"{dh}) bf16, scattered ring; errors {'; '.join(rels)} match=True "
          f"| leg bf16 ms={leg['ms']:.4f} plain_ms={leg['plain_ms']:.4f} "
          f"sdpa_ms={leg['library_ms']:.4f} bound_ms={leg['bound_ms']:.5f} "
          f"({leg['bound_by']}) | device time by CUDA graph replay: "
          f"ms={leg['device_ms']:.4f} sdpa_ms={leg['device_lib']:.4f} | "
          f"W=8192 bf16 ms={ms_8k:.4f} | g=6 (the internvl ring leg's "
          f"shape, q ({ib}, {ih}, {idh}) kw/vw ({ib}, {iW}, {ikvh}, {idh}) "
          f"bf16): ms={g6['ms']:.4f} plain_ms={g6['plain_ms']:.4f} "
          f"sdpa_ms={g6['library_ms']:.4f} bound_ms={g6['bound_ms']:.5f} "
          f"({g6['bound_by']}); by CUDA graph replay ms="
          f"{g6['device_ms']:.4f} sdpa_ms={g6['device_lib']:.4f}; "
          f"S={g6['S']} chunks | split: S={S} chunks of "
          f"{W // S} keys, {b * kvh * S} split blocks (one per sequence, "
          f"kv head and chunk) + {b * h} combine blocks "
          f"on {sms} SMs ({'; '.join(plans)})", flush=True)
    return dict(max_abs_err=max(errs), ms=leg["ms"],
                plain_ms=leg["plain_ms"], bound_ms=leg["bound_ms"],
                bound_by=leg["bound_by"], library_ms=leg["library_ms"],
                device_ms=leg["device_ms"])


def swa_times(q, kw, vw, bias, rounds: int) -> dict:
    """swa_decode at one shape beside its plain version and SDPA
    (enable_gqa, the bias as its mask): wrapper times by CUDA events,
    device times by CUDA graph replay, the bytes bound, the chunks."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_decode import splits
    from repro_torch.kernels.swa_decode import swa_decode_attention as swa
    b, h, dh = q.shape
    W, kvh = kw.shape[1], kw.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qs, ks, vs = q[:, :, None, :], kw.transpose(1, 2), vw.transpose(1, 2)
    mask = bias[:, None, None, :].to(q.dtype)
    nbytes = q.element_size() * (2 * q.numel() + kw.numel() + vw.numel()) \
        + 4 * bias.numel()
    bms, by = bound(nbytes, 4 * b * h * W * dh)
    return dict(
        ms=time_ms(lambda: swa(q, kw, vw, bias, scale), rounds),
        plain_ms=time_ms(lambda: ref.swa_decode_attention(
            q, kw, vw, bias, scale), rounds),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), rounds),
        device_ms=graph_ms(lambda: swa(q, kw, vw, bias, scale)),
        device_lib=graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        bound_ms=bms, bound_by=by, S=splits(b, h, W, kvh, q.device))


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
    route_allk(device)
    return counts, tally


def route_allk(device) -> None:
    """benchmarks/bench_route_serve.py's step comparison at its
    configuration (k=16, k'=4, d=128, B=64, n=64, qwen1.5-0.5b
    transformer heads; requests spread over the tau rows): the routed
    step and plane._make_allk_step (every cluster's head over the whole
    batch, then the vote's) on the same inputs. Votes and labels must
    be equal, and the predictions of the routed step's kept requests
    within rtol / atol 1e-6 (tests/test_route_serve.py holds the JAX
    pair so). Prints each step's median device ms (the profiler's
    kernel time, RA_REPS calls) and wall ms, the ratio, and each step's
    launches. The reference's bench asserts a ratio of 5 on its own
    chip; the card's is printed, not asserted."""
    from repro_torch.fed.plane import (_make_allk_step, _make_routed_step,
                                       route_capacity)
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.kernels import ops
    from repro_torch.models.heads import init_heads
    from repro_torch.utils.prng import GumbelSource
    k, kp, d, B, n = 16, 4, 128, 64, 64
    cfg = StreamConfig(k=k, k_prime=kp, d=d, capacity=64, batch_size=B,
                       bucket_sizes=(n,), heads="qwen1.5-0.5b",
                       head_arch="transformer")
    gen = torch.Generator(device=device).manual_seed(RA_SEED)
    tau = torch.randn((k, d), generator=gen, device=device) * 8.0
    owner = torch.arange(B, device=device) % k
    data = (torch.randn((B, n, d), generator=gen, device=device)
            + tau[owner][:, None, :])
    pmask = torch.ones((B, n), dtype=torch.bool, device=device)
    kv = torch.full((B,), k, dtype=torch.int32, device=device)
    heads = init_heads(torch.Generator().manual_seed(RA_SEED), k,
                       cfg.head_spec(), device=device)
    gumbel = GumbelSource(RA_SEED).draw(range(B), kp, n, device)
    args = (tau, heads, gumbel, data, pmask, kv)
    steps = {"routed": _make_routed_step(cfg), "allk": _make_allk_step(cfg)}
    outs, launches, dev, wall = {}, {}, {}, {}
    for name, fn in steps.items():
        fn(*args)
        sync()
        ops.reset_launch_counts()
        outs[name] = fn(*args)
        sync()
        launches[name] = {kname: c for kname, c in
                          ops.launch_counts().items() if c}
        walls = []
        for _ in range(RA_REPS):
            t0 = time.perf_counter()
            fn(*args)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall[name] = float(np.median(walls))
        dev[name] = float(np.median([device_ms(lambda: fn(*args))
                                     for _ in range(3)]))
    r, a = outs["routed"], outs["allk"]
    require(torch.equal(r[5], a[5]), "route allk: the votes differ")
    for i in range(4):
        require(torch.equal(r[i], a[i]),
                f"route allk: output {i} of the label body differs")
    kept = r[6]
    require(bool(kept.any()) and bool(a[6].all()),
            "route allk: no kept request, or the baseline dropped one")
    err = float((a[4][kept] - r[4][kept]).abs().max())
    scale = float(r[4][kept].abs().max())
    require(torch.allclose(a[4][kept], r[4][kept], rtol=1e-6, atol=1e-6),
            f"route allk: kept predictions differ by {err} (largest "
            f"{scale})")
    C = route_capacity(B, k, cfg.head_capacity)
    print(f"route allk: bench_route_serve.py's steps (k={k}, k'={kp}, "
          f"d={d}, B={B}, n={n}, qwen1.5-0.5b transformer heads; routed "
          f"queues of C={C}, {k * C} slots against allk's {k * B} head "
          f"forwards) on the same inputs: votes and labels equal, "
          f"{int(kept.sum())} of {B} kept, their predictions within rtol / "
          f"atol 1e-6 (max error {err:.3e}, largest {scale:.3e}) | routed "
          f"{dev['routed']:.4f} ms device, {wall['routed']:.3f} ms wall | "
          f"allk {dev['allk']:.4f} ms device, {wall['allk']:.3f} ms wall | "
          f"allk / routed {dev['allk'] / dev['routed']:.2f}x device, "
          f"{wall['allk'] / wall['routed']:.2f}x wall (medians of "
          f"{RA_REPS} wall and 3 device calls) | launches routed "
          f"{json.dumps(launches['routed'])}, allk "
          f"{json.dumps(launches['allk'])}", flush=True)


def probe_leg(smi: str) -> None:
    """launch/perf_probe.py on Mixtral-8x7B's decode_32k step at 2 of 32
    layers (full width, the shape's 128 sequences over a 32768-token
    context, the ring of W=4096): one line of the top PP_TOP ops by
    device time and the collective schedule (one rank, no mesh)."""
    from repro_torch.launch.perf_probe import probe
    res = probe("mixtral-8x7b", "decode_32k", layers=2, n=PP_TOP,
                device="cuda", verbose=False)
    require(res["op_ms"] > 0,
            "perf_probe: the profiler recorded no device time")
    print(f"perf_probe: {res['config']} on {res['device']} ({smi}): one "
          f"step {res['wall_ms']:.3f} ms wall, {res['op_ms']:.4f} ms of "
          f"device time | top ops: " + "; ".join(
              f"{name[:70]} x{c} {ms:.4f} ms ({100 * share:.1f}%)"
              for name, c, ms, share in res["top"])
          + " | collectives: none (one rank, no mesh)", flush=True)


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
    profiler. Also returns the run (model, parameters, batch, tokens,
    logits and walls) for the expert-parallel legs."""
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
    prompts = mx_prompts(cfg)
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
    step_bound_ms = memory_s(step_bytes) * 1e3
    T, d, H, KVH, hd = B * MX_PROMPT, cfg.d_model, cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    m = cfg.moe
    pairs = sum(min(i + 1, cfg.sliding_window) for i in range(MX_PROMPT))
    bf16_flops = MX_LAYERS * (2 * T * d * (2 * H + 2 * KVH) * hd
                              + 2 * T * d * m.n_experts
                              + 2 * T * m.top_k * 3 * d * m.d_expert) \
        + 2 * B * d * V
    f32_flops = MX_LAYERS * 4 * B * H * hd * pairs
    prefill_bound_s = compute_s(bf16_flops, f32_flops)
    META.submit("decode prefill", cfg, batch, bf16_flops, f32_flops)
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
    run = {"model": model, "params": params, "batch": batch,
           "toks": toks.cpu(),
           "logits": [lg.cpu() for lg in stats["logits"]],
           "prefill_s": prefill_s, "decode_s": decode_s}
    del params, cache, stats
    torch.cuda.empty_cache()
    return counts, {"moe_combine": combine_tally}, run


def mx_prompts(cfg) -> torch.Tensor:
    """The decode leg's MX_BATCH prompts of MX_PROMPT tokens."""
    return torch.as_tensor(np.random.default_rng(MX_SEED).integers(
        0, cfg.vocab_size, size=(MX_BATCH, MX_PROMPT)), dtype=torch.int32)


# ------------------------------------------ expert-parallel MoE serving --

class CollectiveClock:
    """While entered: the seconds and calls of ``ShardGroup.all_to_all``,
    ``psum``, ``all_gather`` and ``reduce_scatter``, each call between
    two device syncs (on gloo a collective waits for the card anyway: it
    stages through the host); a call made inside another (a gather along
    another dim goes through one along dim 0) counts once, as the
    outer."""

    KINDS = ("all_to_all", "psum", "all_gather", "reduce_scatter")

    def __init__(self):
        self.s = dict.fromkeys(self.KINDS, 0.0)
        self.n = dict.fromkeys(self.KINDS, 0)
        self._depth = 0

    def __enter__(self):
        from repro_torch.utils.mesh import ShardGroup
        self._saved = {k: getattr(ShardGroup, k) for k in self.KINDS}
        for kind, fn in self._saved.items():
            def timed(group, *a, _fn=fn, _kind=kind, **kw):
                if self._depth:
                    return _fn(group, *a, **kw)
                self._depth += 1
                try:
                    sync()
                    t0 = time.perf_counter()
                    out = _fn(group, *a, **kw)
                    sync()
                finally:
                    self._depth -= 1
                self.s[_kind] += time.perf_counter() - t0
                self.n[_kind] += 1
                return out
            setattr(ShardGroup, kind, timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.utils.mesh import ShardGroup
        for kind, fn in self._saved.items():
            setattr(ShardGroup, kind, fn)

    def share(self, wall: float) -> str:
        return ", ".join(f"{k} {self.s[k]:.3f} s in {self.n[k]} calls "
                         f"({100 * self.s[k] / wall:.1f}%)"
                         for k in self.KINDS if self.n[k])


def ep_ds_cfg(capacity_factor=None):
    """DeepSeek-V3 at its published widths (configs/deepseek_v3_671b.py:
    256 experts top-8 of 2048, one shared expert, impl="alltoall",
    ep="2d"), with another capacity factor if given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b")
    if capacity_factor is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def ep_ds_layer(device, ctx=None):
    """One DeepSeek-V3 MoE layer drawn from EP_DS_SEED on ``device``;
    under a mesh ``ctx`` with this rank's part of its experts (cut as
    drawn: the bits of that part of the whole draw)."""
    from repro_torch.models import moe
    gen = torch.Generator(device=device).manual_seed(EP_DS_SEED)
    return moe.init_moe(gen, ep_ds_cfg(), torch.bfloat16, ctx)


def ep_x(device, shape, d: int) -> torch.Tensor:
    """A MoE layer's input: (B, S) tokens of d, N(0, 1) in bf16."""
    gen = torch.Generator(device=device).manual_seed(EP_DS_SEED + 1)
    return torch.randn(tuple(shape) + (d,), generator=gen,
                       device=device).to(torch.bfloat16)


def ep_ds_x(device, shape) -> torch.Tensor:
    return ep_x(device, shape, ep_ds_cfg().d_model)


def mx_draw_heads(params, f: int = 0):
    """A few entries of the Mixtral leg's draw: the embedding's first
    rows and, of layer 0's w1, the first columns from ``f`` of the hidden
    dim (a rank's part starts its columns at its offset ``f``)."""
    w1 = params["segments"][0]["moe"]["w1"]
    return (params["embed"][:2, :8].cpu(), w1[0, :, :2, f:f + 8].cpu())


def mx_dropless(model):
    """The Mixtral leg's model at a dropless capacity factor (E / top_k:
    every expert's queue holds every token)."""
    import dataclasses

    from repro_torch.models.model import build_model
    m = model.cfg.moe
    return build_model(model.cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k)))


def mx_dropless_prefill(layers: int) -> torch.Tensor:
    """The prefill logits (on the host) of Mixtral-8x7B at ``layers``
    layers drawn whole from MX_SEED on the card, at a dropless capacity
    factor, over the decode leg's prompts (one generate of a step)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    model = mx_dropless(build_model(get_config("mixtral-8x7b").replace(
        n_layers=layers)))
    params = init_params(model, seed=MX_SEED, device="cuda")
    _, stats, _ = timed_generate(model, params, {
        "tokens": mx_prompts(model.cfg)}, None, steps=1)
    out = stats["logits"][0].cpu()
    del params, stats
    torch.cuda.empty_cache()
    return out


def logit_gap(toks, logits, want_toks, want_logits):
    """How a generate's (tokens, logits) stand to a reference run's: the
    tokens equal, the largest |difference| of the prefill's logits and
    the reference prefill's largest |logit|, and the largest |difference|
    of every logit row whose tokens fed so far equal the reference's
    (with their count)."""
    same = toks == want_toks                                   # (B, steps)
    fed = torch.cat([torch.ones(same.shape[0], 1, dtype=torch.bool),
                     torch.cumprod(same.int(), dim=1).bool()], dim=1)
    err, compared = 0.0, 0
    for j, (got, want) in enumerate(zip(logits, want_logits)):
        rows = fed[:, j]
        if rows.any():
            compared += int(rows.sum())
            err = max(err, float((got.float()[rows] - want.float()[rows])
                                 .abs().max()))
    pre = float((logits[0].float() - want_logits[0].float()).abs().max())
    return {"equal": int(same.sum()), "of": same.numel(), "pre": pre,
            "err": err, "compared": compared,
            "scale": float(want_logits[0].float().abs().max())}


def gap_line(g, tol=None) -> str:
    bar = "" if tol is None else f"tolerance {tol} x "
    return (f"{g['equal']} of {g['of']} tokens equal, prefill logits max "
            f"|diff| {g['pre']:.4g} ({bar}largest {g['scale']:.4g}), over "
            f"the {g['compared']} (row, step) logits whose tokens so far "
            f"agree {g['err']:.4g}")


def mx_layer0(params):
    """The MoE parameters of the Mixtral leg's first layer (views)."""
    from repro_torch.models.transformer import layer_params
    return layer_params(params["segments"][0], 0)["moe"]


def expert_bytes(p) -> int:
    from repro_torch.models.moe import EXPERT_LEAVES
    return sum(p[k].numel() * p[k].element_size() for k in EXPERT_LEAVES)


def nccl_one_rank(tmp: Path, name: str):
    """A one-rank NCCL world in this process and its (data=1, model=1)
    mesh's context."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.utils.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / f"{name}_store"), 1), rank=0, world_size=1)
    return make_ctx(make_mesh((1, 1), EP_AXES, backend="nccl"))


def gloo_rank(tmp: str, name: str, rank: int, shape):
    """Rank ``rank`` of a gloo world of the mesh ``shape``'s size on
    cuda:0 (collectives staged through the host) and its context."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.utils.mesh import make_mesh
    torch.cuda.set_device(0)
    world = int(np.prod(shape))
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"{name}_store"), world), rank=rank,
        world_size=world)
    return make_ctx(make_mesh(shape, EP_AXES, backend="gloo"))


def timed_generate(model, params, batch, ctx, steps: int = MX_STEPS):
    """(tokens, stats, wall s) of one generate, ending in a sync."""
    from repro_torch.launch.serve import generate
    stats = {}
    sync()
    t0 = time.perf_counter()
    toks = generate(model, params, batch, steps=steps, ctx=ctx, stats=stats)
    sync()
    return toks, stats, time.perf_counter() - t0


def ep1_leg(device, run, smi: str, tmp: Path):
    """A one-rank NCCL world in this process, mesh (data=1, model=1),
    where every path of the MoE layer is the local path: Mixtral-8x7B
    (impl="dense": expert tensor parallelism) through generate with the
    decode leg's parameters (popped from ``run``), prompts and steps,
    its tokens and every logit bit for bit the decode leg's, launches
    counted; then local and mesh runs in turns for the (1, 1) path's
    overhead, and one more under the collective clock; and, for ep2
    (saved to ``tmp``), its first MoE layer by the local path on
    MX_BATCH x MX_PROMPT random tokens and a few entries of the draw.
    Then one
    DeepSeek-V3 MoE layer at full width (impl="alltoall", ep="2d") on
    EP_DS_WALL tokens, bit for bit the local path's, and its dropless
    output on EP_DS_DROPLESS tokens by the local path, for ep4. Returns
    (counts, that dropless output on the CPU)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    t_leg = time.perf_counter()
    model, batch, params = run["model"], run["batch"], run.pop("params")
    cfg = model.cfg
    ctx = nccl_one_rank(tmp, "ep1")
    try:
        require(moe.moe_path(cfg.moe, MX_BATCH, MX_PROMPT, ctx) == "etp"
                and moe.moe_path(cfg.moe, MX_BATCH, 1, ctx) == "etp",
                "ep1: Mixtral does not take expert tensor parallelism")
        timed_generate(model, params, batch, ctx, steps=2)   # NCCL warm-up
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        toks, stats, _ = timed_generate(model, params, batch, ctx)
        counts = ops.launch_counts()
        require(torch.equal(toks.cpu(), run["toks"])
                and len(stats["logits"]) == len(run["logits"])
                and all(torch.equal(a.cpu(), b) for a, b in
                        zip(stats["logits"], run["logits"])),
                "ep1: Mixtral under the (1, 1) mesh differs from the decode "
                "leg's run")
        want = {"swa_decode": MX_LAYERS * MX_STEPS,
                "moe_dispatch": MX_LAYERS * (MX_STEPS + 1),
                "moe_combine": MX_LAYERS * (MX_STEPS + 1)}
        require(all(counts[k] == n for k, n in want.items()),
                f"ep1: launches {counts}, expected {want}")
        tp1_line = tp1_check(model, params, ctx, stats, run, counts)
        walls = {"mesh": [stats], "local": []}
        for name in ("local", "mesh", "local"):
            _, st, _ = timed_generate(model, params, batch,
                                      ctx if name == "mesh" else None)
            walls[name].append(st)
        with CollectiveClock() as clock:
            _, _, cwall = timed_generate(model, params, batch, ctx)
        mx_peak = torch.cuda.max_memory_allocated(device) / 1e9
        y0, _ = moe.apply_moe(mx_layer0(params), ep_x(
            device, (MX_BATCH, MX_PROMPT), cfg.d_model), cfg)
        half = cfg.moe.d_expert // 2
        vhalf = cfg.vocab_size // 2
        torch.save({"layer0": y0.cpu(), "draw": mx_draw_heads(params),
                    "w1": {f: mx_draw_heads(params, f)[1]
                           for f in (0, half)},
                    "embed": {v: params["embed"][v:v + 2, :8].cpu()
                              for v in (0, vhalf)}},
                   tmp / "ep2_want.pt")
        del params, stats, y0
        torch.cuda.empty_cache()

        def span(name, key):
            v = [st[key] for st in walls[name]]
            return f"{min(v):.3f}-{max(v):.3f} s"
        mx_line = (f"Mixtral-8x7B ({MX_LAYERS} of 32 layers, {MX_BATCH} x "
                   f"{MX_PROMPT} tokens, {MX_STEPS} steps) tokens and all "
                   f"{len(run['logits'])} logits bit for bit the decode "
                   f"leg's; prefill mesh {span('mesh', 'prefill_s')} / "
                   f"local {span('local', 'prefill_s')}, decode mesh "
                   f"{span('mesh', 'decode_s')} / local "
                   f"{span('local', 'decode_s')} (decode leg "
                   f"{run['prefill_s']:.3f} / {run['decode_s']:.3f} s); "
                   f"under the clock {cwall:.3f} s: {clock.share(cwall)}; "
                   f"peak {mx_peak:.2f} GB; launches {counts}")

        # One DeepSeek-V3 MoE layer: the alltoall path at one shard.
        torch.cuda.reset_peak_memory_stats(device)
        p = ep_ds_layer(device)
        cfg_ds = ep_ds_cfg()
        x = ep_ds_x(device, EP_DS_WALL)
        require(moe.moe_path(cfg_ds.moe, *EP_DS_WALL, ctx) == "alltoall",
                "ep1: the DeepSeek-V3 layer does not take the alltoall path")
        moe.apply_moe(p, x, cfg_ds, ctx)                     # warm-up
        ops.reset_launch_counts()
        y, aux = moe.apply_moe(p, x, cfg_ds, ctx)
        sync()
        ds_counts = ops.launch_counts()
        y0, aux0 = moe.apply_moe(p, x, cfg_ds)
        require(torch.equal(y, y0) and torch.equal(aux, aux0),
                "ep1: the DeepSeek-V3 layer's alltoall path at (1, 1) "
                "differs from its local path")
        require(ds_counts["moe_dispatch"] == 1
                and ds_counts["moe_combine"] == 1,
                f"ep1: the DeepSeek-V3 layer launched {ds_counts}")
        ds_walls = {"mesh": [], "local": []}
        for name in ("local", "mesh", "mesh", "local"):
            sync()
            t0 = time.perf_counter()
            moe.apply_moe(p, x, cfg_ds, ctx if name == "mesh" else None)
            sync()
            ds_walls[name].append(time.perf_counter() - t0)
        with CollectiveClock() as clock:
            sync()
            t0 = time.perf_counter()
            moe.apply_moe(p, x, cfg_ds, ctx)
            sync()
            ds_cwall = time.perf_counter() - t0
        dropless = ep_ds_cfg(cfg_ds.moe.n_experts / cfg_ds.moe.top_k)
        y_ref, _ = moe.apply_moe(p, ep_ds_x(device, EP_DS_DROPLESS),
                                 dropless)
        y_ref = y_ref.cpu()
        ds_peak = torch.cuda.max_memory_allocated(device) / 1e9
        held = expert_bytes(p)
        del p, x, y, y0
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for k, v in ds_counts.items():
        counts[k] += v
    print(f"ep1: one-rank NCCL world, mesh (data=1, model=1) ({smi}): "
          + mx_line + f" | DeepSeek-V3 MoE layer (E={cfg_ds.moe.n_experts} "
          f"top-{cfg_ds.moe.top_k} of {cfg_ds.moe.d_expert}, "
          f"d={cfg_ds.d_model}, {cfg_ds.moe.n_shared} shared expert, bf16, "
          f"{held / 1e9:.2f} GB of experts; {EP_DS_WALL[0]} x "
          f"{EP_DS_WALL[1]} tokens, capacity "
          f"{cfg_ds.moe.capacity_factor}): alltoall / 2d bit for bit the "
          f"local path (output and aux); mesh "
          f"{min(ds_walls['mesh']) * 1e3:.1f}-"
          f"{max(ds_walls['mesh']) * 1e3:.1f} ms / local "
          f"{min(ds_walls['local']) * 1e3:.1f}-"
          f"{max(ds_walls['local']) * 1e3:.1f} ms; under the clock "
          f"{ds_cwall * 1e3:.1f} ms: {clock.share(ds_cwall)}; peak "
          f"{ds_peak:.2f} GB; launches {ds_counts} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    print(f"tp1: ({smi}) " + tp1_line, flush=True)
    return counts, y_ref


def tp1_check(model, params, ctx, stats, run, counts) -> str:
    """The ep1 run read as the tp1 leg: Mixtral-8x7B (fsdp, seq_shard)
    under the (1, 1) mesh takes every dense layout's code path
    (launch/sharding.leaf_parts resolves each leaf; at one rank every
    part is the whole leaf, and every collective a group of one), and
    its tokens and logits are the decode leg's bits (checked by ep1).
    Returns the tp1 line."""
    from repro_torch.launch.sharding import (leaf_parts, param_paths,
                                             param_spec)
    from repro_torch.models.transformer import seq_parallel
    from repro_torch.utils.tree import leaves
    cfg = model.cfg
    shapes = model.param_shapes()
    paths = param_paths(params)
    require(cfg.fsdp and cfg.seq_shard,
            "tp1: Mixtral's fsdp and seq_shard are not on")
    cut = sum(any(a is not None for a in param_spec(cfg, ctx, p, shapes[p]))
              for p in paths)
    require(all(not leaf_parts(cfg, ctx, p, shapes[p]) for p in paths),
            "tp1: a leaf at mesh (1, 1) is not held whole")
    held = sum(a.numel() * a.element_size() for a in leaves(params))
    return (f"Mixtral-8x7B ({MX_LAYERS} of 32 layers, fsdp and seq_shard "
            f"as configured) under the one-rank NCCL mesh (data=1, "
            f"model=1), the ep1 run: param_spec cuts {cut} of its "
            f"{len(paths)} leaves (FSDP over data, heads / FFN hidden / "
            f"vocab over model), each held as its whole leaf at one rank "
            f"({held / 1e9:.2f} GB, the decode leg's); sequence-parallel "
            f"residual at {MX_PROMPT} tokens: "
            f"{seq_parallel(cfg, ctx, MX_PROMPT)} (tp = 1); "
            f"{MX_BATCH} x {MX_PROMPT} prefill and {MX_STEPS} steps: tokens "
            f"and all {len(stats['logits'])} logits bit for bit the decode "
            f"leg's; launches {json.dumps(counts)}")


def ep_twin(ctx):
    """Reduced Mixtral-8x7B (f32) under ``ctx``'s mesh on the card and on
    the CPU from one draw: 2 prompts of 64 tokens and 8 greedy steps.
    Returns (tokens equal, the logits' largest difference over their
    largest magnitude)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    cfg = get_config("mixtral-8x7b", reduced=True).replace(dtype="float32")
    model = build_model(cfg)
    params = init_params(model, seed=0, device="cpu", ctx=ctx)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64)), dtype=torch.int32)
    runs = []
    for dev in ("cuda", "cpu"):
        stats = {}
        out = generate(model, tree_map(lambda a: a.to(dev), params),
                       {"tokens": toks}, steps=8, ctx=ctx, stats=stats)
        runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                             for lg in stats["logits"]])))
    (t1, l1), (t0, l0) = runs
    return (torch.equal(t1, t0),
            float((l1 - l0).abs().max()) / float(l0.abs().max()))


def ep2_rank(rank: int, tmp: str) -> None:
    """One rank of the ep2 leg (spawned): Mixtral-8x7B at the decode
    leg's width, prompts and steps, EP2_LAYERS layers, under the (1, 2)
    mesh, its experts' hidden dim (and its dense layers) cut in
    two as drawn; a warm-up, then one generate between a reset and a
    read of the launch counts, under the collective clock; then the
    reduced f32 twin. Then one generate of a step at a dropless capacity
    factor, for its prefill's logits."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    ctx = gloo_rank(tmp, "ep2", rank, (1, 2))
    try:
        cfg = get_config("mixtral-8x7b").replace(n_layers=EP2_LAYERS)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = init_params(model, seed=MX_SEED, device="cuda", ctx=ctx)
        sync()
        init_s = time.perf_counter() - t0
        held = sum(a.numel() * a.element_size() for a in leaves(params))
        w1 = tuple(params["segments"][0]["moe"]["w1"].shape)
        draw = mx_draw_heads(params)
        batch = {"tokens": mx_prompts(cfg)}
        path = moe.moe_path(cfg.moe, MX_BATCH, MX_PROMPT, ctx)
        y0, _ = moe.apply_moe(mx_layer0(params), ep_x(
            "cuda", (MX_BATCH, MX_PROMPT), cfg.d_model), cfg, ctx)
        y0 = y0.cpu()
        timed_generate(model, params, batch, ctx, steps=2)    # warm-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with CollectiveClock() as clock:
            toks, stats, wall = timed_generate(model, params, batch, ctx)
        counts = ops.launch_counts()
        _, dl_stats, _ = timed_generate(mx_dropless(model), params, batch,
                                        ctx, steps=1)
        from repro_torch.launch.sharding import leaf_parts
        emb = leaf_parts(cfg, ctx, ("embed",), (cfg.vocab_size,
                                                cfg.d_model))
        out = {"describe": ctx.mesh.describe(), "toks": toks.cpu(),
               "dropless": dl_stats["logits"][0].cpu(),
               "embed_lo": emb[0].lo if emb else 0,
               "logits": [lg.cpu() for lg in stats["logits"]],
               "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
               "wall": wall, "clock": (clock.s, clock.n), "counts": counts,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "init_s": init_s, "held_gb": held / 1e9, "w1": w1,
               "path": path, "layer0": y0, "draw": draw,
               "part": moe.expert_part(cfg.moe, ctx, "w1")}
        del params, stats, dl_stats
        torch.cuda.empty_cache()
        out["twin"] = ep_twin(ctx)
        torch.save(out, os.path.join(tmp, f"ep2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ep2_leg(smi: str, tmp: Path):
    """Two gloo ranks on cuda:0, mesh (1, 2): Mixtral-8x7B at EP2_LAYERS
    layers, its experts' FFN hidden dim cut in two (and its attention
    heads and vocab: the dense layouts), the psum of the
    bf16 partials in shard order. Each rank's draw holds the entries of
    ep1's whole draw at its part's offset; every rank holds the same
    tokens and logits. The first MoE layer on ep1's random input within
    EP_BF16_TOL of the local path's largest magnitude. At a dropless
    capacity factor the prefill's logits within EP_LOGIT_TOL of the
    largest magnitude of a single-device dropless run of the same depth
    (:func:`mx_dropless_prefill`, drawn here before the ranks start).
    The run at the config's 1.25 is held to no single-device run (the
    decode leg's has 8 layers, and at 1.25 a token whose top-2 choice
    flips at a bf16 step also moves which later tokens its expert
    drops). The reduced f32 twin equal to the CPU's
    sharded run within EP_TWIN_TOL (tokens exact). The line is printed
    before the checks fail."""
    import torch.multiprocessing as mp
    want_dl = mx_dropless_prefill(EP2_LAYERS)
    t0 = time.perf_counter()
    mp.spawn(ep2_rank, args=(str(tmp),), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"ep2_rank{r}.pt", weights_only=False)
             for r in range(2)]
    a, b = ranks
    want = torch.load(tmp / "ep2_want.pt")
    faults = []
    for r, got in enumerate(ranks):
        emb, w1 = got["draw"]
        if not (torch.equal(emb, want["embed"][got["embed_lo"]])
                and torch.equal(w1, want["w1"][got["part"].lo])):
            faults.append(f"rank {r}: its draw differs from ep1's whole "
                          f"draw at its part")
    same_bits = all(torch.equal(x, y) for x, y in zip(
        [a["toks"], a["layer0"], a["dropless"], *a["logits"]],
        [b["toks"], b["layer0"], b["dropless"], *b["logits"]]))
    if not same_bits:
        faults.append("the ranks' tokens, logits or first layer differ")
    if a["path"] != "etp":
        faults.append(f"the path is {a['path']}")
    dscale = float(want_dl.float().abs().max())
    derr = float((a["dropless"].float() - want_dl.float()).abs().max())
    if derr > EP_LOGIT_TOL * dscale:
        faults.append(f"dropless prefill logits {derr:.4g} off the single-"
                      f"device dropless run's (tolerance {EP_LOGIT_TOL} x "
                      f"{dscale:.4g})")
    y0 = want["layer0"]
    lscale = float(y0.float().abs().max())
    lerr = float((a["layer0"].float() - y0.float()).abs().max())
    if lerr > EP_BF16_TOL * lscale:
        faults.append(f"the first MoE layer is {lerr:.4g} off the local "
                      f"path's (tolerance {EP_BF16_TOL} x {lscale:.4g})")
    launches = {"swa_decode": EP2_LAYERS * MX_STEPS,
                "moe_dispatch": EP2_LAYERS * (MX_STEPS + 1),
                "moe_combine": EP2_LAYERS * (MX_STEPS + 1)}
    for r, got in enumerate(ranks):
        equal, terr = got["twin"]
        if not (equal and terr <= EP_TWIN_TOL):
            faults.append(f"rank {r}: the reduced f32 twin on the card "
                          f"differs from the CPU's sharded run ({equal}, "
                          f"{terr:.3e})")
        if any(got["counts"][k] != n for k, n in launches.items()):
            faults.append(f"rank {r}: launches {got['counts']}, expected "
                          f"{launches}")
    clock = CollectiveClock()
    clock.s, clock.n = a["clock"]
    counts = {k: a["counts"][k] + b["counts"][k] for k in a["counts"]}
    print(f"ep2: {a['describe']} (two processes on cuda:0) ({smi}): "
          f"Mixtral-8x7B ({EP2_LAYERS} of 32 layers; each rank holds w1 "
          f"{a['w1']} of every MoE segment, {a['held_gb']:.2f} GB, drawn in "
          f"{a['init_s']:.2f} s), {MX_BATCH} x {MX_PROMPT} tokens, "
          f"{MX_STEPS} steps; every rank the same bits: {same_bits}; the "
          f"first MoE layer on random tokens max |diff| {lerr:.4g} from "
          f"the local path's (tolerance {EP_BF16_TOL} x {lscale:.4g}); "
          f"dropless prefill logits max |diff| {derr:.4g} from a single-"
          f"device dropless run's (tolerance {EP_LOGIT_TOL} x "
          f"{dscale:.4g}); prefill "
          f"{a['prefill_s']:.3f} s, decode {a['decode_s']:.3f} s "
          f"({a['decode_s'] / MX_STEPS * 1e3:.2f} ms a step), wall "
          f"{a['wall']:.3f} s: {clock.share(a['wall'])}; peak "
          f"{a['peak_gb']:.2f} + {b['peak_gb']:.2f} GB; reduced f32 twin "
          f"on the card against the CPU's sharded run: tokens "
          f"{'exact' if all(r['twin'][0] for r in ranks) else 'differ'}, "
          f"logits within {max(r['twin'][1] for r in ranks):.3e} "
          f"(tolerance {EP_TWIN_TOL}); {spawn_s:.1f} s from spawn to join; "
          f"launches by rank {a['counts']} {b['counts']}", flush=True)
    require(not faults, "ep2: " + "; ".join(faults))
    return counts


def ep4_rank(rank: int, tmp: str) -> None:
    """One rank of the ep4 leg (spawned): the DeepSeek-V3 MoE layer under
    the (2, 2) mesh, 64 of its 256 experts drawn on this rank; the
    dropless output on EP_DS_DROPLESS tokens, then EP_DS_WALL tokens at
    the config's capacity factor: a warm-up, two timed runs and one
    under the collective clock, between a reset and a read of the
    launch counts."""
    import hashlib

    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    ctx = gloo_rank(tmp, "ep4", rank, (2, 2))
    try:
        cfg = ep_ds_cfg()
        t0 = time.perf_counter()
        p = ep_ds_layer("cuda", ctx)
        sync()
        init_s = time.perf_counter() - t0
        dropless = ep_ds_cfg(cfg.moe.n_experts / cfg.moe.top_k)
        ops.reset_launch_counts()
        y_dl, _ = moe.apply_moe(p, ep_ds_x("cuda", EP_DS_DROPLESS),
                                dropless, ctx)
        x = ep_ds_x("cuda", EP_DS_WALL)
        moe.apply_moe(p, x, cfg, ctx)                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        walls, ys = [], []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            y, _ = moe.apply_moe(p, x, cfg, ctx)
            sync()
            walls.append(time.perf_counter() - t0)
            ys.append(y)
        with CollectiveClock() as clock:
            sync()
            t0 = time.perf_counter()
            moe.apply_moe(p, x, cfg, ctx)
            sync()
            cwall = time.perf_counter() - t0
        counts = ops.launch_counts()
        out = {"describe": ctx.mesh.describe(), "y_dl": y_dl.cpu(),
               "hash": hashlib.sha256(ys[0].cpu().view(torch.int16).numpy()
                                      .tobytes()).hexdigest(),
               "twice": torch.equal(ys[0], ys[1]), "walls": walls,
               "cwall": cwall, "clock": (clock.s, clock.n),
               "counts": counts, "init_s": init_s,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "held_gb": expert_bytes(p) / 1e9,
               "w1": tuple(p["w1"].shape),
               "paths": (moe.moe_path(dropless.moe, *EP_DS_DROPLESS, ctx),
                         moe.moe_path(cfg.moe, *EP_DS_WALL, ctx))}
        torch.save(out, os.path.join(tmp, f"ep4_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ep4_leg(y_ref, smi: str, tmp: Path):
    """Four gloo ranks on cuda:0, mesh (2, 2): the DeepSeek-V3 MoE layer
    at full width under ep="2d", each rank 64 of the 256 experts. The
    dropless output (capacity factor E / top_k) on every rank the same
    bits and within EP_BF16_TOL of the largest magnitude of the single-
    device dropless layer's (``y_ref``, ep1's); at the config's 1.25 the
    same bits on every rank, and its wall."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.spawn(ep4_rank, args=(str(tmp),), nprocs=4, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"ep4_rank{r}.pt", weights_only=False)
             for r in range(4)]
    a = ranks[0]
    for r, got in enumerate(ranks):
        require(got["paths"] == ("alltoall", "alltoall"),
                f"ep4 rank {r}: paths {got['paths']}")
        require(torch.equal(got["y_dl"], a["y_dl"])
                and got["hash"] == a["hash"] and got["twice"],
                f"ep4 rank {r}: the output differs from rank 0's or from "
                f"its own first run")
        require(got["counts"]["moe_dispatch"] == 5
                and got["counts"]["moe_combine"] == 5,
                f"ep4 rank {r}: launches {got['counts']}")
    scale = float(y_ref.float().abs().max())
    err = float((a["y_dl"].float() - y_ref.float()).abs().max())
    require(err <= EP_BF16_TOL * scale,
            f"ep4: the dropless output is {err:.4g} off the single-device "
            f"layer's (tolerance {EP_BF16_TOL} x {scale:.4g})")
    clock = CollectiveClock()
    clock.s, clock.n = a["clock"]
    counts = {k: sum(r["counts"][k] for r in ranks) for k in a["counts"]}
    print(f"ep4: {a['describe']} (four processes on cuda:0) ({smi}): "
          f"DeepSeek-V3 MoE layer, ep=2d over (data, model): each rank "
          f"holds w1 {a['w1']}, {a['held_gb']:.2f} GB of the layer's "
          f"{a['held_gb'] * 4:.2f} GB of experts (drawn in "
          f"{a['init_s']:.2f} s); dropless ({EP_DS_DROPLESS[0]} x "
          f"{EP_DS_DROPLESS[1]} tokens, capacity factor 32) the same bits "
          f"on every rank, max |diff| {err:.4g} from the single-device "
          f"layer (tolerance {EP_BF16_TOL} x {scale:.4g}); capacity 1.25 "
          f"on {EP_DS_WALL[0]} x {EP_DS_WALL[1]} tokens the same bits on "
          f"every rank and twice: "
          + ", ".join(f"{w * 1e3:.1f}" for w in a["walls"])
          + f" ms, under the clock {a['cwall'] * 1e3:.1f} ms: "
          f"{clock.share(a['cwall'])}; peak by rank "
          + " + ".join(f"{r['peak_gb']:.2f}" for r in ranks)
          + f" GB; {spawn_s:.1f} s from spawn to join; launches by rank "
          + " ".join(json.dumps(r["counts"]) for r in ranks), flush=True)
    return counts


def ep_legs(device, run, smi: str):
    """The expert-parallel legs: ep1, ep2 and ep4. Returns their launch
    counts, by leg."""
    t_legs = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ep1_counts, y_ref = ep1_leg(device, run, smi, tmp)
        torch.cuda.empty_cache()
        ep2_counts = ep2_leg(smi, tmp)
        ep4_counts = ep4_leg(y_ref, smi, tmp)
    print(f"legs: ep1, ep2, ep4 in {time.perf_counter() - t_legs:.1f} s of "
          f"wall ({smi})", flush=True)
    return {"ep1": ep1_counts, "ep2": ep2_counts, "ep4": ep4_counts}


# ------------------------------------------- training under a mesh (ept) --

def bits_digest(t: torch.Tensor, chunk: int = 1 << 26) -> tuple:
    """Two position-weighted sums of ``t``'s bits (its bytes as int32
    words where they fill them, else bytes), modulo 2^64: equal bits
    give equal digests, and tensors that differ anywhere differ in them
    but by chance. Computed on ``t``'s device, ``chunk`` words at a
    time (a 7.5 GB expert gradient would need 60 GB of int64 at once)."""
    b = t.detach().contiguous().view(-1).view(torch.uint8)
    words = b.view(torch.int32) if b.numel() % 4 == 0 else b
    h1 = h2 = 0
    for lo in range(0, words.numel(), chunk):
        v = words[lo:lo + chunk].to(torch.int64)
        i = torch.arange(lo + 1, lo + 1 + v.numel(), device=v.device,
                         dtype=torch.int64)
        h1 += int((v * (i * 2654435761 + 97)).sum())
        h2 += int((v * (i * 40503 + (i >> 7) * 7919 + 1)).sum())
    return h1 % (1 << 64), h2 % (1 << 64)


def replicated_digests(params, shards) -> list:
    """:func:`bits_digest` of every leaf held whole (not a part)."""
    from repro_torch.utils.tree import leaves
    return [bits_digest(a) for a, sh in zip(leaves(params), shards)
            if sh is None]


def ept_steps(step, state, batches, digests=None):
    """The EPT_STEPS steps of a train step over ``batches``: the first a
    warm-up, the second timed alone, the third under the collective
    clock and the profiler (its device time: its kernels' own times).
    With ``digests`` (a function of the parameters) it is called after
    every step. Returns (state, record)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    rec = {"walls": [], "loss": [], "grad_norm": [], "digests": []}
    clock = CollectiveClock()
    for i, b in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        if i == 2:
            with clock, torch_profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                state, met = step(state, b)
                sync()
        else:
            state, met = step(state, b)
            sync()
        rec["walls"].append(time.perf_counter() - t0)
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        if digests is not None:
            rec["digests"].append(digests(state.params))
    t = sum(e.self_device_time_total for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA"))
    rec["device_s"] = t / 1e6 if t else None
    rec["clock"] = (clock.s, clock.n)
    return state, rec


def ept_line(rec) -> str:
    """A run's walls, device time, collective share, losses and norms."""
    clock = CollectiveClock()
    clock.s, clock.n = rec["clock"]
    dev = ("not measured (the profiler recorded no device time)"
           if rec["device_s"] is None else f"{rec['device_s']:.3f} s")
    w = rec["walls"]
    return (f"steps {w[0]:.3f} (warm-up), {w[1]:.3f}, {w[2]:.3f} s (under "
            f"the clock and the profiler: device time {dev}, "
            f"{clock.share(w[2]) or 'no collectives'}); loss "
            + ", ".join(f"{v:.6f}" for v in rec["loss"]) + "; grad norm "
            + ", ".join(f"{v:.6f}" for v in rec["grad_norm"]))


def max_gap(got: torch.Tensor, want: torch.Tensor, device,
            rows: int = 16) -> float:
    """The largest |got - want| over want's largest magnitude, taken on
    ``device`` in blocks of ``rows`` along dim 0 (the tensors on any
    device, of one shape)."""
    num = den = 0.0
    for i in range(0, got.shape[0], rows):
        a = got[i:i + rows].to(device).float()
        b = want[i:i + rows].to(device).float()
        num = max(num, float((a - b).abs().max()))
        den = max(den, float(b.abs().max()))
    return num / den


def ept_mixtral(device, layers: int, ctx=None):
    """Mixtral-8x7B at its published widths cut to ``layers`` layers,
    its remat, microbatch 4 and adamw at TF_LR, drawn from TF_SEED on
    ``device`` (under a mesh ``ctx``, this rank's parts as drawn): (model,
    optimizer, state, the batches of the train full leg's size)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainState
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    cfg = get_config("mixtral-8x7b").replace(n_layers=layers)
    model = build_model(cfg)
    opt = build_optimizer(cfg.optimizer, TF_LR)
    params = init_params(model, seed=TF_SEED, device=device, ctx=ctx)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    batches = train_batches(TF_SEED, cfg.vocab_size, TF_BATCH, TF_SEQ + 1,
                            EPT_STEPS, device)
    return model, opt, state, batches


def ept_layer_grads(p, x, dy, cfg, ctx):
    """The gradient of sum(y * dy) + aux of one MoE layer (``p``, this
    rank's parts under a mesh) at ``x``: {leaf: grad} for the router,
    the expert leaves, the shared expert's and x."""
    from repro_torch.models import moe
    names = ["router", *moe.EXPERT_LEAVES]
    req = {k: p[k].detach().requires_grad_(True) for k in names}
    shared = {k: v.detach().requires_grad_(True)
              for k, v in p["shared"].items()}
    xr = x.detach().requires_grad_(True)
    y, aux = moe.apply_moe(dict(p, **req, shared=shared), xr, cfg, ctx)
    loss = (y.float() * dy.float()).sum() + aux
    got = torch.autograd.grad(loss, [*req.values(), *shared.values(), xr])
    keys = names + [f"shared.{k}" for k in shared] + ["x"]
    return dict(zip(keys, got))


def ept_twin(ctx, name: str, over: dict, opt_name: str, **kw):
    """Reduced ``name`` (f32, ``over`` its MoE fields) under ``ctx``'s
    mesh, EPT_STEPS steps of ``opt_name`` (options ``kw``) at lr 1e-3 on
    the card and on the CPU from one draw: the largest relative gap of
    the losses and grad norms, and of the parameters (each leaf's
    largest |difference| over its largest magnitude)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.launch.serve import init_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    cfg = get_config(name, reduced=True).replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **over))
    model = build_model(cfg)
    params = init_params(model, seed=0, device="cpu", ctx=ctx)
    rng = np.random.default_rng(1)
    batches = [{k: torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(EPT_STEPS)]
    runs = []
    for dev in ("cuda", "cpu"):
        opt = build_optimizer(opt_name, 1e-3, **kw)
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        state = TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=dev))
        step = make_train_step(model, ctx, opt)
        mets = []
        for b in batches:
            state, met = step(state, {k: v.to(dev) for k, v in b.items()})
            mets += [float(met["loss"]), float(met["grad_norm"])]
        runs.append((np.array(mets), [a.cpu() for a in leaves(
            state.params)]))
    (m1, p1), (m0, p0) = runs
    met_gap = float(np.max(np.abs(m1 - m0) / np.abs(m0)))
    par_gap = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                  for a, b in zip(p1, p0))
    return met_gap, par_gap


def ept_grad_parts(cfg, ctx, grads) -> dict:
    """{leaf: [(axis, lo, hi), ...]} of :func:`ept_layer_grads`' leaves:
    the parts of the MoE layer's leaves this rank holds
    (launch/sharding.leaf_parts: the experts, the router's FSDP dim, the
    shared experts' FSDP and tensor-parallel dims); x's none."""
    from repro_torch.launch.sharding import leaf_parts
    from repro_torch.models import moe
    m, d = cfg.moe, cfg.d_model
    shapes = {"router": (d, m.n_experts),
              "shared.w1": (d, m.n_shared * m.d_expert),
              "shared.w3": (d, m.n_shared * m.d_expert),
              "shared.w2": (m.n_shared * m.d_expert, d)}
    for name in moe.EXPERT_LEAVES:
        shapes[name] = moe._full_shape(m, d, name)
    out = {}
    for k in grads:
        if k == "x":
            out[k] = []
            continue
        path = ("moe",) + tuple(k.split("."))
        out[k] = [(p.axis, p.lo, p.hi)
                  for p in leaf_parts(cfg, ctx, path, shapes[k])]
    return out


def ept1_leg(device, smi: str, tmp: Path):
    """A one-rank NCCL world in this process, mesh (data=1, model=1).
    Mixtral-8x7B at the train full leg's width, depth and tokens: EPT_STEPS
    steps of the local make_train_step, then of the mesh's from the same
    draw, whose loss, grad norm and every parameter must be the local
    run's bits (by :func:`bits_digest`; launches counted on the mesh's).
    The local run's parameters stay on the host for ept2. Then one
    DeepSeek-V3 MoE layer at its published widths on EP_DS_DROPLESS
    tokens: its gradient (the router's, every expert leaf's, the shared
    expert's and x's) by the local path, then under the mesh, the same
    bits. Returns (counts, the Mixtral reference)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import param_shards
    from repro_torch.launch.train import make_train_step
    from repro_torch.utils.tree import leaves
    t_leg = time.perf_counter()
    ctx = nccl_one_rank(tmp, "ept1")
    try:
        model, opt, state, batches = ept_mixtral(device, TF_LAYERS)
        state, local = ept_steps(make_train_step(model, None, opt), state,
                                 batches)
        want = [bits_digest(a) for a in leaves(state.params)]
        mx_ref = [a.cpu() for a in leaves(state.params)]
        del state
        torch.cuda.empty_cache()
        model, opt, state, batches = ept_mixtral(device, TF_LAYERS, ctx)
        shards = param_shards(state.params, model.cfg, ctx)
        require(all(sh is None for sh in shards),
                "ept1: a part at mesh (1, 1) is not the whole leaf")
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        state, mesh = ept_steps(make_train_step(model, ctx, opt), state,
                                batches)
        counts = ops.launch_counts()
        mx_peak = torch.cuda.max_memory_allocated(device) / 1e9
        require(mesh["loss"] == local["loss"]
                and mesh["grad_norm"] == local["grad_norm"],
                f"ept1: the mesh's losses {mesh['loss']} / grad norms "
                f"{mesh['grad_norm']} are not the local step's "
                f"{local['loss']} / {local['grad_norm']}")
        same = [bits_digest(a) == w for a, w in zip(leaves(state.params),
                                                    want)]
        require(all(same), f"ept1: {same.count(False)} of {len(same)} "
                f"parameters differ from the local step's")
        mb, L = model.cfg.microbatch, TF_LAYERS
        launches = {"moe_dispatch": 2 * L * mb * EPT_STEPS,
                    "moe_combine": 2 * L * mb * EPT_STEPS,
                    "moe_combine_bwd": L * mb * EPT_STEPS,
                    "moe_dispatch_bwd": L * mb * EPT_STEPS}
        require(all(counts[k] == n for k, n in launches.items()),
                f"ept1: launches {counts}, expected {launches}")
        nparam = sum(a.numel() for a in mx_ref)
        del state, batches
        torch.cuda.empty_cache()

        # One DeepSeek-V3 MoE layer, forward and backward.
        cfg_ds = ep_ds_cfg()
        torch.cuda.reset_peak_memory_stats(device)
        p = ep_ds_layer(device)
        x = ep_ds_x(device, EP_DS_DROPLESS)
        dy = ep_x(device, EP_DS_DROPLESS, cfg_ds.d_model)
        ept_layer_grads(p, x, dy, cfg_ds, None)              # warm-up
        walls, digests = {}, {}
        for name, c in (("local", None), ("mesh", ctx)):
            if name == "mesh":
                ops.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            g = ept_layer_grads(p, x, dy, cfg_ds, c)
            sync()
            walls[name] = time.perf_counter() - t0
            require(all(v.abs().max() > 0 for v in g.values()),
                    f"ept1: a DeepSeek-V3 layer gradient is zero ({name})")
            digests[name] = {k: bits_digest(v) for k, v in g.items()}
            del g
        ds_counts = ops.launch_counts()
        diff = [k for k, v in digests["mesh"].items()
                if v != digests["local"][k]]
        require(not diff, f"ept1: the DeepSeek-V3 layer's gradient under "
                f"the mesh differs from the local path's at {diff}")
        ds_peak = torch.cuda.max_memory_allocated(device) / 1e9
        held = expert_bytes(p)
        del p, x, dy
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for k, v in ds_counts.items():
        counts[k] += v
    print(f"ept1: one-rank NCCL world, mesh (data=1, model=1) ({smi}): "
          f"Mixtral-8x7B ({TF_LAYERS} of 32 layers, {nparam / 1e9:.3f} B "
          f"parameters, remat, microbatch {model.cfg.microbatch}, adamw lr "
          f"{TF_LR}, batches of {TF_BATCH} x {TF_SEQ} tokens), "
          f"{EPT_STEPS} steps: loss, grad norm and all {len(mx_ref)} "
          f"parameters bit for bit the local make_train_step's | mesh "
          + ept_line(mesh) + " | local " + ept_line(local)
          + f" | peak {mx_peak:.2f} GB | launches {json.dumps(counts)} | "
          f"DeepSeek-V3 MoE layer ({cfg_ds.moe.n_experts} experts top-"
          f"{cfg_ds.moe.top_k} of {cfg_ds.moe.d_expert}, d={cfg_ds.d_model},"
          f" bf16, {held / 1e9:.2f} GB of experts; {EP_DS_DROPLESS[0]} x "
          f"{EP_DS_DROPLESS[1]} tokens, capacity "
          f"{cfg_ds.moe.capacity_factor}): forward and backward under the "
          f"mesh {walls['mesh'] * 1e3:.1f} ms, local "
          f"{walls['local'] * 1e3:.1f} ms, every gradient bit for bit the "
          f"local path's; peak {ds_peak:.2f} GB; launches "
          f"{json.dumps(ds_counts)} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    return counts, mx_ref, mx_peak


def ept2_rank(rank: int, tmp: str) -> None:
    """One rank of the ept2 leg (spawned): Mixtral-8x7B at full width,
    EPT2_LAYERS layers, under the (1, 2) mesh, its experts' hidden dim
    cut in two as drawn; EPT_STEPS steps with the digests of the
    replicated leaves after each, launches counted; its final expert
    parts saved; then the reduced f32 twin."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import param_shards
    from repro_torch.launch.train import make_train_step
    from repro_torch.utils.tree import leaves
    ctx = gloo_rank(tmp, "ept2", rank, (1, 2))
    try:
        model, opt, state, batches = ept_mixtral("cuda", EPT2_LAYERS, ctx)
        shards = param_shards(state.params, model.cfg, ctx)
        held = sum(a.numel() * a.element_size()
                   for a in leaves(state.params))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, rec = ept_steps(
            make_train_step(model, ctx, opt), state, batches,
            digests=lambda p: replicated_digests(p, shards))
        rec["counts"] = ops.launch_counts()
        rec["microbatch"] = model.cfg.microbatch
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["held_gb"] = held / 1e9
        rec["describe"] = ctx.mesh.describe()
        rec["parts"] = {i: ([(c.axis, c.lo, c.hi) for c in sh.cuts],
                            a.cpu()) for i, (a, sh)
                        in enumerate(zip(leaves(state.params), shards))
                        if sh is not None}
        del state, batches
        torch.cuda.empty_cache()
        # adamw at eps 1e-4, as the CPU train tests: at 1e-8 a weight
        # whose gradient is near 0 moves by lr * g / (|g| + eps), which
        # turns a gradient's last-bit difference into a step of lr.
        rec["twin"] = ept_twin(ctx, "mixtral-8x7b", {}, "adamw", eps=1e-4)
        torch.save(rec, os.path.join(tmp, f"ept2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ept2_leg(mx_ref, smi: str, tmp: Path):
    """Two gloo ranks on cuda:0, mesh (1, 2): Mixtral-8x7B training with
    its experts' hidden dim cut in two. The ranks' replicated leaves the
    same bits after every step; each rank's expert parts within
    EP_BF16_TOL of each leaf's largest magnitude of the same part of the
    local run of ept1 (``mx_ref``, the same depth, draw and batches);
    each rank's reduced f32 twin within EPT_TWIN_TOL of the CPU's sharded
    run. Returns the launch counts of both ranks."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.spawn(ept2_rank, args=(str(tmp),), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"ept2_rank{r}.pt", weights_only=False)
             for r in range(2)]
    a, b = ranks
    faults = []
    if a["digests"] != b["digests"]:
        steps = [i + 1 for i, (x, y) in enumerate(zip(a["digests"],
                                                      b["digests"]))
                 if x != y]
        faults.append(f"the ranks' replicated leaves differ after steps "
                      f"{steps}")
    if a["loss"] != b["loss"] or a["grad_norm"] != b["grad_norm"]:
        faults.append("the ranks' losses or grad norms differ")
    err = 0.0
    for r, got in enumerate(ranks):
        for i, (cuts, part) in got["parts"].items():
            want = mx_ref[i]
            for axis, lo, hi in cuts:
                want = want.narrow(axis, lo, hi - lo)
            err = max(err, max_gap(part, want, "cuda"))
        mg, pg = got["twin"]
        if not (mg <= EPT_TWIN_TOL and pg <= EPT_TWIN_TOL):
            faults.append(f"rank {r}: the reduced f32 twin on the card is "
                          f"{mg:.3e} / {pg:.3e} off the CPU's sharded run")
    if err > EP_BF16_TOL:
        faults.append(f"an expert part is {err:.4g} of its leaf's largest "
                      f"magnitude off the local step's (tolerance "
                      f"{EP_BF16_TOL})")
    mb, L = a["microbatch"], EPT2_LAYERS
    want = {"moe_dispatch": 2 * L * mb * EPT_STEPS,
            "moe_combine": 2 * L * mb * EPT_STEPS,
            "moe_combine_bwd": L * mb * EPT_STEPS,
            "moe_dispatch_bwd": L * mb * EPT_STEPS}
    for r, got in enumerate(ranks):
        if any(got["counts"][k] != n for k, n in want.items()):
            faults.append(f"rank {r}: launches {got['counts']}, expected "
                          f"{want}")
    counts = {k: a["counts"][k] + b["counts"][k] for k in a["counts"]}
    print(f"ept2: {a['describe']} (two processes on cuda:0) ({smi}): "
          f"Mixtral-8x7B cut to {EPT2_LAYERS} of 32 layers (each rank "
          f"holds {a['held_gb']:.2f} GB of parameters: half of every "
          f"expert's hidden dim, of the attention heads and of the vocab "
          f"rows, as param_spec cuts them), the train full leg's "
          f"batches, remat, "
          f"microbatch 4, adamw: rank 0 " + ept_line(a)
          + f"; every rank's replicated leaves the same bits after each "
          f"step: {a['digests'] == b['digests']}; the expert parts within "
          f"{err:.3e} of each leaf's largest magnitude of ept1's local run "
          f"(tolerance {EP_BF16_TOL}); peak by rank {a['peak_gb']:.2f} + "
          f"{b['peak_gb']:.2f} GB; reduced f32 twin against the CPU's "
          f"sharded run: metrics within "
          f"{max(r['twin'][0] for r in ranks):.3e}, parameters within "
          f"{max(r['twin'][1] for r in ranks):.3e} (tolerance "
          f"{EPT_TWIN_TOL}); {spawn_s:.1f} s from spawn to join; launches "
          f"by rank {json.dumps(a['counts'])} {json.dumps(b['counts'])}",
          flush=True)
    require(not faults, "ept2: " + "; ".join(faults))
    return counts


def ept4_rank(rank: int, tmp: str) -> None:
    """One rank of the ept4 leg (spawned): the DeepSeek-V3 MoE layer
    under the (2, 2) mesh, 64 of its 256 experts drawn on this rank:
    forward and backward at a dropless capacity factor on EP_DS_DROPLESS
    tokens, timed (launches counted), then again under the collective
    clock and the profiler; its gradient saved (and the digests of its
    replicated ones); then the reduced f32 DeepSeek-V3 twins (adafactor,
    MTP; ep="2d" and "tp")."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.kernels import ops
    from repro_torch.models import moe
    ctx = gloo_rank(tmp, "ept4", rank, (2, 2))
    try:
        cfg = ep_ds_cfg()
        dropless = ep_ds_cfg(cfg.moe.n_experts / cfg.moe.top_k)
        p = ep_ds_layer("cuda", ctx)
        x = ep_ds_x("cuda", EP_DS_DROPLESS)
        dy = ep_x("cuda", EP_DS_DROPLESS, cfg.d_model)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        grads = ept_layer_grads(p, x, dy, dropless, ctx)
        sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        torch.save({k: v.cpu() for k, v in grads.items()},
                   os.path.join(tmp, f"ept4_grads{rank}.pt"))
        parts = ept_grad_parts(cfg, ctx, grads)
        replicated = {k: bits_digest(v) for k, v in grads.items()
                      if not parts[k]}
        del grads
        with CollectiveClock() as clock, torch_profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            ept_layer_grads(p, x, dy, dropless, ctx)
            sync()
            cwall = time.perf_counter() - t0
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA"))
        out = {"describe": ctx.mesh.describe(), "wall": wall,
               "device_s": dev / 1e6 if dev else None, "cwall": cwall,
               "clock": (clock.s, clock.n), "counts": counts,
               "replicated": replicated,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "held_gb": expert_bytes(p) / 1e9,
               "part": moe.expert_part(cfg.moe, ctx, "w1"),
               "parts": parts,
               "path": moe.moe_path(dropless.moe, *EP_DS_DROPLESS, ctx)}
        del p, x, dy
        torch.cuda.empty_cache()
        out["twins"] = {ep: ept_twin(ctx, "deepseek-v3-671b",
                                     {"impl": "alltoall", "ep": ep},
                                     "adafactor") for ep in ("2d", "tp")}
        torch.save(out, os.path.join(tmp, f"ept4_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ept4_leg(device, smi: str, tmp: Path):
    """Four gloo ranks on cuda:0, mesh (2, 2): the DeepSeek-V3 MoE layer
    at full width under ep="2d", 64 experts a rank, forward and backward
    at a dropless capacity factor; the replicated gradients (the
    router's, the shared expert's, dx) the same bits on every rank. Once
    the ranks have exited, the single-device layer's gradient on the
    same inputs is computed here (so the card never holds it beside the
    ranks' layers), and each rank's expert-part gradient and the
    replicated ones are held to it within EP_BF16_TOL of each leaf's
    largest magnitude. The reduced f32 DeepSeek-V3 twins (2d and tp)
    within EPT_TWIN_TOL of the CPU's sharded run. Returns the launch
    counts of all ranks."""
    import torch.multiprocessing as mp

    from repro_torch.models import moe
    t0 = time.perf_counter()
    mp.spawn(ept4_rank, args=(str(tmp),), nprocs=4, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"ept4_rank{r}.pt", weights_only=False)
             for r in range(4)]
    faults = []
    for r, got in enumerate(ranks):
        if got["path"] != "alltoall":
            faults.append(f"rank {r}: path {got['path']}")
        if got["replicated"] != ranks[0]["replicated"]:
            faults.append(f"rank {r}: a replicated gradient differs from "
                          f"rank 0's")
        for ep, (mg, pg) in got["twins"].items():
            if not (mg <= EPT_TWIN_TOL and pg <= EPT_TWIN_TOL):
                faults.append(f"rank {r}: the reduced f32 twin (ep={ep}) "
                              f"on the card is {mg:.3e} / {pg:.3e} off the "
                              f"CPU's sharded run")
        if any(got["counts"][k] == 0 for k in (
                "moe_dispatch", "moe_combine_bwd", "moe_dispatch_bwd")):
            faults.append(f"rank {r}: launches {got['counts']}")
    t1 = time.perf_counter()
    cfg = ep_ds_cfg()
    dropless = ep_ds_cfg(cfg.moe.n_experts / cfg.moe.top_k)
    p = ep_ds_layer(device)
    ref = ept_layer_grads(p, ep_ds_x(device, EP_DS_DROPLESS),
                          ep_x(device, EP_DS_DROPLESS, cfg.d_model),
                          dropless, None)
    del p
    torch.cuda.empty_cache()
    err = {}
    for r, got in enumerate(ranks):
        grads = torch.load(tmp / f"ept4_grads{r}.pt", mmap=True)
        for k, g in grads.items():
            want = ref[k]
            for axis, lo, hi in got["parts"][k]:
                want = want.narrow(axis, lo, hi - lo)
            err[k] = max(err.get(k, 0.0), max_gap(g, want, device))
        del grads
    del ref
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t1
    bad = {k: e for k, e in err.items() if e > EP_BF16_TOL}
    if bad:
        faults.append(f"gradients off the single-device layer's beyond "
                      f"{EP_BF16_TOL}: {bad}")
    a = ranks[0]
    clock = CollectiveClock()
    clock.s, clock.n = a["clock"]
    dev = ("not measured" if a["device_s"] is None
           else f"{a['device_s']:.3f} s")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in a["counts"]}
    print(f"ept4: {a['describe']} (four processes on cuda:0) ({smi}): "
          f"DeepSeek-V3 MoE layer, ep=2d over (data, model), each rank "
          f"{a['held_gb']:.2f} GB of the layer's {4 * a['held_gb']:.2f} GB "
          f"of experts (w1 part {a['part'].lo}:{a['part'].hi} of rank 0); "
          f"forward and backward dropless on {EP_DS_DROPLESS[0]} x "
          f"{EP_DS_DROPLESS[1]} tokens: wall {a['wall']:.3f} s, under the "
          f"clock and the profiler {a['cwall']:.3f} s (device time {dev}): "
          f"{clock.share(a['cwall'])}; the replicated gradients the same "
          f"bits on every rank; every gradient against the single-device "
          f"layer's (largest |diff| over the leaf's largest magnitude, "
          f"tolerance {EP_BF16_TOL}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in err.items())
          + f" (reference and checks {check_s:.1f} s); peak by rank "
          + " + ".join(f"{r['peak_gb']:.2f}" for r in ranks)
          + " GB; reduced f32 DeepSeek-V3 twins (adafactor, MTP) against "
          "the CPU's sharded run: " + ", ".join(
              f"ep={ep} metrics {mg:.3e} parameters {pg:.3e}"
              for ep, (mg, pg) in a["twins"].items())
          + f" (tolerance {EPT_TWIN_TOL}); {spawn_s:.1f} s from spawn to "
          f"join; launches by rank "
          + " ".join(json.dumps(r["counts"]) for r in ranks), flush=True)
    require(not faults, "ept4: " + "; ".join(faults))
    return counts


# ------------------------------- the dense layers' layouts (tp1, tp2) --

def shape_key(*args):
    """The shapes and dtypes of a call's tensors, its other arguments as
    they are."""
    return tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""))
                 if torch.is_tensor(a) else a for a in args)


@contextlib.contextmanager
def first_inputs(kernels, path: str, keep: bool):
    """While entered: each kernel wrapper of ``kernels`` ((module,
    function) pairs) tallied by :func:`shape_key`; on exit, where
    ``keep``, the first inputs of each shape saved to ``path`` on the
    host, keyed by (module, shape key)."""
    with contextlib.ExitStack() as stack:
        tallies = [stack.enter_context(Tally(mod, shape_key, fn=fn))
                   for mod, fn in kernels]
        yield
    if keep:
        torch.save({(t.name,) + key: tuple(a.cpu() if torch.is_tensor(a)
                                           else a for a in inputs)
                    for t in tallies
                    for key, (_, inputs) in t.shapes.items()}, path)


TP_SERVE_KERNELS = (("swa_decode", "swa_decode_attention"),
                    ("moe_dispatch", "moe_dispatch"),
                    ("moe_combine", "moe_combine"))
TP_TRAIN_KERNELS = (("moe_dispatch", "moe_dispatch"),
                    ("moe_combine", "moe_combine"),
                    ("moe_dispatch_bwd", "moe_dispatch_bwd"),
                    ("moe_combine_bwd", "moe_combine_bwd"))


def tp2_cfgs():
    """(the serving model: Mixtral-8x7B at EPT2_LAYERS layers at a
    dropless capacity factor; the training model at TP2_TRAIN_LAYERS,
    dropless and with the load-balance loss's weight 0), fsdp and
    seq_shard as configured. With the batch cut over data each shard
    fills its experts' queues and averages its load-balance loss over
    its own rows, as the reference's sharded program does; dropless and
    at weight 0 the step is the single-device step's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    full = get_config("mixtral-8x7b")
    train = mx_dropless(build_model(full.replace(
        n_layers=TP2_TRAIN_LAYERS, microbatch=TP2_MICROBATCH))).cfg
    return (mx_dropless(build_model(full.replace(n_layers=EPT2_LAYERS))),
            build_model(train.replace(moe=dataclasses.replace(
                train.moe, router_aux_weight=0.0))))


def tp2_f32_serve(ctx):
    """The f32 twin of tp2's serving run: its model in f32 drawn from
    MX_SEED (this rank's parts under ``ctx``; whole where None), over the
    decode leg's prompts, which fill its 4096-slot ring, and TP_F32_STEPS
    greedy steps, each of which overwrites a slot: (tokens, logits, wall
    s) on the host."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    serve, _ = tp2_cfgs()
    model = build_model(serve.cfg.replace(dtype="float32"))
    params = init_params(model, seed=MX_SEED, device="cuda", ctx=ctx)
    toks, stats, wall = timed_generate(model, params, {
        "tokens": mx_prompts(model.cfg)}, ctx, steps=TP_F32_STEPS)
    out = (toks.cpu(), [lg.cpu() for lg in stats["logits"]], wall)
    del params, stats
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def first_attention():
    """While entered: the first attention block's output as block_seq
    adds it to the residual stream (the first call of models/
    transformer's ``leave_region``: layer 0's attention in a prefill),
    kept on the host with the call's ``seq`` (True: this rank's rows of
    the sequence)."""
    from types import SimpleNamespace

    from repro_torch.models import transformer
    fn = transformer.leave_region
    got = SimpleNamespace(out=None, seq=None)

    def hook(y, ctx, *, seq, local, **kw):
        out = fn(y, ctx, seq=seq, local=local, **kw)
        if got.out is None:
            got.out, got.seq = out.detach().cpu(), seq
        return out
    transformer.leave_region = hook
    try:
        yield got
    finally:
        transformer.leave_region = fn


def tp2_rank(rank: int, tmp: str) -> None:
    """One rank of the tp2 leg (spawned; two gloo ranks on cuda:0). Mesh
    (1, 2): the serving model drawn from MX_SEED as this rank's parts,
    a warm-up (its first attention block kept: :func:`first_attention`),
    then generate over the decode leg's prompts and steps between a
    reset and a read of the launch counts, under the collective clock,
    its kernels' first inputs kept by shape (rank 0's,
    :func:`first_inputs`); then its f32 twin (:func:`tp2_f32_serve`).
    Mesh (2, 1) in the same world: the training model drawn from
    TF_SEED (FSDP over data), one train step of TP2_BATCH x TF_SEQ
    tokens (TP2_MICROBATCH microbatches, each one's rows cut over data),
    timed under the clock, launches counted and kernel inputs kept; then every
    parameter part this rank holds after the step and its part of
    adamw's first moment (in bf16), with its cuts (rank 0 also the
    whole leaves)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.sharding import make_ctx, param_shards
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.mesh import make_mesh
    from repro_torch.utils.tree import leaves
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "tp2_store"), 2), rank=rank, world_size=2)
    try:
        out = {}
        serve, train = tp2_cfgs()
        ctx = make_ctx(make_mesh((1, 2), EP_AXES, backend="gloo"))
        params = init_params(serve, seed=MX_SEED, device="cuda", ctx=ctx)
        held = sum(a.numel() * a.element_size() for a in leaves(params))
        batch = {"tokens": mx_prompts(serve.cfg)}
        with first_attention() as attn:                       # warm-up
            timed_generate(serve, params, batch, ctx, steps=2)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with first_inputs(TP_SERVE_KERNELS, os.path.join(
                tmp, "tp2_serve_inputs.pt"), rank == 0), \
                CollectiveClock() as clock:
            toks, stats, wall = timed_generate(serve, params, batch, ctx,
                                               steps=MX_STEPS)
        out["serve"] = {
            "describe": ctx.mesh.describe(), "toks": toks.cpu(),
            "attn": attn.out, "attn_seq": attn.seq,
            "logits": [lg.cpu() for lg in stats["logits"]],
            "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "wall": wall, "clock": (clock.s, clock.n),
            "counts": ops.launch_counts(), "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, stats
        torch.cuda.empty_cache()
        out["serve"]["f32"] = tp2_f32_serve(ctx)

        ctx = make_ctx(make_mesh((2, 1), EP_AXES, backend="gloo"))
        cfg = train.cfg
        opt = build_optimizer(cfg.optimizer, TF_LR)
        params = init_params(train, seed=TF_SEED, device="cuda", ctx=ctx)
        held = sum(a.numel() * a.element_size() for a in leaves(params))
        shards = param_shards(params, cfg, ctx)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device="cuda"))
        batch = train_batches(TF_SEED, cfg.vocab_size, TP2_BATCH,
                              TF_SEQ + 1, 1, "cuda")[0]
        step = make_train_step(train, ctx, opt)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with first_inputs(TP_TRAIN_KERNELS, os.path.join(
                tmp, "tp2_train_inputs.pt"), rank == 0), \
                CollectiveClock() as clock:
            sync()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            sync()
            wall = time.perf_counter() - t0
        out["train"] = {
            "describe": ctx.mesh.describe(), "loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]), "wall": wall,
            "clock": (clock.s, clock.n), "counts": ops.launch_counts(),
            "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "digests": replicated_digests(state.params, shards),
            "cut": sum(sh is not None for sh in shards),
            "leaves": len(shards),
            "parts": {i: ([(c.axis, c.lo, c.hi) for c in sh.cuts]
                          if sh is not None else [], a.cpu(),
                          m.to(torch.bfloat16).cpu())
                      for i, (a, m, sh) in enumerate(zip(
                          leaves(state.params), leaves(state.opt["m"]),
                          shards))
                      if sh is not None or rank == 0}}
        del state, params
        torch.cuda.empty_cache()
        torch.save(out, os.path.join(tmp, f"tp2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp2_reference(device):
    """The single-device runs tp2 is held to, on the card: the serving
    model drawn whole from MX_SEED through generate (a warm-up, whose
    first attention block is kept, then tokens, logits, the parameters'
    bytes, the peak), its f32 twin (:func:`tp2_f32_serve`), then the
    training model's one step from TF_SEED's whole draw on tp2's batch
    (loss, grad norm, the parameters after it and adamw's first moment,
    the step's gradient scaled, in bf16 on the host, the parameters'
    bytes, the peak)."""
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    serve, train = tp2_cfgs()
    params = init_params(serve, seed=MX_SEED, device=device)
    held = sum(a.numel() * a.element_size() for a in leaves(params))
    batch = {"tokens": mx_prompts(serve.cfg)}
    with first_attention() as attn:                           # warm-up
        timed_generate(serve, params, batch, None, steps=2)
    sync()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    toks, stats, wall = timed_generate(serve, params, batch, None,
                                       steps=MX_STEPS)
    peak = torch.cuda.max_memory_allocated(device)
    out = {"toks": toks.cpu(), "logits": [lg.cpu() for lg in
                                          stats["logits"]],
           "attn": attn.out, "held_gb": held / 1e9, "wall": wall,
           "peak_gb": peak / 1e9, "over_gb": (peak - base) / 1e9}
    del params, stats
    torch.cuda.empty_cache()
    out["f32"] = tp2_f32_serve(None)
    cfg = train.cfg
    opt = build_optimizer(cfg.optimizer, TF_LR)
    params = init_params(train, seed=TF_SEED, device=device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    batch = train_batches(TF_SEED, cfg.vocab_size, TP2_BATCH, TF_SEQ + 1,
                          1, device)[0]
    torch.cuda.reset_peak_memory_stats(device)
    sync()
    t0 = time.perf_counter()
    state, met = make_train_step(train, None, opt)(state, batch)
    sync()
    out.update(train_wall=time.perf_counter() - t0,
               loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               train_held_gb=sum(a.numel() * a.element_size()
                                 for a in leaves(state.params)) / 1e9,
               train_peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               train_params=[a.cpu() for a in leaves(state.params)],
               train_m=[m.to(torch.bfloat16).cpu()
                        for m in leaves(state.opt["m"])])
    del state, params, batch
    torch.cuda.empty_cache()
    return out


def tp_kernel_checks(path: Path, rounds: int):
    """Each kernel's first inputs at every shape the tp2 ranks gave it
    (``path``, rank 0's): the kernel against its plain version on the
    card (swa_decode within 2e-2 of the largest output in bf16, 2e-5 in
    f32; moe_dispatch and moe_combine (top-2) and moe_dispatch_bwd bit
    for bit; moe_combine_bwd's dybuf bit for bit, its dgates within 1e-5
    of the largest), each timed (device time by graph replay, CUDA
    events over ``rounds`` calls) beside the plain version and its
    bound (:func:`tp_kernel_work`). Returns the lines' entries."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_combine_bwd as mcb
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import moe_dispatch_bwd as mdb
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_decode as sw
    first = torch.load(path, weights_only=False)
    out = []
    for key, args in first.items():
        name = key[0]
        a = tuple(t.cuda() if torch.is_tensor(t) else t for t in args)
        if name == "swa_decode":
            kern = lambda: sw.swa_decode_attention(*a)   # noqa: E731
            plain = lambda: ref.swa_decode_attention(*a)   # noqa: E731
            tol = 2e-2 if a[0].dtype == torch.bfloat16 else 2e-5
        elif name == "moe_dispatch":
            kern = lambda: md.moe_dispatch(*a)   # noqa: E731
            plain = lambda: ref.moe_dispatch(*a)   # noqa: E731
            tol = 0.0
        elif name == "moe_combine":
            kern = lambda: mc.moe_combine(*a)   # noqa: E731
            plain = lambda: ref.moe_combine(*a)   # noqa: E731
            tol = 0.0
        elif name == "moe_dispatch_bwd":
            dbuf, slot, keep, top_k = a
            kern = lambda: mdb.moe_dispatch_bwd(*a)   # noqa: E731
            plain = lambda: ref.moe_dispatch_bwd(   # noqa: E731
                dbuf, slot, keep, slot.numel() // top_k, top_k, dbuf.dtype)
            tol = 0.0
        else:
            kern = lambda: mcb.moe_combine_bwd(*a)   # noqa: E731
            plain = lambda: ref.moe_combine_bwd(*a)   # noqa: E731
            tol = None
        got, want = kern(), plain()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)]
        scale = [float(w.float().abs().max()) for w in want]
        if tol is None:       # dybuf exact, dgates within 1e-5
            ok = errs[0] == 0.0 and errs[1] <= 1e-5 * max(scale[1], 1e-30)
        else:
            ok = all(e <= tol * max(sc, 1e-30) for e, sc in zip(errs, scale))
        shape = ", ".join(f"{tuple(t.shape)}" for t in a
                          if torch.is_tensor(t))
        require(ok, f"tp kernels: {name} at ({shape}) differs from its "
                    f"plain version by {errs}")
        bms, by = bound(*tp_kernel_work(name, a))
        out.append(f"{name} ({shape}; {str(a[0].dtype).replace('torch.', '')})"
                   f": max |diff| {max(errs):.3e} from the plain version, "
                   f"device ms={graph_ms(kern):.4f} (graph replay), "
                   f"ms={time_ms(kern, rounds):.4f} "
                   f"plain_ms={time_ms(plain, rounds):.4f} "
                   f"bound_ms={bms:.5f} ({by})")
        del a, got, want
    return out


def tp_kernel_work(name: str, a) -> tuple:
    """(bytes, f32 operations) the call of kernel ``name`` on ``a`` needs,
    counted as the kernel lines of the other legs count them: each row
    a call reads once (only the rows its routing names), its small
    inputs and its outputs once."""
    if name == "swa_decode":
        q, kw, vw, bias = a[:4]
        b, h, dh = q.shape
        return (q.element_size() * (2 * q.numel() + kw.numel() + vw.numel())
                + 4 * bias.numel(), 4 * b * h * kw.shape[1] * dh)
    if name == "moe_dispatch":
        x, src, valid = a
        S, d = src.shape[0], x.shape[1]
        rows = int(torch.unique(src[valid]).numel())
        return x.element_size() * (rows + S) * d + 5 * S, 0
    if name == "moe_combine":
        return combine_work(a[0], a[1], a[3])
    if name == "moe_dispatch_bwd":
        dbuf, slot, keep, top_k = a
        N, d = slot.shape[0], dbuf.shape[1]
        kept = int(keep.sum())
        return (dbuf.element_size() * (kept + N // top_k) * d + 5 * N,
                kept * d)
    dout, ybuf, src_entry, valid, w, top_k = a
    S, d = ybuf.shape
    N, kept = w.shape[0], int(valid.sum())
    tokens = int(torch.unique(src_entry[valid] // top_k).numel())
    esz = ybuf.element_size()
    return (4 * tokens * d + esz * kept * d + 5 * S + 8 * N + esz * S * d,
            3 * kept * d)


def tp2_leg(device, smi: str, tmp: Path, train_peak: float):
    """Two gloo ranks on cuda:0 (collectives staged through the host),
    Mixtral-8x7B with its fsdp and seq_shard. Mesh (1, 2), at
    EPT2_LAYERS layers: tensor and sequence parallelism, the decode
    leg's prompts and steps at a dropless capacity factor; mesh (2, 1),
    at TP2_TRAIN_LAYERS (dropless, load-balance weight 0:
    :func:`tp2_cfgs`): FSDP and the batch cut over data, one train step.
    Held to the single-device runs of :func:`tp2_reference`: both
    ranks the same tokens and logits (bf16 and f32), and the same loss,
    grad norm and replicated leaves' bits; within TP_TOL of the
    single-device run's largest magnitude: the prefill's logits, the
    first layer's attention block as generate's prefill ran it (its
    rows put together from the ranks' sequence parts), the loss and the
    grad norm (relative) and every parameter part after the step (of the
    same slice of the single-device step's leaf); within TP_GRAD_TOL
    each part of adamw's first moment, (1 - b1) times the step's clipped
    gradient (after one step a parameter differs by at most about 2 lr
    where a gradient's sign flips, so the moment carries the check of
    the gradient's reductions); the f32 twin's tokens equal and its
    logits at every step within TP_F32_TOL of the largest; each rank's
    parameters below the single-device draw's bytes. The bf16 decode
    steps' logits against the single-device run are reported only:
    top-2 routing over the random router flips a token's experts where
    a bf16 rounding step moves its input, which then feeds other tokens
    back. The kernels at the ranks' shapes are held to their plain
    versions (:func:`tp_kernel_checks`). ``train_peak``: the one-rank
    train full leg's peak (ept1), for the line. Returns both ranks'
    launch counts."""
    import torch.multiprocessing as mp
    t_leg = time.perf_counter()
    ref = tp2_reference(device)
    print(f"card memory before the tp2 ranks: {ept_release()}", flush=True)
    t0 = time.perf_counter()
    mp.spawn(tp2_rank, args=(str(tmp),), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"tp2_rank{r}.pt", weights_only=False)
             for r in range(2)]
    a, b = ranks
    faults = []
    sa, sb = a["serve"], b["serve"]
    if not (torch.equal(sa["toks"], sb["toks"]) and all(
            torch.equal(x, y) for x, y in zip(sa["logits"], sb["logits"]))):
        faults.append("the ranks' tokens or logits differ")
    ta, tb = a["train"], b["train"]
    if (ta["loss"], ta["grad_norm"], ta["digests"]) != (
            tb["loss"], tb["grad_norm"], tb["digests"]):
        faults.append("the ranks' loss, grad norm or replicated leaves "
                      "differ")
    gap = logit_gap(sa["toks"], sa["logits"], ref["toks"], ref["logits"])
    if gap["pre"] > TP_TOL * gap["scale"]:
        faults.append(f"the prefill logits are {gap['pre']:.4g} off the "
                      f"single-device run's (tolerance {TP_TOL} x "
                      f"{gap['scale']:.4g})")
    if sa["attn_seq"]:
        attn = torch.cat([sa["attn"], sb["attn"]], dim=1)
    else:
        attn = sa["attn"]
        if not torch.equal(sa["attn"], sb["attn"]):
            faults.append("the ranks' attention blocks differ")
    ascale = float(ref["attn"].float().abs().max())
    aerr = (float((attn.float() - ref["attn"].float()).abs().max())
            if attn.shape == ref["attn"].shape else float("inf"))
    if aerr > TP_TOL * ascale:
        faults.append(f"the attention block {tuple(attn.shape)} is "
                      f"{aerr:.4g} off the single-device block's "
                      f"{tuple(ref['attn'].shape)} (tolerance {TP_TOL} x "
                      f"{ascale:.4g})")
    (ft, fl, fwall), (mt, ml, mwall) = ref["f32"], sa["f32"]
    if not (torch.equal(mt, sb["f32"][0]) and all(
            torch.equal(x, y) for x, y in zip(ml, sb["f32"][1]))):
        faults.append("the ranks' f32 tokens or logits differ")
    fscale = max(float(lg.abs().max()) for lg in fl)
    ferr = max(float((x - y).abs().max()) for x, y in zip(ml, fl))
    fequal = int((mt == ft).sum())
    if not (fequal == ft.numel() and ferr <= TP_F32_TOL * fscale):
        faults.append(f"the f32 twin: {fequal} of {ft.numel()} tokens "
                      f"equal, logits {ferr:.4g} off (tolerance "
                      f"{TP_F32_TOL} x {fscale:.4g})")
    perr = merr = 0.0
    for got in (ta, tb):
        for i, (cuts, part, m) in got["parts"].items():
            want, want_m = ref["train_params"][i], ref["train_m"][i]
            for axis, lo, hi in cuts:
                want = want.narrow(axis, lo, hi - lo)
                want_m = want_m.narrow(axis, lo, hi - lo)
            perr = max(perr, max_gap(part, want, device))
            merr = max(merr, max_gap(m, want_m, device))
    if perr > TP_TOL or merr > TP_GRAD_TOL:
        faults.append(f"a parameter part after the step is {perr:.4g}, and "
                      f"a part of adamw's first moment {merr:.4g}, of its "
                      f"slice's largest magnitude off the single-device "
                      f"step's (tolerances {TP_TOL}, {TP_GRAD_TOL})")
    lerr = abs(ta["loss"] - ref["loss"]) / abs(ref["loss"])
    gerr = abs(ta["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    if max(lerr, gerr) > TP_TOL:
        faults.append(f"the loss {ta['loss']:.6f} / grad norm "
                      f"{ta['grad_norm']:.6f} are {lerr:.3e} / {gerr:.3e} "
                      f"off the single-device {ref['loss']:.6f} / "
                      f"{ref['grad_norm']:.6f}")
    for r, got in enumerate(ranks):
        for part, whole in (("serve", ref["held_gb"]),
                            ("train", ref["train_held_gb"])):
            if not got[part]["held_gb"] < whole:
                faults.append(f"rank {r} {part}: {got[part]['held_gb']:.2f}"
                              f" GB held, not below {whole:.2f}")
    L, T, mb = EPT2_LAYERS, TP2_TRAIN_LAYERS, TP2_MICROBATCH
    want = {"serve": {"swa_decode": L * MX_STEPS,
                      "moe_dispatch": L * (MX_STEPS + 1),
                      "moe_combine": L * (MX_STEPS + 1)},
            "train": {"moe_dispatch": 2 * T * mb, "moe_combine": 2 * T * mb,
                      "moe_combine_bwd": T * mb,
                      "moe_dispatch_bwd": T * mb}}
    for r, got in enumerate(ranks):
        for part, w in want.items():
            if any(got[part]["counts"][k] != n for k, n in w.items()):
                faults.append(f"rank {r} {part}: launches "
                              f"{got[part]['counts']}, expected {w}")
    clocks = {}
    for part in ("serve", "train"):
        clocks[part] = CollectiveClock()
        clocks[part].s, clocks[part].n = a[part]["clock"]
    t1 = time.perf_counter()
    kern = tp_kernel_checks(tmp / "tp2_serve_inputs.pt", 20) \
        + tp_kernel_checks(tmp / "tp2_train_inputs.pt", 20)
    check_s = time.perf_counter() - t1
    counts = {k: sum(r[part]["counts"][k] for r in ranks
                     for part in ("serve", "train")) for k in
              sa["counts"]}
    print(f"tp2 serve: {sa['describe']} (two processes on cuda:0) ({smi}): "
          f"Mixtral-8x7B cut to {EPT2_LAYERS} of 32 layers, tensor and "
          f"sequence parallel (heads, expert hidden dim and vocab over "
          f"model, the residual cut on the sequence), dropless, "
          f"{MX_BATCH} x {MX_PROMPT} tokens and {MX_STEPS} steps; both "
          f"ranks the same tokens and logits; the first layer's attention "
          f"block in the prefill max |diff| {aerr:.4g} from the single-"
          f"device block's (tolerance {TP_TOL} x {ascale:.4g}); against "
          f"the single-device run (prefill held, steps reported): "
          + gap_line(gap, TP_TOL) + f"; f32 twin ({TP_F32_STEPS} steps "
          f"over the full ring): {fequal} of {ft.numel()} tokens equal, "
          f"logits max |diff| {ferr:.4g} (tolerance {TP_F32_TOL} x "
          f"{fscale:.4g}), wall {mwall:.3f} s (single device "
          f"{fwall:.3f} s); parameters "
          f"{sa['held_gb']:.2f} + {sb['held_gb']:.2f} GB a rank (single "
          f"device {ref['held_gb']:.2f} GB); peak {sa['peak_gb']:.2f} + "
          f"{sb['peak_gb']:.2f} GB (single device {ref['peak_gb']:.2f} GB, "
          f"{ref['over_gb']:.2f} GB over its parameters); prefill "
          f"{sa['prefill_s']:.3f} s, decode {sa['decode_s']:.3f} s, wall "
          f"{sa['wall']:.3f} s (single device {ref['wall']:.3f} s): "
          f"{clocks['serve'].share(sa['wall'])}; launches by rank "
          f"{json.dumps(sa['counts'])} {json.dumps(sb['counts'])}",
          flush=True)
    print(f"tp2 train: {ta['describe']} ({smi}): Mixtral-8x7B at "
          f"{TP2_TRAIN_LAYERS} layer (dropless, load-balance weight 0), "
          f"FSDP over data ({ta['cut']} of its "
          f"{ta['leaves']} leaves cut), one step of {TP2_BATCH} x {TF_SEQ} "
          f"tokens, microbatch {TP2_MICROBATCH} (each microbatch's "
          f"{TP2_BATCH // TP2_MICROBATCH} rows cut over data), "
          f"remat, adamw lr {TF_LR}: loss {ta['loss']:.6f}, grad norm "
          f"{ta['grad_norm']:.6f} (single device {ref['loss']:.6f}, "
          f"{ref['grad_norm']:.6f}: {lerr:.3e}, {gerr:.3e} off; tolerance "
          f"{TP_TOL}), both ranks the same bits and the same replicated "
          f"leaves; every parameter part after the step within {perr:.3e} "
          f"of its slice's largest magnitude of the single-device step's "
          f"(tolerance {TP_TOL}), and of adamw's first moment (the step's "
          f"gradient) within {merr:.3e} (tolerance {TP_GRAD_TOL}); "
          f"parameters "
          f"{ta['held_gb']:.2f} + "
          f"{tb['held_gb']:.2f} GB "
          f"a rank (single device {ref['train_held_gb']:.2f} GB); peak "
          f"{ta['peak_gb']:.2f} + {tb['peak_gb']:.2f} GB (single device "
          f"{ref['train_peak_gb']:.2f} GB, its step {ref['train_wall']:.3f}"
          f" s; the one-rank train full leg at 2 layers {train_peak:.2f} "
          f"GB); step wall {ta['wall']:.3f} s: "
          f"{clocks['train'].share(ta['wall'])}; "
          f"launches by rank {json.dumps(ta['counts'])} "
          f"{json.dumps(tb['counts'])}", flush=True)
    print(f"tp kernels ({smi}): at the tp2 ranks' shapes (rank 0's first "
          f"inputs a shape, checked on the card after the ranks exit, "
          f"{check_s:.1f} s): " + "; ".join(kern), flush=True)
    print(f"tp2: {spawn_s:.1f} s from spawn to join, leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    require(not faults, "tp2: " + "; ".join(faults))
    return counts


def card_memory() -> str:
    """What this process holds on the card: allocated and reserved."""
    return (f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def ept_release() -> str:
    """Free what this process caches on the card before ranks that share
    it start (the ept4 ranks need about 15 GB each); returns what it
    still holds."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return card_memory()


def ept_legs(device, smi: str):
    """The legs that train under a mesh: ept1, ept2 and ept4, then tp2
    (the dense layouts on two ranks). Returns their launch counts, by
    leg. The spawned ranks allocate with
    expandable segments, so that four of them leave little reserved and
    unused."""
    t_legs = time.perf_counter()
    print(f"card memory before the ept legs: {ept_release()}", flush=True)
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            ept1_counts, mx_ref, mx_peak = ept1_leg(device, smi, tmp)
            print(f"card memory before ept2: {ept_release()}", flush=True)
            ept2_counts = ept2_leg(mx_ref, smi, tmp)
            del mx_ref
            print(f"card memory before ept4: {ept_release()}", flush=True)
            ept4_counts = ept4_leg(device, smi, tmp)
            print(f"card memory before tp2: {ept_release()}", flush=True)
            tp2_counts = tp2_leg(device, smi, tmp, mx_peak)
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    print(f"legs: ept1, ept2, ept4, tp2 in {time.perf_counter() - t_legs:.1f}"
          f" s of wall ({smi})", flush=True)
    return {"ept1": ept1_counts, "ept2": ept2_counts, "ept4": ept4_counts,
            "tp2": tp2_counts}


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


# ------------------------------------------------------------ training --

def moe_bwd_inputs(dev, T, d, E, top_k, cf, dtype, seed=0):
    """A routing of T tokens of d among E experts by the model's own
    route and plan (models/moe.py), with random x, router, queue
    gradient dbuf, expert outputs ybuf and output gradient dout."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    m = dataclasses.replace(get_config("mixtral-8x7b").moe, n_experts=E,
                            top_k=top_k, capacity_factor=cf)
    g = torch.Generator(device=dev).manual_seed(seed + T + d + top_k)
    x = torch.randn(T, d, generator=g, device=dev).to(dtype)
    scale = 0.006 if d >= 1024 else 0.05
    router = (torch.randn(d, E, generator=g, device=dev) * scale).to(dtype)
    ids, gates, _ = moe._route(router, x, m)
    C = moe._capacity(T, m)
    src, valid, flat_e, pos_c, keep, src_entry = moe._plan(ids, m, C)
    S = E * C
    return dict(
        T=T, d=d, top_k=top_k, dtype=dtype, S=S, x=x, src=src, valid=valid,
        keep=keep, src_entry=src_entry, gates=gates.reshape(-1),
        slot=(flat_e * C + pos_c).to(torch.int32),
        w=torch.where(keep, gates.reshape(-1), 0.0).float(),
        dbuf=torch.randn(S, d, generator=g, device=dev).to(dtype),
        ybuf=torch.randn(S, d, generator=g, device=dev).to(dtype),
        dout=torch.randn(T, d, generator=g, device=dev))


def kernel_moe_grads(inp):
    """dx, dybuf and dgates through ops.moe_dispatch / ops.moe_combine
    given the routing (the kernels and their backward), with the
    launches of the two calls: (dx, dy, dg, counts)."""
    from repro_torch.kernels import ops
    top_k = inp["top_k"]
    xr = inp["x"].clone().requires_grad_(True)
    yr = inp["ybuf"].clone().requires_grad_(True)
    gr = inp["gates"].clone().requires_grad_(True)
    ops.reset_launch_counts()
    buf = ops.moe_dispatch(xr, inp["src"], inp["valid"], slot=inp["slot"],
                           keep=inp["keep"], top_k=top_k)
    dx, = torch.autograd.grad(buf, xr, inp["dbuf"])
    y = ops.moe_combine(yr, inp["slot"], torch.where(inp["keep"], gr, 0.0),
                        top_k, src_entry=inp["src_entry"],
                        valid=inp["valid"])
    dy, dg = torch.autograd.grad(y, (yr, gr), inp["dout"])
    sync()
    return dx, dy, dg, ops.launch_counts()


def check_moe_grads(inp) -> dict:
    """The kernels' gradients against the plain versions on the card
    and against f64: dx bit for bit with the plain formula (the f32 sum
    in j order, cast once: ref.moe_dispatch_bwd) for every top_k, with
    the plain autograd for top_k <= 2, and within one rounding to x's
    type (plus the f32 sum's own error) of the f64 sum; dybuf bit for bit
    with the plain autograd; dgates within 1e-6 of sum_c |dout * ybuf|
    of the f64 sum; two calls bit for bit; launches (1, 1, 1, 1): the
    dispatch's backward is the moe_dispatch_bwd kernel, no moe_combine.
    Returns the errors."""
    from repro_torch.kernels import ref
    T, top_k, dtype = inp["T"], inp["top_k"], inp["dtype"]
    dx, dy, dg, counts = kernel_moe_grads(inp)
    dx2, dy2, dg2, _ = kernel_moe_grads(inp)
    label = (f"({inp['S']},{inp['d']}) {str(dtype).replace('torch.', '')} "
             f"top_k={top_k}")
    require((counts["moe_dispatch"], counts["moe_combine"],
             counts["moe_combine_bwd"], counts["moe_dispatch_bwd"])
            == (1, 1, 1, 1), f"train kernels {label}: launches {counts}")
    require(same_bits((dx.float(), dy.float(), dg),
                      (dx2.float(), dy2.float(), dg2)),
            f"train kernels {label}: two calls differ")
    xr = inp["x"].clone().requires_grad_(True)
    want_dx, = torch.autograd.grad(
        ref.moe_dispatch(xr, inp["src"], inp["valid"]), xr, inp["dbuf"])
    require(torch.equal(dx, ref.moe_dispatch_bwd(
        inp["dbuf"], inp["slot"], inp["keep"], T, top_k, dtype)),
        f"train kernels {label}: dx differs from the plain formula")
    exact = ref.moe_dispatch_bwd(inp["dbuf"].double(), inp["slot"],
                                 inp["keep"], T, top_k)
    terms = ref.sequential_combine(inp["dbuf"].double().abs(), inp["slot"],
                                   inp["keep"].double(), top_k)
    unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    require(bool(((dx.double() - exact).abs()
                  <= unit * exact.abs() + top_k * 2.0 ** -24 * terms).all()),
            f"train kernels {label}: dx beyond one rounding of the f64 sum")
    dx_err = float((dx.float() - want_dx.float()).abs().max())
    if top_k <= 2:
        require(torch.equal(dx, want_dx),
                f"train kernels {label}: dx differs from the plain autograd")
    yr = inp["ybuf"].clone().requires_grad_(True)
    gr = inp["gates"].clone().requires_grad_(True)
    want_dy, want_dg = torch.autograd.grad(
        ref.moe_combine(yr, inp["slot"], torch.where(inp["keep"], gr, 0.0),
                        top_k), (yr, gr), inp["dout"])
    require(torch.equal(dy, want_dy),
            f"train kernels {label}: dybuf differs from the plain autograd")
    args = (inp["src_entry"], inp["valid"], inp["w"].double(), top_k)
    exact_dg = ref.moe_combine_bwd(inp["dout"].double(),
                                   inp["ybuf"].double(), *args)[1]
    terms = ref.moe_combine_bwd(inp["dout"].double().abs(),
                                inp["ybuf"].double().abs(), *args)[1]
    ratio = float(((dg.double() - exact_dg).abs()
                   / (1e-6 * terms + 1e-30)).max())
    require(ratio <= 1.0, f"train kernels {label}: dgates beyond 1e-6 of "
                          f"its terms (x{ratio:.3f})")
    require(bool((dg[~inp["keep"]] == 0).all()),
            f"train kernels {label}: a dropped entry's gate gradient")
    return dict(label=label, dx_err=dx_err,
                dg_err=float((dg - want_dg).abs().max()), dg_ratio=ratio)


def check_dispatch_bwd(inp) -> None:
    """The moe_dispatch_bwd kernel alone on the routing ``inp``: bit for
    bit to the plain version (ref.moe_dispatch_bwd), two calls the same
    bits, and the old route's bits (moe_combine with the keep mask as
    0/1 gates, then the cast) on these finite inputs; then with token
    0's every entry dropped and a row of +-inf at its first entry's
    clamped slot (another token's): the plain version's bits again,
    token 0's dx exactly 0."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_dispatch_bwd as mdb
    from repro_torch.kernels import ref
    T, top_k, dtype = inp["T"], inp["top_k"], inp["dtype"]
    dbuf, slot, keep = inp["dbuf"], inp["slot"], inp["keep"]
    label = (f"({inp['S']},{inp['d']}) {str(dtype).replace('torch.', '')} "
             f"top_k={top_k}")
    got = mdb.moe_dispatch_bwd(dbuf, slot, keep, top_k)
    again = mdb.moe_dispatch_bwd(dbuf, slot, keep, top_k)
    want = ref.moe_dispatch_bwd(dbuf, slot, keep, T, top_k, dtype)
    old = mc.moe_combine(dbuf, slot, keep.float(), top_k).to(dtype)
    sync()
    require(all(same_bits((got.float(),), (o.float(),))
                for o in (want, again, old)),
            f"dispatch backward {label}: the kernel differs from the plain "
            f"version, from itself or from the old route")
    del got, again, want, old
    drop = keep.clone()
    drop[:top_k] = False
    dinf = dbuf.clone()
    dinf[int(slot[0])] = float("inf")
    dinf[int(slot[0]), ::2] = -float("inf")
    got = mdb.moe_dispatch_bwd(dinf, slot, drop, top_k)
    want = ref.moe_dispatch_bwd(dinf, slot, drop, T, top_k, dtype)
    sync()
    require(same_bits((got.float(),), (want.float(),))
            and bool((got[0] == 0).all()),
            f"dispatch backward {label}: a token all dropped beside a row "
            f"of inf differs from the plain version")


def train_kernels(dev, rounds: int):
    """The MoE layer's backward on the card: moe_dispatch's (the
    moe_dispatch_bwd kernel) and moe_combine's (the moe_combine_bwd
    kernel), at the full-width train leg's routing and at TK_SHAPES,
    checked by check_moe_grads and check_dispatch_bwd; at the full width
    each timed (CUDA events over ``rounds`` calls; device time by graph
    replay) beside the plain formulas (kernels/ref.py), one library call
    each (index_add_ for dx; torch.gather + mul + sum for the
    combine's), the bounds and, for dx, the old route (moe_combine with
    0/1 gates, then the cast), timed as a yardstick only. Returns the
    kernels line's rows of moe_combine_bwd and moe_dispatch_bwd."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_combine_bwd as mcb
    from repro_torch.kernels import moe_dispatch_bwd as mdb
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x7b")
    m = cfg.moe
    T = TF_SEQ * TF_BATCH // cfg.microbatch        # tokens a microbatch
    full = moe_bwd_inputs(dev, T, cfg.d_model, m.n_experts, m.top_k,
                          m.capacity_factor, torch.bfloat16)
    require(full["S"] == m.n_experts * moe._capacity(T, m),
            "train kernels: the full-width routing's slots")
    checks = [check_moe_grads(full)]
    check_dispatch_bwd(full)
    for T_, d_, E_, k_, cf_, dt_ in TK_SHAPES:
        small = moe_bwd_inputs(dev, T_, d_, E_, k_, cf_, dt_)
        checks.append(check_moe_grads(small))
        check_dispatch_bwd(small)
    for c in checks:
        print(f"train kernels {c['label']}: two calls bitwise equal, "
              f"launches 1/1/1/1, moe_dispatch_bwd alone bitwise equal to "
              f"the plain version and the old route (and beside a token "
              f"all dropped and a row of inf); dx max_abs_err="
              f"{c['dx_err']:.3e} against "
              f"the plain autograd, dybuf bitwise, dgates "
              f"max_abs_err={c['dg_err']:.3e} (x{c['dg_ratio']:.4f} of the "
              f"1e-6 tolerance against f64)", flush=True)

    f = full
    S, d, top_k, dtype = f["S"], f["d"], f["top_k"], f["dtype"]
    esz = f["dbuf"].element_size()
    valid, keep = f["valid"], f["keep"]
    nvalid = int(valid.sum())
    N = T * top_k
    # Dispatch backward: the moe_dispatch_bwd kernel; the old route (the
    # combine of dbuf with keep as 0/1 gates, then the cast) is timed in
    # turns with it, as a yardstick only.
    keepf = keep.float()

    def dx_fn():
        return ops._dispatch_bwd(f["dbuf"], f["slot"], keep, T, top_k, dtype)

    def old_fn():
        return mc.moe_combine(f["dbuf"], f["slot"], keepf, top_k).to(dtype)
    ms = time_ms(dx_fn, rounds)
    old_ms = time_ms(old_fn, rounds)
    plain = time_ms(lambda: ref.moe_dispatch_bwd(f["dbuf"], f["slot"], keep,
                                                 T, top_k, dtype), rounds)
    # The library's dx: index_add_ of every slot's row into its token's,
    # the invalid slots into a spare row T.
    idx = torch.where(valid, f["src"], T).long()

    def lib_fn():
        return torch.zeros((T + 1, d), dtype=dtype, device=dev).index_add_(
            0, idx, f["dbuf"])
    lib = time_ms(lib_fn, rounds)
    dev_ms, dev_old, dev_old2, dev_ms2 = (graph_ms(fn) for fn in (
        dx_fn, old_fn, old_fn, dx_fn))
    kern_old = graph_ms(lambda: mc.moe_combine(f["dbuf"], f["slot"], keepf,
                                               top_k))
    dev_lib = graph_ms(lib_fn)
    got = dx_fn()
    want = ref.moe_dispatch_bwd(f["dbuf"], f["slot"], keep, T, top_k, dtype)
    sync()
    err_x = float((got.float() - want.float()).abs().max())
    del got, want
    nbytes = esz * (nvalid * d + T * d) + 5 * N
    bms, by = bound(nbytes, nvalid * d)
    print(f"train kernels dispatch backward ({S},{d}) bf16 -> ({T},{d}) "
          f"top_k={top_k}, {nvalid} valid slots, {int(keep.sum())} of {N} "
          f"entries kept, moe_dispatch_bwd ("
          f"{mdb.plan(T, d, top_k, dtype, dev).describe()}): "
          f"max_abs_err={err_x:.3e} | ms={ms:.4f} old_route_ms={old_ms:.4f} "
          f"plain_ms={plain:.4f} index_add_ms={lib:.4f} bound_ms={bms:.5f} "
          f"({by}, {nbytes} bytes) | device time by CUDA graph replay, in "
          f"turns: ms={dev_ms:.4f} / {dev_ms2:.4f}, old route "
          f"{dev_old:.4f} / {dev_old2:.4f} (its moe_combine kernel "
          f"{kern_old:.4f}, the rest the cast), index_add_ms={dev_lib:.4f}",
          flush=True)
    row_x = dict(max_abs_err=err_x, ms=ms, plain_ms=plain, bound_ms=bms,
                 bound_by=by, library_ms=lib, device_ms=dev_ms)
    # Combine backward: the moe_combine_bwd kernel.
    def bwd_fn():
        return mcb.moe_combine_bwd(f["dout"], f["ybuf"], f["src_entry"],
                                   valid, f["w"], top_k)
    ms_c = time_ms(bwd_fn, rounds)
    plain_c = time_ms(lambda: ref.moe_combine_bwd(
        f["dout"], f["ybuf"], f["src_entry"], valid, f["w"], top_k), rounds)
    owner = torch.where(valid, f["src_entry"].long(), 0)
    gidx = (owner // top_k)[:, None].expand(S, d)
    wv = torch.where(valid, f["w"][owner], 0.0)[:, None]

    def lib_c():
        rows = torch.gather(f["dout"], 0, gidx)
        return (rows * wv).to(dtype), torch.sum(rows * f["ybuf"], dim=-1)
    lib_ms_c = time_ms(lib_c, rounds)
    dev_c = graph_ms(bwd_fn)
    dev_lib_c = graph_ms(lib_c)
    tokens = int(torch.unique(owner[valid] // top_k).numel())
    nbytes_c = (4 * tokens * d + esz * nvalid * d + 5 * S + 4 * N
                + esz * S * d + 4 * N)
    bms_c, by_c = bound(nbytes_c, 3 * nvalid * d)
    got_dy, got_dg = bwd_fn()
    want_dy, want_dg = ref.moe_combine_bwd(f["dout"], f["ybuf"],
                                           f["src_entry"], valid, f["w"],
                                           top_k)
    sync()
    err = max(float((got_dy.float() - want_dy.float()).abs().max()),
              float((got_dg - want_dg).abs().max()))
    print(f"train kernels combine backward dout ({T},{d}) f32, ybuf "
          f"({S},{d}) bf16, {nvalid} valid slots of {tokens} tokens: "
          f"max_abs_err={err:.3e} against the plain formula | "
          f"ms={ms_c:.4f} plain_ms={plain_c:.4f} "
          f"gather_mul_sum_ms={lib_ms_c:.4f} bound_ms={bms_c:.5f} ({by_c}, "
          f"{nbytes_c} bytes) | device time by CUDA graph replay: "
          f"ms={dev_c:.4f} gather_mul_sum_ms={dev_lib_c:.4f}", flush=True)
    return {"moe_combine_bwd": dict(
        max_abs_err=max([err] + [c["dg_err"] for c in checks]), ms=ms_c,
        plain_ms=plain_c, bound_ms=bms_c, bound_by=by_c, library_ms=lib_ms_c,
        device_ms=dev_c), "moe_dispatch_bwd": row_x}


def train_batches(seed: int, vocab: int, B: int, S: int, steps: int,
                  device):
    from repro_torch.data.lm_stream import synthetic_batches
    return [{k: torch.as_tensor(v).to(device) for k, v in b.items()}
            for b in synthetic_batches(seed, vocab, B, S, steps)]


def small_train_agreement(device):
    """TS_CONFIGS reduced, f32, microbatch TS_MB: TS_STEPS steps of
    make_train_step on ``device`` and on the CPU from one state, carried
    by convert.train_state; loss and grad norm within 1e-5 relative,
    parameters within 1e-5 of each leaf's largest magnitude plus 1e-6
    (adamw at eps 1e-4: tests/test_torch_train.py). Returns {config:
    (largest loss error, largest parameter error)}."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    out = {}
    for name in TS_CONFIGS:
        cfg = get_config(name, reduced=True).replace(dtype="float32",
                                                     microbatch=TS_MB)
        model = build_model(cfg)
        opt = build_optimizer("adamw", 1e-3, eps=1e-4)
        params = init_params(model, seed=0, device="cpu")
        np_state = (tree_map(lambda a: a.numpy(), params),
                    tree_map(lambda a: a.numpy(), opt.init(params)),
                    np.int32(0))
        step = make_train_step(model, None, opt)
        states = {dev: convert.train_state(np_state, dev)
                  for dev in (device, torch.device("cpu"))}
        lerr = perr = 0.0
        for b in train_batches(1, cfg.vocab_size, TS_BATCH, TS_SEQ + 1,
                               TS_STEPS, "cpu"):
            mets = {}
            for dev in states:
                states[dev], mets[dev] = step(
                    states[dev], {k: v.to(dev) for k, v in b.items()})
            got, want = mets[device], mets[torch.device("cpu")]
            for key in ("loss", "grad_norm"):
                e = abs(float(got[key]) - float(want[key]))
                require(e <= 1e-5 * abs(float(want[key])),
                        f"train small {name}: {key} differs from the CPU "
                        f"by {e}")
                lerr = max(lerr, e)
            for a, w in zip(leaves(states[device].params),
                            leaves(states[torch.device("cpu")].params)):
                e = float((a.cpu() - w).abs().max())
                require(e <= 1e-5 * float(w.abs().max()) + 1e-6,
                        f"train small {name}: parameters differ by {e}")
                perr = max(perr, e)
        require(int(states[device].step) == TS_STEPS,
                f"train small {name}: step")
        out[name] = (lerr, perr)
    return out


def train_profile(label: str, fn, wall_s: float) -> None:
    """Runs ``fn`` (one train step) once under torch.profiler and prints
    its device time split: bf16 GEMMs (projections, experts, unembed),
    f32 GEMMs (the attention's scores and weighted sums), the port's MoE
    kernels by name and split into forward (moe_dispatch, moe_combine)
    and backward (moe_combine_bwd, moe_dispatch_bwd), the
    optimizer and the clip (the kernels inside the device-side spans of
    their record_function ranges in launch/train.py; "not measured"
    without those spans), and the rest (elementwise work, softmax,
    norms, casts, the embedding's scatter)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    # The kernels' own times; the ranges' GPU-side spans are left out.
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and not e.key.startswith("train_step/")]
    total = sum(e.self_device_time_total for e in dev) / 1e3
    if not total:
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)", flush=True)
        return
    # A range's device time: the kernels that run inside its device-side
    # span (the GPU user annotation of its record_function). The host
    # range's device_time_total would count that span as one of its own
    # kernels beside the kernels inside it.
    spans = {}
    for e in prof.events():
        if e.name.startswith("train_step/") and str(
                e.device_type).endswith("CUDA"):
            spans.setdefault(e.name, []).append((e.time_range.start,
                                                 e.time_range.end))
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
               and not e.name.startswith("train_step/")]
    ranges = {name: sum(k.time_range.elapsed_us() for k in kernels
                        if any(a <= k.time_range.start and k.time_range.end
                               <= b for a, b in sp)) / 1e3
              for name, sp in spans.items()}
    # cuBLAS's GEMM kernels by name: Hopper's tensor-core kernels
    # (nvjet, xmma, cutlass) take the bf16 products; the f32 ones (TF32
    # off) are the SIMT / f32f32 kernels.
    gemm = re.compile(r"gemm|xmma|cutlass|wgmma|nvjet", re.I)
    simt = re.compile(r"sgemm|f32f32|simt", re.I)
    bf16 = sum(e.self_device_time_total for e in dev
               if gemm.search(e.key) and not simt.search(e.key)) / 1e3
    f32 = sum(e.self_device_time_total for e in dev
              if gemm.search(e.key) and simt.search(e.key)) / 1e3
    port = {}
    for e in dev:
        hit = re.search(r"moe_(dispatch_bwd|dispatch|combine_bwd|combine)"
                        r"_kernel", e.key)
        if hit and "repro_torch" in e.key:
            ms, n = port.get(hit.group(0), (0.0, 0))
            port[hit.group(0)] = (ms + e.self_device_time_total / 1e3,
                                  n + e.count)
    if not ranges:
        print(f"profile {label}: no device-side spans of the optimizer and "
              f"clip ranges (their split not measured)", flush=True)
    opt = ranges.get("train_step/optimizer", 0.0)
    clip = ranges.get("train_step/clip", 0.0)
    ours = sum(ms for ms, _ in port.values())
    rest = total - bf16 - f32 - ours - opt - clip
    parts = "; ".join(f"{k} {ms:.3f} ms x{n} ({1e3 * ms / n:.1f} us each)"
                      for k, (ms, n) in sorted(port.items()))
    # Forward (and remat): the dispatch and the combine; backward: the
    # two backward kernels.
    fwd = sum(port.get(f"moe_{k}_kernel", (0.0, 0))[0]
              for k in ("dispatch", "combine"))
    bwd = sum(port.get(f"moe_{k}_kernel", (0.0, 0))[0]
              for k in ("dispatch_bwd", "combine_bwd"))
    parts += f"; forward {fwd:.3f} ms, backward {bwd:.3f} ms"

    def pct(v):
        return f"{v:.2f} ms ({100 * v / total:.1f}%)"
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    tops = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} "
                     f"ms x{e.count}" for e in top)
    print(f"profile {label}: device time {total:.2f} ms of "
          f"{wall_s * 1e3:.1f} ms unprofiled wall (busy "
          f"{100 * total / (wall_s * 1e3):.1f}%): bf16 GEMMs {pct(bf16)}, "
          f"f32 GEMMs (attention) {pct(f32)}, port MoE kernels "
          f"{pct(ours)} [{parts}], optimizer {pct(opt)}, clip {pct(clip)}, "
          f"the rest {pct(rest)} | top kernels: {tops}", flush=True)


def train_full_leg(device):
    """Training at Mixtral-8x7B's full width, TF_LAYERS of 32 layers,
    with the config's remat, microbatch and adamw (launch.train): a
    warm-up step, then TF_STEPS timed steps between a reset and a read
    of the launch counts, then one more step under the profiler.
    Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import param_count, tree_bytes
    t_leg = time.perf_counter()
    full = get_config("mixtral-8x7b")
    cfg = full.replace(n_layers=TF_LAYERS)
    require(cfg.remat and cfg.microbatch == 4 and cfg.optimizer == "adamw",
            "train full: the config's remat, microbatch and optimizer")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=TF_SEED, device=device)
    opt = build_optimizer(cfg.optimizer, TF_LR)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    sync()
    init_s = time.perf_counter() - t0
    nparam, pbytes = param_count(params), tree_bytes(params)
    step = make_train_step(model, None, opt)
    batches = train_batches(TF_SEED, cfg.vocab_size, TF_BATCH, TF_SEQ + 1,
                            TF_WARM + TF_STEPS + 1, device)
    for b in batches[:TF_WARM]:
        state, _ = step(state, b)
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    walls, losses, gnorms = [], [], []
    for b in batches[TF_WARM:TF_WARM + TF_STEPS]:
        t0 = time.perf_counter()
        state, met = step(state, b)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    require(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
            f"train full: loss {losses}, grad norm {gnorms} not finite")
    require(int(state.step) == TF_WARM + TF_STEPS, "train full: step")
    mb, L = cfg.microbatch, TF_LAYERS
    # Per step and MoE layer, per microbatch: the forward and its remat
    # recompute each dispatch and combine once; the backward launches
    # moe_dispatch_bwd and moe_combine_bwd once.
    want = {"moe_dispatch": 2 * L * mb * TF_STEPS,
            "moe_combine": 2 * L * mb * TF_STEPS,
            "moe_combine_bwd": L * mb * TF_STEPS,
            "moe_dispatch_bwd": L * mb * TF_STEPS}
    require(all(counts[k] == n for k, n in want.items()),
            f"train full: launches {counts}, expected {want}")
    wall = float(np.median(walls))
    tokens = TF_BATCH * TF_SEQ
    # Bound: the products of a step, counting only the routed queue
    # slots the experts compute (E * C a microbatch); bf16 on the tensor
    # cores, the attention's scores and weighted sums in f32. A layer's
    # forward runs twice (remat) and its backward costs two forwards; the
    # unembedding's forward once.
    d, H, KVH, hd, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.vocab_size)
    m = cfg.moe
    Tm = tokens // mb
    slots = m.n_experts * moe._capacity(Tm, m)
    layer_bf16 = (2 * Tm * d * (2 * H + 2 * KVH) * hd + 2 * Tm * d
                  * m.n_experts + 2 * slots * 3 * d * m.d_expert)
    pairs = sum(min(i + 1, cfg.sliding_window) for i in range(TF_SEQ))
    layer_f32 = 4 * (Tm // TF_SEQ) * H * hd * pairs
    bf16_flops = mb * (4 * L * layer_bf16 + 3 * 2 * Tm * d * V)
    f32_flops = mb * 4 * L * layer_f32
    bound_s = compute_s(bf16_flops, f32_flops)
    META.submit("train full", cfg, batches[0], bf16_flops, f32_flops,
               train=True)
    per_step = {k: counts[k] // TF_STEPS for k in want}
    print(f"train full: Mixtral-8x7B (d={d}, {H} heads / {KVH} kv heads of "
          f"{hd}, {m.n_experts} experts top-{m.top_k} of {m.d_expert}, "
          f"vocab {V}, bf16) cut to {L} of {full.n_layers} layers "
          f"({nparam / 1e9:.3f} B parameters, {pbytes / 1e9:.2f} GB, drawn "
          f"on the card with adamw's state in {init_s:.2f} s), remat, "
          f"microbatch {mb}, adamw lr {TF_LR}: batches of {TF_BATCH} x "
          f"{TF_SEQ} tokens | steps "
          + ", ".join(f"{w:.3f}" for w in walls)
          + f" s ({tokens / wall:.1f} tokens/s at the median; bound "
          f"{bound_s:.3f} s a step: {bf16_flops:.3e} bf16 + {f32_flops:.3e}"
          f" f32 flops) | loss " + ", ".join(f"{v:.4f}" for v in losses)
          + " | grad norm " + ", ".join(f"{v:.4f}" for v in gnorms)
          + f" | peak memory {peak_gb:.2f} GB | launches a step "
          f"{json.dumps(per_step)} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    train_profile("train full", lambda: step(state, batches[-1]), wall)
    del state, params, batches
    torch.cuda.empty_cache()
    return counts


def train_example_leg(device):
    """examples/train_lm.py on the card: reduced granite-3-2b trained by
    launch.train.train_loop for TE_STEPS adamw steps at TE_LR on the
    synthetic stream, then 8 tokens generated for 4 prompts; the last
    logged loss must be below the first. Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_stream import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import build_model
    cfg = get_config("granite-3-2b", reduced=True).replace(microbatch=1)
    model = build_model(cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = train_loop(
        model, synthetic_batches(0, cfg.vocab_size, TE_BATCH, TE_SEQ,
                                 TE_STEPS),
        steps=TE_STEPS, lr=TE_LR, log_every=TE_LOG, device=device)
    sync()
    wall = time.perf_counter() - t0
    require(history[-1][1] < history[0][1],
            f"train example: the loss did not fall ({history})")
    prompt = {"tokens": torch.arange(16, dtype=torch.int32)[None].repeat(
        4, 1)}
    out = generate(model, state.params, prompt, steps=8)
    require(tuple(out.shape) == (4, 8), "train example: generated tokens")
    print(f"train example: reduced {cfg.name} ({cfg.n_layers} layers, "
          f"d={cfg.d_model}, vocab {cfg.vocab_size}), {TE_STEPS} adamw "
          f"steps at lr {TE_LR} on batches of {TE_BATCH} x {TE_SEQ - 1} "
          f"tokens in {wall:.2f} s ({TE_STEPS / wall:.1f} steps/s) | loss "
          + ", ".join(f"{s}: {v:.4f}" for s, v in history)
          + f" | generated {out.tolist()[0]} (first of 4)", flush=True)
    return ops.launch_counts()


def train_legs(device, rounds: int):
    """The train legs in order: the backward kernels, the small
    agreement, the full-width leg and the example. Returns (the
    moe_combine_bwd and moe_dispatch_bwd rows of the kernels line by
    name, the full leg's counts, the example's counts)."""
    t_legs = time.perf_counter()
    rows = train_kernels(device, rounds)
    errs = small_train_agreement(device)
    print("reference: reduced " + " and ".join(errs) + f" (f32, microbatch "
          f"{TS_MB}), {TS_STEPS} steps of make_train_step on the card equal "
          f"the CPU's from one state (loss and grad norm within 1e-5 "
          f"relative, parameters within 1e-5 of a leaf's largest magnitude "
          f"+ 1e-6; largest errors "
          + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items())
          + ")", flush=True)
    full_counts = train_full_leg(device)
    example_counts = train_example_leg(device)
    print(f"legs: train kernels, train small, train full, train example in "
          f"{time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    return rows, full_counts, example_counts


def ds_config(layers: int, dense: int, **kw):
    """DeepSeek-V3 at its published widths, cut to ``layers`` layers of
    which the first ``dense`` are dense."""
    from repro_torch.configs import get_config
    full = get_config("deepseek-v3-671b")
    return full, full.replace(n_layers=layers, n_dense_layers=dense, **kw)


def mla_layer_flops(cfg, T: int) -> int:
    """bf16 flops of one MLA layer's projections over T tokens (the
    latent up-projected to every token's keys and values)."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return 2 * T * (d * m.q_lora_rank + m.q_lora_rank * H * qk
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_dim)
                    + H * m.v_dim * d)


def ffn_flops(cfg, T: int, moe_layer: bool, kept: int = 0) -> int:
    """bf16 flops of a layer's FFN over T tokens: the dense SwiGLU, or
    the router, the ``kept`` routed (token, expert) pairs and the shared
    expert."""
    d = cfg.d_model
    if not moe_layer:
        return 2 * T * 3 * d * cfg.d_ff
    m = cfg.moe
    return (2 * T * d * m.n_experts + 2 * kept * 3 * d * m.d_expert
            + 2 * T * 3 * d * m.n_shared * m.d_expert)


def attention_f32_flops(cfg, B: int, S: int) -> int:
    """f32 flops of one layer's causal attention (scores and weighted
    sums) over B sequences of S tokens."""
    m = cfg.mla
    pairs = S * (S + 1) // 2
    return 2 * B * cfg.n_heads * pairs * (m.qk_nope_dim + m.qk_rope_dim
                                          + m.v_dim)


def deepseek_kernels(dev, rounds: int) -> None:
    """The MoE kernels at DeepSeek-V3's full-width routings (d=7168 bf16,
    256 experts at top-8, capacity factor 1.25) of the serve leg's
    prefill (16384 tokens, C=640) and decode step (4 tokens, C=1) and of
    the train leg (4096 tokens, C=160), each routing by the model's own
    _route and _plan from a router at the init's scale: moe_dispatch bit
    for bit with its plain version; moe_combine bit for bit with the
    sequential sum (ref.sequential_combine, choices in order) and within
    1e-6 of the terms' magnitudes of the plain version (torch.sum over
    the 8 choices); at the train routing both backward paths by
    check_moe_grads and the dispatch's backward kernel alone by
    check_dispatch_bwd. Device times by graph replay beside the plain
    versions (event time), one library call each (embedding_bag;
    index_add_ for dx; gather + mul + sum for the combine's backward),
    the bounds and, for dx, the old route (moe_combine with 0/1 gates,
    then the cast), timed in turns with the kernel as a yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe_combine import moe_combine
    from repro_torch.kernels.moe_combine_bwd import moe_combine_bwd
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    _, cfg = ds_config(DS_LAYERS, DS_DENSE)
    m, d = cfg.moe, cfg.d_model
    for label, T in (("serve prefill", DS_BATCH * DS_PROMPT),
                     ("serve decode", DS_BATCH),
                     ("train", DST_BATCH * DST_SEQ)):
        f = moe_bwd_inputs(dev, T, d, m.n_experts, m.top_k,
                           m.capacity_factor, torch.bfloat16)
        x, src, valid, slot, w = f["x"], f["src"], f["valid"], f["slot"], \
            f["w"]
        S, N, top_k, esz = f["S"], T * m.top_k, m.top_k, 2
        C = S // m.n_experts
        got, want = moe_dispatch(x, src, valid), ref.moe_dispatch(x, src,
                                                                  valid)
        sync()
        require(torch.equal(got, want), f"deepseek kernels {label}: "
                                        f"moe_dispatch differs from the plain "
                                        f"version")
        del got, want
        nvalid = int(valid.sum())
        dev_ms = graph_ms(lambda: moe_dispatch(x, src, valid))
        plain = time_ms(lambda: ref.moe_dispatch(x, src, valid), rounds)
        idx = torch.clamp(src, 0, T - 1).long().view(-1, 1)
        wv = valid.to(x.dtype).view(-1, 1)
        lib = graph_ms(lambda: F.embedding_bag(idx, x, per_sample_weights=wv,
                                               mode="sum"))
        nbytes = esz * (int(torch.unique(src[valid]).numel()) * d + S * d) \
            + 5 * S
        bms, by = bound(nbytes, 0)
        print(f"deepseek kernels moe_dispatch {label}: x ({T},{d}) bf16 -> "
              f"({S},{d}) = {m.n_experts} experts x C={C}, {nvalid} valid "
              f"slots; bitwise equal to the plain version | device "
              f"ms={dev_ms:.4f} plain_ms={plain:.4f} embedding_bag device "
              f"ms={lib:.4f} bound_ms={bms:.5f} ({by}, {nbytes} bytes)",
              flush=True)

        ybuf = f["ybuf"]
        got = moe_combine(ybuf, slot, w, top_k)
        again = moe_combine(ybuf, slot, w, top_k)
        seq = ref.sequential_combine(ybuf, slot, w, top_k)
        plain_out = ref.moe_combine(ybuf, slot, w, top_k)
        terms = ref.sequential_combine(ybuf.abs(), slot, w.abs(), top_k)
        sync()
        bitwise = same_bits((got,), (seq,)) and same_bits((got,), (again,))
        ratio = float(((got - plain_out).abs()
                       / (1e-6 * terms + 1e-30)).max())
        err = float((got - plain_out).abs().max())
        require(bitwise, f"deepseek kernels {label}: moe_combine differs "
                         f"from the sequential sum or between two calls")
        require(ratio <= 1.0, f"deepseek kernels {label}: moe_combine beyond "
                              f"1e-6 of its terms of the plain version "
                              f"(x{ratio:.3f})")
        del got, again, seq, plain_out, terms
        dev_c = graph_ms(lambda: moe_combine(ybuf, slot, w, top_k))
        plain_c = time_ms(lambda: ref.moe_combine(ybuf, slot, w, top_k),
                          rounds)
        cidx = torch.clamp(slot, 0, S - 1).long().view(T, top_k)
        cw = w.to(ybuf.dtype).view(T, top_k)
        lib_c = graph_ms(lambda: F.embedding_bag(
            cidx, ybuf, per_sample_weights=cw, mode="sum"))
        nbytes_c, flops_c = combine_work(ybuf, slot, top_k)
        bms_c, by_c = bound(nbytes_c, flops_c)
        print(f"deepseek kernels moe_combine {label}: ybuf ({S},{d}) bf16 -> "
              f"({T},{d}) f32 at top_k={top_k}, {int(f['keep'].sum())} of {N} "
              f"choices kept; bitwise equal to the sequential sum and run "
              f"twice, max_abs_err={err:.3e} against the plain version "
              f"(x{ratio:.4f} of 1e-6 of its terms) | device ms={dev_c:.4f} "
              f"plain_ms={plain_c:.4f} embedding_bag device ms={lib_c:.4f} "
              f"(bf16 out) bound_ms={bms_c:.5f} ({by_c}, {nbytes_c} bytes)",
              flush=True)
        if label != "train":
            del f
            continue
        c = check_moe_grads(f)
        check_dispatch_bwd(f)
        keep = f["keep"]
        dbuf = f["dbuf"]
        keepf = keep.float()

        def dx_fn():
            return ops._dispatch_bwd(dbuf, slot, keep, T, top_k,
                                     torch.bfloat16)

        def dx_old():
            return moe_combine(dbuf, slot, keepf, top_k).to(torch.bfloat16)
        dx_dev, dx_old_dev, dx_old_dev2, dx_dev2 = (graph_ms(fn) for fn in (
            dx_fn, dx_old, dx_old, dx_fn))
        dx_ev = time_ms(dx_fn, rounds)
        dx_old_ev = time_ms(dx_old, rounds)
        dx_plain = time_ms(lambda: ref.moe_dispatch_bwd(
            dbuf, slot, keep, T, top_k, torch.bfloat16), rounds)
        aidx = torch.where(valid, src, T).long()
        dx_lib = graph_ms(lambda: torch.zeros(
            (T + 1, d), dtype=torch.bfloat16, device=dev).index_add_(
                0, aidx, dbuf))
        nbytes_x = esz * (nvalid * d + T * d) + 5 * N
        bms_x, by_x = bound(nbytes_x, nvalid * d)
        print(f"deepseek kernels dispatch backward {c['label']}: dbuf "
              f"({S},{d}) -> dx ({T},{d}), moe_dispatch_bwd bitwise equal "
              f"to the plain formula and the old route, "
              f"max_abs_err={c['dx_err']:.3e} against the plain autograd | "
              f"device ms={dx_dev:.4f} / {dx_dev2:.4f} (event "
              f"{dx_ev:.4f}), old route device ms={dx_old_dev:.4f} / "
              f"{dx_old_dev2:.4f} (event {dx_old_ev:.4f}), "
              f"plain_ms={dx_plain:.4f} index_add_ device ms={dx_lib:.4f} "
              f"bound_ms={bms_x:.5f} ({by_x}, {nbytes_x} bytes)", flush=True)
        bw = (f["dout"], ybuf, f["src_entry"], valid, w, top_k)
        cb_dev = graph_ms(lambda: moe_combine_bwd(*bw))
        cb_plain = time_ms(lambda: ref.moe_combine_bwd(*bw), rounds)
        owner = torch.where(valid, f["src_entry"].long(), 0)
        gidx = (owner // top_k)[:, None].expand(S, d)
        wo = torch.where(valid, w[owner], 0.0)[:, None]

        def lib_cb():
            rows = torch.gather(f["dout"], 0, gidx)
            return (rows * wo).to(ybuf.dtype), torch.sum(rows * ybuf, dim=-1)
        cb_lib = graph_ms(lib_cb)
        tokens = int(torch.unique(owner[valid] // top_k).numel())
        nbytes_b = (4 * tokens * d + esz * nvalid * d + 5 * S + 4 * N
                    + esz * S * d + 4 * N)
        bms_b, by_b = bound(nbytes_b, 3 * nvalid * d)
        print(f"deepseek kernels combine backward {c['label']}: dout "
              f"({T},{d}) f32, ybuf ({S},{d}) bf16, {nvalid} valid slots: "
              f"dybuf bitwise, dgates max_abs_err={c['dg_err']:.3e} "
              f"(x{c['dg_ratio']:.4f} of the 1e-6 tolerance against f64), "
              f"two calls bitwise | device ms={cb_dev:.4f} "
              f"plain_ms={cb_plain:.4f} gather_mul_sum device "
              f"ms={cb_lib:.4f} bound_ms={bms_b:.5f} ({by_b}, {nbytes_b} "
              f"bytes)", flush=True)
        del f
    torch.cuda.empty_cache()


def small_deepseek_agreement(device):
    """Reduced DeepSeek-V3 (f32; MLA, MTP, 1 dense and 1 MoE layer of 4
    experts at top-2) on ``device`` and on the CPU from the same
    parameters: generate over 2 prompts of 48 tokens and DSR_DECODE
    steps (tokens exact, logits within 1e-4 of their largest magnitude,
    as the Mixtral reference line), then DSR_TRAIN steps of
    make_train_step with the config's adafactor (lr 1e-3) at microbatch
    2 on batches of 4 x 32 tokens from one state (loss and grad norm
    within 1e-5 relative, parameters within 1e-5 of a leaf's largest
    magnitude + 1e-6). Returns (logit error, loss error, parameter
    error)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    cfg = get_config("deepseek-v3-671b", reduced=True).replace(
        dtype="float32", microbatch=2)
    model = build_model(cfg)
    params = init_params(model, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 48)), dtype=torch.int32)
    runs = []
    for dev in (device, torch.device("cpu")):
        stats = {}
        out = generate(model, tree_map(lambda a: a.to(dev), params),
                       {"tokens": toks}, steps=DSR_DECODE, stats=stats)
        runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                             for lg in stats["logits"]])))
    (t1, l1), (t0, l0) = runs
    require(torch.equal(t1, t0), "small deepseek: tokens differ from the CPU")
    lerr = float((l1 - l0).abs().max())
    require(lerr <= 1e-4 * float(l0.abs().max()),
            f"small deepseek: logits differ from the CPU by {lerr}")
    opt = build_optimizer(cfg.optimizer, 1e-3)
    step = make_train_step(model, None, opt)
    states = {dev: TrainState(tree_map(lambda a: a.clone().to(dev), params),
                              tree_map(lambda a: a.to(dev),
                                       opt.init(params)),
                              torch.zeros((), dtype=torch.int32, device=dev))
              for dev in (device, torch.device("cpu"))}
    merr = perr = 0.0
    for b in train_batches(2, cfg.vocab_size, 4, 33, DSR_TRAIN, "cpu"):
        mets = {}
        for dev in states:
            states[dev], mets[dev] = step(
                states[dev], {k: v.to(dev) for k, v in b.items()})
        got, want = mets[device], mets[torch.device("cpu")]
        for key in ("loss", "grad_norm"):
            e = abs(float(got[key]) - float(want[key]))
            require(e <= 1e-5 * abs(float(want[key])),
                    f"small deepseek: {key} differs from the CPU by {e}")
            merr = max(merr, e)
        for a, w in zip(leaves(states[device].params),
                        leaves(states[torch.device("cpu")].params)):
            e = float((a.cpu() - w).abs().max())
            require(e <= 1e-5 * float(w.abs().max()) + 1e-6,
                    f"small deepseek: parameters differ by {e}")
            perr = max(perr, e)
    return lerr, merr, perr


def deepseek_serve_leg(device):
    """LM serving at DeepSeek-V3's full widths, DS_LAYERS of 61 layers
    (the 3 dense and 2 MoE) with the MTP head drawn (serving does not
    run it): a warm-up generate of 2 steps with moe_dispatch and
    moe_combine launches tallied by shape, then 4 prompts of 4096
    tokens and DS_STEPS greedy steps through launch.serve.generate
    between a reset and a read of the launch counts and of the peak
    memory, then 8 more steps under the profiler. Every MoE layer
    launches moe_dispatch and moe_combine once in the prefill and once
    a step. Returns the counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_bytes
    t_leg = time.perf_counter()
    full, cfg = ds_config(DS_LAYERS, DS_DENSE)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=DS_SEED, device=device)
    sync()
    init_s = time.perf_counter() - t0
    pbytes = tree_bytes(params)
    mtp_bytes = tree_bytes({k: params[k] for k in params
                            if k.startswith("mtp_")})
    emb = params["embed"]
    prompts = torch.as_tensor(np.random.default_rng(DS_SEED).integers(
        0, cfg.vocab_size, size=(DS_BATCH, DS_PROMPT)), dtype=torch.int32)
    batch = {"tokens": prompts}
    with Tally("moe_dispatch", dispatch_key, keep=False) as dtally, \
            Tally("moe_combine", combine_key, keep=False) as ctally:
        generate(model, params, batch, steps=2)           # warm-up
        sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    stats = {}
    toks = generate(model, params, batch, steps=DS_STEPS, stats=stats)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    cache = stats["cache"]
    B, V, S = DS_BATCH, cfg.vocab_size, DS_PROMPT
    require(tuple(toks.shape) == (B, DS_STEPS)
            and bool(((toks >= 0) & (toks < V)).all()),
            "deepseek serve: tokens")
    require(all(tuple(lg.shape) == (B, V) and bool(torch.isfinite(lg).all())
                for lg in stats["logits"]),
            "deepseek serve: logits not finite")
    m = cfg.mla
    require(all(sorted(seg) == ["latent", "rope"]
                and tuple(seg["latent"].shape[1:]) == (B, S + DS_STEPS + 1,
                                                       m.kv_lora_rank)
                for seg in cache["segments"])
            and cache["len"].tolist() == [S + DS_STEPS] * B,
            "deepseek serve: the latent cache")
    n_moe = DS_LAYERS - DS_DENSE
    want = {"moe_dispatch": n_moe * (DS_STEPS + 1),
            "moe_combine": n_moe * (DS_STEPS + 1)}
    require(all(counts[k] == n for k, n in want.items())
            and counts["swa_decode"] == 0,
            f"deepseek serve: launches {counts}, expected {want}")
    # Bounds. Decode: every parameter but the embedding table and the
    # MTP head is read each step (every expert's queue has C = 1 slot),
    # plus B embedding rows and the latent caches. Prefill: the products
    # the model needs, the routed pairs at top-8 (none dropped counted
    # as kept: an upper count), attention in f32.
    cache_bytes = sum(seg[n].numel() * seg[n].element_size()
                      for seg in cache["segments"] for n in seg)
    step_bytes = (pbytes - mtp_bytes - emb.numel() * emb.element_size()
                  + B * cfg.d_model * emb.element_size() + cache_bytes)
    step_bound_ms = memory_s(step_bytes) * 1e3
    T = B * S
    bf16_flops = (DS_LAYERS * mla_layer_flops(cfg, T)
                  + DS_DENSE * ffn_flops(cfg, T, False)
                  + n_moe * ffn_flops(cfg, T, True, T * cfg.moe.top_k)
                  + 2 * B * cfg.d_model * V)
    f32_flops = DS_LAYERS * attention_f32_flops(cfg, B, S)
    prefill_bound_s = compute_s(bf16_flops, f32_flops)
    META.submit("deepseek serve prefill", cfg, batch, bf16_flops, f32_flops)
    prefill_s, decode_s = stats["prefill_s"], stats["decode_s"]
    step_ms = decode_s / DS_STEPS * 1e3
    tally = "; ".join(
        f"{name} " + json.dumps({str(k): v[0] for k, v in t.shapes.items()})
        for name, t in (("moe_dispatch", dtally), ("moe_combine", ctally)))
    print(f"deepseek serve full: DeepSeek-V3 (d={cfg.d_model}, "
          f"{cfg.n_heads} heads, MLA q_lora {m.q_lora_rank} / kv_lora "
          f"{m.kv_lora_rank} / rope {m.qk_rope_dim} / nope {m.qk_nope_dim} "
          f"/ v {m.v_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
          f"of {cfg.moe.d_expert} + {cfg.moe.n_shared} shared, dense d_ff "
          f"{cfg.d_ff}, vocab {V}, bf16) cut to {DS_LAYERS} of "
          f"{full.n_layers} layers ({DS_DENSE} dense, {n_moe} MoE) with the "
          f"MTP head: {pbytes / 1e9:.2f} GB drawn on the card in "
          f"{init_s:.2f} s; {B} prompts of {S} tokens, {DS_STEPS} greedy "
          f"steps through launch.serve.generate over the latent cache "
          f"({cache_bytes / 1e6:.1f} MB) | prefill {prefill_s:.3f} s, "
          f"{T / prefill_s:.1f} tokens/s (bound {prefill_bound_s:.3f} s, "
          f"operations: {bf16_flops:.3e} bf16 + {f32_flops:.3e} f32 flops) | "
          f"decode {decode_s:.3f} s, {B * DS_STEPS / decode_s:.1f} tokens/s, "
          f"{step_ms:.3f} ms per step (bound {step_bound_ms:.3f} ms, bytes: "
          f"{step_bytes / 1e9:.2f} GB per step) | peak memory "
          f"{peak_gb:.2f} GB | logits finite | launches {counts} | warm-up "
          f"(2 steps) launches by shape: {tally} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    step = make_serve_step(model)
    tok = toks[:, -1].to(device)

    def eight_steps():
        # The last 8 positions decoded again (the cache has no room
        # past them), in place.
        c = {**cache, "len": cache["len"] - 8}
        for _ in range(8):
            _, c = step(params, c, tok)
    profile("deepseek decode", eight_steps, decode_s * 8 / DS_STEPS)
    del params, cache, stats
    torch.cuda.empty_cache()
    return counts


def deepseek_train_leg(device):
    """Training at DeepSeek-V3's full widths, DST_LAYERS of 61 layers (1
    dense, 1 MoE) with the MTP head, the config's remat and adafactor,
    microbatch 1 (launch.train): a warm-up step, then DST_STEPS timed
    steps between a reset and a read of the launch counts and the peak
    memory, then one more step under the profiler. Returns the counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import param_count, tree_bytes
    t_leg = time.perf_counter()
    full, cfg = ds_config(DST_LAYERS, DST_DENSE, microbatch=1)
    require(cfg.remat and cfg.optimizer == "adafactor" and cfg.mtp
            and full.microbatch == 8,
            "deepseek train: the config's remat, adafactor and MTP head")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=DS_SEED, device=device)
    opt = build_optimizer(cfg.optimizer, DST_LR)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    sync()
    init_s = time.perf_counter() - t0
    nparam, pbytes = param_count(params), tree_bytes(params)
    sbytes = tree_bytes(state.opt)
    step = make_train_step(model, None, opt)
    batches = train_batches(DS_SEED, cfg.vocab_size, DST_BATCH, DST_SEQ + 1,
                            DST_WARM + DST_STEPS + 1, device)
    for b in batches[:DST_WARM]:
        state, _ = step(state, b)
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    walls, mets = [], []
    for b in batches[DST_WARM:DST_WARM + DST_STEPS]:
        t0 = time.perf_counter()
        state, met = step(state, b)
        sync()
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    require(all(np.isfinite(v) for mt in mets for v in mt.values())
            and all(sorted(mt) == ["aux", "ce", "grad_norm", "loss",
                                   "mtp_ce"] for mt in mets),
            f"deepseek train: metrics {mets}")
    require(int(state.step) == DST_WARM + DST_STEPS, "deepseek train: step")
    n_moe = DST_LAYERS - DST_DENSE
    want = {"moe_dispatch": 2 * n_moe * DST_STEPS,
            "moe_combine": 2 * n_moe * DST_STEPS,
            "moe_combine_bwd": n_moe * DST_STEPS,
            "moe_dispatch_bwd": n_moe * DST_STEPS}
    require(all(counts[k] == n for k, n in want.items()),
            f"deepseek train: launches {counts}, expected {want}")
    wall = float(np.median(walls))
    T = DST_BATCH * DST_SEQ
    d, V = cfg.d_model, cfg.vocab_size
    slots = cfg.moe.n_experts * moe._capacity(T, cfg.moe)
    # Bound: the products of a step. The segments' layers and the MTP
    # block run their forward twice (remat) and a backward of two
    # forwards; the unembedding (main and MTP) and the MTP projection
    # a forward and a backward; the experts count their queue slots.
    layers = (DST_LAYERS + 1) * mla_layer_flops(cfg, T) \
        + (DST_DENSE + 1) * ffn_flops(cfg, T, False) \
        + n_moe * ffn_flops(cfg, T, True, slots)
    bf16_flops = 4 * layers + 3 * (2 * 2 * T * d * V + 2 * T * 2 * d * d)
    f32_flops = 4 * (DST_LAYERS + 1) * attention_f32_flops(cfg, DST_BATCH,
                                                            DST_SEQ)
    bound_s = compute_s(bf16_flops, f32_flops)
    META.submit("deepseek train full", cfg, batches[0], bf16_flops,
               f32_flops, train=True)
    per_step = {k: counts[k] // DST_STEPS for k in want}

    def series(key):
        return ", ".join(f"{mt[key]:.4f}" for mt in mets)
    print(f"deepseek train full: DeepSeek-V3 at its published widths cut to "
          f"{DST_LAYERS} of {full.n_layers} layers ({DST_DENSE} dense, "
          f"{n_moe} MoE) with the MTP head ({nparam / 1e9:.3f} B "
          f"parameters, {pbytes / 1e9:.2f} GB, adafactor's state "
          f"{sbytes / 1e9:.3f} GB, drawn on the card in {init_s:.2f} s), "
          f"remat, microbatch 1 (the config's {full.microbatch} cut), "
          f"adafactor lr {DST_LR}: batches of {DST_BATCH} x {DST_SEQ} "
          f"tokens | steps " + ", ".join(f"{w:.3f}" for w in walls)
          + f" s ({T / wall:.1f} tokens/s at the median; bound "
          f"{bound_s:.3f} s a step: {bf16_flops:.3e} bf16 + {f32_flops:.3e} "
          f"f32 flops) | loss {series('loss')} | ce {series('ce')} | mtp_ce "
          f"{series('mtp_ce')} | aux {series('aux')} | grad norm "
          f"{series('grad_norm')} | peak memory {peak_gb:.2f} GB | launches "
          f"a step {json.dumps(per_step)} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    train_profile("deepseek train full", lambda: step(state, batches[-1]),
                  wall)
    # The clip and the optimizer alone, by CUDA events, on one batch's
    # gradients: the profile's split of the step checked another way.
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.optim import clip_by_global_norm
    _, _, grads = _value_and_grad(model, None, state.params, batches[-1])
    sync()
    t_clip = time_ms(lambda: clip_by_global_norm(grads, 1.0), 1, warmup=0)
    t_opt = time_ms(lambda: opt.update(grads, state.opt, state.params,
                                       state.step), 1, warmup=0)
    print(f"deepseek train full: the clip alone {t_clip:.2f} ms, adafactor's "
          f"update alone {t_opt:.2f} ms (CUDA events, one call each, "
          f"{nparam / 1e9:.3f} B parameters)", flush=True)
    del state, params, batches, grads
    torch.cuda.empty_cache()
    return counts


def deepseek_legs(device, rounds: int):
    """The DeepSeek-V3 legs in order: the MoE kernels at its routings,
    the reduced reference against the CPU, serving and training at full
    width. Returns (the serve leg's counts, the train leg's)."""
    t_legs = time.perf_counter()
    deepseek_kernels(device, rounds)
    lerr, merr, perr = small_deepseek_agreement(device)
    print(f"reference: reduced deepseek-v3-671b (f32; MLA, MTP, 1 dense and "
          f"1 MoE layer) through generate (2 prompts of 48 tokens, "
          f"{DSR_DECODE} steps) and {DSR_TRAIN} adafactor steps of "
          f"make_train_step (microbatch 2) on the card equals the CPU run "
          f"(tokens exact, logits within 1e-4 relative, max error "
          f"{lerr:.3e}; loss and grad norm within 1e-5 relative, max error "
          f"{merr:.3e}; parameters within 1e-5 of a leaf's largest "
          f"magnitude + 1e-6, max error {perr:.3e})", flush=True)
    serve_counts = deepseek_serve_leg(device)
    train_counts = deepseek_train_leg(device)
    print(f"legs: deepseek kernels, reference, serve full, train full in "
          f"{time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    return serve_counts, train_counts


def small_state_agreement(device, name):
    """Reduced ``name`` (f32; SMR_CONFIGS's depth) on ``device`` and on
    the CPU from the same parameters (``twin_agreement``): greedy
    generate over 2 prompts of each of SMR_PROMPTS tokens and SMR_DECODE
    steps, then SMR_TRAIN steps of make_train_step at microbatch 2.
    Returns (logit error, loss error, parameter error)."""
    from repro_torch.configs import get_config
    cfg = get_config(name, reduced=True).replace(
        dtype="float32", microbatch=2, **SMR_CONFIGS[name])
    return twin_agreement(device, f"small {name}", cfg, SMR_PROMPTS,
                          SMR_DECODE, SMR_TRAIN)


def twin_agreement(device, what: str, cfg, prompts, decode: int,
                   train: int, extra=None):
    """``cfg`` (f32) on ``device`` and on the CPU from the same
    parameters: greedy generate over 2 prompts of each of ``prompts``
    tokens and ``decode`` steps (tokens exact; logits and every cache
    leaf, states, shared-block caches and encoder keys and values,
    within 1e-5 of their largest magnitude), then ``train`` steps of
    make_train_step with adamw (lr 1e-3, eps 1e-4) at the config's
    microbatch on batches of 4 x 32 tokens from one state (loss and grad
    norm within 1e-5 relative, parameters within 1e-5 of a leaf's
    largest magnitude + 1e-6). ``extra(B, seed)`` gives the family's
    inputs beside the tokens (CPU tensors). Returns (logit error, loss
    error, parameter error)."""
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    extra = extra or (lambda B, seed: {})
    model = build_model(cfg)
    params = init_params(model, seed=0, device="cpu")
    lerr = 0.0
    for S in prompts:
        toks = torch.as_tensor(np.random.default_rng(S).integers(
            0, cfg.vocab_size, size=(2, S)), dtype=torch.int32)
        runs = []
        for dev in (device, torch.device("cpu")):
            stats = {}
            out = generate(model, tree_map(lambda a: a.to(dev), params),
                           {"tokens": toks, **extra(2, S)},
                           steps=decode, stats=stats)
            runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                                 for lg in stats["logits"]]),
                         leaves(tree_map(lambda a: a.cpu(), stats["cache"]))))
        (t1, l1, c1), (t0, l0, c0) = runs
        require(torch.equal(t1, t0), f"{what}: tokens differ from the "
                f"CPU at S={S}")
        e = float((l1 - l0).abs().max())
        require(e <= 1e-5 * float(l0.abs().max()),
                f"{what}: logits differ from the CPU by {e} at S={S}")
        lerr = max(lerr, e)
        require(len(c1) == len(c0) and all(
            a.shape == b.shape and a.dtype == b.dtype
            and float((a.float() - b.float()).abs().max())
            <= 1e-5 * float(b.float().abs().max()) for a, b in zip(c1, c0)),
            f"{what}: the cache differs from the CPU at S={S}")
    opt = build_optimizer(cfg.optimizer, 1e-3, eps=1e-4)
    step = make_train_step(model, None, opt)
    states = {dev: TrainState(tree_map(lambda a: a.clone().to(dev), params),
                              tree_map(lambda a: a.to(dev),
                                       opt.init(params)),
                              torch.zeros((), dtype=torch.int32, device=dev))
              for dev in (device, torch.device("cpu"))}
    merr = perr = 0.0
    for i, b in enumerate(train_batches(2, cfg.vocab_size, 4, 33, train,
                                        "cpu")):
        b = {**b, **extra(4, 10 + i)}
        mets = {}
        for dev in states:
            states[dev], mets[dev] = step(
                states[dev], {k: v.to(dev) for k, v in b.items()})
        got, want = mets[device], mets[torch.device("cpu")]
        for key in ("loss", "grad_norm"):
            e = abs(float(got[key]) - float(want[key]))
            require(e <= 1e-5 * abs(float(want[key])),
                    f"{what}: {key} differs from the CPU by {e}")
            merr = max(merr, e)
        for a, w in zip(leaves(states[device].params),
                        leaves(states[torch.device("cpu")].params)):
            e = float((a.cpu() - w).abs().max())
            require(e <= 1e-5 * float(w.abs().max()) + 1e-6,
                    f"{what}: parameters differ by {e}")
            perr = max(perr, e)
    return lerr, merr, perr


def recurrence_f32_flops(cfg, B: int, S: int):
    """f32 flops of one forward of a state model over B sequences of S
    tokens (S a multiple of ssm_chunk): (its chunked recurrences, for
    the hybrid its shared block's causal attention, else 0), the
    products these forms need, the masked halves of the intra-chunk and
    causal scores left out."""
    C, nc = cfg.ssm_chunk, S // cfg.ssm_chunk
    if cfg.family == "ssm":                    # rwkv6_chunked
        dh = cfg.ssm.head_dim
        H = cfg.d_model // dh
        pairs = C * (C - 1) // 2               # strict lower triangle
        per_chunk = H * (2 * 2 * pairs * dh + 2 * 2 * C * dh * dh
                         + 2 * C * dh)
        return B * nc * per_chunk * cfg.n_layers, 0
    d_inner = cfg.ssm.expand * cfg.d_model     # ssd_chunked
    P, N = cfg.ssm.head_dim, cfg.ssm.state_dim
    H = d_inner // P
    pairs = C * (C + 1) // 2                   # lower triangle, diagonal in
    per_chunk = 2 * pairs * N + H * (2 * pairs * P + 2 * 2 * C * P * N)
    uses = -(-cfg.n_layers // cfg.hybrid_attn_every)
    attn = B * cfg.n_heads * 2 * 2 * cfg.hd * S * (S + 1) // 2
    return B * nc * per_chunk * cfg.n_layers, uses * attn


def span_profile(label: str, fn, wall_s: float, ranges) -> float:
    """Runs ``fn`` once under torch.profiler and prints its device time
    split by the record_function ``ranges`` (the kernels inside each
    range's device-side spans), then the kernels outside them as bf16
    GEMMs, f32 GEMMs (TF32 off) and the rest, and the busy share against
    ``wall_s``, the unprofiled wall of the same work. Returns the device
    time in ms (0.0 where the profiler recorded none)."""
    import bisect
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    t_prof = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    # The profiler's raw events (name, start, duration): prof.events()
    # builds a tree of every host and device event, which for a train
    # step of 10^5 kernels costs far more than the step itself.
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA")]
    spans = sorted((a, b, name) for name, a, b in events if name in ranges)
    kernels = [ev for ev in events if ev[0] not in ranges]
    total = sum(b - a for _, a, b in kernels) / 1e6
    if not total:
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)", flush=True)
        return 0.0
    starts = [a for a, _, _ in spans]
    inside = {name: [0.0, 0] for name in ranges if name in
              {n for _, _, n in spans}}
    gemm = re.compile(r"gemm|xmma|cutlass|wgmma|nvjet", re.I)
    simt = re.compile(r"sgemm|f32f32|simt", re.I)
    outside = {"bf16 GEMMs": 0.0, "f32 GEMMs": 0.0, "the rest": 0.0}
    rest = {}
    for kname, t0, t1 in kernels:
        # The ranges do not nest: the last span to start before the
        # kernel holds it, or none does.
        i = bisect.bisect_right(starts, t0) - 1
        hit = spans[i][2] if i >= 0 and t1 <= spans[i][1] else None
        ms = (t1 - t0) / 1e6
        if hit is not None:
            inside[hit][0] += ms
            inside[hit][1] += 1
        elif gemm.search(kname):
            outside["f32 GEMMs" if simt.search(kname)
                    else "bf16 GEMMs"] += ms
        else:
            outside["the rest"] += ms
            r_ms, n = rest.get(kname, (0.0, 0))
            rest[kname] = (r_ms + ms, n + 1)

    def pct(v):
        return f"{v:.2f} ms ({100 * v / total:.1f}%)"
    parts = [f"{name} {pct(ms)} in {n} kernels"
             for name, (ms, n) in inside.items()]
    if not spans:
        parts.append("no device-side spans of the ranges " + ", ".join(
            ranges) + " (their split not measured)")
    parts += [f"{name} outside them {pct(ms)}"
              for name, ms in outside.items()]
    def short(name):
        for noise in ("void ", "at::native::", "(anonymous namespace)::"):
            name = name.replace(noise, "")
        return name[:96]
    tops = "; ".join(f"{short(name)} {ms:.2f} ms x{n}" for name, (ms, n) in
                     sorted(rest.items(), key=lambda r: -r[1][0])[:5])
    print(f"profile {label}: device time {total:.2f} ms of "
          f"{wall_s * 1e3:.1f} ms unprofiled wall (busy "
          f"{100 * total / (wall_s * 1e3):.1f}%); " + "; ".join(parts)
          + f" | the rest's top kernels: {tops} | profiled and read in "
          f"{time.perf_counter() - t_prof:.1f} s", flush=True)
    return total


def state_serve_leg(device, name):
    """LM serving at ``name``'s published widths and full depth: a
    warm-up generate of 2 steps, then SM_BATCH prompts of SM_PROMPT
    tokens and SM_STEPS greedy steps through launch.serve.generate
    between a reset and a read of the launch counts and of the peak
    memory; then one more prefill and 8 more steps under the profiler,
    split by STATE_RANGES. No kernel of the port runs on this path.
    Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import param_count, tree_bytes
    t_leg = time.perf_counter()
    cfg = get_config(name)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=SM_SEED, device=device)
    sync()
    init_s = time.perf_counter() - t0
    nparam, pbytes = param_count(params), tree_bytes(params)
    emb = params["embed"]
    B, S, V, d = SM_BATCH, SM_PROMPT, cfg.vocab_size, cfg.d_model
    prompts = torch.as_tensor(np.random.default_rng(SM_SEED).integers(
        0, V, size=(B, S)), dtype=torch.int32)
    batch = {"tokens": prompts}
    generate(model, params, batch, steps=2)              # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    stats = {}
    toks = generate(model, params, batch, steps=SM_STEPS, stats=stats)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    cache = stats["cache"]
    require(tuple(toks.shape) == (B, SM_STEPS)
            and bool(((toks >= 0) & (toks < V)).all()), f"{name} serve: tokens")
    require(all(tuple(lg.shape) == (B, V) and bool(torch.isfinite(lg).all())
                for lg in stats["logits"]), f"{name} serve: logits not finite")
    require(cache["len"].tolist() == [S + SM_STEPS] * B
            and len(cache["segments"]) == len(model.segments)
            and all(tuple(next(iter(seg.values())).shape[:2])
                    == (spec.n_layers, B)
                    for seg, spec in zip(cache["segments"], model.segments)),
            f"{name} serve: the state cache")
    if cfg.family == "hybrid":
        require(len(cache["shared"]) == len(model.segments)
                and all(tuple(c["k"].shape) == (1, B, S + SM_STEPS + 1,
                                                cfg.n_kv_heads, cfg.hd)
                        for c in cache["shared"]),
                f"{name} serve: the shared block's caches")
    require(sum(counts.values()) == 0,
            f"{name} serve: launches {counts}, expected none")
    # Bounds. Prefill: the bf16 products of every layer over the B x S
    # tokens and the unembedding of the last token, plus the recurrences'
    # (and the shared attention's) f32 products. Decode: every parameter
    # but the embedding table read once a step, B embedding rows, the
    # states read and written, the shared caches read.
    unembed = 0 if cfg.tie_embeddings else params["unembed"].numel()
    n_mm = nparam - emb.numel() - unembed
    T = B * S
    bf16_flops = 2 * n_mm * T + 2 * d * V * B
    loop_flops, attn_flops = recurrence_f32_flops(cfg, B, S)
    f32_flops = loop_flops + attn_flops
    prefill_bound_s = compute_s(bf16_flops, f32_flops)
    META.submit(f"{STATE_LEGS[name]} serve prefill", cfg, batch, bf16_flops,
               f32_flops)
    seg_bytes = tree_bytes(cache["segments"])
    kv_bytes = tree_bytes(cache.get("shared", []))
    step_bytes = (pbytes - emb.numel() * emb.element_size()
                  + B * d * emb.element_size() + 2 * seg_bytes + kv_bytes)
    step_bound_ms = memory_s(step_bytes) * 1e3
    prefill_s, decode_s = stats["prefill_s"], stats["decode_s"]
    step_ms = decode_s / SM_STEPS * 1e3
    groups = (f"{len(model.segments)} groups of "
              + "+".join(str(s.n_layers) for s in model.segments)
              + f" Mamba2 layers, the shared block after each"
              if cfg.family == "hybrid" else f"{cfg.n_layers} layers")
    print(f"{STATE_LEGS[name]} serve full: {name} at its published widths "
          f"(d={d}, vocab {V}, bf16), {groups}, {nparam / 1e9:.3f} B "
          f"parameters ({pbytes / 1e9:.2f} GB) drawn on the card in "
          f"{init_s:.2f} s; {B} prompts of {S} tokens (ssm_chunk "
          f"{cfg.ssm_chunk}: the chunked prefill), {SM_STEPS} greedy steps "
          f"through launch.serve.generate (states {seg_bytes / 1e6:.1f} MB"
          + (f", shared-block caches {kv_bytes / 1e6:.1f} MB" if kv_bytes
             else "")
          + f") | prefill {prefill_s:.3f} s, {T / prefill_s:.1f} tokens/s "
          f"(bound {prefill_bound_s:.4f} s: {bf16_flops:.3e} bf16 + "
          f"{f32_flops:.3e} f32 flops, of which the chunk loop "
          f"{loop_flops:.3e}, bound {compute_s(f32=loop_flops) * 1e3:.2f}"
          f" ms"
          + (f", and the shared attention {attn_flops:.3e}, bound "
             f"{compute_s(f32=attn_flops) * 1e3:.2f} ms" if attn_flops
             else "")
          + f") | decode {decode_s:.3f} s, "
          f"{B * SM_STEPS / decode_s:.1f} tokens/s, {step_ms:.3f} ms a step "
          f"(bound {step_bound_ms:.3f} ms, bytes: {step_bytes / 1e9:.3f} GB a "
          f"step) | peak memory {peak_gb:.2f} GB | logits finite | launches "
          f"{json.dumps(counts)} | leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    prefill = make_prefill(model)
    step = make_serve_step(model)
    ranges = STATE_RANGES[name]
    with torch.no_grad():
        span_profile(f"{name} prefill", lambda: prefill(params, batch),
                     prefill_s, ranges)
        tok = toks[:, -1].to(device)

        def eight_steps():
            # Steps past the generated ones, the states advanced in place
            # (the shared caches' last 8 rows written again).
            c = {**cache, "len": cache["len"] - 8}
            for _ in range(8):
                _, c = step(params, c, tok)
        span_profile(f"{name} decode (8 steps)", eight_steps,
                     decode_s * 8 / SM_STEPS, ranges)
    del params, cache, stats
    torch.cuda.empty_cache()
    return counts


def state_train_leg(device, name, layers: int):
    """Training at ``name``'s published widths cut to ``layers`` layers,
    with the config's adamw, remat and microbatch 2 (launch.train): a
    warm-up step, then SMT_STEPS timed steps of SMT_BATCH x SMT_SEQ
    tokens between a reset and a read of the launch counts and the peak
    memory, then one more step under the profiler (the recurrences'
    ranges, the clip's and the optimizer's). Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import param_count, tree_bytes
    t_leg = time.perf_counter()
    full = get_config(name)
    cfg = full.replace(n_layers=layers)
    require(cfg.remat and cfg.optimizer == "adamw" and cfg.microbatch == 2,
            f"{name} train: the config's remat, adamw and microbatch 2")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=SM_SEED, device=device)
    opt = build_optimizer(cfg.optimizer, SMT_LR)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    sync()
    init_s = time.perf_counter() - t0
    nparam, pbytes = param_count(params), tree_bytes(params)
    sbytes = tree_bytes(state.opt)
    n_mm = nparam - params["embed"].numel()
    step = make_train_step(model, None, opt)
    batches = train_batches(SM_SEED, cfg.vocab_size, SMT_BATCH, SMT_SEQ + 1,
                            SMT_WARM + SMT_STEPS + 1, device)
    for b in batches[:SMT_WARM]:
        state, _ = step(state, b)
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    walls, mets = [], []
    for b in batches[SMT_WARM:SMT_WARM + SMT_STEPS]:
        t0 = time.perf_counter()
        state, met = step(state, b)
        sync()
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    require(all(np.isfinite(v) for mt in mets for v in mt.values())
            and all(sorted(mt) == ["grad_norm", "loss"] for mt in mets),
            f"{name} train: metrics {mets}")
    require(int(state.step) == SMT_WARM + SMT_STEPS, f"{name} train: step")
    require(sum(counts.values()) == 0,
            f"{name} train: launches {counts}, expected none")
    wall = float(np.median(walls))
    T = SMT_BATCH * SMT_SEQ
    # Bound: 6 N T bf16 flops (N: every parameter but the embedding
    # table; a forward and a backward, remat's second forward not
    # counted) and three forwards' worth of the recurrences' f32
    # products (microbatches of SMT_BATCH / 2 sequences).
    bf16_flops = 6 * n_mm * T
    f32_flops = 3 * cfg.microbatch * sum(recurrence_f32_flops(
        cfg, SMT_BATCH // cfg.microbatch, SMT_SEQ))
    bound_s = compute_s(bf16_flops, f32_flops)
    META.submit(f"{STATE_LEGS[name]} train full", cfg, batches[0], bf16_flops,
               f32_flops, train=True)

    def series(key):
        return ", ".join(f"{mt[key]:.4f}" for mt in mets)
    print(f"{STATE_LEGS[name]} train full: {name} at its published widths "
          f"cut to {layers} of {full.n_layers} layers ({nparam / 1e9:.3f} B "
          f"parameters, {pbytes / 1e9:.2f} GB, adamw's state "
          f"{sbytes / 1e9:.2f} GB, drawn on the card in {init_s:.2f} s), "
          f"remat, microbatch {cfg.microbatch}, adamw lr {SMT_LR}: batches "
          f"of {SMT_BATCH} x {SMT_SEQ} tokens | steps "
          + ", ".join(f"{w:.3f}" for w in walls)
          + f" s ({T / wall:.1f} tokens/s at the median; bound {bound_s:.3f}"
          f" s a step: 6 N T = {bf16_flops:.3e} bf16 + {f32_flops:.3e} f32 "
          f"flops) | loss {series('loss')} | grad norm {series('grad_norm')}"
          f" | peak memory {peak_gb:.2f} GB | launches {json.dumps(counts)} "
          f"| leg wall {time.perf_counter() - t_leg:.1f} s", flush=True)
    span_profile(f"{name} train step (the ranges hold the forward and "
                 f"remat's recompute; their backward is outside them)",
                 lambda: step(state, batches[-1]), wall,
                 STATE_RANGES[name] + ("train_step/clip",
                                       "train_step/optimizer"))
    del state, params, batches
    torch.cuda.empty_cache()
    return counts


def state_legs(device):
    """The RWKV-6 and Zamba2 legs in order: the reduced references
    against the CPU, then serving and training at full width. Returns
    {leg: launch counts}."""
    t_legs = time.perf_counter()
    for name in SMR_CONFIGS:
        t0 = time.perf_counter()
        lerr, merr, perr = small_state_agreement(device, name)
        depth = ("5 layers in groups of 2, three uses of the shared block"
                 if name.startswith("zamba2") else "2 layers")
        print(f"reference: reduced {name} (f32, {depth}) through generate "
              f"(2 prompts of each of {SMR_PROMPTS} tokens: chunked and scan "
              f"prefill, {SMR_DECODE} steps) and {SMR_TRAIN} adamw steps of "
              f"make_train_step (microbatch 2, 4 x 32 tokens) on the card "
              f"equals the CPU run (tokens exact; logits and cache leaves "
              f"within 1e-5 relative, max logit error {lerr:.3e}; loss and "
              f"grad norm within 1e-5 relative, max error {merr:.3e}; "
              f"parameters within 1e-5 of a leaf's largest magnitude + 1e-6,"
              f" max error {perr:.3e}) in {time.perf_counter() - t0:.1f} s",
              flush=True)
    counts = {}
    for name, layers in (("rwkv6-7b", SMT_RWKV_LAYERS), ("zamba2-1.2b", 38)):
        key = STATE_LEGS[name]
        counts[f"{key}_serve"] = state_serve_leg(device, name)
        counts[f"{key}_train"] = state_train_leg(device, name, layers)
    print(f"legs: rwkv and zamba2 references, serve full, train full in "
          f"{time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    return counts


def family_inputs(cfg, B: int, seed: int, device="cpu"):
    """The family's inputs beside the tokens, drawn from a seeded numpy
    generator x 0.02 as the JAX package's dummy_inputs: Whisper's
    enc_embeds (B, n_ctx, d), InternVL2's patch_embeds (B, n_prefix, d),
    f32 (the model casts them to its dtype)."""
    rng = np.random.default_rng(1000 + seed)
    if cfg.family == "encdec":
        name, n = "enc_embeds", cfg.encoder.n_ctx
    else:
        name, n = "patch_embeds", cfg.encoder.n_prefix
    return {name: torch.as_tensor((rng.normal(size=(B, n, cfg.d_model))
                                   * 0.02).astype(np.float32)).to(device)}


def small_family_agreement(device, label):
    """Reduced whisper-base or internvl2-26b (FR_CONFIGS[label], f32,
    microbatch 2) on ``device`` and on the CPU from the same parameters
    (``twin_agreement``): greedy generate over 2 prompts of FR_PROMPT
    tokens (with the family's inputs) and FR_DECODE steps, then FR_TRAIN
    adamw steps. The ring variant (W=32, 16 patches and 16 tokens)
    decodes through swa_decode. Returns the three errors."""
    from repro_torch.configs import get_config
    name, kw = FR_CONFIGS[label]
    cfg = get_config(name, reduced=True).replace(dtype="float32",
                                                  microbatch=2, **kw)
    return twin_agreement(device, f"small {label}", cfg, (FR_PROMPT,),
                          FR_DECODE, FR_TRAIN if not kw else 0,
                          extra=lambda B, seed: family_inputs(cfg, B, seed))


def gqa_layer_params(cfg) -> int:
    """The product weights of one GQA attn_ffn layer: q, k, v, o and the
    FFN (SwiGLU's three, GeLU's two)."""
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ffn = (3 if cfg.activation == "swiglu" else 2) * d * cfg.d_ff
    return 2 * d * H * hd + 2 * d * KVH * hd + ffn


def family_flops(cfg, B: int, S: int, layers: int, last_only: bool):
    """(bf16, f32) flops of one forward over B sequences: for Whisper S
    decoder tokens over encoder.n_ctx frames (the encoder's layers, the
    decoder's and its cross-attention's products), for InternVL2 the
    n_prefix patches and S - n_prefix tokens through ``layers`` layers
    (vis_proj's product too). The unembedding of the last token only
    (``last_only``, a prefill) or of every text token. f32: the
    attention's scores and weighted sums, 4 hd flops a (query head, key)
    pair: the encoder's over every frame, the causal halves, the
    cross-attention's over every frame."""
    d, H, hd, V = cfg.d_model, cfg.n_heads, cfg.hd, cfg.vocab_size
    per = gqa_layer_params(cfg)
    causal = S * (S + 1) // 2
    if cfg.family == "encdec":
        Se, Le = cfg.encoder.n_ctx, cfg.encoder.n_layers
        bf16 = 2 * B * (Se * per * Le + S * per * layers
                        + layers * (S * 2 * d * H * hd
                                    + Se * 2 * d * cfg.n_kv_heads * hd))
        f32 = 4 * B * H * hd * (Le * Se * Se + layers * (causal + S * Se))
        text = S
    else:
        P = cfg.encoder.n_prefix
        bf16 = 2 * B * (S * per * layers + P * d * d)
        f32 = 4 * B * H * hd * causal * layers
        text = S - P
    bf16 += 2 * B * d * V * (1 if last_only else text)
    return bf16, f32


def family_serve_leg(device, label, params=None):
    """LM serving of whisper-base or InternVL2-26B at the published
    widths and full depth (FAMILY_LEGS[label]): a warm-up generate of 2
    steps (not for the ring, whose prefill is the full leg's), then the
    leg's batch and FS_STEPS greedy steps through launch.serve.generate
    between a reset and a read of the launch counts and the peak
    memory; the ring leg holds swa_decode against its plain version on
    its own layer-0 ring. Then one prefill and 8 more steps under the
    profiler, split by FAMILY_RANGES. ``params`` reuses the full leg's
    parameters (the ring variant). Returns (counts, params)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.swa_decode import swa_decode_attention as swa
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.models.common import apply_norm, apply_rope
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_params
    from repro_torch.utils.tree import param_count, tree_bytes
    t_leg = time.perf_counter()
    name, B, S, window = FAMILY_LEGS[label]
    cfg = get_config(name)
    if window:
        cfg = cfg.with_sliding_window(window)
    model = build_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = init_params(model, seed=FS_SEED, device=device)
    sync()
    init_s = time.perf_counter() - t0
    nparam, pbytes = param_count(params), tree_bytes(params)
    V, d = cfg.vocab_size, cfg.d_model
    text = S - (cfg.encoder.n_prefix if cfg.family == "vlm" else 0)
    prompts = torch.as_tensor(np.random.default_rng(FS_SEED).integers(
        0, V, size=(B, text)), dtype=torch.int32)
    batch = {"tokens": prompts, **family_inputs(cfg, B, FS_SEED)}
    if not window:
        generate(model, params, batch, steps=2)          # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    stats = {}
    toks = generate(model, params, batch, steps=FS_STEPS, stats=stats)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    cache = stats["cache"]
    require(tuple(toks.shape) == (B, FS_STEPS)
            and bool(((toks >= 0) & (toks < V)).all()), f"{label}: tokens")
    require(all(tuple(lg.shape) == (B, V) and bool(torch.isfinite(lg).all())
                for lg in stats["logits"]), f"{label}: logits not finite")
    seg = cache["segments"][0]
    require(cache["len"].tolist() == [S + FS_STEPS] * B
            and ("pos" in seg) == bool(window)
            and ("ck" in seg) == (cfg.family == "encdec"), f"{label}: cache")
    want = {k: 0 for k in counts}
    if window:
        want["swa_decode"] = cfg.n_layers * FS_STEPS
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    swa_line = ""
    if window:
        # swa_decode on the leg's own layer-0 ring and last query.
        lp = layer_params(params["segments"][0], 0)
        pos = cache["len"].long() - 1
        require(bool((seg["pos"][0].amax(dim=-1) == pos).all()),
                f"{label}: the ring does not hold the last position")
        h = apply_norm(cfg.norm, lp["ln1"],
                       params["embed"][toks[:, -1].long().to(device)])
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
                f"{label}: swa_decode on the leg's ring differs by {serr}")
        swa_line = (f", swa_decode on the leg's layer-0 ring (g="
                    f"{cfg.n_heads // cfg.n_kv_heads}) max_abs_err="
                    f"{serr:.3e}")
    # Bounds. Prefill: the products of every layer (bf16) and the
    # attention's (f32). Decode: every decoder parameter read once a step
    # (the embedding table only where tied: the unembedding reads it; B
    # of its rows otherwise), the caches read (Whisper's encoder keys and
    # values too).
    bf16_flops, f32_flops = family_flops(cfg, B, S, cfg.n_layers, True)
    prefill_bound_s = compute_s(bf16_flops, f32_flops)
    META.submit(f"{label} serve prefill", cfg, batch, bf16_flops, f32_flops)
    emb = params["embed"]
    enc_bytes = (tree_bytes(params["enc_segments"])
                 + tree_bytes(params["enc_norm"])
                 if cfg.family == "encdec" else 0)
    vis_bytes = tree_bytes(params.get("vis_proj", []))
    cache_bytes = tree_bytes(cache["segments"])
    step_bytes = (pbytes - enc_bytes - vis_bytes
                  - (0 if cfg.tie_embeddings
                     else emb.numel() * emb.element_size())
                  + B * d * emb.element_size() + cache_bytes)
    step_bound_ms = memory_s(step_bytes) * 1e3
    prefill_s, decode_s = stats["prefill_s"], stats["decode_s"]
    step_ms = decode_s / FS_STEPS * 1e3
    what = (f"{cfg.encoder.n_layers} encoder and {cfg.n_layers} decoder "
            f"layers, {B} clips of {cfg.encoder.n_ctx} frame embeddings, "
            f"prompts of {S} tokens" if cfg.family == "encdec" else
            f"{cfg.n_layers} layers, {B} prompts of {cfg.encoder.n_prefix} "
            f"patch embeddings and {text} tokens")
    cache_what = (f"ring of W={window}" if window else "full cache")
    print(f"{label} serve full: {name} at its published widths (d={d}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, "
          f"d_ff {cfg.d_ff} {cfg.activation}, {cfg.norm}, vocab {V}, bf16), "
          f"{what}; {nparam / 1e9:.3f} B parameters ({pbytes / 1e9:.2f} GB)"
          + (f" drawn on the card in {init_s:.2f} s" if not window
             else " (the full leg's)")
          + f"; {FS_STEPS} greedy steps over the {cache_what} "
          f"({cache_bytes / 1e9:.3f} GB) | prefill {prefill_s:.3f} s, "
          f"{B * S / prefill_s:.1f} tokens/s (bound {prefill_bound_s:.4f} s: "
          f"{bf16_flops:.3e} bf16 flops, bound "
          f"{compute_s(bf16_flops):.4f} s, + {f32_flops:.3e} f32 "
          f"attention flops, bound {compute_s(f32=f32_flops):.4f} s) | "
          f"decode {decode_s:.3f} s, {B * FS_STEPS / decode_s:.1f} tokens/s, "
          f"{step_ms:.3f} ms a step (bound {step_bound_ms:.3f} ms, bytes: "
          f"{step_bytes / 1e9:.3f} GB a step) | peak memory {peak_gb:.2f} GB "
          f"| logits finite{swa_line} | launches {json.dumps(counts)} | leg "
          f"wall {time.perf_counter() - t_leg:.1f} s", flush=True)
    prefill = make_prefill(model)
    step = make_serve_step(model)
    dev_batch = {k: v.to(device) for k, v in batch.items()}
    with torch.no_grad():
        if not window:
            span_profile(f"{label} prefill",
                         lambda: prefill(params, dev_batch), prefill_s,
                         FAMILY_RANGES)
        tok = toks[:, -1].to(device)

        def eight_steps():
            # The last 8 positions again: their cache rows (or ring
            # slots, with the same positions) written anew.
            c = {**cache, "len": cache["len"] - 8}
            for _ in range(8):
                _, c = step(params, c, tok)
        span_profile(f"{label} decode (8 steps)", eight_steps,
                     decode_s * 8 / FS_STEPS, FAMILY_RANGES)
    del cache, stats
    return counts, params


def family_train_leg(device, label, layers: int):
    """Training of whisper-base or InternVL2-26B at the published widths
    (FAMILY_TRAIN[label]) cut to ``layers`` decoder layers, with the
    config's adamw, remat and microbatch: a warm-up step, then FT_STEPS
    timed steps between a reset and a read of the launch counts and the
    peak memory, then one more step under the profiler (the attention
    ranges, the clip's and the optimizer's). Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import param_count, tree_bytes
    t_leg = time.perf_counter()
    name, B, S = FAMILY_TRAIN[label]
    full = get_config(name)
    cfg = full.replace(n_layers=layers)
    require(cfg.remat and cfg.optimizer == "adamw",
            f"{label} train: the config's remat and adamw")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model, seed=FS_SEED, device=device)
    opt = build_optimizer(cfg.optimizer, FT_LR)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    sync()
    init_s = time.perf_counter() - t0
    nparam, pbytes = param_count(params), tree_bytes(params)
    sbytes = tree_bytes(state.opt)
    text = S - (cfg.encoder.n_prefix if cfg.family == "vlm" else 0)
    step = make_train_step(model, None, opt)
    batches = [{**b, **family_inputs(cfg, B, i, device)} for i, b in
               enumerate(train_batches(FS_SEED, cfg.vocab_size, B, text + 1,
                                       FT_WARM + FT_STEPS + 1, device))]
    for b in batches[:FT_WARM]:
        state, _ = step(state, b)
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    walls, mets = [], []
    for b in batches[FT_WARM:FT_WARM + FT_STEPS]:
        t0 = time.perf_counter()
        state, met = step(state, b)
        sync()
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    require(all(np.isfinite(v) for mt in mets for v in mt.values())
            and all({"grad_norm", "loss"} <= set(mt) for mt in mets),
            f"{label} train: metrics {mets}")
    require(int(state.step) == FT_WARM + FT_STEPS, f"{label} train: step")
    require(sum(counts.values()) == 0,
            f"{label} train: launches {counts}, expected none")
    wall = float(np.median(walls))
    # Bound: three forwards' worth (a forward and a backward; remat's
    # second forward not counted) of the bf16 products, every text
    # token unembedded, and of the attention's f32 products.
    bf16_flops, f32_flops = (3 * f for f in family_flops(cfg, B, S, layers,
                                                         False))
    bound_s = compute_s(bf16_flops, f32_flops)
    META.submit(f"{label} train full", cfg, batches[0], bf16_flops, f32_flops,
               train=True)

    def series(key):
        return ", ".join(f"{mt[key]:.4f}" for mt in mets)
    what = (f"{B} x ({cfg.encoder.n_ctx} frames, {S} tokens)"
            if cfg.family == "encdec" else
            f"{B} x ({cfg.encoder.n_prefix} patches + {text} tokens)")
    print(f"{label} train full: {name} at its published widths cut to "
          f"{layers} of {full.n_layers} layers ({nparam / 1e9:.3f} B "
          f"parameters, {pbytes / 1e9:.2f} GB, adamw's state "
          f"{sbytes / 1e9:.2f} GB, drawn on the card in {init_s:.2f} s), "
          f"remat, microbatch {cfg.microbatch}, adamw lr {FT_LR}: batches "
          f"of {what} | steps " + ", ".join(f"{w:.3f}" for w in walls)
          + f" s ({B * S / wall:.1f} tokens/s at the median; bound "
          f"{bound_s:.3f} s a step: {bf16_flops:.3e} bf16 + {f32_flops:.3e} "
          f"f32 flops) | loss {series('loss')} | grad norm "
          f"{series('grad_norm')} | peak memory {peak_gb:.2f} GB | launches "
          f"{json.dumps(counts)} | leg wall {time.perf_counter() - t_leg:.1f}"
          f" s", flush=True)
    span_profile(f"{label} train step (the ranges hold the forward and "
                 f"remat's recompute; their backward is outside them)",
                 lambda: step(state, batches[-1]), wall,
                 FAMILY_RANGES + ("train_step/clip", "train_step/optimizer"))
    del state, params, batches
    torch.cuda.empty_cache()
    return counts


def family_legs(device):
    """The Whisper and InternVL2 legs in order: the reduced references
    against the CPU, then Whisper serving and training at full depth,
    InternVL2 serving all 48 layers over the full cache and over the
    ring of its sliding-window variant (the same parameters), and
    training at FT_INTERNVL_LAYERS layers. Returns {leg: launch
    counts}."""
    t_legs = time.perf_counter()
    for label in FR_CONFIGS:
        t0 = time.perf_counter()
        lerr, merr, perr = small_family_agreement(device, label)
        name, kw = FR_CONFIGS[label]
        train = (f" and {FR_TRAIN} adamw steps of make_train_step "
                 f"(microbatch 2, 4 x 32 tokens)" if not kw else "")
        print(f"reference: reduced {label} (f32) through generate (2 prompts "
              f"of {FR_PROMPT} tokens with the family's inputs, {FR_DECODE} "
              f"steps){train} on the card equals the CPU run (tokens exact; "
              f"logits and cache leaves within 1e-5 relative, max logit "
              f"error {lerr:.3e}"
              + (f"; loss and grad norm within 1e-5 relative, max error "
                 f"{merr:.3e}; parameters within 1e-5 of a leaf's largest "
                 f"magnitude + 1e-6, max error {perr:.3e}" if not kw else "")
              + f") in {time.perf_counter() - t0:.1f} s", flush=True)
    counts = {}
    counts["whisper_serve"] = family_serve_leg(device, "whisper")[0]
    torch.cuda.empty_cache()
    counts["whisper_train"] = family_train_leg(device, "whisper", 6)
    counts["internvl_serve"], params = family_serve_leg(device, "internvl")
    counts["internvl_ring"] = family_serve_leg(device, "internvl ring",
                                               params)[0]
    # The 40 GB of parameters go before the train leg draws its own.
    del params
    torch.cuda.empty_cache()
    counts["internvl_train"] = family_train_leg(device, "internvl",
                                                FT_INTERNVL_LAYERS)
    print(f"legs: whisper and internvl references, serve full, ring, train "
          f"full in {time.perf_counter() - t_legs:.1f} s of wall", flush=True)
    return counts


# ---------------------------------- the other families under a mesh --

def tpf_cfg(name: str, f32: bool = False):
    """``name`` as the tpf leg runs it: at its published widths cut to
    TPF_SERVE's depth (InternVL2 with its 4096-token sliding window), or
    reduced in f32 with TPF_TWIN's options (``f32``); microbatch 1."""
    import dataclasses

    from repro_torch.configs import get_config
    if f32:
        return get_config(name, reduced=True).replace(
            dtype="float32", microbatch=1, **TPF_TWIN[name])
    cfg = get_config(name)
    over, _, _ = TPF_SERVE[name]
    over = dict(over)
    if "enc_layers" in over:
        over["encoder"] = dataclasses.replace(cfg.encoder,
                                              n_layers=over.pop("enc_layers"))
    window = over.pop("window", None)
    if window:
        cfg = cfg.with_sliding_window(window)
    return cfg.replace(microbatch=1, **over)


def tpf_train_cfg(name: str):
    """``name`` at its published widths cut to 1 layer, with its
    config's fsdp, at microbatch 1 (each of the 2 rows a rank)."""
    from repro_torch.configs import get_config
    return get_config(name).replace(n_layers=1, microbatch=1)


def tpf_batch(cfg, B: int, S: int, seed: int, device, labels=False):
    """B prompts (or a train batch, ``labels``) of S positions in all
    (InternVL2's patches in front of S - n_prefix tokens) with the
    family's inputs (:func:`family_inputs`), on ``device``."""
    text = S - (cfg.encoder.n_prefix if cfg.family == "vlm" else 0)
    if labels:
        out = train_batches(seed, cfg.vocab_size, B, text + 1, 1, device)[0]
    else:
        out = {"tokens": torch.as_tensor(np.random.default_rng(
            seed).integers(0, cfg.vocab_size, size=(B, text)),
            dtype=torch.int32).to(device)}
    if cfg.family in ("encdec", "vlm"):
        out.update(family_inputs(cfg, B, seed, device))
    return out


def tpf_train_state(model, ctx, device):
    """adamw (lr TF_LR) from TF_SEED's draw (this rank's parts under
    ``ctx``): (state, the parameters' bytes)."""
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import TrainState
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    opt = build_optimizer(model.cfg.optimizer, TF_LR)
    params = init_params(model, seed=TF_SEED, device=device, ctx=ctx)
    held = sum(a.numel() * a.element_size() for a in leaves(params))
    return TrainState(params, opt.init(params), torch.zeros(
        (), dtype=torch.int32, device=device)), opt, held


def tpf_reference(device):
    """The single-device runs the tpf ranks are held to, on the card:
    each TPF_SERVE model drawn whole from FS_SEED through generate
    (tokens, logits, the parameters' bytes, wall), and one train step of
    each TPF_TRAIN model from TF_SEED (loss, grad norm, the parameters
    after it and adamw's first moment in bf16 on the host, bytes)."""
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    out = {}
    for name, (_, B, S) in TPF_SERVE.items():
        model = build_model(tpf_cfg(name))
        params = init_params(model, seed=FS_SEED, device=device)
        held = sum(a.numel() * a.element_size() for a in leaves(params))
        toks, stats, wall = timed_generate(
            model, params, tpf_batch(model.cfg, B, S, FS_SEED, device),
            None, steps=TPF_STEPS)
        out[name] = {"toks": toks.cpu(), "held_gb": held / 1e9,
                     "logits": [lg.cpu() for lg in stats["logits"]],
                     "wall": wall}
        del params, stats
        torch.cuda.empty_cache()
    for name in TPF_TRAIN:
        model = build_model(tpf_train_cfg(name))
        state, opt, held = tpf_train_state(model, None, device)
        batch = tpf_batch(model.cfg, TPF_BATCH, TF_SEQ, TF_SEED, device,
                          labels=True)
        sync()
        t0 = time.perf_counter()
        state, met = make_train_step(model, None, opt)(state, batch)
        sync()
        out[name + " train"] = {
            "wall": time.perf_counter() - t0, "loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]), "held_gb": held / 1e9,
            "params": [a.cpu() for a in leaves(state.params)],
            "m": [m.to(torch.bfloat16).cpu() for m in leaves(
                state.opt["m"])]}
        del state, batch
        torch.cuda.empty_cache()
    return out


def tpf_twin(ctx, name: str) -> dict:
    """Reduced ``name`` (f32, :func:`tpf_cfg`) under ``ctx``'s mesh on
    the card and on the CPU from one draw: greedy generate over 4
    prompts of 32 positions and 4 steps, then 2 adamw steps (lr 1e-3,
    eps 1e-3) on 4 x 32 positions: the tokens equal, and the largest
    relative gaps of the logits, the losses and grad norms, and the
    parameters (each leaf's largest |difference| over its largest
    magnitude)."""
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    model = build_model(tpf_cfg(name, f32=True))
    cfg = model.cfg
    params = init_params(model, seed=0, device="cpu", ctx=ctx)
    prompt = tpf_batch(cfg, 4, 32, 5, "cpu")
    batches = [tpf_batch(cfg, 4, 32, 6 + i, "cpu", labels=True)
               for i in range(2)]
    runs = []
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        stats = {}
        toks = generate(model, p, {k: v.to(dev) for k, v in prompt.items()},
                        steps=4, ctx=ctx, stats=stats)
        opt = build_optimizer("adamw", 1e-3, eps=1e-3)
        state = TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=dev))
        step = make_train_step(model, ctx, opt)
        mets = []
        for b in batches:
            state, met = step(state, {k: v.to(dev) for k, v in b.items()})
            mets += [float(met["loss"]), float(met["grad_norm"])]
        runs.append((toks.cpu(), torch.stack([lg.cpu() for lg in
                                              stats["logits"]]),
                     np.array(mets), [a.cpu() for a in leaves(
                         state.params)]))
    (t1, l1, m1, p1), (t0, l0, m0, p0) = runs
    return {"toks": bool(torch.equal(t1, t0)),
            "logits": float((l1 - l0).abs().max() / l0.abs().max()),
            "met": float(np.max(np.abs(m1 - m0) / np.abs(m0))),
            "params": max(float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30) for a, b in zip(p1, p0))}


def tpf_rank(rank: int, tmp: str) -> None:
    """One rank of the tpf leg (spawned; two gloo ranks on cuda:0). Mesh
    (1, 2): each TPF_SERVE model drawn from FS_SEED as this rank's parts,
    then generate over its prompts and TPF_STEPS steps between a reset
    and a read of the launch counts and the peak, under the collective
    clock (InternVL2's swa_decode first inputs kept, rank 0's:
    :func:`first_inputs`); then each model's f32 twin
    (:func:`tpf_twin`). Mesh (2, 1) in the same world: each TPF_TRAIN
    model at 1 layer, one train step of TPF_BATCH x TF_SEQ positions
    (each rank its row), timed under the clock: loss, grad norm, the
    replicated leaves' digests and every part this rank holds after the
    step with adamw's first moment (rank 0 also the whole leaves)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.sharding import make_ctx, param_shards
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.utils.mesh import make_mesh
    from repro_torch.utils.tree import leaves
    ctx = gloo_rank(tmp, "tpf", rank, (1, 2))
    try:
        out = {}
        for name, (_, B, S) in TPF_SERVE.items():
            model = build_model(tpf_cfg(name))
            params = init_params(model, seed=FS_SEED, device="cuda",
                                 ctx=ctx)
            held = sum(a.numel() * a.element_size() for a in leaves(params))
            batch = tpf_batch(model.cfg, B, S, FS_SEED, "cuda")
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with first_inputs(TP_SERVE_KERNELS[:1], os.path.join(
                    tmp, "tpf_serve_inputs.pt"), rank == 0
                    and model.cfg.sliding_window is not None), \
                    CollectiveClock() as clock:
                toks, stats, wall = timed_generate(model, params, batch,
                                                   ctx, steps=TPF_STEPS)
            out[name] = {
                "describe": ctx.mesh.describe(), "toks": toks.cpu(),
                "logits": [lg.cpu() for lg in stats["logits"]],
                "prefill_s": stats["prefill_s"],
                "decode_s": stats["decode_s"], "wall": wall,
                "clock": (clock.s, clock.n), "counts": ops.launch_counts(),
                "held_gb": held / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del params, stats, batch
            torch.cuda.empty_cache()
        out["twins"] = {name: tpf_twin(ctx, name) for name in TPF_TWIN}
        ctx = make_ctx(make_mesh((2, 1), EP_AXES, backend="gloo"))
        for name in TPF_TRAIN:
            model = build_model(tpf_train_cfg(name))
            state, opt, held = tpf_train_state(model, ctx, "cuda")
            shards = param_shards(state.params, model.cfg, ctx)
            batch = tpf_batch(model.cfg, TPF_BATCH, TF_SEQ, TF_SEED, "cuda",
                              labels=True)
            step = make_train_step(model, ctx, opt)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with CollectiveClock() as clock:
                sync()
                t0 = time.perf_counter()
                state, met = step(state, batch)
                sync()
                wall = time.perf_counter() - t0
            out[name + " train"] = {
                "describe": ctx.mesh.describe(), "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]), "wall": wall,
                "clock": (clock.s, clock.n), "counts": ops.launch_counts(),
                "held_gb": held / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "digests": replicated_digests(state.params, shards),
                "cut": sum(sh is not None for sh in shards),
                "leaves": len(shards),
                "parts": {i: ([(c.axis, c.lo, c.hi) for c in sh.cuts]
                              if sh is not None else [], a.cpu(),
                              m.to(torch.bfloat16).cpu())
                          for i, (a, m, sh) in enumerate(zip(
                              leaves(state.params), leaves(state.opt["m"]),
                              shards))
                          if sh is not None or rank == 0}}
            del state, batch
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(tmp, f"tpf_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tpf_leg(device, smi: str):
    """Two gloo ranks on cuda:0 (collectives staged through the host):
    the ssm, hybrid, encdec and vlm families' layouts. Serving under
    (1, 2), tensor parallel at the published widths (TPF_SERVE): both
    ranks the same tokens and logits, the prefill's logits within TP_TOL
    of the single-device run's largest magnitude (:func:`tpf_reference`;
    the bf16 steps' logits reported), each rank's parameters below the
    single-device draw's bytes, swa_decode launched on every layer and
    step of the InternVL2 ring and held to its plain version at the
    ranks' shape (:func:`tp_kernel_checks`). The f32 reduced twins on the
    card against the CPU under the same mesh (:func:`tpf_twin`): tokens
    equal, logits, loss, grad norm and parameters within EPT_TWIN_TOL.
    One train step under (2, 1) (FSDP, the batch cut over data) of each
    TPF_TRAIN model at 1 layer: both ranks the same loss, grad norm and
    replicated leaves; loss, grad norm and every parameter part within
    TP_TOL, each part of adamw's first moment within TP_GRAD_TOL, of the
    single-device step's. Returns both ranks' launch counts."""
    import torch.multiprocessing as mp
    t_leg = time.perf_counter()
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ref = tpf_reference(device)
        print(f"card memory before the tpf ranks: {ept_release()}",
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            mp.spawn(tpf_rank, args=(str(tmp),), nprocs=2, join=True)
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(tmp / f"tpf_rank{r}.pt", weights_only=False)
                     for r in range(2)]
            t1 = time.perf_counter()
            kern = tp_kernel_checks(tmp / "tpf_serve_inputs.pt", 20)
            check_s = time.perf_counter() - t1
            require(kern, "tpf: no swa_decode inputs were kept on the "
                          "ring")
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    a, b = ranks
    faults = []
    for name, (over, B, S) in TPF_SERVE.items():
        sa, sb, want = a[name], b[name], ref[name]
        if not (torch.equal(sa["toks"], sb["toks"]) and all(
                torch.equal(x, y) for x, y in zip(sa["logits"],
                                                  sb["logits"]))):
            faults.append(f"{name}: the ranks' tokens or logits differ")
        gap = logit_gap(sa["toks"], sa["logits"], want["toks"],
                        want["logits"])
        if gap["pre"] > TP_TOL * gap["scale"]:
            faults.append(f"{name}: the prefill logits are {gap['pre']:.4g}"
                          f" off the single-device run's (tolerance "
                          f"{TP_TOL} x {gap['scale']:.4g})")
        for r, got in enumerate((sa, sb)):
            if not got["held_gb"] < want["held_gb"]:
                faults.append(f"{name}: rank {r} holds {got['held_gb']:.2f}"
                              f" GB, not below {want['held_gb']:.2f}")
        clock = CollectiveClock()
        clock.s, clock.n = sa["clock"]
        swa = sa["counts"]["swa_decode"]
        print(f"tpf serve {name}: {sa['describe']} (two processes on cuda:0)"
              f" ({smi}): published widths at {json.dumps(over)}, tensor "
              f"parallel over model, {B} x {S} positions and {TPF_STEPS} "
              f"steps; both ranks the same tokens and logits; against the "
              f"single-device run (prefill held, steps reported): "
              + gap_line(gap, TP_TOL) + f"; parameters {sa['held_gb']:.3f} "
              f"+ {sb['held_gb']:.3f} GB a rank (single device "
              f"{want['held_gb']:.3f} GB); peak {sa['peak_gb']:.2f} + "
              f"{sb['peak_gb']:.2f} GB; prefill {sa['prefill_s']:.3f} s, "
              f"decode {sa['decode_s']:.3f} s, wall {sa['wall']:.3f} s "
              f"(single device {want['wall']:.3f} s): "
              f"{clock.share(sa['wall'])}; swa_decode launches {swa} + "
              f"{sb['counts']['swa_decode']}", flush=True)
    for name in TPF_TWIN:
        tw = (a["twins"][name], b["twins"][name])
        if not all(t["toks"] and max(t["logits"], t["met"], t["params"])
                   <= EPT_TWIN_TOL for t in tw):
            faults.append(f"{name}: the f32 twin on the card is off the "
                          f"CPU's sharded run: {tw}")
        print(f"tpf twin {name} (reduced, f32, {json.dumps(TPF_TWIN[name])},"
              f" mesh (1, 2), {smi}): the card against the CPU under the "
              f"same mesh: tokens equal {tw[0]['toks']} {tw[1]['toks']}; "
              f"logits {max(t['logits'] for t in tw):.3e}, loss and grad "
              f"norm {max(t['met'] for t in tw):.3e}, parameters after 2 "
              f"adamw steps {max(t['params'] for t in tw):.3e} of their "
              f"largest magnitude (tolerance {EPT_TWIN_TOL})", flush=True)
    for name in TPF_TRAIN:
        key = name + " train"
        ta, tb, want = a[key], b[key], ref[key]
        if (ta["loss"], ta["grad_norm"], ta["digests"]) != (
                tb["loss"], tb["grad_norm"], tb["digests"]):
            faults.append(f"{key}: the ranks' loss, grad norm or replicated"
                          f" leaves differ")
        perr = merr = 0.0
        for got in (ta, tb):
            for i, (cuts, part, m) in got["parts"].items():
                wp, wm = want["params"][i], want["m"][i]
                for axis, lo, hi in cuts:
                    wp = wp.narrow(axis, lo, hi - lo)
                    wm = wm.narrow(axis, lo, hi - lo)
                perr = max(perr, max_gap(part, wp, device))
                merr = max(merr, max_gap(m, wm, device))
        lerr = abs(ta["loss"] - want["loss"]) / abs(want["loss"])
        gerr = abs(ta["grad_norm"] - want["grad_norm"]) / abs(
            want["grad_norm"])
        if max(lerr, gerr, perr) > TP_TOL or merr > TP_GRAD_TOL:
            faults.append(f"{key}: loss {lerr:.3e}, grad norm {gerr:.3e}, "
                          f"parameter parts {perr:.3e}, first moment "
                          f"{merr:.3e} off the single-device step "
                          f"(tolerances {TP_TOL}, {TP_GRAD_TOL})")
        if not (ta["held_gb"] < want["held_gb"]
                and tb["held_gb"] < want["held_gb"]):
            faults.append(f"{key}: a rank holds {ta['held_gb']:.2f} / "
                          f"{tb['held_gb']:.2f} GB, not below "
                          f"{want['held_gb']:.2f}")
        clock = CollectiveClock()
        clock.s, clock.n = ta["clock"]
        print(f"tpf train {name}: {ta['describe']} ({smi}): 1 layer at the "
              f"published widths, FSDP over data ({ta['cut']} of its "
              f"{ta['leaves']} leaves cut), one step of {TPF_BATCH} x "
              f"{TF_SEQ} positions (a row a rank), adamw lr {TF_LR}: loss "
              f"{ta['loss']:.6f}, grad norm {ta['grad_norm']:.6f} (single "
              f"device {want['loss']:.6f}, {want['grad_norm']:.6f}: "
              f"{lerr:.3e}, {gerr:.3e} off); both ranks the same bits and "
              f"replicated leaves; parameter parts within {perr:.3e}, the "
              f"first moment's within {merr:.3e} (tolerances {TP_TOL}, "
              f"{TP_GRAD_TOL}); parameters {ta['held_gb']:.2f} + "
              f"{tb['held_gb']:.2f} GB a rank (single device "
              f"{want['held_gb']:.2f} GB); peak {ta['peak_gb']:.2f} + "
              f"{tb['peak_gb']:.2f} GB; step wall {ta['wall']:.3f} s "
              f"(single device {want['wall']:.3f} s): "
              f"{clock.share(ta['wall'])}", flush=True)
    ring = next(n for n, (over, _, _) in TPF_SERVE.items()
                if over.get("window"))
    layers = TPF_SERVE[ring][0]["n_layers"]
    for r, got in enumerate(ranks):
        if got[ring]["counts"]["swa_decode"] != layers * TPF_STEPS:
            faults.append(f"rank {r}: swa_decode launched "
                          f"{got[ring]['counts']['swa_decode']} times on the "
                          f"{ring} ring, expected {layers * TPF_STEPS}")
    print(f"tpf kernels ({smi}): at the tpf ranks' shapes (rank 0's first "
          f"inputs, checked on the card after the ranks exit, {check_s:.1f}"
          f" s): " + "; ".join(kern), flush=True)
    print(f"tpf: {spawn_s:.1f} s from spawn to join, leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    require(not faults, "tpf: " + "; ".join(faults))
    return {k: sum(r[n]["counts"][k] for r in ranks
                   for n in list(TPF_SERVE) + [t + " train"
                                               for t in TPF_TRAIN])
            for k in a[ring]["counts"]}


def cp_cfg(label: str, twin: bool = False):
    """``label``'s model as the cp2 leg runs it (CP_SERVE: published
    widths cut as given; ``twin``: CP_TWIN's reduced f32 one), its
    window applied; microbatch 1."""
    from repro_torch.configs import get_config
    name, over, window, _ = (CP_TWIN if twin else CP_SERVE)[label]
    cfg = get_config(name, reduced=twin).replace(microbatch=1, **over)
    if twin:
        cfg = cfg.replace(dtype="float32")
    return cfg.with_sliding_window(window) if window else cfg


def cp_prompt(cfg, S: int, seed: int, device):
    return {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(1, S)), dtype=torch.int32).to(device)}


def cp_prefill(model, params, batch, ctx):
    """launch.serve's prefill of ``batch`` with room for CP_STEPS steps
    (the batch cut as generate cuts it): (logits, the cache's leaves
    by path, on the host)."""
    from repro_torch.launch.serve import make_prefill
    from repro_torch.launch.sharding import cut_batch, param_paths
    from repro_torch.utils.tree import leaves
    model.decode_room = CP_STEPS + 1
    ctx, batch = cut_batch(ctx, batch)
    logits, cache = make_prefill(model, ctx)(params, batch)
    return logits.cpu(), dict(zip(param_paths(cache),
                                  (a.cpu() for a in leaves(cache))))


def cp_reference(device):
    """The single-device runs the cp2 ranks are held to, on the card:
    each CP_SERVE model drawn whole from CP_SEED, its prefill (logits and
    the whole cache) and generate over CP_STEPS steps (tokens, logits,
    wall)."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    out = {}
    for label, (_, _, _, S) in CP_SERVE.items():
        model = build_model(cp_cfg(label))
        params = init_params(model, seed=CP_SEED, device=device)
        batch = cp_prompt(model.cfg, S, CP_SEED, device)
        logits, cache = cp_prefill(model, params, batch, None)
        toks, stats, wall = timed_generate(model, params, batch, None,
                                           steps=CP_STEPS)
        out[label] = {"prefill": logits, "cache": cache, "toks": toks.cpu(),
                      "logits": [lg.cpu() for lg in stats["logits"]],
                      "wall": wall, "decode_s": stats["decode_s"]}
        del params, stats
        torch.cuda.empty_cache()
    return out


def cp_twin(ctx, label: str) -> dict:
    """Reduced ``label`` (f32, :func:`cp_cfg`) under ``ctx``'s mesh on the
    card and on the CPU from one draw: greedy generate over one prompt of
    CP_TWIN's length and CP_TWIN_STEPS steps: the tokens equal and the
    logits' largest relative gap."""
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    model = build_model(cp_cfg(label, twin=True))
    params = init_params(model, seed=0, device="cpu", ctx=ctx)
    prompt = cp_prompt(model.cfg, CP_TWIN[label][3], 5, "cpu")
    runs = []
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        stats = {}
        toks = generate(model, p, {k: v.to(dev) for k, v in prompt.items()},
                        steps=CP_TWIN_STEPS, ctx=ctx, stats=stats)
        runs.append((toks.cpu(), torch.stack([lg.cpu() for lg in
                                              stats["logits"]])))
    (t1, l1), (t0, l0) = runs
    return {"toks": bool(torch.equal(t1, t0)),
            "logits": float((l1 - l0).abs().max() / l0.abs().max())}


def cp2_rank(rank: int, tmp: str) -> None:
    """One rank of the cp2 leg (spawned; two gloo ranks on cuda:0), mesh
    (2, 1): each CP_SERVE model drawn from CP_SEED (whole: fsdp off, no
    model axis), its prefill (the cache this rank holds kept on the
    host), then generate over its prompt and CP_STEPS steps between a
    reset and a read of the launch counts and the peak, under the
    collective clock (the ring's swa_decode_partial and swa_combine first
    inputs kept, rank 0's: :func:`first_inputs`); then each model's f32
    twin (:func:`cp_twin`)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    ctx = gloo_rank(tmp, "cp2", rank, (2, 1))
    try:
        out = {}
        for label, (_, _, window, S) in CP_SERVE.items():
            model = build_model(cp_cfg(label))
            params = init_params(model, seed=CP_SEED, device="cuda",
                                 ctx=ctx)
            batch = cp_prompt(model.cfg, S, CP_SEED, "cuda")
            logits, cache = cp_prefill(model, params, batch, ctx)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with first_inputs(CP_KERNELS, os.path.join(
                    tmp, "cp2_inputs.pt"), rank == 0 and window is not None), \
                    CollectiveClock() as clock:
                toks, stats, wall = timed_generate(model, params, batch,
                                                   ctx, steps=CP_STEPS)
            out[label] = {
                "describe": ctx.mesh.describe(), "prefill": logits,
                "cache": cache, "toks": toks.cpu(),
                "logits": [lg.cpu() for lg in stats["logits"]],
                "held": [tuple(a.shape) for a in leaves(stats["cache"])],
                "prefill_s": stats["prefill_s"],
                "decode_s": stats["decode_s"], "wall": wall,
                "clock": (clock.s, clock.n), "counts": ops.launch_counts(),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del params, stats, cache
            torch.cuda.empty_cache()
        out["twins"] = {label: cp_twin(ctx, label) for label in CP_TWIN}
        torch.save(out, os.path.join(tmp, f"cp2_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def cp_block(path, whole: torch.Tensor, rank: int, dp: int = 2):
    """Rank ``rank``'s block of a whole decode-cache leaf of one sequence
    over ``dp`` ranks: the contiguous block [r n / dp, (r + 1) n / dp) of
    the sequence of a key, value or latent leaf whose n positions divide,
    any other leaf whole."""
    if (path[-1] in ("k", "v", "ck", "cv", "latent", "rope")
            and whole.shape[2] % dp == 0):
        n = whole.shape[2] // dp
        return whole[:, :, rank * n:(rank + 1) * n]
    return whole


def cp_kernel_checks(path: Path, rounds: int) -> dict:
    """swa_decode's partial and combine entry points at rank 0's first
    inputs of the cp2 ring (q (1, 32, 128) over its 2048 of the 4096
    slots, bf16; the gathered states of both ranks): the partial's chunk
    states within 2e-5 of ref.swa_decode_partial's at the same chunks
    (m exact where a chunk holds no key), the combine within 2e-2 of
    ref.merge_states's largest output (bf16); each timed beside its
    plain version (the partial also beside SDPA over the rank's keys)
    with its bound. Returns the two kernels' rows."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_decode as sw
    first = torch.load(path, weights_only=False)
    rows = {}
    for args in first.values():
        a = tuple(t.cuda() if torch.is_tensor(t) else t for t in args)
        if len(a) == 6:     # the partial's (q, kw, vw, bias, scale, ranks)
            name = "swa_decode_partial"
            q, kw, vw, bias, scale, ranks = a
            got = sw.swa_decode_partial(q, kw, vw, bias, scale, ranks=ranks)
            S = got.shape[1]
            want = ref.swa_decode_partial(q, kw, vw, bias, scale, splits=S)
            live = want[..., 0] > -1e29
            errs = [float((x - y).abs().max()) / float(y.abs().max())
                    for x, y in ((got[..., 0][live], want[..., 0][live]),
                                 (got[..., 1], want[..., 1]),
                                 (got[..., 2:], want[..., 2:]))]
            require(torch.equal(got[..., 0][~live], want[..., 0][~live])
                    and max(errs) <= 2e-5,
                    f"cp kernels: swa_decode_partial's states are {errs} "
                    f"off the plain version's (tolerance 2e-5)")
            kern = lambda: sw.swa_decode_partial(  # noqa: E731
                q, kw, vw, bias, scale, ranks=ranks)
            plain = lambda: ref.swa_decode_partial(  # noqa: E731
                q, kw, vw, bias, scale, splits=S)
            qs, ks, vs = q[:, :, None, :], kw.transpose(1, 2), \
                vw.transpose(1, 2)
            mask = bias[:, None, None, :].to(q.dtype)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
            b, h, dh = q.shape
            nbytes = (q.element_size() * (q.numel() + kw.numel()
                                          + vw.numel())
                      + 4 * (bias.numel() + got.numel()))
            work = (nbytes, 4 * b * h * kw.shape[1] * dh)
            err, shape = max(errs), (f"q {tuple(q.shape)} kw/vw "
                                     f"{tuple(kw.shape)}, S={S}")
        else:
            name = "swa_combine"
            part, dtype = a
            got = sw.swa_combine(part, dtype)
            want = ref.merge_states(part)
            err = float((got.float() - want).abs().max())
            require(err <= 2e-2 * float(want.abs().max()),
                    f"cp kernels: swa_combine is {err} off the plain "
                    f"version (tolerance 2e-2 of {float(want.abs().max())})")
            kern = lambda: sw.swa_combine(part, dtype)  # noqa: E731
            plain = lambda: ref.merge_states(part).to(dtype)  # noqa: E731
            lib = None
            rows_, S, width = part.shape
            work = (4 * part.numel() + got.numel() * got.element_size(),
                    4 * rows_ * S * (width - 2))
            shape = f"part {tuple(part.shape)} -> {tuple(got.shape)}"
        sync()
        bms, by = bound(*work)
        rows[name] = dict(
            max_abs_err=err, ms=time_ms(kern, rounds),
            plain_ms=time_ms(plain, rounds), bound_ms=bms, bound_by=by,
            library_ms=None if lib is None else time_ms(lib, rounds),
            device_ms=graph_ms(kern),
            device_lib=None if lib is None else graph_ms(lib), shape=shape)
        del a, got, want
    require(set(rows) == {"swa_decode_partial", "swa_combine"},
            f"cp kernels: first inputs kept for {sorted(rows)}")
    return rows


def cp2_leg(device, smi: str):
    """Two gloo ranks on cuda:0 (collectives staged through the host),
    mesh (2, 1), one sequence: the context-parallel decode cache
    (CP_SERVE). Each model's prefill logits within TP_TOL of the
    single-device run's largest (:func:`cp_reference`), the decode steps'
    reported; each rank's cache after the prefill exactly its block
    (:func:`cp_block`) of the single-device cache, within TP_TOL of its
    largest; both ranks the same tokens and logits; the ring's steps
    through swa_decode_partial and swa_combine on every layer and step
    (and never the whole-window swa_decode), the full and latent caches'
    through no kernel (the reference's plain decode); the partial and
    combine held to their plain versions at the ranks' inputs and timed
    (:func:`cp_kernel_checks`); the f32 twins on the card against the CPU
    under the same mesh (:func:`cp_twin`) within CP_TWIN_TOL. Returns
    (both ranks' launch counts, the two kernels' rows)."""
    import torch.multiprocessing as mp
    t_leg = time.perf_counter()
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ref = cp_reference(device)
        print(f"card memory before the cp2 ranks: {ept_release()}",
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            mp.spawn(cp2_rank, args=(str(tmp),), nprocs=2, join=True)
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(tmp / f"cp2_rank{r}.pt", weights_only=False)
                     for r in range(2)]
            rows = cp_kernel_checks(tmp / "cp2_inputs.pt", 20)
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    a, b = ranks
    faults = []
    for label, (name, over, window, S) in CP_SERVE.items():
        sa, sb, want = a[label], b[label], ref[label]
        if not (torch.equal(sa["toks"], sb["toks"]) and all(
                torch.equal(x, y) for x, y in zip(sa["logits"],
                                                  sb["logits"]))):
            faults.append(f"{label}: the ranks' tokens or logits differ")
        gap = logit_gap(sa["toks"], sa["logits"], want["toks"],
                        want["logits"])
        if gap["pre"] > TP_TOL * gap["scale"]:
            faults.append(f"{label}: the prefill logits are {gap['pre']:.4g}"
                          f" off the single-device run's (tolerance "
                          f"{TP_TOL} x {gap['scale']:.4g})")
        blocks, cut = [], 0
        for r, got in enumerate((sa, sb)):
            for path, whole in want["cache"].items():
                mine = cp_block(path, whole, r)
                held = got["cache"][path]
                cut += mine.shape != whole.shape
                if held.shape != mine.shape:
                    faults.append(f"{label}: rank {r} holds {'.'.join(path)}"
                                  f" as {tuple(held.shape)}, its block is "
                                  f"{tuple(mine.shape)} of "
                                  f"{tuple(whole.shape)}")
                    continue
                err = float((held.float() - mine.float()).abs().max())
                if err > TP_TOL * max(float(mine.float().abs().max()), 1e-30):
                    faults.append(f"{label}: rank {r}'s {'.'.join(path)} is "
                                  f"{err:.3e} off its block of the "
                                  f"single-device cache")
                blocks.append(f"{'.'.join(path)} {tuple(held.shape)}")
        layers = cp_cfg(label).n_layers
        for r, got in enumerate((sa, sb)):
            c = got["counts"]
            want_n = layers * CP_STEPS if window else 0
            if (c["swa_decode_partial"], c["swa_combine"],
                    c["swa_decode"]) != (want_n, want_n, 0):
                faults.append(f"{label}: rank {r} launched "
                              f"swa_decode_partial {c['swa_decode_partial']}"
                              f", swa_combine {c['swa_combine']} and "
                              f"swa_decode {c['swa_decode']} times, "
                              f"expected {want_n}, {want_n}, 0")
        clock = CollectiveClock()
        clock.s, clock.n = sa["clock"]
        print(f"cp2 serve {label}: {sa['describe']} (two processes on "
              f"cuda:0) ({smi}): {name} at its published widths, "
              f"{json.dumps(over)}, window {window}, 1 x {S} tokens and "
              f"{CP_STEPS} steps; each rank's cache its block of the "
              f"single-device prefill's ({cut // 2} leaves cut on the "
              f"sequence; rank 0: {'; '.join(blocks[:len(blocks) // 2])}); "
              f"both ranks the same tokens and logits; against the "
              f"single-device run (prefill held, steps reported): "
              + gap_line(gap, TP_TOL) + f"; peak {sa['peak_gb']:.2f} + "
              f"{sb['peak_gb']:.2f} GB; prefill {sa['prefill_s']:.3f} s, "
              f"decode {sa['decode_s']:.3f} s "
              f"({1e3 * sa['decode_s'] / CP_STEPS:.2f} ms a step; single "
              f"device {1e3 * want['decode_s'] / CP_STEPS:.2f} ms), wall "
              f"{sa['wall']:.3f} s (single device "
              f"{want['wall']:.3f} s): {clock.share(sa['wall'])}; launches "
              f"{json.dumps(sa['counts'])}", flush=True)
    for label in CP_TWIN:
        tw = (a["twins"][label], b["twins"][label])
        if not all(t["toks"] and t["logits"] <= CP_TWIN_TOL for t in tw):
            faults.append(f"{label}: the f32 twin on the card is off the "
                          f"CPU's run under the mesh: {tw}")
        name, over, window, S = CP_TWIN[label]
        print(f"cp2 twin {label} (reduced {name}, f32, window {window}, 1 x "
              f"{S} tokens and {CP_TWIN_STEPS} steps, mesh (2, 1), {smi}): "
              f"the card against the CPU under the same mesh: tokens equal "
              f"{tw[0]['toks']} {tw[1]['toks']}; logits "
              f"{max(t['logits'] for t in tw):.3e} of their largest "
              f"magnitude (tolerance {CP_TWIN_TOL})", flush=True)
    for name, r in rows.items():
        lib = ("" if r["library_ms"] is None else
               f" sdpa_ms={r['library_ms']:.4f} (graph replay "
               f"{r['device_lib']:.4f}; SDPA over the rank's keys)")
        print(f"cp kernels {name} ({r['shape']}; {smi}): max error "
              f"{r['max_abs_err']:.3e} against the plain version, "
              f"ms={r['ms']:.4f} device ms={r['device_ms']:.4f} (graph "
              f"replay) plain_ms={r['plain_ms']:.4f}{lib} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    print(f"cp2: {spawn_s:.1f} s from spawn to join, leg wall "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    require(not faults, "cp2: " + "; ".join(faults))
    counts = {k: sum(r[label]["counts"][k] for r in ranks
                     for label in CP_SERVE)
              for k in a[next(iter(CP_SERVE))]["counts"]}
    return counts, rows


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
    decode_counts, tallies["decode"], run = decode_leg(torch.device("cuda"))
    ep_counts = ep_legs(torch.device("cuda"), run, smi)
    del run
    probe_leg(smi)
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
    for leg, c in ep_counts.items():
        require(c["moe_dispatch"] > 0 and c["moe_combine"] > 0,
                f"moe_dispatch or moe_combine was not launched on the {leg} "
                f"leg")
        require(leg == "ep4" or c["swa_decode"] > 0,
                f"swa_decode was not launched on the {leg} leg")
    new_counts += tuple(ep_counts.values())
    train_rows, train_counts, example_counts = train_legs(
        torch.device("cuda"), rounds=20)
    rows.update(train_rows)
    # What the earlier legs kept on the card (tallied inputs, the mesh
    # legs' serves) is not needed past here: the DeepSeek legs fill it.
    del (tallies, pers_tallies, attach_tallies, et_tallies, er_tallies,
         more, want_more, attach, taus, enc_rr, renc_rr)
    torch.cuda.empty_cache()
    ept_counts = ept_legs(torch.device("cuda"), smi)
    for leg, c in ept_counts.items():
        require(all(c[k] > 0 for k in ("moe_dispatch", "moe_combine",
                                       "moe_combine_bwd",
                                       "moe_dispatch_bwd")),
                f"moe_dispatch, moe_combine, moe_combine_bwd or "
                f"moe_dispatch_bwd was not launched on the {leg} leg")
    new_counts += tuple(ept_counts.values())
    torch.cuda.empty_cache()
    ds_serve_counts, ds_train_counts = deepseek_legs(torch.device("cuda"),
                                                     rounds=20)
    for name in ("moe_dispatch", "moe_combine"):
        require(ds_serve_counts[name] > 0 and ds_train_counts[name] > 0,
                f"{name} was not launched on the deepseek serve and train "
                f"legs")
    for name in ("moe_combine_bwd", "moe_dispatch_bwd"):
        require(ds_train_counts[name] > 0,
                f"{name} was not launched on the deepseek train leg")
    new_counts += (ds_serve_counts, ds_train_counts)
    # The DeepSeek legs freed what they drew; the state legs start from a
    # card holding little else.
    torch.cuda.empty_cache()
    print(f"card memory before the state legs: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    state_counts = state_legs(torch.device("cuda"))
    torch.cuda.empty_cache()
    family_counts = family_legs(torch.device("cuda"))
    require(family_counts["internvl_ring"]["swa_decode"]
            == 48 * FS_STEPS, "swa_decode was not launched on every layer "
            "and step of the internvl ring leg")
    new_counts += tuple(family_counts.values())
    torch.cuda.empty_cache()
    tpf_counts = tpf_leg(torch.device("cuda"), smi)
    require(tpf_counts["swa_decode"] > 0,
            "swa_decode was not launched on the tpf leg")
    new_counts += (tpf_counts,)
    torch.cuda.empty_cache()
    cp2_counts, cp_rows = cp2_leg(torch.device("cuda"), smi)
    require(cp2_counts["swa_decode_partial"] > 0
            and cp2_counts["swa_combine"] > 0,
            "swa_decode_partial or swa_combine was not launched on the cp2 "
            "leg")
    new_counts += (cp2_counts,)

    META.report()

    replaces = {
        "pdist_argmin": "src/repro/kernels/pdist_argmin.py:101",
        "kmeans_update": "src/repro/kernels/kmeans_update.py:90",
        "solve_attach": "src/repro/kernels/solve_attach.py:155",
        "moe_dispatch": "src/repro/kernels/moe_dispatch.py:57",
        "moe_combine": "src/repro/kernels/moe_dispatch.py:146",
        "swa_decode": "src/repro/kernels/swa_decode.py:65",
        # No Pallas kernel: the JAX package differentiates ref.py's
        # moe_combine, whose gradient this kernel computes.
        "moe_combine_bwd": "src/repro/kernels/ref.py:142",
        # Nor here: the JAX package differentiates ref.py's moe_dispatch.
        "moe_dispatch_bwd": "src/repro/kernels/ref.py:135",
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
                         + train_counts[name] + example_counts[name]
                         + sum(c[name] for c in new_counts)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"]})
    # swa_decode's two more entry points (the context-parallel ring): its
    # split kernel alone and its combine alone, from the same source.
    for name, r in cp_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/swa_decode.cu",
            "replaces": replaces["swa_decode"],
            "launches": sum(c.get(name, 0) for c in (
                run_counts, serve_counts, route_counts, decode_counts,
                train_counts, example_counts) + new_counts),
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
          + json.dumps(eroute_counts) + " train_full "
          + json.dumps(train_counts) + " train_example "
          + json.dumps(example_counts) + " deepseek_serve "
          + json.dumps(ds_serve_counts) + " deepseek_train "
          + json.dumps(ds_train_counts) + "".join(
              f" {leg} " + json.dumps(c) for leg, c in
              list(ep_counts.items()) + list(ept_counts.items()))
          + "".join(
              f" {leg} " + json.dumps(c) for leg, c in
              list(state_counts.items()) + list(family_counts.items()))
          + " tpf " + json.dumps(tpf_counts)
          + " cp2 " + json.dumps(cp2_counts)
          + "; every kernel matched its plain version; the rwkv, zamba2, "
          "whisper and internvl legs launched none of the port's kernels "
          "(those paths have none: their scans and attention are plain "
          "PyTorch) but the internvl ring legs' swa_decode", flush=True)
    print(f"card: {smi}; chip_smoke wall {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        META.close()
    sys.exit(rc)
