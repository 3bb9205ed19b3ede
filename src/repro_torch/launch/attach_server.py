"""The attachment server (counterpart of ``repro/launch/attach_server.py``):
one k-FED round, then a stream of late-joining devices served through
one ``FederationPlan`` and ``Session``.

It shows the serving layer end to end on one device: batched and
bucketed Theorem 3.2 attachment, incremental folding under an admission
policy with a refresh cadence (``--refresh async`` stages the tau swap
and commits it at the next flush boundary), queue-depth autoscaling,
cluster-routed heads, and a checkpoint whose restored session must
serve the rest of the stream bit for bit as the uninterrupted one.

  PYTHONPATH=src python -m repro_torch.launch.attach_server \\
      --requests 24 --fold-policy lru --capacity 20 --refresh async \\
      --autoscale throughput --checkpoint /tmp/attach.npz

It runs on the card unless given ``--device cpu`` (the plain PyTorch
versions of the kernels). ``--serve-axes`` shards each serve batch over
the ranks of a ``torch.distributed`` world started by ``torchrun`` (rank
and world size come from its environment; the mesh puts every rank on
the first named axis), over NCCL on the card, one rank a card, or gloo
(``--backend gloo``: on the CPU, or ranks sharing a card):

  torchrun --nproc-per-node 2 -m repro_torch.launch.attach_server \\
      --serve-axes data --device cpu [--heads linear]

Every rank serves the same stream and rank 0 prints; with ``--heads``
each batch goes through the sharded routed step. The JAX package's
``--force-host-devices`` is refused by name: its counterpart here is
``torchrun --nproc-per-node``.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.attach_server")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--k-prime", type=int, default=4)
    ap.add_argument("--d", type=int, default=24)
    ap.add_argument("--devices-per-group", type=int, default=4)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--refresh-every", type=int, default=16)
    ap.add_argument("--refresh", default="sync", choices=("sync", "async"),
                    help="tau swap: sync swaps between batches; async "
                         "stages the standby buffer and commits the "
                         "versioned swap at the next flush boundary")
    ap.add_argument("--autoscale", default="off",
                    choices=("off", "latency", "throughput"),
                    help="re-select the batch rung and the bucket ladder "
                         "from the queue at flush boundaries (latency "
                         "tracks the queue both ways; throughput holds "
                         "full batches over single-flush dips); "
                         "--batch-size becomes the ceiling")
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--fold-policy", default="drop",
                    choices=("drop", "lru", "weighted_reservoir"),
                    help="fold-slot admission: drop (served, not folded, "
                         "past capacity), lru, or weighted_reservoir")
    ap.add_argument("--heads", default="off", metavar="NAME",
                    help="cluster-routed serving: 'off', 'linear', or a "
                         "registered model config (e.g. 'qwen1.5-0.5b')")
    ap.add_argument("--head-arch", default="ffn",
                    choices=("ffn", "transformer"))
    ap.add_argument("--head-capacity", type=float, default=1.25,
                    metavar="F",
                    help="each cluster's dispatch queue holds "
                         "ceil(batch * F / k) requests a step")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="save mid-stream and check that the restored "
                         "session serves the rest bit for bit alike")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--serve-axes", default=None, metavar="AXES",
                    help="comma-separated mesh axes to shard the serve "
                         "batch over (run under torchrun; --batch-size "
                         "must divide over the ranks)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's collectives: nccl (default on the "
                         "card, one rank a card) or gloo (default on the "
                         "CPU; ranks may share a card)")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    metavar="N", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.force_host_devices:
        ap.error("--force-host-devices is the JAX package's flag; in the "
                 "port run the server under torchrun --nproc-per-node N "
                 "with --serve-axes")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    import numpy as np

    from repro_torch.data.gaussian import (late_device_stream,
                                           structured_devices)
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.kernels import ops
    from repro_torch.utils.metrics import clustering_accuracy

    serve_axes = (tuple(args.serve_axes.split(","))
                  if args.serve_axes else None)
    mesh = None
    if serve_axes:
        from repro_torch.utils.mesh import make_mesh
        backend = args.backend or ("gloo" if args.device == "cpu"
                                   else "nccl")
        world = int(os.environ.get("WORLD_SIZE", 1))
        mesh = make_mesh((world,) + (1,) * (len(serve_axes) - 1),
                         serve_axes, backend=backend)
    lead = mesh is None or mesh.rank == 0

    def say(line: str) -> None:
        if lead:
            print(line, flush=True)

    k, kp, d = args.k, args.k_prime, args.d
    fm = structured_devices(args.seed, k=k, d=d, k_prime=kp,
                            m0=args.devices_per_group, n_per_comp_dev=25,
                            sep=60.0)
    plan = FederationPlan(k=k, k_prime=kp, d=d, capacity=args.capacity,
                          batch_size=args.batch_size,
                          refresh_every=args.refresh_every,
                          refresh=args.refresh, autoscale=args.autoscale,
                          fold_policy=args.fold_policy, heads=args.heads,
                          head_arch=args.head_arch,
                          head_capacity=args.head_capacity,
                          checkpoint=args.checkpoint, device=args.device,
                          serve_axes=serve_axes)
    sess = Session(plan, mesh=mesh)
    if mesh is not None:
        say(f"mesh: {mesh.describe()}")
    rr = sess.run(args.seed + 1, fm.data)
    Z = fm.data.shape[0]
    acc0 = clustering_accuracy(rr.labels.cpu().numpy(), fm.labels, k)
    say(f"round: Z={Z} devices, k={k}, k'={kp}, accuracy "
        f"{100 * acc0:.2f}% on {sess.device}")

    stream = late_device_stream(fm.means, kp, args.requests, args.seed + 2)
    half = len(stream) // 2
    first = ([r[0] for r in stream[:half]], [r[2] for r in stream[:half]])
    rest = ([r[0] for r in stream[half:]], [r[2] for r in stream[half:]])
    t0 = time.perf_counter()
    if args.heads != "off":
        preds = sess.serve_predict(*first)
        out = [(p.labels, p.tau_version) for p in preds]
    else:
        out = sess.serve_versioned(*first)
    dt = time.perf_counter() - t0
    pts = sum(r[0].shape[0] for r in stream[:half])
    accs = [clustering_accuracy(lbl, r[1], k)
            for (lbl, _), r in zip(out, stream[:half])]
    st = sess.stats()
    versions = sorted({v for _, v in out})
    say(f"served {half} devices / {pts} points in {dt:.2f}s "
        f"({half / dt:.1f} dev/s, {pts / dt:.0f} pts/s) on "
        f"{st['serve_shards']} serve shard(s), tau versions {versions}, "
        f"mean accuracy {100 * float(np.mean(accs)):.2f}%")
    if args.heads != "off":
        h = st["heads"]
        routed = [p for p in preds if p.routed]
        clusters = sorted({p.cluster for p in routed})
        mean_pred = (float(np.mean([np.abs(p.prediction).mean()
                                    for p in routed])) if routed else 0.0)
        say(f"heads[{h['mode']}/{h['arch']}]: routed {len(routed)}/{half}"
            f" requests over {len(clusters)} cluster head(s) "
            f"({h['params_per_head']} params/head, {h['queue_capacity']}"
            f" queue slots/cluster, {h['overflowed']} overflowed), mean "
            f"|prediction| {mean_pred:.3f}")

    if args.checkpoint:
        sess.save()
        restored = Session.restore(args.checkpoint, plan, mesh=mesh)
        live = sess.serve_versioned(*rest)
        again = restored.serve_versioned(*rest)
        same = all(np.array_equal(a, b) and va == vb
                   for (a, va), (b, vb) in zip(live, again))
        say(f"checkpoint -> restore -> serve: bitwise identical labels "
            f"AND tau versions vs uninterrupted session: {same}")
        if not same:
            raise SystemExit("the restored session served other labels or "
                             "tau versions than the uninterrupted one")
    else:
        sess.serve(*rest)

    st = sess.stats()
    say(f"stats: {st['served_devices']} served, {st['folded']} folded "
        f"(capacity {st['capacity']}, policy {st['fold_policy']}), "
        f"refresh cadence {args.refresh_every} ({args.refresh}), final "
        f"tau version {st['tau_version']}")
    a = st["autoscale"]
    say(f"autoscale[{a['policy']}]: active shards {a['shards']}/"
        f"{a['granted_shards']}, batch {a['batch_size']}/"
        f"{a['max_batch']}, ladder {a['ladder']}, {a['decisions']} "
        f"decisions, {st['plane_compiles']} compiled signatures, last "
        f"flush dispatch {a['last_dispatch_us']}us / materialize "
        f"{a['last_materialize_us']}us")
    say("launches: " + json.dumps(ops.launch_counts()))
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
