"""Profile of one step (counterpart of ``repro/launch/perf_probe.py``).

The reference reads its lowered IR; the port has none, so it profiles
one train step, prefill or decode step of an (arch, shape) on the card
with ``torch.profiler``, at ``--layers`` of the config's depth (the
widths never cut; ``--batch`` and ``--seq`` cut the shape's batch and
sequence where the card cannot hold them). It prints the top ``-n`` ops
by device time (name, calls, device ms, share) and the collective
schedule: under a mesh (``--mesh-shape D M``, a ``torch.distributed``
world from ``torchrun`` or, for one rank, made here) every collective
of its ``ShardGroup`` s counted by ``launch/mesh.CountedMesh``; without
one, none.

  PYTHONPATH=src python -m repro_torch.launch.perf_probe \\
      --arch mixtral-8x7b --shape decode_32k --layers 2

``--device cpu`` runs the config's reduced variant on the CPU (the
tests); its table is the host's op time, not a device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import socket
import time
from collections import defaultdict
from typing import Optional, Sequence

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import SWA_FOR_LONG, build_step
from repro_torch.launch.mesh import CountedMesh, collective_table
from repro_torch.launch.sharding import make_ctx


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_config(arch: str, shape_name: str, layers: int, *,
                 reduced: bool = False):
    """The config a probe runs: ``arch`` (its reduced variant where
    ``reduced``) at ``layers`` layers (at most its own depth), the dense
    leading layers of an MoE config kept below ``layers``."""
    cfg = get_config(arch, reduced=reduced)
    if shape_name == "long_500k" and arch in SWA_FOR_LONG:
        cfg = cfg.with_sliding_window(4096)
    n = min(layers, cfg.n_layers)
    return cfg.replace(n_layers=n,
                       n_dense_layers=min(cfg.n_dense_layers, n - 1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh(shape: Sequence[int], device: torch.device):
    """A counted ("data", "model") mesh over the torch.distributed world
    (one rank's world is made here) and whether this call made it."""
    import torch.distributed as dist
    from repro_torch.utils.mesh import make_mesh
    backend = "nccl" if device.type == "cuda" else "gloo"
    made = False
    if not dist.is_initialized() and shape[0] * shape[1] == 1:
        dist.init_process_group(backend, rank=0, world_size=1,
                                init_method=f"tcp://localhost:{_free_port()}")
        made = True
    mesh = make_mesh(tuple(shape), ("data", "model"), backend=backend)
    return CountedMesh(mesh), made


def _device_table(prof, device: torch.device):
    """{op name: [calls, ms]} of the profile: kernels by device time on
    the card, aten ops by self host time on the CPU."""
    table = defaultdict(lambda: [0, 0.0])
    if device.type == "cuda":
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                row = table[e.name()]
                row[0] += 1
                row[1] += e.duration_ns() / 1e6
    else:
        for e in prof.key_averages():
            if e.self_cpu_time_total > 0:
                table[e.key] = [e.count, e.self_cpu_time_total / 1e3]
    return table


def probe(arch: str, shape_name: str, *, layers: int = 2, n: int = 30,
          batch: Optional[int] = None, seq: Optional[int] = None,
          device: str = "cuda", mesh_shape: Optional[Sequence[int]] = None,
          verbose: bool = True) -> dict:
    """Profile one step; returns {"wall_ms", "op_ms", "top": [(name,
    calls, ms, share)], "collectives", "device", "config"}. ``op_ms`` is
    device time on the card and the host's op time on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("perf_probe runs on CUDA, but "
                           "torch.cuda.is_available() is False: pass "
                           "--device cpu for the reduced config on the CPU")
    from torch.profiler import ProfilerActivity, profile
    cfg = probe_config(arch, shape_name, layers, reduced=dev.type == "cpu")
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape,
                                global_batch=batch or shape.global_batch,
                                seq_len=seq or shape.seq_len)
    mesh, made = (_mesh(mesh_shape, dev) if mesh_shape else (None, False))
    try:
        ctx = make_ctx(mesh) if mesh is not None else None
        gen = torch.Generator(device=dev).manual_seed(0)
        step, args, _ = build_step(cfg, shape, ctx, gen)
        out = step(*args)                                   # warm-up
        if shape.mode == "train":
            args = (out[0],) + tuple(args[1:])
        _sync(dev)
        if mesh is not None:
            mesh.reset()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            step(*args)
            _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        coll = collective_table(mesh.collectives) if mesh is not None \
            else {}
    finally:
        if made:
            import torch.distributed as dist
            dist.destroy_process_group()
    table = _device_table(prof, dev)
    total = sum(ms for _, ms in table.values())
    top = sorted(((name, c, ms, ms / total if total else 0.0)
                  for name, (c, ms) in table.items()),
                 key=lambda r: -r[2])[:n]
    res = {"wall_ms": wall_ms, "op_ms": total, "top": top,
           "collectives": coll, "mesh": mesh_shape,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "config": f"{cfg.name} {cfg.n_layers} layers, batch "
                     f"{shape.global_batch}, sequence {shape.seq_len}, "
                     f"{shape.mode}"}
    if verbose:
        report(res)
    return res


def report(res: dict) -> None:
    what = ("device" if res["device"] != "cpu"
            else "host op (a CPU run: no device time)")
    print(f"perf_probe {res['config']} on {res['device']}: one step "
          f"{res['wall_ms']:.3f} ms wall, {what} time {res['op_ms']:.3f} ms")
    print(f"\n== top {len(res['top'])} ops by {what} time ==")
    for name, calls, ms, share in res["top"]:
        print(f"  {ms:10.4f} ms {100 * share:5.1f}% x{calls:<6d} "
              f"{name[:90]}")
    print("\n== collective schedule ==")
    if res["mesh"] is None:
        print("  none (one rank, no mesh)")
    elif not res["collectives"]:
        print(f"  none on mesh {tuple(res['mesh'])}")
    for kind, v in res["collectives"].items():
        print(f"  {kind:16s} count={v['count']:8d} bytes={v['bytes']:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh-shape", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"))
    ap.add_argument("-n", type=int, default=30)
    args = ap.parse_args(argv)
    return probe(args.arch, args.shape, layers=args.layers, n=args.n,
                 batch=args.batch, seq=args.seq, device=args.device,
                 mesh_shape=args.mesh_shape)


if __name__ == "__main__":
    main()
