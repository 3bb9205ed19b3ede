"""Dry run of every (architecture x input shape x mesh) on the meta
device (counterpart of ``repro/launch/dryrun.py``): one rank's train
step, prefill or decode step, built as that rank of the production mesh
builds it, executed on ``meta`` tensors (shapes only, no allocation,
no card), with its matmul flops, bytes and collectives counted. Records
go to a JSONL file.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out out.jsonl

The mesh is :func:`launch.mesh.make_production_mesh`'s one-rank view of
the reference's 16 x 16 (or 2 x 16 x 16) layout: every leaf, batch row
and cache block as ``launch/sharding`` cuts it for rank 0, every
collective recorded with its operand bytes. A record's terms are that
rank's, on a named hardware profile (``launch/roofline.py``):

  * ``flops_per_device``: the rank's matmul flops (``launch/flops.py``);
    ``flops_eff_per_device`` at the card's f32 / bf16 ratio;
  * ``flops_bf16`` / ``flops_f32``: the whole step's, counted by running
    it once more without a mesh (as the reference's ``jaxpr_flops_*``
    count the global program);
  * ``bytes_per_device``: the sum of each executed op's operand and
    result bytes on the rank. That is eager PyTorch's unfused traffic,
    larger than XLA's fused "bytes accessed" of the reference;
  * ``collectives`` ({kind: {"count", "bytes"}}) and
    ``collective_bytes``, the operand bytes of every collective;
  * ``bytes_peak_est``: the parameters, optimizer state, decode cache
    and batch the rank holds, from their meta sizes. It leaves out
    activations;
  * ``t_count_s``: the seconds the rank's counted run took here (in
    place of the reference's lower and compile times).

A path with a data-dependent shape or a host read (``nonzero``, boolean
indexing, ``.item()``) cannot run on meta tensors: its record is
``status: "error"``, naming the line of the port that failed.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (SHAPES, dummy_inputs, get_config,
                                 input_specs, list_archs)
from repro_torch.launch.flops import Counter, effective_flops
from repro_torch.launch.mesh import (collective_bytes, collective_table,
                                     make_production_mesh)
from repro_torch.launch.roofline import (HW_PROFILES, active_param_count,
                                         model_flops, param_count,
                                         roofline_terms)
from repro_torch.launch.sharding import cut_batch, make_ctx
from repro_torch.launch.train import init_state, make_train_step
from repro_torch.models.common import ShapeOnly
from repro_torch.models.model import build_model
from repro_torch.optim import build_optimizer
from repro_torch.utils.tree import tree_bytes

# (arch, shape) pairs skipped by design (the reference's DESIGN.md §5).
SKIPS = {
    ("whisper-base", "long_500k"):
        "enc-dec with a 448-token decoder context by construction; no "
        "faithful sub-quadratic decoder variant exists for this arch",
}

# Dense/VLM archs run long_500k as their sliding-window variant.
SWA_FOR_LONG = {"mistral-nemo-12b", "granite-3-2b", "qwen1.5-0.5b",
                "nemotron-4-15b", "internvl2-26b"}


class DryRunError(RuntimeError):
    """A step could not run on the meta device; the message names the
    port's line that failed."""


def arch_config(arch: str, shape_name: str):
    cfg = get_config(arch)
    if shape_name == "long_500k" and arch in SWA_FOR_LONG:
        cfg = cfg.with_sliding_window(4096)
    return cfg


def build_step(cfg, shape, ctx=None, gen=None):
    """(step, args, held) of one (config, shape) under ``ctx`` (None: one
    device): the train step on (state, batch), the prefill on (params,
    batch) or the decode step on (params, cache, tokens), as
    ``launch/train`` and ``launch/serve`` run them (each rank cuts its
    rows of the global batch). ``gen``: a ``torch.Generator`` to draw
    the parameters and inputs on its device, or None for ``meta``
    tensors. ``held`` is what the rank keeps resident besides the step's
    outputs: its parameters, optimizer state, cache and batch rows."""
    model = build_model(cfg)
    if gen is None:
        gen, batch = ShapeOnly(), input_specs(cfg, shape)
    else:
        batch = dummy_inputs(gen, cfg, shape)
    if shape.mode == "train":
        optimizer = build_optimizer(cfg.optimizer, 1e-4)
        state = init_state(model, gen, optimizer, ctx)
        step = make_train_step(model, ctx, optimizer)
        return step, (state, batch), (state, cut_batch(ctx, batch)[1])
    params = model.init(gen, ctx)
    if shape.mode == "prefill":
        model.decode_room = 1

        @torch.no_grad()
        def prefill(p, b):
            c, rows = cut_batch(ctx, b)
            return model.prefill(p, rows, c)
        return prefill, (params, batch), (params, cut_batch(ctx, batch)[1])
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device=gen.device, ctx=ctx)
    tokens = batch["tokens"]

    @torch.no_grad()
    def decode(p, c, t):
        cx, rows = cut_batch(ctx, {"tokens": t})
        return model.serve_step(p, c, rows["tokens"], cx)
    return decode, (params, cache, tokens), (
        params, cache, cut_batch(ctx, {"tokens": tokens})[1])


# The counting tools' own frames, which every op of a counted run passes.
_TOOLS = ("launch/flops.py", "launch/mesh.py")


def _where(exc: BaseException) -> str:
    """The innermost line of the port in ``exc``'s traceback, the
    counting tools' frames left out."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename
              and not f.filename.replace("\\", "/").endswith(_TOOLS)]
    if not frames:
        return "outside the port"
    f = frames[-1]
    name = f.filename[f.filename.rfind("repro_torch"):]
    return f"{name}:{f.lineno} ({f.name})"


def count(step, args):
    """(Counter, outputs, seconds) of one run of ``step(*args)`` on meta
    tensors; a failure raises :class:`DryRunError` naming the port's
    line."""
    t0 = time.time()
    try:
        with Counter() as c:
            out = step(*args)
    except (NotImplementedError, RuntimeError) as e:
        raise DryRunError(f"the step cannot run on the meta device at "
                          f"{_where(e)}: {type(e).__name__}: "
                          f"{str(e).splitlines()[0]}") from e
    return c, out, time.time() - t0


def lower_one(arch: str, shape, multi_pod: bool = False, *,
              hw: Optional[str] = None, verbose: bool = True, mesh=None,
              cfg=None) -> dict:
    """The record of one combination (``status`` "ok" or "skipped"; a
    step that cannot run on meta tensors raises :class:`DryRunError`).
    ``shape``: a name of ``SHAPES`` or an ``InputShape``. ``mesh`` (a
    ``launch.mesh.MetaMesh``) and ``cfg`` stand in for the production
    mesh and the arch's config (the tests' small meshes and reduced
    configs)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name = "multi" if multi_pod else "single"
    if (arch, shape.name) in SKIPS:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIPS[(arch, shape.name)]}
    cfg = cfg or arch_config(arch, shape.name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    ctx = make_ctx(mesh)
    step, args, held = build_step(cfg, shape, ctx)
    mesh.reset()
    rank, out, t_count = count(step, args)
    held_bytes = tree_bytes(held)
    if shape.mode == "prefill":
        held_bytes += tree_bytes(out[1])          # the cache it builds
    coll = collective_table(mesh.collectives)
    cbytes = collective_bytes(mesh.collectives)
    whole, _, _ = count(*build_step(cfg, shape, None)[:2])

    shapes = build_model(cfg).param_shapes()
    n_params = param_count(shapes)
    n_active = active_param_count(cfg, shapes)
    chips = mesh.world
    flops = rank.flops["bf16"] + rank.flops["f32"]
    flops_eff = effective_flops(rank.flops, hw)
    mf = model_flops(cfg, shape, n_params, n_active)
    terms = roofline_terms(flops_eff, rank.bytes, cbytes, hw=hw)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "n_params": n_params,
        "n_active_params": n_active,
        "flops_per_device": flops, "flops_eff_per_device": flops_eff,
        "flops_bf16": whole.flops["bf16"], "flops_f32": whole.flops["f32"],
        "bytes_per_device": rank.bytes,
        "collectives": coll, "collective_bytes": cbytes,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(flops * chips, 1.0),
        **terms, "bytes_peak_est": held_bytes,
        "t_count_s": round(t_count, 2),
    }
    if verbose:
        print(f"[{arch} x {shape.name} x {mesh_name}] OK "
              f"compute={terms['compute_s']:.4f}s "
              f"memory={terms['memory_s']:.4f}s "
              f"collective={terms['collective_s']:.4f}s "
              f"bottleneck={terms['bottleneck']} (counted in "
              f"{t_count:.1f}s)")
        print(f"  rank: flops={flops:.3e} bytes={rank.bytes:.3e} "
              f"collective_bytes={cbytes:.3e} "
              f"held={held_bytes / 2**30:.2f}GiB")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--hw-profile", default=None,
                    choices=sorted(HW_PROFILES),
                    help="hardware profile for the roofline terms "
                         "(default: REPRO_HW_PROFILE or h100)")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.mesh == "both" else \
        [args.mesh == "multi"]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    r = lower_one(arch, shape, mp, hw=args.hw_profile)
                except DryRunError as e:
                    r = {"arch": arch, "shape": shape,
                         "mesh": "multi" if mp else "single",
                         "status": "error", "error": str(e),
                         "trace": traceback.format_exc()[-2000:]}
                    print(f"[{arch} x {shape} x {r['mesh']}] FAILED: {e}")
                results.append(r)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    print(f"\n{ok} ok / {sk} skipped / {len(results) - ok - sk} failed "
          f"of {len(results)}")
    return results


if __name__ == "__main__":
    main()
