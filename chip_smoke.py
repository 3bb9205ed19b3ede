"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/kernels/csrc with
nvcc, holds each kernel against its plain PyTorch version on the card
at the shapes of the main path, then drives the main path through the
port's entry points: the one-shot k-FED round (Session.run) at the
largest setting of the paper's Table 1 (d=300, k=100, k'=10, m0=5,
40 points per component per device: 50 devices x 400 points), and the
Theorem 3.2 serve path (Session.from_round + serve_versioned) for 32
late devices of 1024 points with a sync refresh every 16 folds. It
checks the launch counts of every kernel on both paths, the clustering
accuracy, and agreement with the CPU run of the plain versions on a
small input.

The second to last line is one JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
Without a CUDA device, or without the repository's src/ next to this
file, it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# f32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# The paper's Table 1 at its largest setting
# (benchmarks/bench_table1_gaussian.py): d, k, m0, k' = sqrt(k).
D, K, KP, M0, N_PER, SEP = 300, 100, 10, 5, 40, 30.0
SERVE_N, SERVE_REQUESTS = 1024, 32
SERVE_PLAN = dict(bucket_sizes=(64, 256, 1024), batch_size=8,
                  refresh_every=16)
MIN_ACCURACY = 0.93


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


def check_update(x, a, k, w, label):
    """Sums within 1e-5 relative + n * 1e-7 * max|x| absolute (f32
    summation of n terms in another order), counts likewise."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_update import kmeans_update
    s, cnt = kmeans_update(x, a, k, w)
    rs, rc = ref.kmeans_update(x, a, k, w)
    sync()
    n = x.shape[-2]
    scale = float(x.abs().max()) * (1.0 if w is None else float(w.max()))
    tol = 1e-5 * rs.abs() + n * 1e-7 * scale
    err = float((s - rs).abs().max())
    require(bool(((s - rs).abs() <= tol).all()),
            f"kmeans_update {label}: sums differ by {err}")
    cerr = float((cnt - rc).abs().max())
    require(cerr <= 1e-5 * float(rc.abs().max()) + n * 1e-7,
            f"kmeans_update {label}: counts differ by {cerr}")
    return max(err, cerr)


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


def kernel_phase(fm, dev, rounds: int):
    """Each kernel against its plain version on the card at the main
    path's shapes, then its time, the plain version's, one library
    call's, and its bound. Returns the rows of the kernels line."""
    from repro_torch.core.lloyd import lloyd
    from repro_torch.core.local_kmeans import local_prepare
    from repro_torch.data.gaussian import late_device_stream
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_update import kmeans_update
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    from repro_torch.kernels.solve_attach import solve_attach
    from repro_torch.utils.prng import GumbelSource
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
    lib = time_ms(lambda: torch.min(torch.cdist(x, c) ** 2, dim=-1), rounds)
    ms_s = time_ms(lambda: pdist_argmin(xs, means), rounds)
    nbytes = 4 * (B * n * d + B * KP * d) + B * KP + 8 * B * n
    flops = 2 * B * n * KP * d + 2 * B * n * d + 2 * B * KP * d
    bms, by = bound(nbytes, flops)
    print(f"kernel pdist_argmin: local {tuple(x.shape)}x{tuple(c.shape)} "
          f"max_abs_err={e1:.3e} (x{r1:.3f} of tol, {t1} ties) "
          f"server {tuple(xs.shape)}x{tuple(means.shape)} "
          f"max_abs_err={e2:.3e} "
          f"(x{r2:.3f}, {t2} ties) match=True | local ms={ms:.4f} "
          f"plain_ms={plain:.4f} cdist_min_ms={lib:.4f} bound_ms={bms:.5f} "
          f"({by}) | server ms={ms_s:.4f}", flush=True)
    rows["pdist_argmin"] = dict(
        max_abs_err=max(e1, e2), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib)

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
    ms_s = time_ms(lambda: kmeans_update(xs, sa, K, w), rounds)
    nbytes = 4 * (B * n * d + B * n + B * KP * d + B * KP)
    flops = 2 * B * n * d
    bms, by = bound(nbytes, flops)
    print(f"kernel kmeans_update: local {tuple(x.shape)} k={KP} "
          f"max_abs_err={e1:.3e} server {tuple(xs.shape)} k={K} weighted "
          f"max_abs_err={e2:.3e} match=True | local ms={ms:.4f} "
          f"plain_ms={plain:.4f} index_add_ms={lib:.4f} "
          f"bound_ms={bms:.5f} ({by}) | server ms={ms_s:.4f}", flush=True)
    rows["kmeans_update"] = dict(
        max_abs_err=max(e1, e2), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib)

    # solve_attach: one serve batch of 8 late devices of 1024 points,
    # started from their Algorithm 1 steps 1-3 core-set means.
    reqs = late_device_stream(fm.means, KP, 8, 99,
                              n_range=(SERVE_N, SERVE_N + 1))
    sx = torch.as_tensor(np.stack([r[0] for r in reqs]), device=dev)
    skv = torch.as_tensor([r[2] for r in reqs], dtype=torch.int32,
                          device=dev)
    spm = torch.ones(sx.shape[:2], dtype=torch.bool, device=dev)
    g = GumbelSource(0).draw(range(8), KP, SERVE_N, dev)
    prep = local_prepare(g, sx, k_max=KP, k_valid=skv, point_mask=spm)
    c0, scm = prep.theta.contiguous(), prep.center_mask.contiguous()
    stau = means
    out = {}
    for dtype in ("f32", "bf16"):
        err = check_solve(sx, c0, stau, scm, spm, dtype, 100)
        store = ref.store_dtype(dtype)
        args = (sx.to(store), c0.to(store), stau.to(store), scm, spm)
        ms = time_ms(lambda: solve_attach(*args, max_iters=100), rounds)
        plain = time_ms(lambda: ref.solve_attach(
            sx, c0, stau, scm, spm, max_iters=100, dtype=dtype),
            max(2, rounds // 4))
        # The work this batch needs: each request's own iteration count.
        iters = lloyd(args[0], args[1], center_mask=scm, point_mask=spm,
                      max_iters=100).iters
        it = int(iters.sum())
        esz = 4 if dtype == "f32" else 2
        sb, sn = sx.shape[:2]
        nbytes = (esz * (sb * sn * D + sb * KP * D + K * D) + sb * (KP + sn)
                  + 4 * (2 * sb * sn + sb * KP * D + sb * KP))
        flops = ((it + sb) * 2 * sn * KP * D + it * sn * D
                 + sb * 2 * sn * D + sb * 2 * KP * K * D)
        bms, by = bound(nbytes, flops)
        print(f"kernel solve_attach {dtype}: {tuple(sx.shape)} k'={KP} k={K} "
              f"iterations={iters.tolist()} max_abs_err={err:.3e} "
              f"match=True | ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bms:.5f} ({by}) | {sb} blocks (one per request) "
              f"on {torch.cuda.get_device_properties(dev).multi_processor_count}"
              f" SMs", flush=True)
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=None)
    rows["solve_attach"] = out["f32"]
    return rows


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

    # Where the time goes: the same two calls under torch.profiler.
    # Device time is the sum of the kernels' own times; the busy share is
    # taken against the unprofiled wall time above.
    profile("run", lambda: Session(plan).run(0, fm.data), run_s)
    profile("serve", lambda: Session.from_round(plan, out.detail, seed=0)
            .serve_versioned(datas, kvs), serve_s)
    return run_counts, serve_counts


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
    print(f"profile {label}: device time {dev_ms:.2f} ms of {wall_s * 1e3:.1f}"
          f" ms unprofiled wall (busy {100 * dev_ms / (wall_s * 1e3):.1f}%); "
          f"top by device time: {tops}", flush=True)


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
    run_counts, serve_counts = main_path(fm, torch.device("cuda"))
    for name in _build.KERNELS:
        require(run_counts[name] + serve_counts[name] > 0,
                f"{name} was not launched on the main path")
    require(serve_counts["solve_attach"] > 0 and serve_counts[
        "pdist_argmin"] > 0 and serve_counts["kmeans_update"] > 0,
        "the serve path did not launch every kernel")

    replaces = {
        "pdist_argmin": "src/repro/kernels/pdist_argmin.py:101",
        "kmeans_update": "src/repro/kernels/kmeans_update.py:90",
        "solve_attach": "src/repro/kernels/solve_attach.py:155",
    }
    kernels = []
    for name in _build.KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": run_counts[name] + serve_counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print("launches: run " + json.dumps(run_counts) + " serve "
          + json.dumps(serve_counts) + "; every kernel matched its plain "
          "version", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
