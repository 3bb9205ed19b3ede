"""Wrapper of the fused serve-step CUDA kernel
(``csrc/solve_attach.cu``; counterpart of
``repro/kernels/solve_attach.py``).

One cooperative launch runs every request's bounded Lloyd loop, the
Theorem 3.2 attach and the Definition 3.3 labels. A request's points
are cut into P slices of R rows, one block a slice holding its rows in
shared memory for the whole loop (or, where a slice does not fit,
reading them from global memory: the streaming mode); the P blocks of a
request agree on each step's centers through a scratch buffer that this
wrapper allocates, two integer barriers a step and a sum of the slices'
partials in slice order. The grid is as many groups of P blocks as fit
on the card at once; group g serves requests g, g + G, ... P depends
only on the request's shape and the card, so a request's outputs do not
depend on the batch it comes in, and two calls give the same bits. One
call counts one launch."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

NAME = "solve_attach"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "solve_attach_f32",
           torch.bfloat16: "solve_attach_bf16"}


class Plan(NamedTuple):
    """How the kernel lays out one request shape on one card."""
    rows: int        # R, points a block holds
    slices: int      # P, blocks a request takes
    resident: bool   # x's slice in shared memory (else streamed)
    smem_bytes: int  # dynamic shared memory of a block
    per_sm: int      # blocks co-resident on one SM at that size
    sms: int
    smem_limit: int  # the card's per-block limit

    @property
    def groups(self) -> int:
        """Groups of P blocks co-resident on the card at once."""
        return self.per_sm * self.sms // self.slices


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(n: int, kp: int, d: int, dtype: torch.dtype, device) -> Plan:
    """The kernel's plan for requests of ``n`` points, ``kp`` centers and
    ``d`` features stored in ``dtype`` on CUDA ``device``."""
    index = torch.device(device).index
    return _plan(n, kp, d, dtype,
                 torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=256)
def _plan(n: int, kp: int, d: int, dtype, index: int) -> Plan:
    fn = _build.load(NAME).solve_attach_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(index):
        err = fn(n, kp, d, int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"{NAME}: planning the launch failed with "
                           f"cudaError_t {err}")
    R, P, resident, smem, per_sm, sms, limit = out
    return Plan(R, P, bool(resident), smem, per_sm, sms, limit)


def solve_attach(x: torch.Tensor, centers0: torch.Tensor, tau: torch.Tensor,
                 center_mask: torch.Tensor, point_mask: torch.Tensor,
                 *, max_iters: int):
    """The fused serve step on the card, a request split over P blocks.

    x: (B, n, d), centers0: (B, k', d), tau: (k, d), all in one storage
    dtype (f32, or bf16 with f32 accumulation); center_mask: bool
    (B, k'); point_mask: bool (B, n). Returns (labels (B, n) int32,
    min_sq_dist (B, n) f32, centers (B, k', d) f32, center_labels
    (B, k') int32), the contract of ``kernels.ref.solve_attach``."""
    global LAUNCHES
    _build.require(NAME, "x", x, _DTYPES, (3,))
    _build.require(NAME, "centers0", centers0, (x.dtype,), (3,))
    _build.require(NAME, "tau", tau, (x.dtype,), (2,))
    _build.require(NAME, "center_mask", center_mask, (torch.bool,), (2,))
    _build.require(NAME, "point_mask", point_mask, (torch.bool,), (2,))
    B, n, d = x.shape
    kp = centers0.shape[1]
    k = tau.shape[0]
    if (centers0.shape != (B, kp, d) or tau.shape[1] != d
            or center_mask.shape != (B, kp) or point_mask.shape != (B, n)):
        raise ValueError(
            f"{NAME}: shapes x {tuple(x.shape)}, centers0 "
            f"{tuple(centers0.shape)}, tau {tuple(tau.shape)}, center_mask "
            f"{tuple(center_mask.shape)}, point_mask "
            f"{tuple(point_mask.shape)} do not agree")
    if len({t.device for t in (x, centers0, tau, center_mask,
                                point_mask)}) != 1:
        raise ValueError(f"{NAME}: operands lie on different devices")
    if kp < 1 or k < 1 or d < 1:
        raise ValueError(f"{NAME}: needs k' >= 1, k >= 1 and d >= 1")
    pl = plan(n, kp, d, x.dtype, x.device)
    if pl.smem_bytes > pl.smem_limit or pl.groups < 1:
        raise ValueError(f"{NAME}: a block for n={n}, k'={kp}, d={d} needs "
                         f"{pl.smem_bytes} bytes of shared memory, above the "
                         f"{pl.smem_limit} a block may use")
    dev = x.device
    labels = torch.empty((B, n), dtype=torch.int32, device=dev)
    mind = torch.empty((B, n), dtype=torch.float32, device=dev)
    centers = torch.empty((B, kp, d), dtype=torch.float32, device=dev)
    clbl = torch.empty((B, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return labels, mind, centers, clbl
    G, P = min(B, pl.groups), pl.slices
    # Per group: the slices' partial sums (two halves), the new centers
    # and the attach candidates (two halves); its barrier counter (zero)
    # and the partial counts.
    part = torch.empty((G * ((2 * P + 1) * kp * d + 4 * P * kp),),
                       dtype=torch.float32, device=dev)
    ints = torch.zeros((G * (1 + 2 * P * (kp + 1)),), dtype=torch.int32,
                       device=dev)
    err = _fn(x.dtype)(
        x.data_ptr(), centers0.data_ptr(), tau.data_ptr(),
        center_mask.data_ptr(), point_mask.data_ptr(), labels.data_ptr(),
        mind.data_ptr(), centers.data_ptr(), clbl.data_ptr(),
        part.data_ptr(), ints.data_ptr(), B, n, kp, k, d, int(max_iters),
        pl.rows, P, int(pl.resident), pl.smem_bytes, G,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        lib = _build.load(NAME)
        lib.solve_attach_error_name.argtypes = [ctypes.c_int]
        lib.solve_attach_error_name.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{NAME}: the cooperative launch of {G * P} blocks failed with "
            f"{lib.solve_attach_error_name(err).decode()} (cudaError_t "
            f"{err})")
    LAUNCHES += 1
    return labels, mind, centers, clbl
