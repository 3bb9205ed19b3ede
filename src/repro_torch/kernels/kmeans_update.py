"""Wrapper of the per-cluster sums/counts CUDA kernels
(``csrc/kmeans_update.cu``; counterpart of
``repro/kernels/kmeans_update.py``).

One call launches two kernels. The first sorts each batch entry's valid
rows by cluster, stably (each cluster's list in point order), and cuts
the lists into segments of L rows; the second sums each segment's rows,
one block a segment, and adds the segments of a longer list in a fixed
tree: groups of consecutive segments in order, then the groups in
order. Rows at -1 are never read. The CUDA source plans the launch from
the shape and the card (``make_plan`` there; :func:`plan` reports it),
and this wrapper allocates the scratch the plan asks for. One call
counts one launch."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

NAME = "kmeans_update"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "kmeans_update_f32",
           torch.bfloat16: "kmeans_update_bf16"}


class Plan(NamedTuple):
    """How the kernels lay out one call on one card."""
    seg_rows: int        # L, rows of a segment (a summing block's rows)
    in_flight: int       # rows whose loads a thread issues at once
    group: int           # segments whose partials a first-level sum adds
    items: int           # segment records of a batch entry (a bound)
    record_ints: int     # ints of a record: header, rows (and weights)
    bucket_warps: int    # warps of a bucketing block (one per entry)
    bucket_smem: int     # shared memory of a bucketing block
    groups: int          # column groups of the summing grid
    sum_threads: int     # threads of a summing block
    sum_blocks: int      # summing blocks: items x groups x B
    scratch_bytes: int   # scratch this wrapper allocates
    sms: int

    def describe(self) -> str:
        return (f"L={self.seg_rows} rows a segment, {self.in_flight} in "
                f"flight a thread, partials added in groups of "
                f"{self.group}; bucketing: one block of "
                f"{32 * self.bucket_warps} threads a batch entry, "
                f"{self.bucket_smem} bytes of shared memory; summing: "
                f"{self.sum_blocks} blocks ({self.items} items a batch "
                f"entry x {self.groups} column groups) of "
                f"{self.sum_threads} threads on {self.sms} SMs; scratch "
                f"{self.scratch_bytes} bytes")


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(B: int, n: int, k: int, d: int, weighted: bool, device) -> Plan:
    """The launch that the kernels make for x (B, n, d) into k clusters,
    with weights or without, on CUDA ``device``."""
    index = torch.device(device).index
    return _plan(B, n, k, d, bool(weighted),
                 torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=256)
def _plan(B, n, k, d, weighted, index) -> Plan:
    fn = _build.load(NAME).kmeans_update_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 12)()
    with torch.cuda.device(index):
        err = fn(B, n, k, d, int(weighted), out)
    if err != 0:
        raise RuntimeError(f"{NAME}: planning the launch of x ({B}, {n}, "
                           f"{d}) into k={k} failed with cudaError_t {err} "
                           f"(the bucketing block's count tables need "
                           f"12 k bytes of shared memory)")
    return Plan(*out)


def _launch(x, assign, k, weights, sums, counts, scratch) -> None:
    """Both kernels on the current stream, into ``sums`` and ``counts``,
    with ``scratch`` (uint8, at least the plan's scratch bytes)."""
    B = x.shape[0] if x.dim() == 3 else 1
    n, d = x.shape[-2:]
    vec = d % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
    err = _fn(x.dtype)(
        x.data_ptr(), assign.data_ptr(),
        None if weights is None else weights.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
        scratch.numel(), B, n, k, d, int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, err)


def kmeans_update(x: torch.Tensor, assign: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None):
    """Per-cluster (weighted) sums and counts, on the card.

    x: (n, d) or (B, n, d), f32 or bf16; assign: int32 (..., n) in
    [-1, k); weights: optional f32 (..., n). Returns (sums (..., k, d)
    f32, counts (..., k) f32), the contract of
    ``kernels.ref.kmeans_update``. Each cluster's rows are summed in
    point order; a cluster of more than L rows in segments of L, whose
    sums are added in groups of ``plan().group`` in order, then the
    groups in order."""
    global LAUNCHES
    _build.require(NAME, "x", x, _DTYPES, (2, 3))
    _build.require(NAME, "assign", assign, (torch.int32,), (x.dim() - 1,))
    if assign.shape != x.shape[:-1] or assign.device != x.device:
        raise ValueError(f"{NAME}: assign {tuple(assign.shape)} on "
                         f"{assign.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    if weights is not None:
        _build.require(NAME, "weights", weights, (torch.float32,),
                       (x.dim() - 1,))
        if weights.shape != x.shape[:-1] or weights.device != x.device:
            raise ValueError(f"{NAME}: weights {tuple(weights.shape)} do "
                             f"not match x {tuple(x.shape)}")
    k = int(k)
    if k < 1:
        raise ValueError(f"{NAME}: k={k} must be >= 1")
    B = x.shape[0] if x.dim() == 3 else 1
    n, d = x.shape[-2:]
    lead = x.shape[:-2]
    sums = torch.empty((*lead, k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty((*lead, k), dtype=torch.float32, device=x.device)
    if sums.numel() == 0:
        return sums, counts
    p = plan(B, n, k, d, weights is not None, x.device)
    scratch = torch.empty((p.scratch_bytes,), dtype=torch.uint8,
                          device=x.device)
    _launch(x, assign, k, weights, sums, counts, scratch)
    LAUNCHES += 1
    return sums, counts
