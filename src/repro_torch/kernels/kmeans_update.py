"""Wrapper of the per-cluster sums/counts CUDA kernel
(``csrc/kmeans_update.cu``; counterpart of
``repro/kernels/kmeans_update.py``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "kmeans_update"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "kmeans_update_f32",
           torch.bfloat16: "kmeans_update_bf16"}


def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kmeans_update(x: torch.Tensor, assign: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None):
    """Per-cluster (weighted) sums and counts, on the card.

    x: (n, d) or (B, n, d), f32 or bf16; assign: int32 (..., n) in
    [-1, k); weights: optional f32 (..., n). Returns (sums (..., k, d)
    f32, counts (..., k) f32), the contract of
    ``kernels.ref.kmeans_update``; every sum is taken in point order."""
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
    err = _fn(x.dtype)(
        x.data_ptr(), assign.data_ptr(),
        None if weights is None else weights.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), B, n, k, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return sums, counts
