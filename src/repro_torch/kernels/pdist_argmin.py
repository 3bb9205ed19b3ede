"""Wrapper of the fused distance + argmin CUDA kernel
(``csrc/pdist_argmin.cu``; counterpart of
``repro/kernels/pdist_argmin.py``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "pdist_argmin"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "pdist_argmin_f32",
           torch.bfloat16: "pdist_argmin_bf16"}


def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pdist_argmin(x: torch.Tensor, c: torch.Tensor,
                 c_mask: Optional[torch.Tensor] = None):
    """Nearest center of every point, on the card.

    x: (n, d) or (B, n, d); c: (k, d) shared, or (B, k, d) with batched
    x; c_mask: optional bool (k,) or (B, k). f32 or bf16 storage (x and
    c alike). Returns (idx (..., n) int32, min_sq_dist (..., n) f32),
    the contract of ``kernels.ref.assign_argmin``."""
    global LAUNCHES
    _build.require(NAME, "x", x, _DTYPES, (2, 3))
    _build.require(NAME, "c", c, (x.dtype,), (2, 3) if x.dim() == 3 else (2,))
    if c.device != x.device:
        raise ValueError(f"{NAME}: x and c lie on {x.device} and {c.device}")
    B = x.shape[0] if x.dim() == 3 else 1
    n, d = x.shape[-2:]
    k = c.shape[-2]
    if c.shape[-1] != d or (c.dim() == 3 and c.shape[0] != B):
        raise ValueError(f"{NAME}: c of shape {tuple(c.shape)} does not "
                         f"match x of shape {tuple(x.shape)}")
    if k < 1:
        raise ValueError(f"{NAME}: needs at least one center")
    m_bstride = 0
    if c_mask is not None:
        _build.require(NAME, "c_mask", c_mask, (torch.bool,), (1, 2))
        if c_mask.shape[-1] != k or (c_mask.dim() == 2
                                     and c_mask.shape[0] != B):
            raise ValueError(f"{NAME}: c_mask of shape "
                             f"{tuple(c_mask.shape)} does not match "
                             f"{B} x {k} centers")
        m_bstride = k if c_mask.dim() == 2 else 0
    idx = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
    val = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if idx.numel() == 0:
        return idx, val
    err = _fn(x.dtype)(
        x.data_ptr(), c.data_ptr(),
        None if c_mask is None else c_mask.data_ptr(),
        idx.data_ptr(), val.data_ptr(), B, n, k, d,
        k * d if c.dim() == 3 else 0, m_bstride,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return idx, val
