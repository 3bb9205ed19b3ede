"""Wrapper of the fused distance + argmin CUDA kernel
(``csrc/pdist_argmin.cu``; counterpart of
``repro/kernels/pdist_argmin.py``).

The CUDA source plans each launch from the shape and the card
(``make_plan`` there; :func:`plan` reports it): a block takes R
consecutive rows (the rows of all batch entries as one axis when the
centers are shared), copies them and its centers into shared memory
once, and splits its work over S slices of TK centers and F parts of the
features, with one more thread a center for the center norms. The F
parts' sums are added in order under Kahan's compensation, which the
distance carries through its cancellation. The slices are merged in
index order with a strict ``<``, so ties go to the smallest center
index. One call counts one launch."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

NAME = "pdist_argmin"
LAUNCHES = 0  # launches of the kernel in this process
ROWS = 0      # rows a block takes; 0 lets the plan choose

_DTYPES = {torch.float32: "pdist_argmin_f32",
           torch.bfloat16: "pdist_argmin_bf16"}


class Plan(NamedTuple):
    """How the kernel lays out one call on one card."""
    tk: int          # centers in a thread's register tile
    rows: int        # R, rows a block takes
    slices: int      # S, slices of tk centers a block takes at once
    parts: int       # F, parts the features of a dot product are cut into
    groups: int      # center groups a block stages one after another
    blocks: int      # blocks of the launch
    threads: int     # threads of a block
    smem_bytes: int  # dynamic shared memory of a block
    per_sm: int      # blocks co-resident on one SM
    sms: int


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(B: int, n: int, k: int, d: int, shared: bool,
         dtype: torch.dtype, device) -> Plan:
    """The launch that the kernel makes for x (B, n, d) against k
    centers of d features, shared by every batch entry or not, stored in
    ``dtype`` on CUDA ``device``."""
    index = torch.device(device).index
    return _plan(B, n, k, d, bool(shared), dtype, ROWS,
                 torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=256)
def _plan(B, n, k, d, shared, dtype, rows, index) -> Plan:
    fn = _build.load(NAME).pdist_argmin_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 10)()
    with torch.cuda.device(index):
        err = fn(B, n, k, d, int(shared), int(dtype == torch.bfloat16), rows,
                 out)
    if err != 0:
        raise RuntimeError(f"{NAME}: planning the launch failed with "
                           f"cudaError_t {err}")
    return Plan(*out)


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
    align = 4 * x.element_size()
    vec = (d % 4 == 0 and x.data_ptr() % align == 0
           and c.data_ptr() % align == 0)
    err = _fn(x.dtype)(
        x.data_ptr(), c.data_ptr(),
        None if c_mask is None else c_mask.data_ptr(),
        idx.data_ptr(), val.data_ptr(), B, n, k, d,
        0 if c.dim() == 2 else k * d, m_bstride, int(vec), ROWS,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return idx, val
