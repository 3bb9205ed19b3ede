"""Wrapper of the MoE dispatch's backward CUDA kernel
(``csrc/moe_dispatch_bwd.cu``).

No Pallas kernel: the JAX package differentiates ``repro/kernels/ref.py``
``moe_dispatch``, whose gradient for x sums each token's kept slot rows
of the queues' gradient. Bound by bytes: the kept rows of dbuf read
once, dx written once in x's dtype (dbuf's). Design: ``moe_combine``'s launch
(a thread owns a 16-byte piece of a row, each warp holds one token and
shares its slots by shuffles and its keep flags by a ballot), with every
load predicated on the keep flag, the sum kept in f32 registers in j
order and rounded once to x's dtype on the store (8 bf16 columns a
16-byte store). The CUDA source plans the launch as ``moe_combine`` does
(``make_plan`` in ``csrc/moe_plan.cuh``; :func:`plan` reports it)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import moe_combine as _mc
from repro_torch.kernels.moe_combine import Plan

NAME = "moe_dispatch_bwd"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "moe_dispatch_bwd_f32",
           torch.bfloat16: "moe_dispatch_bwd_bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(T: int, d: int, top_k: int, dtype, device) -> Plan:
    """The launch that the kernel makes for T tokens of d columns at
    top_k from a 16-byte aligned dbuf of ``dtype`` on CUDA ``device``."""
    index = torch.device(device).index
    esize = torch.empty((), dtype=dtype).element_size()
    return _mc._plan(NAME, T, d, top_k, esize, _mc._vector(d, esize, True),
                     torch.cuda.current_device() if index is None else index)


def moe_dispatch_bwd(dbuf: torch.Tensor, slot: torch.Tensor,
                     keep: torch.Tensor, top_k: int) -> torch.Tensor:
    """The dispatch's gradient for x, on the card.

    dbuf: (S, d) f32 or bf16, in x's dtype; slot: (T*top_k,) int32
    (clipped to [0, S)); keep: (T*top_k,) bool. Returns (T, d) in
    dbuf's dtype: ``dx[t] = sum over the kept j of
    dbuf[slot[t*top_k + j]]`` in f32 from +0, j in order, rounded once.
    The contract of ``kernels.ref.moe_dispatch_bwd``, bit for bit; a
    dropped entry's row is not read."""
    global LAUNCHES
    _build.require(NAME, "dbuf", dbuf, _DTYPES, (2,))
    _build.require(NAME, "slot", slot, (torch.int32,), (1,))
    _build.require(NAME, "keep", keep, (torch.bool,), (1,))
    top_k = int(top_k)
    N = slot.shape[0]
    if top_k < 1 or N % top_k:
        raise ValueError(f"{NAME}: top_k={top_k} must be >= 1 and divide "
                         f"the {N} (token, choice) entries")
    if keep.shape != slot.shape or {slot.device,
                                    keep.device} != {dbuf.device}:
        raise ValueError(f"{NAME}: slot {tuple(slot.shape)} on "
                         f"{slot.device} and keep {tuple(keep.shape)} on "
                         f"{keep.device} do not match each other and dbuf "
                         f"on {dbuf.device}")
    S, d = dbuf.shape
    if S < 1:
        raise ValueError(f"{NAME}: dbuf has no slots to gather from")
    T = N // top_k
    out = torch.empty((T, d), dtype=dbuf.dtype, device=dbuf.device)
    if out.numel() == 0:
        return out
    vec = _mc._vector(d, dbuf.element_size(), dbuf.data_ptr() % 16 == 0)
    err = _fn(dbuf.dtype)(
        dbuf.data_ptr(), slot.data_ptr(), keep.data_ptr(), out.data_ptr(), S,
        T, d, top_k, int(vec),
        torch.cuda.current_stream(dbuf.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return out
