"""Wrapper of the queue-order row gather CUDA kernel
(``csrc/moe_dispatch.cu``; counterpart of ``_moe_dispatch`` in
``repro/kernels/moe_dispatch.py``).

Replaces the Pallas scalar-prefetch DMA gather. Bound by bytes: a
valid slot reads one row of x, every slot writes one. Design: one block
per (slot, 16 KB chunk of the row), each loading its own routing index;
16-byte vector copies where aligned, scalar on the ragged tail; an
invalid slot writes zeros without reading x.

Its gradient needs no kernel of its own: a valid slot is owned by
exactly one kept (token, choice) entry, so dx is the combine of the
queues' gradient with the keep mask as 0/1 gates, which the
``moe_combine`` kernel (``csrc/moe_combine.cu``) computes, then a cast
to x's dtype (``kernels.ops._Dispatch``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "moe_dispatch"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "moe_dispatch_f32",
           torch.bfloat16: "moe_dispatch_bf16"}


def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_dispatch(x: torch.Tensor, src: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Gather rows into queue order, on the card.

    x: (T, d) f32 or bf16; src: (S,) int32 (clipped to [0, T));
    valid: (S,) bool. Returns (S, d) in x's dtype, invalid slots zero:
    the contract of ``kernels.ref.moe_dispatch``, bit for bit."""
    global LAUNCHES
    _build.require(NAME, "x", x, _DTYPES, (2,))
    _build.require(NAME, "src", src, (torch.int32,), (1,))
    _build.require(NAME, "valid", valid, (torch.bool,), (1,))
    if valid.shape != src.shape or {src.device, valid.device} != {x.device}:
        raise ValueError(f"{NAME}: src {tuple(src.shape)} on {src.device} "
                         f"and valid {tuple(valid.shape)} on {valid.device} "
                         f"do not match each other and x on {x.device}")
    T, d = x.shape
    if T < 1:
        raise ValueError(f"{NAME}: x has no rows to gather from")
    S = src.shape[0]
    out = torch.empty((S, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _fn(x.dtype)(x.data_ptr(), src.data_ptr(), valid.data_ptr(),
                       out.data_ptr(), T, S, d,
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return out
