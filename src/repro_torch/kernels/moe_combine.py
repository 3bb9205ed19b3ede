"""Wrapper of the weighted re-assembly CUDA kernel
(``csrc/moe_combine.cu``; counterpart of ``_moe_combine`` in
``repro/kernels/moe_dispatch.py``).

Replaces the Pallas scalar-prefetch gather-and-accumulate. Bound by
bytes: top_k rows of ybuf read, one f32 row written per token. Design:
one block per (token, 256 columns), one column per thread, the sum over
the token's top_k choices kept in a register in j order, each product
and sum rounded on its own (no FMA contraction)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "moe_combine"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "moe_combine_f32",
           torch.bfloat16: "moe_combine_bf16"}


def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_combine(ybuf: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                top_k: int) -> torch.Tensor:
    """Weighted re-assembly, on the card.

    ybuf: (S, d) f32 or bf16; slot: (T*top_k,) int32 (clipped to
    [0, S)); gates: (T*top_k,) f32. Returns (T, d) f32, the contract of
    ``kernels.ref.moe_combine``."""
    global LAUNCHES
    _build.require(NAME, "ybuf", ybuf, _DTYPES, (2,))
    _build.require(NAME, "slot", slot, (torch.int32,), (1,))
    _build.require(NAME, "gates", gates, (torch.float32,), (1,))
    top_k = int(top_k)
    N = slot.shape[0]
    if top_k < 1 or N % top_k:
        raise ValueError(f"{NAME}: top_k={top_k} must be >= 1 and divide "
                         f"the {N} (token, choice) entries")
    if gates.shape != slot.shape or {slot.device,
                                     gates.device} != {ybuf.device}:
        raise ValueError(f"{NAME}: slot {tuple(slot.shape)} on "
                         f"{slot.device} and gates {tuple(gates.shape)} on "
                         f"{gates.device} do not match each other and ybuf "
                         f"on {ybuf.device}")
    S, d = ybuf.shape
    if S < 1:
        raise ValueError(f"{NAME}: ybuf has no slots to gather from")
    T = N // top_k
    out = torch.empty((T, d), dtype=torch.float32, device=ybuf.device)
    if out.numel() == 0:
        return out
    err = _fn(ybuf.dtype)(ybuf.data_ptr(), slot.data_ptr(), gates.data_ptr(),
                          out.data_ptr(), S, T, d, top_k,
                          torch.cuda.current_stream(ybuf.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return out
