"""Wrapper of the sliding-window decode attention CUDA kernel
(``csrc/swa_decode.cu``; counterpart of ``swa_decode_attention`` in
``repro/kernels/swa_decode.py``).

Replaces the Pallas online-softmax kernel over window blocks. Bound by
bytes: every key and value of the window is read once. Design: one
block per (batch, kv head) walking the window in tiles of 64 keys
through shared memory, the g query rows of the group sharing each tile,
f32 softmax state in shared memory and the accumulator in registers; a
ragged last tile is cut inside the kernel, so W needs no padding."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "swa_decode"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "swa_decode_f32",
           torch.bfloat16: "swa_decode_bf16"}

# The kernel's limits: head width, and query rows x width per kv head
# (its per-thread accumulators).
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 8192


def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def swa_decode_attention(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                         bias: torch.Tensor, scale: float) -> torch.Tensor:
    """One-token attention over a window of cached keys, on the card.

    q: (b, h, dh); kw / vw: (b, W, kvh, dh), f32 or bf16 like q;
    bias: (b, W) f32, added to the scaled scores (0 valid, -1e30 not).
    Returns (b, h, dh) in q's dtype: the contract of
    ``kernels.ref.swa_decode_attention``."""
    global LAUNCHES
    _build.require(NAME, "q", q, _DTYPES, (3,))
    _build.require(NAME, "kw", kw, _DTYPES, (4,))
    _build.require(NAME, "vw", vw, _DTYPES, (4,))
    _build.require(NAME, "bias", bias, (torch.float32,), (2,))
    b, h, dh = q.shape
    W, kvh = kw.shape[1], kw.shape[2]
    if (kw.dtype != q.dtype or vw.dtype != q.dtype
            or tuple(kw.shape) != (b, W, kvh, dh) or vw.shape != kw.shape
            or tuple(bias.shape) != (b, W)
            or {kw.device, vw.device, bias.device} != {q.device}):
        raise ValueError(f"{NAME}: q {tuple(q.shape)} {q.dtype}, kw "
                         f"{tuple(kw.shape)} {kw.dtype}, vw "
                         f"{tuple(vw.shape)} {vw.dtype} and bias "
                         f"{tuple(bias.shape)} do not match (q (b, h, dh), "
                         f"kw/vw (b, W, kvh, dh) of q's dtype, bias (b, W), "
                         f"one device)")
    if W < 1 or kvh < 1 or h % kvh:
        raise ValueError(f"{NAME}: W={W} and kvh={kvh} must be >= 1 and kvh "
                         f"must divide h={h}")
    if dh > MAX_HEAD_DIM or (h // kvh) * dh > MAX_GROUP_WIDTH:
        raise ValueError(f"{NAME}: head_dim {dh} (at most {MAX_HEAD_DIM}) or "
                         f"group {h // kvh} x {dh} (at most "
                         f"{MAX_GROUP_WIDTH}) is beyond the kernel")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _fn(q.dtype)(q.data_ptr(), kw.data_ptr(), vw.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), b, h, W, kvh, dh,
                       float(scale),
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return out
