"""Wrapper of the fused serve-step CUDA kernel
(``csrc/solve_attach.cu``; counterpart of
``repro/kernels/solve_attach.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "solve_attach"
LAUNCHES = 0  # launches of the kernel in this process

# Dynamic shared memory one block (one request) may use on Hopper.
MAX_SMEM_BYTES = 232448

_DTYPES = {torch.float32: "solve_attach_f32",
           torch.bfloat16: "solve_attach_bf16"}


def _lib():
    lib = _build.load(NAME)
    lib.solve_attach_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.solve_attach_smem_bytes.restype = ctypes.c_longlong
    return lib


def _fn(dtype):
    fn = getattr(_lib(), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def solve_attach(x: torch.Tensor, centers0: torch.Tensor, tau: torch.Tensor,
                 center_mask: torch.Tensor, point_mask: torch.Tensor,
                 *, max_iters: int):
    """The fused serve step on the card, one block per request.

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
    smem = _lib().solve_attach_smem_bytes(n, kp, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{NAME}: a request of n={n}, k'={kp}, d={d} needs "
                         f"{smem} bytes of shared memory, above the "
                         f"{MAX_SMEM_BYTES} a block may use")
    dev = x.device
    labels = torch.empty((B, n), dtype=torch.int32, device=dev)
    mind = torch.empty((B, n), dtype=torch.float32, device=dev)
    centers = torch.empty((B, kp, d), dtype=torch.float32, device=dev)
    clbl = torch.empty((B, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return labels, mind, centers, clbl
    err = _fn(x.dtype)(
        x.data_ptr(), centers0.data_ptr(), tau.data_ptr(),
        center_mask.data_ptr(), point_mask.data_ptr(), labels.data_ptr(),
        mind.data_ptr(), centers.data_ptr(), clbl.data_ptr(),
        B, n, kp, k, d, int(max_iters),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return labels, mind, centers, clbl
