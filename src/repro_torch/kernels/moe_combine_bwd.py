"""Wrapper of the combine's backward CUDA kernel
(``csrc/moe_combine_bwd.cu``).

No Pallas kernel stands behind it: the JAX package trains through
``repro/kernels/ref.py``'s ``moe_combine``, which XLA differentiates.
This kernel gives a training step on the card the gradient of the
combine's slot rows and gates in gather form (``kernels.ref.
moe_combine_bwd``), so that the MoE layer's backward launches no library
scatter. Bound by bytes: for each valid slot its token's f32 gradient
row and its ybuf row read, every slot's gradient row written. Design:
one block a slot, 16-byte pieces where aligned, the dot reduced in a
fixed order (so two calls give the same bits).

The backward of ``moe_dispatch`` needs no kernel of its own: it is the
combine of the queues' gradient with the keep mask as 0/1 gates, and
goes through ``kernels/moe_combine.py`` (see ``kernels.ops``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "moe_combine_bwd"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "moe_combine_bwd_f32",
           torch.bfloat16: "moe_combine_bwd_bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_combine_bwd(dout: torch.Tensor, ybuf: torch.Tensor,
                    src_entry: torch.Tensor, valid: torch.Tensor,
                    w: torch.Tensor, top_k: int):
    """The combine's gradients, on the card.

    dout: (T, d) f32; ybuf: (S, d) f32 or bf16; src_entry: (S,) int32,
    the entry owning each valid slot; valid: (S,) bool; w: (T*top_k,)
    f32, the gates the forward took. Returns (dybuf (S, d) in ybuf's
    dtype, dgates (T*top_k,) f32): the contract of
    ``kernels.ref.moe_combine_bwd``, dybuf bit for bit, dgates summed in
    another (fixed) order."""
    global LAUNCHES
    _build.require(NAME, "dout", dout, (torch.float32,), (2,))
    _build.require(NAME, "ybuf", ybuf, _DTYPES, (2,))
    _build.require(NAME, "src_entry", src_entry, (torch.int32,), (1,))
    _build.require(NAME, "valid", valid, (torch.bool,), (1,))
    _build.require(NAME, "w", w, (torch.float32,), (1,))
    top_k = int(top_k)
    S, d = ybuf.shape
    T = dout.shape[0]
    if top_k < 1 or w.shape[0] != T * top_k or dout.shape[1] != d:
        raise ValueError(f"{NAME}: dout {tuple(dout.shape)}, ybuf "
                         f"{tuple(ybuf.shape)} and w {tuple(w.shape)} do not "
                         f"match at top_k={top_k}")
    if src_entry.shape != (S,) or valid.shape != (S,) or len(
            {dout.device, ybuf.device, src_entry.device, valid.device,
             w.device}) != 1:
        raise ValueError(f"{NAME}: src_entry {tuple(src_entry.shape)} and "
                         f"valid {tuple(valid.shape)} must be ({S},) and "
                         f"every operand on one device")
    dybuf = torch.empty_like(ybuf)
    dgates = torch.zeros((T * top_k,), dtype=torch.float32,
                         device=ybuf.device)
    if dybuf.numel() == 0:
        return dybuf, dgates
    piece = 16 // ybuf.element_size()
    vec = (d % piece == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (dout, ybuf, dybuf)))
    err = _fn(ybuf.dtype)(dout.data_ptr(), ybuf.data_ptr(),
                          src_entry.data_ptr(), valid.data_ptr(),
                          w.data_ptr(), dybuf.data_ptr(), dgates.data_ptr(),
                          S, T, d, top_k, int(vec),
                          torch.cuda.current_stream(ybuf.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return dybuf, dgates
