"""Wrapper of the weighted re-assembly CUDA kernel
(``csrc/moe_combine.cu``; counterpart of ``_moe_combine`` in
``repro/kernels/moe_dispatch.py``).

Replaces the Pallas scalar-prefetch gather-and-accumulate. Bound by
bytes: top_k rows of ybuf read, one f32 row written per token. Design:
a thread owns a 16-byte piece of a row (8 bf16 or 4 f32 columns; one
column where d is not a multiple of the piece or ybuf's base is not
16-byte aligned), a block takes chunks of one or more tokens' rows in
whole warps, each warp loads its token's slots and gates once and
shares them by shuffles, every choice's load is in flight before the first
multiply, and the sum over the choices stays in registers in j order,
each product and sum rounded on its own (no FMA contraction). The CUDA
source plans the launch from the shape and the card (``make_plan``
in ``csrc/moe_plan.cuh``; :func:`plan` reports it)."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

NAME = "moe_combine"
LAUNCHES = 0  # launches of the kernel in this process

_DTYPES = {torch.float32: "moe_combine_f32",
           torch.bfloat16: "moe_combine_bf16"}


class Plan(NamedTuple):
    """How the kernel lays out one call on one card."""
    columns: int    # columns of a thread's piece (1: the scalar path)
    pieces: int     # pieces of a row
    chunks: int     # chunks a row is cut into
    chunk: int      # threads a chunk, one piece each, in whole warps
    tokens: int     # tokens a block
    unrolled: int   # choices unrolled (top_k in {1, 2, 4, 8}; 0: stages)
    stages: int     # stages of up to 8 choices
    threads: int    # threads of a block
    blocks: int
    sms: int

    def describe(self) -> str:
        path = ("scalar, one column a thread" if self.columns == 1 else
                f"vector, {self.columns} columns (16 bytes) a thread")
        choices = (f"{self.unrolled} choices unrolled" if self.unrolled
                   else f"{self.stages} stages of 8 choices")
        return (f"{path}; {self.pieces} pieces a row in {self.chunks} "
                f"chunk(s) of {self.chunk} threads; {self.tokens} token(s) "
                f"a block; {choices}; {self.blocks} blocks of "
                f"{self.threads} threads on {self.sms} SMs")


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(T: int, d: int, top_k: int, dtype, device) -> Plan:
    """The launch that the kernel makes for T tokens of d columns at
    top_k from a 16-byte aligned ybuf of ``dtype`` on CUDA ``device``."""
    index = torch.device(device).index
    esize = torch.empty((), dtype=dtype).element_size()
    return _plan(NAME, T, d, top_k, esize, _vector(d, esize, True),
                 torch.cuda.current_device() if index is None else index)


def _vector(d: int, esize: int, aligned: bool) -> bool:
    """Whether a call takes the 16-byte vector path."""
    return aligned and (d * esize) % 16 == 0


@functools.lru_cache(maxsize=256)
def _plan(name, T, d, top_k, esize, vec, index) -> Plan:
    """The plan that kernel ``name`` (this one, or another that shares
    its launch: ``csrc/moe_plan.cuh``) makes on card ``index``."""
    fn = getattr(_build.load(name), f"{name}_plan")
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 10)()
    with torch.cuda.device(index):
        err = fn(T, d, top_k, esize, int(vec), out)
    if err != 0:
        raise RuntimeError(f"{name}: planning the launch of {T} tokens of "
                           f"{d} columns at top_k={top_k} failed with "
                           f"cudaError_t {err} (too many blocks)")
    return Plan(*out)


def moe_combine(ybuf: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                top_k: int) -> torch.Tensor:
    """Weighted re-assembly, on the card.

    ybuf: (S, d) f32 or bf16; slot: (T*top_k,) int32 (clipped to
    [0, S)); gates: (T*top_k,) f32. Returns (T, d) f32, the contract of
    ``kernels.ref.moe_combine``: bit for bit for top_k <= 2, and the
    sequential sum over j (each product rounded, then added) for any
    top_k."""
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
    vec = _vector(d, ybuf.element_size(), ybuf.data_ptr() % 16 == 0)
    err = _fn(ybuf.dtype)(ybuf.data_ptr(), slot.data_ptr(), gates.data_ptr(),
                          out.data_ptr(), S, T, d, top_k, int(vec),
                          torch.cuda.current_stream(ybuf.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return out
