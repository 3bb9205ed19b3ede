"""Wrapper of the sliding-window decode attention CUDA kernels
(``csrc/swa_decode.cu``; counterpart of ``swa_decode_attention`` in
``repro/kernels/swa_decode.py``).

Replaces the Pallas online-softmax kernel over window blocks. Bound by
bytes: every key and value of the window is read once. Design: a
split-window decode. The window of each (batch, kv head) is cut into S
chunks of at least 64 keys, S chosen by the launcher from b * kvh, W and
the card's SM count so that about twice as many blocks as SMs run (16
chunks of 256 keys at the Mixtral decode shape). Each block streams its
chunk with 16-byte loads straight into registers, several key steps in
flight per warp and no block barrier in the key loop, keeps the f32
softmax state in registers, and writes its partial (m, l, acc) to a
scratch buffer that this wrapper allocates; a second kernel merges the
chunks of each query row in chunk order (no float atomics, so two calls
give the same bits). With S = 1 the first kernel writes the output
itself. One call launches both kernels and counts one launch.

A rank of a context-parallel decode cache (``launch/sharding.
seq_block``) holds a block of the ring's slots: :func:`swa_decode_partial`
runs the split kernel alone over that block and returns its chunks'
states (S = 1 included), and :func:`swa_combine`, the combine kernel on
its own, merges the states the ranks gathered, rank after rank. Each
rank's S is capped at ``MAX_SPLITS`` over the ranks, because the
combine holds every chunk's state of a row in shared memory. Each of the
two counts its own launches (``PARTIAL``, ``COMBINE``)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "swa_decode"
LAUNCHES = 0  # launches of the kernel in this process


class Count:
    """The launches of one more entry point of the library, counted
    under its own name (``kernels.ops.launch_counts``)."""

    def __init__(self, name: str):
        self.NAME = name
        self.LAUNCHES = 0


PARTIAL = Count("swa_decode_partial")
COMBINE = Count("swa_combine")

_DTYPES = {torch.float32: "swa_decode_f32",
           torch.bfloat16: "swa_decode_bf16"}
_PARTIAL = {torch.float32: "swa_decode_partial_f32",
            torch.bfloat16: "swa_decode_partial_bf16"}
_COMBINE = {torch.float32: "swa_combine_f32",
            torch.bfloat16: "swa_combine_bf16"}

# The kernel's limits: head width (a lane holds at most 8 pieces of a
# row), and query rows x width per kv head.
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 8192
# The most chunk states the combine merges for one query row (kMaxSplits).
MAX_SPLITS = 32


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load(NAME), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _partial_fn(dtype):
    fn = getattr(_build.load(NAME), _PARTIAL[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _combine_fn(dtype):
    fn = getattr(_build.load(NAME), _COMBINE[dtype])
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def splits(b: int, h: int, W: int, kvh: int, device) -> int:
    """The number of window chunks S a launch of this shape takes on
    CUDA ``device``, as the kernel's launcher chooses it."""
    index = torch.device(device).index
    return _splits(b, h, W, kvh,
                   torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=256)
def _splits(b: int, h: int, W: int, kvh: int, index: int) -> int:
    fn = _build.load(NAME).swa_decode_splits
    fn.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_int]
    fn.restype = ctypes.c_int64
    n = fn(b, h, W, kvh, index)
    if n < 1:
        raise RuntimeError(f"{NAME}: choosing the window split failed with "
                           f"cudaError_t {-n}")
    return n


def _check(q, kw, vw, bias):
    """Refuse operands the split kernel does not take; (b, h, dh, W,
    kvh)."""
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
    return b, h, dh, W, kvh


def swa_decode_attention(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                         bias: torch.Tensor, scale: float) -> torch.Tensor:
    """One-token attention over a window of cached keys, on the card.

    q: (b, h, dh); kw / vw: (b, W, kvh, dh), f32 or bf16 like q;
    bias: (b, W) f32, added to the scaled scores (0 valid, -1e30 not).
    Returns (b, h, dh) in q's dtype: the contract of
    ``kernels.ref.swa_decode_attention``."""
    global LAUNCHES
    b, h, dh, W, kvh = _check(q, kw, vw, bias)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    S = splits(b, h, W, kvh, q.device)
    # Each chunk's state of each query row: m, l and acc (dh), in f32.
    part = torch.empty((b * h * S * (dh + 2) if S > 1 else 0,),
                       dtype=torch.float32, device=q.device)
    err = _fn(q.dtype)(q.data_ptr(), kw.data_ptr(), vw.data_ptr(),
                       bias.data_ptr(), part.data_ptr(), out.data_ptr(), b,
                       h, W, kvh, dh, S, float(scale),
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    LAUNCHES += 1
    return out


def swa_decode_partial(q: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                       bias: torch.Tensor, scale: float, *, ranks: int = 1,
                       chunks: Optional[int] = None) -> torch.Tensor:
    """The split kernel alone, on the card: the softmax state of each of
    S chunks of the window, (b * h, S, dh + 2) f32 (m, l, acc), the
    contract of ``kernels.ref.swa_decode_partial``. S is ``chunks``, or
    the launcher's choice for this shape capped at ``MAX_SPLITS //
    ranks`` (``ranks``: how many ranks' states one combine will merge).
    Operands as :func:`swa_decode_attention`'s."""
    b, h, dh, W, kvh = _check(q, kw, vw, bias)
    if not 1 <= ranks <= MAX_SPLITS:
        raise ValueError(f"{PARTIAL.NAME}: ranks={ranks} must be in [1, "
                         f"{MAX_SPLITS}]")
    S = chunks or min(splits(b, h, W, kvh, q.device), MAX_SPLITS // ranks)
    if not 1 <= S <= min(W, MAX_SPLITS // ranks):
        raise ValueError(f"{PARTIAL.NAME}: {S} chunks of a window of {W} "
                         f"for {ranks} ranks (at most {MAX_SPLITS} in all)")
    part = torch.empty((b * h, S, dh + 2), dtype=torch.float32,
                       device=q.device)
    if part.numel() == 0:
        return part
    err = _partial_fn(q.dtype)(
        q.data_ptr(), kw.data_ptr(), vw.data_ptr(), bias.data_ptr(),
        part.data_ptr(), b, h, W, kvh, dh, S, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(PARTIAL.NAME, err)
    PARTIAL.LAUNCHES += 1
    return part


def swa_combine(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel alone, on the card: rows' S chunk states
    (rows, S, dh + 2) f32 merged in chunk order (``kernels.ref.
    merge_states``) -> (rows, dh) in ``dtype`` (f32 or bf16)."""
    _build.require(COMBINE.NAME, "part", part, (torch.float32,), (3,))
    if dtype not in _DTYPES:
        raise ValueError(f"{COMBINE.NAME}: dtype {dtype}, the kernel writes "
                         f"{list(_DTYPES)}")
    rows, S, ps = part.shape
    dh = ps - 2
    if not (1 <= S <= MAX_SPLITS and 1 <= dh <= MAX_HEAD_DIM):
        raise ValueError(f"{COMBINE.NAME}: {S} chunk states of width {dh} "
                         f"(at most {MAX_SPLITS} of {MAX_HEAD_DIM})")
    out = torch.empty((rows, dh), dtype=dtype, device=part.device)
    if rows == 0:
        return out
    err = _combine_fn(dtype)(
        part.data_ptr(), out.data_ptr(), rows, dh, S,
        torch.cuda.current_stream(part.device).cuda_stream)
    _build.check(COMBINE.NAME, err)
    COMBINE.LAUNCHES += 1
    return out
