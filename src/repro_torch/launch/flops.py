"""Dtype-aware matmul flop counting of the ops that execute (counterpart
of ``repro/launch/jaxpr_flops.py``).

The reference walks a jaxpr, multiplying each scan body by its trip
count. Here a ``TorchDispatchMode`` sees every aten op as it runs, on
any device (``meta`` included, where nothing is computed), so a Python
chunk loop, a microbatch loop or ``torch.utils.checkpoint``'s recompute
in the backward is charged as often as it runs. ``aten.mm``, ``bmm``,
``addmm``, ``baddbmm`` and ``convolution`` are charged by their matrix
operands' dtype: f32 (or f64) products as "f32", every other dtype as
"bf16".

The same mode sums each executed op's operand and result bytes (view
ops move nothing and are not counted). That is eager PyTorch's unfused
traffic: every elementwise pass reads and writes its tensors, so it is
larger than XLA's fused "bytes accessed" of the reference.

Counts are this process's: under a mesh each rank counts its own work.
"""
from __future__ import annotations

import math
from collections import Counter as _Tally
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten


def _dtype_key(dt: torch.dtype) -> str:
    return "f32" if dt in (torch.float32, torch.float64) else "bf16"


def _mm(a, b) -> float:
    # (m, k) @ (k, n)
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> float:
    # (B, m, k) @ (B, k, n)
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv(w, out) -> float:
    # out (N, O, *spatial), w (O, I / groups, *kernel)
    return 2.0 * math.prod(out.shape) * math.prod(w.shape[1:])


def _matmul_flops(func, args, out):
    """(flops, operand dtype) of a counted op, else None."""
    packet = func._overloadpacket
    if packet is aten.mm:
        return _mm(args[0], args[1]), args[0].dtype
    if packet is aten.addmm:
        return _mm(args[1], args[2]), args[1].dtype
    if packet is aten.bmm:
        return _bmm(args[0], args[1]), args[0].dtype
    if packet is aten.baddbmm:
        return _bmm(args[1], args[2]), args[1].dtype
    if packet is aten.convolution:
        return _conv(args[1], out), args[0].dtype
    return None


def _nbytes(tree) -> int:
    flat, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in flat
               if isinstance(t, torch.Tensor))


class Counter(TorchDispatchMode):
    """Counts, while active, the matmul flops by dtype (``flops``), the
    bytes each op reads and writes (``bytes``) and the calls of each
    counted op (``calls``)."""

    def __init__(self):
        super().__init__()
        self.flops = {"bf16": 0.0, "f32": 0.0}
        self.bytes = 0
        self.calls: _Tally = _Tally()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        mm = _matmul_flops(func, args, out)
        if mm is not None:
            f, dt = mm
            self.flops[_dtype_key(dt)] += f
            self.calls[func._overloadpacket.__name__] += 1
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def flops_by_dtype(fn, *args, **kwargs) -> Dict[str, float]:
    """{"bf16": ..., "f32": ...} matmul and convolution flops of
    ``fn(*args, **kwargs)`` as it executes (on ``meta`` tensors, shapes
    only)."""
    with Counter() as c:
        fn(*args, **kwargs)
    return dict(c.flops)


def effective_flops(fl: Dict[str, float], hw=None) -> float:
    """bf16-equivalent flops on the card: ``bf16 + f32 * peak_flops /
    peak_flops_f32``, so that ``effective / peak_flops`` is ``bf16 /
    989e12 + f32 / 67e12`` on the ``h100`` profile (the port's f32
    products run outside the tensor cores, TF32 off). The reference
    charges f32 twice (the TPU's MXU at half rate); that ratio is the
    TPU's, not the card's."""
    from repro_torch.launch.roofline import hw_profile
    if not isinstance(hw, dict):
        hw = hw_profile(hw)
    return (fl.get("bf16", 0.0)
            + fl.get("f32", 0.0) * hw["peak_flops"] / hw["peak_flops_f32"])
