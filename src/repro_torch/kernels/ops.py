"""Dispatch over the port's kernels (counterpart of
``repro/kernels/ops.py``).

The device of the data decides, and nothing else: a CPU tensor goes to
the plain version in ``kernels/ref.py``; a CUDA tensor goes to the
hand-written kernel, which launches or raises. There is no fallback
from one to the other and no switch that routes CUDA tensors to the
plain version. Operands are made contiguous here, because the kernel
wrappers refuse strided tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import kmeans_update as _ku
from repro_torch.kernels import pdist_argmin as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import solve_attach as _sa

# Row count above which assign_argmin streams fixed-size chunks through
# the kernel instead of one monolithic call (repro/kernels/ops.py).
CHUNK_ROWS = 1 << 18

_WRAPPERS = (_pa, _ku, _sa)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {m.NAME: m.LAUNCHES for m in _WRAPPERS}


def reset_launch_counts() -> None:
    for m in _WRAPPERS:
        m.LAUNCHES = 0


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    # The full distance matrix is a plain product outside any kernel.
    return _ref.pairwise_sq_dists(x, c)


def _assign_argmin_one(x, c, c_mask):
    if x.device.type == "cpu":
        return _ref.assign_argmin(x, c, c_mask)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _pa.pdist_argmin(x.contiguous(), c.to(x.dtype).contiguous(),
                            None if c_mask is None else c_mask.contiguous())


def assign_argmin(x: torch.Tensor, c: torch.Tensor,
                  c_mask: Optional[torch.Tensor] = None):
    """Nearest center of every point: (idx (..., n) int32,
    min_sq_dist (..., n) f32). Above ``CHUNK_ROWS`` rows the points
    stream through in fixed-size chunks, bounding the working set."""
    n = x.shape[-2]
    if n <= CHUNK_ROWS:
        return _assign_argmin_one(x, c, c_mask)
    parts = [_assign_argmin_one(x[..., lo:lo + CHUNK_ROWS, :], c, c_mask)
             for lo in range(0, n, CHUNK_ROWS)]
    return (torch.cat([p[0] for p in parts], dim=-1),
            torch.cat([p[1] for p in parts], dim=-1))


def kmeans_update(x: torch.Tensor, assign: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None):
    """Per-cluster sums and counts: (sums (..., k, d) f32,
    counts (..., k) f32)."""
    if x.device.type == "cpu":
        return _ref.kmeans_update(x, assign, k, weights)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _ku.kmeans_update(
        x.contiguous(), assign.to(torch.int32).contiguous(), k,
        None if weights is None else weights.float().contiguous())


def solve_attach(x: torch.Tensor, centers0: torch.Tensor, tau: torch.Tensor,
                 center_mask: Optional[torch.Tensor] = None,
                 point_mask: Optional[torch.Tensor] = None,
                 *, max_iters: int = 100, dtype: str = "f32"):
    """The fused serve step (bounded Lloyd, Theorem 3.2 attach,
    Definition 3.3 labels) for a (B, n, d) request batch. ``dtype``:
    "f32" or "bf16" storage, f32 accumulation either way."""
    if x.device.type == "cpu":
        return _ref.solve_attach(x, centers0, tau, center_mask, point_mask,
                                 max_iters=max_iters, dtype=dtype)
    store = _ref.store_dtype(dtype)
    B, n, _ = x.shape
    kp = centers0.shape[1]
    cm = (torch.ones((B, kp), dtype=torch.bool, device=x.device)
          if center_mask is None else center_mask)
    pm = (torch.ones((B, n), dtype=torch.bool, device=x.device)
          if point_mask is None else point_mask)
    return _sa.solve_attach(
        x.to(store).contiguous(), centers0.to(store).contiguous(),
        tau.to(store).contiguous(), cm.contiguous(), pm.contiguous(),
        max_iters=max_iters)
