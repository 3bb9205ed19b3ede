"""Per-cluster personalization (counterpart of
``repro/fed/personalize.py``): the majority vote that assigns a request
(or device) one cluster from its per-point labels. The routed serving
step routes by it."""
from __future__ import annotations

import torch


def majority_vote(labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row majority cluster. labels: (Z, n) int with -1 for masked
    points; returns (Z,) int32. Counts are a fixed-order one-hot sum
    (no bincount), and ties go to the smallest cluster id, as in the
    reference; a row with no valid point votes 0."""
    cols = torch.arange(k, device=labels.device, dtype=labels.dtype)
    counts = torch.sum((labels.unsqueeze(-1) == cols).float(), dim=1)
    # torch.argmax returns the first maximal index, like jnp.argmax.
    return torch.argmax(counts, dim=1).to(torch.int32)
