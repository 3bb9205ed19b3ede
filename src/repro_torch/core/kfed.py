"""k-means cost of a labelling (counterpart of
``repro/core/kfed.kmeans_cost_of_labels``).

The rest of ``repro/core/kfed.py`` (``kfed``, ``aggregate``,
``_kfed_impl``) is the JAX package's deprecated entry points over
``Session.run`` and ``core/server.aggregate``; the port's callers use
those directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def kmeans_cost_of_labels(data: torch.Tensor, labels: torch.Tensor,
                          k: int) -> torch.Tensor:
    """phi(T) (eq. 1) of any labelling. data: (..., n, d), flattened;
    labels at -1 are left out."""
    x = data.reshape(-1, data.shape[-1]).float()
    lb = labels.reshape(-1)
    sums, cnt = ops.kmeans_update(x, lb, k)
    mu = sums / torch.clamp(cnt, min=1.0)[:, None]
    diff = x - mu[torch.clamp(lb, 0, k - 1).long()]
    per = torch.sum(diff * diff, dim=1)
    return torch.sum(torch.where(lb >= 0, per, torch.zeros_like(per)))
