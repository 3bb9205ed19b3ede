"""The one source of random draws on the main path.

k-means++ seeding (``core/lloyd.kmeans_pp_init``) is the only random step
of the one-shot round and of the serve step. The JAX package draws it as
``jax.random.categorical(key, logits) = argmax(gumbel + logits)``; the
port takes the Gumbel noise from a ``GumbelSource`` and does the argmax
itself, so a caller that needs the JAX package's exact draws (the parity
tests) passes a source that computes them, and everything else uses the
default below.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


class GumbelSource:
    """Gumbel(0, 1) noise keyed by ``(seed, id)``.

    ``draw(ids, k_prime, n, device)`` returns (len(ids), k_prime, n) f32:
    row 0 is the first k-means++ pick of id ``ids[i]``, rows 1.. the
    later picks. The id is the device index in ``Session.run`` and the
    request id in serving, so a request's draws depend on its own
    ``(seed, id)`` only and batching never changes its labels. Each id
    has its own CPU ``torch.Generator``, so the draws are the same on
    every device.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _generator(self, i: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, int(i)]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device="cpu").manual_seed(int(state))

    def draw(self, ids: Sequence[int], k_prime: int, n: int,
             device) -> torch.Tensor:
        out = torch.empty((len(ids), k_prime, n), dtype=torch.float32)
        for row, i in enumerate(ids):
            u = torch.rand((k_prime, n), generator=self._generator(i))
            out[row] = -torch.log(-torch.log(u.clamp_min(_TINY)))
        return out.to(device)
