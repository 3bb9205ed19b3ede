"""The sources of random draws.

k-means++ seeding (``core/lloyd.kmeans_pp_init``) is the only random step
of the one-shot round and of the serve step, and sampled decoding
(``launch/serve.generate`` with ``greedy=False``) the only one of LM
serving. The JAX package draws both as ``jax.random.categorical(key,
logits) = argmax(gumbel + logits)``; the port takes the Gumbel noise
from a source (``GumbelSource`` for k-means++, ``StepGumbel`` for
decoding) and does the argmax itself, so a caller that needs the JAX
package's exact draws (the parity tests) passes a source that computes
them, and everything else uses the defaults below.
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

    def draw(self, ids: Sequence[int], k_prime: int, n: int,
             device) -> torch.Tensor:
        out = torch.empty((len(ids), k_prime, n), dtype=torch.float32)
        for row, i in enumerate(ids):
            out[row] = _gumbel((k_prime, n), self.seed, i)
        return out.to(device)


class StepGumbel:
    """Gumbel(0, 1) noise for sampled decoding, keyed by ``(seed, step)``.

    ``draw(step, shape, dtype, device)`` returns the noise that decode
    step ``step`` (0 for the token after the first decode step) adds to
    its logits of ``shape``, in their ``dtype``, as
    ``jax.random.gumbel(k, shape, dtype)`` gives it for the step's key
    ``k`` in the JAX package. Drawn from a CPU ``torch.Generator`` in
    f32, so the tokens are the same on every device.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def draw(self, step: int, shape, dtype: torch.dtype,
             device) -> torch.Tensor:
        return _gumbel(tuple(shape), self.seed, step).to(device, dtype)


def _gumbel(shape, seed: int, i: int) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape`` in f32 from the generator of
    ``(seed, i)``."""
    state = np.random.SeedSequence([seed, int(i)]).generate_state(
        1, np.uint64)[0]
    u = torch.rand(shape, generator=torch.Generator(
        device="cpu").manual_seed(int(state)))
    return -torch.log(-torch.log(u.clamp_min(_TINY)))
