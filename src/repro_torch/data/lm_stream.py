"""The synthetic token stream of ``examples/train_lm.py``, from a numpy
generator: an order-2 language where the next token is
``(3 * tok + 7) % vocab``, with 2% of the tokens moved up by one, so a
model's loss falls fast."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_batches(seed: int, vocab: int, B: int, S: int,
                      steps: int) -> Iterator[Dict[str, np.ndarray]]:
    """``steps`` batches of {"tokens" (B, S-1), "labels" (B, S-1)}
    int32, the labels the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = np.empty((B, S), dtype=np.int64)
        toks[:, 0] = rng.integers(0, vocab, size=B)
        for i in range(1, S):
            toks[:, i] = (3 * toks[:, i - 1] + 7) % vocab
        noise = rng.random((B, S)) < 0.02
        toks = np.where(noise, (toks + 1) % vocab, toks).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
