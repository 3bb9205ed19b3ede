"""Optimizers and learning-rate schedules (counterpart of
``repro/optim``)."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,  # noqa
                                          build_optimizer,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,  # noqa
                                         warmup_cosine)
