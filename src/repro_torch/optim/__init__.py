"""Optimizers over nested-dict parameter trees."""
from repro_torch.optim.sgd import (  # noqa: F401
    Optimizer,
    adamw,
    constant_schedule,
    cosine_schedule,
    make_optimizer,
    sgd_momentum,
)
