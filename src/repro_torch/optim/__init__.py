"""Optimizers on the fleet plane — the counterpart of ``repro.optim``."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, adam, make_optimizer, momentum, rmsprop, sgd,
)
