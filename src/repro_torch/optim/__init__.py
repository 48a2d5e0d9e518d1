"""Optimizers as (init, update) pairs: :mod:`repro_torch.optim.optimizers`."""
from repro_torch.optim.optimizers import momentum, sgd  # noqa: F401
