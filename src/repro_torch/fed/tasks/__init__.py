"""Federated tasks: the model-side contract consumed by the engine.

Built in: :class:`repro_torch.fed.tasks.mlp.MLPTask`, the paper's
Section-V MNIST MLP (the default task of :mod:`repro_torch.fed.runtime`).
"""
from repro_torch.fed.tasks.base import SumLoss, TaskData  # noqa: F401
from repro_torch.fed.tasks.mlp import MLPTask  # noqa: F401
