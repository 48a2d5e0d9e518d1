"""Federated tasks: the model-side contract consumed by the engine.

Built in: :class:`repro_torch.fed.tasks.mlp.MLPTask`, the paper's
Section-V MNIST MLP (the default task of :mod:`repro_torch.fed.runtime`),
and :class:`repro_torch.fed.tasks.transformer.LMTask` /
:func:`~repro_torch.fed.tasks.transformer.transformer_task`, a decoder-only
LM of the ``dense`` family trained as a federated next-token task, and
:func:`~repro_torch.fed.tasks.rwkv6.rwkv6_task`, the same over RWKV-6
(the ``ssm`` family).
"""
from repro_torch.fed.tasks.base import SumLoss, TaskData  # noqa: F401
from repro_torch.fed.tasks.mlp import MLPTask  # noqa: F401
from repro_torch.fed.tasks.transformer import (  # noqa: F401
    LMTask, transformer_task)
from repro_torch.fed.tasks.rwkv6 import rwkv6_task  # noqa: F401
