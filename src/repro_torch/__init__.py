"""repro_torch — the PyTorch/CUDA port of ``repro`` (mini-batch SSCA
federated learning) for one NVIDIA H100.

The module layout mirrors ``repro``: ``data/``, ``core/``, ``mlpapp/``,
``fed/`` and ``kernels/``.  The package imports ``torch`` and numpy only;
it never imports ``jax`` or ``repro``.

**Device policy.**  Entry points (:func:`repro_torch.fed.runtime.run_alg1`,
the kernel wrappers in :mod:`repro_torch.kernels`) run on ``cuda`` unless
the caller passes ``device="cpu"``.  Without a GPU and without an explicit
``device`` they raise; they never drop to the CPU silently.
"""
from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, else what
    the caller names.  Raises when the default is asked for and no CUDA
    device is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_cuda(x: torch.Tensor, device: Device = None) -> bool:
    """Route a kernel wrapper's input: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (the plain version).  ``device`` is
    checked against where ``x`` lies, so a CPU tensor reaches the plain
    version only when the caller asked for the CPU."""
    want = resolve_device(device)
    if x.device.type != want.type:
        raise ValueError(
            f"tensor on {x.device} but device={want} was asked for")
    if want.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {want}")
    return want.type == "cuda"
