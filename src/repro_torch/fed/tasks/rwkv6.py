"""RWKV-6 (the attention-free ``ssm`` family) as a federated task.

The port of ``repro/fed/tasks/rwkv6.py``: the same LM machinery as
:mod:`repro_torch.fed.tasks.transformer`, another model family.  The
forward is the RWKV-6 time-mix / channel-mix stack
(:mod:`repro_torch.models.rwkv6`), whose WKV scan runs on the
hand-written kernel for CUDA tensors, so the client upload is a tree of
stacked mix vectors, decay LoRAs and WKV projections.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.fed.tasks.transformer import LMTask


def rwkv6_task(*, layers: int = 2, d_model: int = 64, d_ff: int = 128,
               vocab: int = 128, seq_len: int = 32) -> LMTask:
    """A reduced RWKV-6 next-token task (4 heads of d_model / 4) sized
    for CPU-scale federated rounds."""
    cfg = reduced(get_config("rwkv6-7b"), layers=layers, d_model=d_model,
                  d_ff=d_ff, vocab=vocab)
    return LMTask(cfg=cfg, seq_len=seq_len)
