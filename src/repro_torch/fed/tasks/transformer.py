"""Decoder-only language models as federated tasks.

The port of ``repro/fed/tasks/transformer.py``: :class:`LMTask` wraps a
:class:`repro_torch.configs.base.ModelConfig` of a family the port builds
(``dense``, ``moe``, ``ssm`` and ``hybrid`` so far) as next-token
prediction.  Each client holds token sequences and uploads the
per-sample-weighted gradient of the sequence-mean cross-entropy; the
server runs the same SSCA recursions as for the paper's MLP.  The MoE
load-balance loss is dropped from the federated objective, as the
reference's task drops it (its loss goes through ``forward``).

``batch`` layout: ``x`` and ``y`` both carry the (B, S) int32 token
matrix (the loss shifts internally), so the engine's (x, y[, w]) triple
needs no special case.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.data import synthetic
from repro_torch.fed.tasks.base import TaskData
from repro_torch.models import build_model


@dataclasses.dataclass(frozen=True)
class LMTask:
    """Next-token prediction over a model-zoo config."""
    cfg: ModelConfig
    seq_len: int = 32

    metric_names = ("train_cost", "test_accuracy")

    @property
    def name(self) -> str:
        return self.cfg.name

    def _model(self):
        return build_model(self.cfg)

    def init_params(self, generator: torch.Generator):
        """Parameters drawn from ``generator``, on its device."""
        return self._model().init(generator, device=generator.device)

    def _per_example_ce(self, params, tokens) -> torch.Tensor:
        """Per-sequence mean next-token cross-entropy, (B,) f32; the
        log-softmax runs over the padded vocabulary, as the reference's
        does."""
        logits = self._model().forward(params, {"tokens": tokens})
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = tokens[:, 1:].long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        return torch.mean(nll, dim=-1)

    def loss_sum(self, params, batch) -> torch.Tensor:
        """Σ_n w_n ℓ_n with ℓ_n the sequence-mean CE: additive in the
        batch, so the super-batch shortcut and the per-client secure
        upload are both exact."""
        x, _, w = batch
        return torch.sum(w * self._per_example_ce(params, x))

    def mean_loss(self, params, batch) -> torch.Tensor:
        x, _ = batch
        return torch.mean(self._per_example_ce(params, x))

    def measure(self, params, x_tr, y_tr, x_te, y_te):
        del y_tr, y_te
        logits = self._model().forward(params, {"tokens": x_te})
        pred = torch.argmax(logits[:, :-1].float(), dim=-1)
        acc = torch.mean((pred == x_te[:, 1:].long()).float())
        return {"train_cost": torch.mean(self._per_example_ce(params, x_tr)),
                "test_accuracy": acc}

    def default_data(self, n_train: int = 512, n_test: int = 128,
                     seed: int = 0) -> TaskData:
        docs = synthetic.token_dataset(n_train + n_test, self.seq_len,
                                       self.cfg.vocab_size, seed=seed)
        x_tr, x_te = docs[:n_train], docs[n_train:]
        # tokens double as their own labels (the loss shifts internally)
        return TaskData(x_tr, x_tr, x_te, x_te)


def transformer_task(arch: str = "llama3-8b", *, layers: int = 2,
                     d_model: int = 64, d_ff: int = 128, vocab: int = 128,
                     seq_len: int = 32) -> LMTask:
    """A reduced decoder-only LM (same family and wiring as ``arch``)
    sized for CPU-scale federated rounds."""
    cfg = reduced(get_config(arch), layers=layers, d_model=d_model,
                  d_ff=d_ff, vocab=vocab)
    return LMTask(cfg=cfg, seq_len=seq_len)
