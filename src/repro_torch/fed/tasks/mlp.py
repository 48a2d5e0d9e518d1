"""The paper's Section-V MNIST MLP as a federated task.

The port of ``repro/fed/tasks/mlp.py``; its losses and metrics delegate
to :mod:`repro_torch.mlpapp.model`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.data import synthetic
from repro_torch.fed.tasks.base import TaskData
from repro_torch.mlpapp import model as mlp


@dataclasses.dataclass(frozen=True)
class MLPTask:
    """Three-layer swish/softmax classifier, eq. (9)/(10): ``k``/``l`` are
    the input/label widths, ``hidden`` the paper's J."""
    k: int = 784
    hidden: int = 128
    l: int = 10

    name = "mlp"
    metric_names = ("train_cost", "test_accuracy", "sparsity")

    def init_params(self, generator: torch.Generator) -> mlp.Params:
        return mlp.init_params(generator, self.k, self.hidden, self.l)

    def loss_sum(self, params, batch) -> torch.Tensor:
        """Σ_n w_n · ce_n — grad = ĝ^t of eq. (2) with exact paper weights."""
        x, y, w = batch
        logp = torch.log_softmax(mlp.logits(params, x), dim=-1)
        return -torch.sum(w * torch.sum(y * logp, dim=-1))

    def measure(self, params, x_tr, y_tr, x_te, y_te):
        return {"train_cost": mlp.cross_entropy(params, (x_tr, y_tr)),
                "test_accuracy": mlp.accuracy(params, x_te, y_te),
                "sparsity": mlp.sparsity(params)}

    def default_data(self, n_train: int = 60000, n_test: int = 10000,
                     seed: int = 0) -> TaskData:
        d = synthetic.classification_dataset(n_train=n_train, n_test=n_test,
                                             k=self.k, l=self.l, seed=seed)
        return TaskData(d.x_train, d.y_train, d.x_test, d.y_test)
