"""The port's engine leaves the caller's global precision setting alone.

``engine.run`` turns TF32 matrix products off for its own run (the
reference computes them in full f32) and restores the caller's
``torch.backends.cuda.matmul.allow_tf32`` on return, also when the run
raises, as the reference's ``engine.run`` changes no global setting.
"""
import pytest
import torch

from repro_torch.data import partition, synthetic
from repro_torch.fed import runtime


def _tiny_run(**kw):
    data = synthetic.classification_dataset(200, 50, seed=0)
    part = partition.iid(200, 4, seed=0)
    return runtime.run_alg1(data, part, batch_size=10, rounds=2,
                            eval_every=1, eval_samples=50, device="cpu", **kw)


@pytest.mark.parametrize("caller", [True, False])
def test_run_restores_the_callers_tf32_setting(caller, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller)
    _, hist = _tiny_run()
    assert len(hist.train_cost) == 2
    assert torch.backends.cuda.matmul.allow_tf32 is caller


def test_run_restores_the_tf32_setting_when_it_raises(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(TypeError):
        _tiny_run(compressor=object())
    assert torch.backends.cuda.matmul.allow_tf32 is True
