"""The port's MLP against the reference, from the same weights.

The weights are carried across with ``params_from_numpy`` (the port does
not reproduce ``jax.random.normal``).  Float tolerance: the two
frameworks sum the matrix products and the softmax in different orders.
Measured on the CPU at these shapes: logits agree to 1.3e-7 and
per-client gradients to 1.5e-7 of their largest magnitude.  Tolerances: rtol 1e-5, and atol 1e-5 of the largest
magnitude for the gradients (whose small entries carry cancellation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import grad, vmap

from repro.fed.tasks import mlp as jtask
from repro.mlpapp import model as jm
from repro_torch.fed.tasks import mlp as ttask
from repro_torch.mlpapp import model as tm


def _setup(k=64, j=32, l=10, n=24):
    p = jm.init_params(jax.random.key(0), k, j, l)
    rng = np.random.default_rng(0)
    x = rng.random((n, k), dtype=np.float32)
    y = np.eye(l, dtype=np.float32)[rng.integers(0, l, n)]
    return p, x, y


def test_params_round_trip():
    p, _, _ = _setup()
    tp = tm.params_from_numpy(p, device="cpu")
    assert tp["w1"].shape == (32, 64) and tp["w2"].shape == (10, 32)
    back = jm.MLPParams(*tm.params_to_numpy(tp))
    for a, b in zip(back, p):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_logits_and_losses_match():
    p, x, y = _setup()
    tp = tm.params_from_numpy(p, device="cpu")
    np.testing.assert_allclose(tm.logits(tp, torch.tensor(x)).numpy(),
                               np.asarray(jm.logits(p, x)), rtol=1e-5,
                               atol=1e-6)
    # the nn.Module wraps the same weights and function
    np.testing.assert_array_equal(
        tm.MLP(tp)(torch.tensor(x)).detach().numpy(),
        tm.logits(tp, torch.tensor(x)).numpy())
    w = np.linspace(0.01, 0.1, len(x)).astype(np.float32)
    want = jtask.MLPTask(64, 32, 10).loss_sum(p, (x, y, w))
    got = ttask.MLPTask(64, 32, 10).loss_sum(
        tp, (torch.tensor(x), torch.tensor(y), torch.tensor(w)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    m_want = jtask.MLPTask(64, 32, 10).measure(p, x, y, x, y)
    m_got = ttask.MLPTask(64, 32, 10).measure(tp, *map(torch.tensor,
                                                       (x, y, x, y)))
    for k in ("train_cost", "test_accuracy", "sparsity"):
        np.testing.assert_allclose(m_got[k].item(), float(m_want[k]),
                                   rtol=1e-5)


def test_per_client_gradients_match():
    p, x, y = _setup()
    clients, b = 4, 6
    xb, yb = x.reshape(clients, b, -1), y.reshape(clients, b, -1)
    ws = np.repeat(np.float32([0.1, 0.2, 0.3, 0.4])[:, None], b, 1)
    jt, tt = jtask.MLPTask(64, 32, 10), ttask.MLPTask(64, 32, 10)
    want = jax.vmap(jax.grad(jt.loss_sum), in_axes=(None, 0))(
        p, (jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(ws)))
    tp = tm.params_from_numpy(p, device="cpu")
    got = vmap(grad(tt.loss_sum), in_dims=(None, 0))(
        tp, tuple(map(torch.tensor, (xb, yb, ws))))
    for k, ref in (("w1", want.w1), ("w2", want.w2)):
        ref = np.asarray(ref)
        assert got[k].shape == ref.shape
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
