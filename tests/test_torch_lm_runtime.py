"""The port's ``run_alg1`` on the decoder-only LM tracks a live JAX run.

Configuration: ``transformer_task(seq_len=16, d_model=32, vocab=64)``
(llama3-8b reduced to 2 layers, 4 heads of 8, f32), 96 training and 24
test documents over 4 iid clients, B = 4, 4 rounds, eval every 2 rounds
on 48 documents, seed 1, τ = 2, λ = 0 and the fused server update, as
``examples/transformer_ssca.py --federated`` runs it; both sides start
from the reference's initial weights.  Cases: plain (the super-batch
path), secure, and secure with the example's ``qsgd(8)`` uploads.

Exact: the eval rounds, the flatten order of the parameter tree and
every field of the ledger (secure at I = 4: 657,968 uplink bytes per
round = 4 × (4 × 41,120 + 4 × 3)).  Within tolerance, with the largest
difference measured on the CPU:

* train cost: rtol 1e-4 (measured 2.7e-7 relative);
* final weights: 5e-5 absolute (measured 3.7e-8 plain, 2.6e-7 secure,
  6.1e-7 with qsgd(8)).  A gradient entry can land on the other side of a 2^-20
  grid rounding, and a qsgd level on the other side of its stochastic
  threshold; the reference's qsgd step also carries its inexact exp2
  (``ROADMAP.md``, queue 3);
* test accuracy: within one token flip of the 360 predicted test
  tokens (measured: equal up to f32 representation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.fed import compression as jcompression
from repro.fed import runtime as jruntime
from repro.fed.tasks import transformer_task as jtransformer_task
from repro_torch import tree
from repro_torch.fed import compression
from repro_torch.fed import runtime
from repro_torch.fed.tasks import transformer_task
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as tt

KW = dict(batch_size=4, rounds=4, eval_every=2, eval_samples=48, seed=1,
          tau=2.0, lam=0.0, fused=True)
TASK = dict(seq_len=16, d_model=32, vocab=64)


@pytest.fixture(scope="module")
def setup():
    jt = jtransformer_task(**TASK)
    data = jt.default_data(n_train=96, n_test=24, seed=0)
    part = jpartition.iid(96, 4, seed=0)
    p0 = jt.init_params(jax.random.key(3))
    return jt, data, part, p0


def test_flatten_order_is_the_reference_one(setup):
    _, _, _, p0 = setup
    pt = tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu")
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(p0)])
    np.testing.assert_array_equal(ops.flatten(pt).numpy(), want)
    padded = ops.flatten_padded(pt)
    assert padded.shape == (-(-want.size // 128), 128)
    np.testing.assert_array_equal(padded.reshape(-1)[:want.size].numpy(),
                                  want)
    assert not padded.reshape(-1)[want.size:].any()
    back = ops.unflatten(padded, pt)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(pt)))


CASES = [("plain", False, None), ("secure", True, None),
         ("secure_qsgd8", True, "qsgd8")]


@pytest.mark.parametrize("name,secure,comp", CASES,
                         ids=[c[0] for c in CASES])
def test_lm_run_alg1_tracks_jax(setup, name, secure, comp):
    jt, data, part, p0 = setup
    jcomp = jcompression.qsgd(8) if comp else None
    tcomp = compression.qsgd(8) if comp else None
    pj, hj = jruntime.run_alg1(data, part, task=jt, params=p0,
                               secure=secure, compressor=jcomp, **KW)
    before = fa.flash_attention_bhsd.launches
    pt, ht = runtime.run_alg1(
        data, part, task=transformer_task(**TASK),
        params=tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
        secure=secure, compressor=tcomp, device="cpu", **KW)
    assert fa.flash_attention_bhsd.launches == before   # the plain version
    assert ht.rounds == hj.rounds == [2, 4]
    assert ht.comm == hj.comm
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    if secure:
        assert ht.uplink_bytes_per_round == 4 * (4 * 41_120 + 4 * 3)
    assert set(ht.metrics) == {"train_cost", "test_accuracy"}
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-4)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, rtol=0,
                               atol=1 / 360 + 1e-6)
    got = tt.params_to_numpy(pt)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, pj))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=5e-5)
    assert ht.train_cost[-1] < ht.train_cost[0]


def test_lm_params_none_initializes_from_seed(setup):
    _, data, part, _ = setup
    kw = dict(KW, rounds=2, secure=True)
    runs = [runtime.run_alg1(data, part, task=transformer_task(**TASK),
                             device="cpu", **kw) for _ in range(2)]
    for a, b in zip(*(tree.leaves(p) for p, _ in runs)):
        assert torch.equal(a, b)
    assert runs[0][1].train_cost == runs[1][1].train_cost
    # the first cost of a fresh init is about ln V
    assert abs(runs[0][1].train_cost[0] - float(jnp.log(64.0))) < 1.5
