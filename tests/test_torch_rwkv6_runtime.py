"""The port's ``run_alg1`` on RWKV-6 tracks a live JAX run.

Configuration: ``rwkv6_task(seq_len=16, d_model=32, vocab=64)`` (rwkv6-7b
reduced to 2 layers, 4 heads of 8, f32), 96 training and 24 test
documents over 4 iid clients, B = 4, 4 rounds, eval every 2 rounds on 48
documents, seed 1, τ = 2, λ = 0 and the fused server update, as
``tests/test_torch_lm_runtime.py`` runs the dense LM.  Both sides start
from the reference's initial weights with ``ln_w`` and ``bonus`` drawn
from a seeded N(0, 0.5²): at their zero init the WKV scan would get no
gradient.  Cases: plain (the super-batch path), secure (the per-client
uploads under ``vmap``, the WKV op folding the clients into one call),
and secure with ``qsgd(8)`` uploads.

Exact: the eval rounds, every field of the ledger (secure at I = 4:
734,768 uplink bytes per round = 4 × (4 × 45,920 + 4 × 3)) and the flatten
order of the parameter tree.  Within tolerance, with the largest
difference measured on the CPU:

* train cost: rtol 1e-4 (measured 2.7e-7 relative);
* final weights: 5e-5 absolute (measured 1.2e-7 plain, 1.9e-7 secure,
  2.2e-6 with qsgd(8)).  A gradient entry can land on the other side of a
  2^-20 grid rounding, and a qsgd level on the other side of its
  stochastic threshold; the reference's qsgd step also carries its
  inexact exp2 (``ROADMAP.md``, queue 3);
* test accuracy: within one token flip of the 360 predicted test tokens
  (measured: equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.fed import compression as jcompression
from repro.fed import runtime as jruntime
from repro.fed.tasks.rwkv6 import rwkv6_task as jrwkv6_task
from repro_torch import tree
from repro_torch.fed import compression, runtime
from repro_torch.fed.tasks import rwkv6_task
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import transformer as tt

KW = dict(batch_size=4, rounds=4, eval_every=2, eval_samples=48, seed=1,
          tau=2.0, lam=0.0, fused=True)
TASK = dict(seq_len=16, d_model=32, vocab=64)


@pytest.fixture(scope="module")
def setup():
    jt = jrwkv6_task(**TASK)
    data = jt.default_data(n_train=96, n_test=24, seed=0)
    part = jpartition.iid(96, 4, seed=0)
    p0 = jt.init_params(jax.random.key(3))
    rng = np.random.default_rng(11)
    blocks = dict(p0["blocks"])
    for name in ("ln_w", "bonus"):
        blocks[name] = jnp.asarray(rng.normal(0.0, 0.5, blocks[name].shape)
                                   .astype(np.float32))
    return jt, data, part, {**p0, "blocks": blocks}


def _carried(p0):
    return tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu")


def test_flatten_order_is_the_reference_one(setup):
    _, _, _, p0 = setup
    pt = _carried(p0)
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(p0)])
    assert want.size == tree.numel(pt) == 45_920
    np.testing.assert_array_equal(ops.flatten(pt).numpy(), want)
    back = ops.unflatten(ops.flatten_padded(pt), pt)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(pt)))


CASES = [("plain", False, None), ("secure", True, None),
         ("secure_qsgd8", True, "qsgd8")]


@pytest.mark.parametrize("name,secure,comp", CASES,
                         ids=[c[0] for c in CASES])
def test_rwkv_run_alg1_tracks_jax(setup, name, secure, comp):
    jt, data, part, p0 = setup
    jcomp = jcompression.qsgd(8) if comp else None
    tcomp = compression.qsgd(8) if comp else None
    pj, hj = jruntime.run_alg1(data, part, task=jt, params=p0,
                               secure=secure, compressor=jcomp, **KW)
    before = rw.rwkv6_wkv_bh.launches
    pt, ht = runtime.run_alg1(data, part, task=rwkv6_task(**TASK),
                              params=_carried(p0), secure=secure,
                              compressor=tcomp, device="cpu", **KW)
    assert rw.rwkv6_wkv_bh.launches == before       # the plain version
    assert ht.rounds == hj.rounds == [2, 4]
    assert ht.comm == hj.comm
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    if secure:
        assert ht.uplink_bytes_per_round == 4 * (4 * 45_920 + 4 * 3)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-4)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, rtol=0,
                               atol=1 / 360 + 1e-6)
    got = tt.params_to_numpy(pt)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, pj))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=5e-5)
    assert ht.train_cost[-1] < ht.train_cost[0]
    # the run moved the WKV scan's weights
    w0 = np.asarray(p0["blocks"]["wk"])
    assert np.abs(got["blocks"]["wk"] - w0).max() > 1e-6


def test_secure_uploads_fold_the_clients_into_one_wkv_call(setup,
                                                           monkeypatch):
    """Under the engine's ``vmap`` over the 4 clients, each layer's WKV
    forward runs once on the folded (4 · B, S, H, Dh) batch, and its
    backward recomputes the plain version once, under the vmap."""
    _, data, part, p0 = setup
    calls = []
    plain = rw.wkv_plain
    monkeypatch.setattr(rw, "wkv_plain", lambda *a: calls.append(
        tuple(a[0].shape)) or plain(*a))
    runtime.run_alg1(data, part, task=rwkv6_task(**TASK),
                     params=_carried(p0), secure=True, device="cpu",
                     **dict(KW, rounds=1, eval_every=5))
    # one upload forward (2 layers), its backward (2 layers, the shapes
    # one client's slice shows) and one eval point (2 forwards of 2
    # layers)
    assert calls[:4] == [(16, 16, 4, 8)] * 2 + [(4, 16, 4, 8)] * 2
    assert len(calls) == 2 + 2 + 2 * 2
