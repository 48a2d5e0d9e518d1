"""The port's ``run_alg2``, ``run_fedsgd`` and ``run_fedavg`` on the
decoder-only LM track live JAX runs of the reference.

Configuration: ``test_torch_lm_runtime.py``'s — ``transformer_task(
seq_len=16, d_model=32, vocab=64)`` (llama3-8b reduced to 2 layers, 4
heads of 8, f32), 96 training and 24 test documents over 4 iid clients,
B = 4, 4 rounds, eval every 2 rounds on 48 documents, seed 1 — with
``run_alg2(limit_u=2.0, tau=2.0)`` (the constraint active: the slack
falls from about 6.3 to 4.1), ``run_fedsgd(lr_a=0.5)`` and
``run_fedavg(local_steps=2, lr_a=0.5)``, plain and secure, both sides
from the reference's initial weights.  The LM's parameter tree is two
deep, so Algorithm 2's upload ``(value, tree)`` puts the value at flat
index 0 ahead of it, FedAvg vmaps its two local steps over the tree, and
the mean combine weights whole LM models.

Exact: the eval rounds, every byte field of the ledger and the comm
breakdown (at I = 4, n = 41,120: Algorithm 2 plain 657,936 uplink bytes
a round = 4 × 4 × 41,121, secure 657,984 = 4 × (4 × 41,121 + 4 × 3);
FedSGD / FedAvg plain 657,920, secure 657,968; downlink 657,920), and
``History.as_dict()``'s keys.  Within tolerance, with the largest
difference measured on the CPU:

* final weights: plain 3.0e-8 (Algorithm 2), 8.9e-8 (FedSGD), 1.7e-7
  (FedAvg); secure 2.6e-7, 1.6e-6 and 6.7e-6, where an entry lands on
  the other side of a 2^-20 grid rounding (atol 5e-5);
* train cost 3.1e-7 relative (rtol 1e-4);
* test accuracy: equal up to f32 representation (within one token flip
  of the 360 predicted test tokens);
* Algorithm 2's slack: 2.9e-6 absolute (rtol 1e-5, atol 2e-5); secure
  within 1e-4 of plain in cost and slack.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.fed import aggregation as jagg
from repro.fed import runtime as jruntime
from repro.fed.tasks import transformer_task as jtransformer_task
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import runtime
from repro_torch.fed.tasks import transformer_task
from repro_torch.models import transformer as tt

KW = dict(batch_size=4, rounds=4, eval_every=2, eval_samples=48, seed=1)
TASK = dict(seq_len=16, d_model=32, vocab=64)

# name -> (runtime function, its arguments, uplink bytes a round plain,
# secure)
ALGS = {
    "alg2": ("run_alg2", dict(limit_u=2.0, tau=2.0), 657_936, 657_984),
    "fedsgd": ("run_fedsgd", dict(lr_a=0.5), 657_920, 657_968),
    "fedavg": ("run_fedavg", dict(local_steps=2, lr_a=0.5), 657_920,
               657_968),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    jt = jtransformer_task(**TASK)
    data = jt.default_data(n_train=96, n_test=24, seed=0)
    part = jpartition.iid(96, 4, seed=0)
    p0 = jt.init_params(jax.random.key(3))
    return jt, data, part, p0


def _runs(setup, name, secure):
    """(reference params, history), (port params, history)."""
    jt, data, part, p0 = setup
    fn, kw, _, _ = ALGS[name]
    jkw, tkw = dict(kw), dict(kw)
    if secure:
        jkw["aggregation"], tkw["aggregation"] = jagg.secure(), tagg.secure()
    ref = getattr(jruntime, fn)(data, part, task=jt, params=p0, **KW, **jkw)
    port = getattr(runtime, fn)(
        data, part, task=transformer_task(**TASK),
        params=tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
        device="cpu", **KW, **tkw)
    return ref, port


@pytest.mark.parametrize("secure", [False, True], ids=["plain", "secure"])
@pytest.mark.parametrize("name", list(ALGS))
def test_lm_algorithms_track_jax(setup, name, secure):
    (pj, hj), (pt, ht) = _runs(setup, name, secure)
    assert ht.rounds == hj.rounds == [2, 4]
    assert ht.comm == hj.comm
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    assert ht.uplink_bytes_per_round == ALGS[name][3 if secure else 2]
    assert ht.downlink_bytes_per_round == 4 * 4 * 41_120
    assert sorted(ht.as_dict()) == sorted(hj.as_dict())
    assert set(ht.metrics) == {"train_cost", "test_accuracy"}
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-4)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, rtol=0,
                               atol=1 / 360 + 1e-6)
    np.testing.assert_allclose(ht.slack, hj.slack, rtol=1e-5, atol=2e-5)
    got = tt.params_to_numpy(pt)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, pj))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=5e-5)
    if name == "alg2":
        assert all(np.isfinite(ht.slack)) and min(ht.slack) > 1.0
        assert ht.slack[-1] < ht.slack[0]
    else:
        assert ht.slack == [0.0, 0.0]
        assert ht.train_cost[-1] < ht.train_cost[0]


def test_lm_secure_alg2_matches_plain(setup):
    _, data, part, p0 = setup
    hists = [runtime.run_alg2(
        data, part, task=transformer_task(**TASK),
        params=tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
        secure=secure, device="cpu", **KW, **ALGS["alg2"][1])[1]
        for secure in (False, True)]
    plain, secure = hists
    np.testing.assert_allclose(secure.train_cost, plain.train_cost,
                               atol=1e-4)
    np.testing.assert_allclose(secure.slack, plain.slack, atol=1e-4)
