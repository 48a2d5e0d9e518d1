"""Algorithm 1 on the decoder-only LM at λ = 0, fused, tracks live JAX
runs of the reference on the paths where the server update runs its
``lambda0`` variant with no β state (``ssca.init(with_beta=False)``).

Configuration: ``tests/test_torch_lm_runtime.py``'s —
``transformer_task(seq_len=16, d_model=32, vocab=64)`` (llama3-8b
reduced to 2 layers, 4 heads of 8, f32), 96 training and 24 test
documents over 4 iid clients, B = 4, 4 rounds, eval every 2 rounds on 48
documents, seed 1, τ = 2, λ = 0, ``fused=True`` — both sides from one
set of initial weights.  Cases: secure async rounds at
``StalenessConfig(max_staleness=1, delay_probs=(0.5, 0.3, 0.2))`` (its
delay 2 drops the slot) and the two-level tree
``hierarchical(secure(), 2)``.

Exact: the eval rounds and ``History.comm`` (the async entry and the
tree's edge hop with it).  Within tolerance, with the largest difference
measured on the CPU:

* final weights: async 2.9e-7, tree 2.5e-7 (atol 5e-7: XLA and
  PyTorch round the LM's f32 forward and backward in other orders, and
  each round carries the difference on);
* train cost: rtol 1e-5 (measured 8.9e-8 relative);
* test accuracy: within one token flip of the 360 predicted test tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.fed import aggregation as jagg
from repro.fed import runtime as jruntime
from repro.fed.staleness import StalenessConfig as JConfig
from repro.fed.tasks import transformer_task as jtransformer_task
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import runtime
from repro_torch.fed.staleness import StalenessConfig
from repro_torch.fed.tasks import transformer_task
from repro_torch.models import transformer as tt

KW = dict(batch_size=4, rounds=4, eval_every=2, eval_samples=48, seed=1,
          tau=2.0, lam=0.0, fused=True)
TASK = dict(seq_len=16, d_model=32, vocab=64)
DELAYS = (0.5, 0.3, 0.2)

# name -> (reference arguments, port arguments, weight tolerance)
CASES = {
    "async_secure": (
        dict(secure=True, staleness=JConfig(max_staleness=1,
                                            delay_probs=DELAYS)),
        dict(secure=True, staleness=StalenessConfig(max_staleness=1,
                                                    delay_probs=DELAYS)),
        5e-7),
    "hier2_secure": (
        dict(aggregation=jagg.hierarchical(jagg.secure(), groups=2)),
        dict(aggregation=tagg.hierarchical(tagg.secure(), groups=2)),
        5e-7),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    """The data, the partition and one set of initial weights, the
    port's seeded init carried to the reference as numpy arrays (the
    reference's own init would compile for seconds)."""
    jt = jtransformer_task(**TASK)
    data = jt.default_data(n_train=96, n_test=24, seed=0)
    part = jpartition.iid(96, 4, seed=0)
    p0 = tt.params_to_numpy(transformer_task(**TASK).init_params(
        torch.Generator().manual_seed(3)))
    return jt, data, part, p0


@pytest.mark.parametrize("name", list(CASES))
def test_lm_alg1_lambda0_tracks_jax(setup, name):
    jt, data, part, p0 = setup
    jkw, tkw, atol = CASES[name]
    pj, hj = jruntime.run_alg1(data, part, task=jt,
                               params=jax.tree.map(jnp.asarray, p0), **KW,
                               **jkw)
    pt, ht = runtime.run_alg1(
        data, part, task=transformer_task(**TASK),
        params=tt.params_from_numpy(p0, "cpu"), device="cpu", **KW, **tkw)
    assert ht.rounds == hj.rounds == [2, 4]
    assert ht.comm == hj.comm
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, rtol=0,
                               atol=1 / 360 + 1e-6)
    got = tt.params_to_numpy(pt)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, pj))
    gap = max(float(np.abs(a - np.asarray(b)).max())
              for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pj)))
    assert gap <= atol, gap
