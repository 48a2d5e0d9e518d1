"""Nested parameter trees in ``jax.tree`` leaf order, and the MLP paths
left unchanged by them.

The port flattens every parameter or message tree (the secure masks'
counters, qsgd's per-leaf counter bases, the fused update's buffer) in
the reference's leaf order: keys sorted, depth first.  The MLP's
``{"w1", "w2"}`` has depth one, so its flat layout (``w1`` row-major,
then ``w2``) must stay exactly what it was; the LM's tree has depth two.
``flatten_padded`` writes a tree straight into one lane-padded
(…, R, 128) buffer, bit for bit what ``flatten`` and then ``pad_lanes``
give.  No tolerances: every check is exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import tree
from repro_torch.core import ssca
from repro_torch.fed import compression
from repro_torch.kernels import ops
from repro_torch.kernels import secure_agg as sa


def _nested(seed=0, lead=()):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)
    return {"embed": a(7, 3), "final_norm": a(3),
            "blocks": {"wq": a(2, 3, 5), "attn_norm": a(2, 3),
                       "wo": a(2, 5, 3)},
            "aux": {"z": {"b": a(4), "a": a(1)}}}


def _torch(t):
    return jax.tree.map(torch.as_tensor, t)


def test_leaf_order_is_jax_tree_order():
    t = _nested()
    assert [x.shape for x in tree.leaves(_torch(t))] == \
        [x.shape for x in jax.tree.leaves(t)]
    for got, want in zip(tree.leaves(_torch(t)), jax.tree.leaves(t)):
        np.testing.assert_array_equal(got.numpy(), want)
    doubled = tree.map(lambda x, y: x + y, _torch(t), _torch(t))
    assert jax.tree.structure(tree.map(lambda x: x.numpy(), doubled)) == \
        jax.tree.structure(t)
    assert tree.numel(_torch(t)) == sum(x.size for x in jax.tree.leaves(t))


@pytest.mark.parametrize("lead", [0, 1])
def test_flatten_padded_is_flatten_then_pad(lead):
    t = _torch(_nested(lead=(3,) * lead))
    got = ops.flatten_padded(t, lead=lead)
    want = ops.pad_lanes(ops.flatten(t, lead=lead))
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got, want)
    back = ops.unflatten(got, tree.map(lambda x: x[(0,) * lead], t),
                         lead=lead)
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(back), tree.leaves(t)))


def test_mlp_flat_layout_unchanged():
    rng = np.random.default_rng(1)
    p = {"w2": torch.tensor(rng.standard_normal((10, 128), np.float32)),
         "w1": torch.tensor(rng.standard_normal((128, 784), np.float32))}
    flat = torch.cat([p["w1"].reshape(-1), p["w2"].reshape(-1)])
    assert torch.equal(ops.flatten(p), flat)
    assert torch.equal(ops.flatten_padded(p).reshape(-1)[:flat.numel()],
                       flat)
    assert ops.flatten_padded(p).shape == (794, 128)


def test_nested_secure_sum_equals_reference_kernel():
    msgs = jax.tree.map(lambda x: x * 1e-2, _nested(seed=2, lead=(4,)))
    key = np.asarray([0x8BADF00D, 0x1234567], np.uint32)
    got = ops.secure_quant_sum(_torch(msgs), key, scale_bits=20,
                               device="cpu")
    want = jops.secure_quant_sum(msgs, jax.numpy.asarray(key),
                                 scale_bits=20, interpret=True)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and equals the plain sum of the quantized leaves
    for a, m in zip(tree.leaves(got), jax.tree.leaves(msgs)):
        assert torch.equal(a, sa.quantize(torch.as_tensor(m), 20)
                           .sum(0, dtype=torch.int32))


def test_nested_fused_update_equals_unfused_bitwise():
    p, g = _torch(_nested(seed=3)), _torch(_nested(seed=4))
    hp = ssca.SSCAHyperParams(tau=0.1, lam=1e-3)
    st = ssca.init(p)
    runs = [ssca.server_update(st, p, g, hp, fused=f, device="cpu")
            for f in (False, True)]
    (pa, sa_), (pb, sb) = runs
    for ta, tb in ((pa, pb), (sa_.lin, sb.lin), (sa_.beta, sb.beta)):
        for a, b in zip(tree.leaves(ta), tree.leaves(tb)):
            assert torch.equal(a, b)


def test_nested_qsgd_equals_reference_bitwise():
    # qsgd compresses leaf by leaf in leaf order, each leaf's counters
    # starting where the previous padded leaf ended; at this scale (every
    # leaf's step 2^e with e in [-14, 12]) the reference's steps are exact
    # powers of two
    from repro.fed import compression as jcompression
    from repro_torch.kernels import compress as kc
    k0, k1, clients = 0x8BADF00D, 0x1234567, 3
    msgs = _nested(seed=5, lead=(clients,))
    seeds = torch.tensor([kc.client_stream_seed(k0, k1, c)
                          for c in range(clients)], dtype=torch.int64)
    got, _ = compression.qsgd(8).compress(_torch(msgs), None, seeds,
                                          device="cpu")
    for c in range(clients):
        want, _ = jcompression.qsgd(8).compress(
            jax.tree.map(lambda x: jax.numpy.asarray(x[c]), msgs), (),
            jax.numpy.uint32(k0), jax.numpy.uint32(k1), jax.numpy.uint32(c))
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a[c].numpy(), np.asarray(b))


def test_tree_results_free_without_the_garbage_collector():
    # a tree built by tree.map must hold its leaves by plain references
    # only: a reference cycle would keep gigabytes of uploads alive until
    # the collector happened to run
    import gc
    import weakref
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = tree.map(lambda v: v + 1, _torch(_nested()))
        probe = weakref.ref(out["blocks"]["wq"])
        del out
        assert probe() is None
    finally:
        if enabled:
            gc.enable()
