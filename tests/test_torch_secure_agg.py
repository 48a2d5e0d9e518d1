"""The port's secure aggregation equals the reference's bit for bit.

Ring arithmetic has no tolerance: the PRF words, the per-client masked
uploads and the Z_2^32 aggregates must match exactly.  The reference
kernel runs in Pallas interpret mode, as the JAX package's own tests run
it on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import secure_agg as jsa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import secure_agg as tsa

K0, K1 = 0x9E3779B1, 0x12345


def _u32(rng, size):
    return rng.integers(0, 2 ** 32, size=size, dtype=np.uint64) \
        .astype(np.uint32)


def _words(t):
    return t.numpy().astype(np.uint32)


def test_prf_helpers_bitwise():
    rng = np.random.default_rng(0)
    x, a, b, c, d = (_u32(rng, 4096) for _ in range(5))
    tx, ta, tb, tc, td = (torch.tensor(v.astype(np.int64))
                          for v in (x, a, b, c, d))
    np.testing.assert_array_equal(_words(tsa._mix32(tx)),
                                  np.asarray(jsa._mix32(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _words(tsa.pair_seed(ta, tb, tc, td)),
        np.asarray(jsa.pair_seed(*map(jnp.asarray, (a, b, c, d)))))
    np.testing.assert_array_equal(
        _words(tsa.mask_bits(ta, tx)),
        np.asarray(jsa.mask_bits(jnp.asarray(a), jnp.asarray(x))))
    # scalar seeds (Python ints), as the plain masked sum calls them
    seed = tsa.pair_seed(K0, K1, 3, 7)
    assert seed == int(jsa.pair_seed(*map(jnp.uint32, (K0, K1, 3, 7))))


def _msgs(rng, i, n):
    # gradient-scale messages, some exactly on the grid's half points
    m = (rng.standard_normal((i, n)) * 0.05).astype(np.float32)
    m[:, :4] = np.float32(2.5 / 2 ** 20)
    return m


def _ref_kernel(m2d, offset, num_clients, alive):
    sc = [np.uint32(K0), np.uint32(K1), np.uint32(offset)]
    if alive is not None:
        sc += list(alive.astype(np.uint32))
    return np.asarray(jsa.masked_sum_2d(
        jnp.asarray(m2d), jnp.asarray(np.asarray(sc, np.uint32)),
        scale_bits=20, num_clients=num_clients, interpret=True,
        with_alive=alive is not None))


def _pad(m):
    n = m.shape[1]
    return np.pad(m, ((0, 0), (0, (-n) % 128))).reshape(m.shape[0], -1, 128)


@pytest.mark.parametrize("num", [1, 2, 3, 10])
@pytest.mark.parametrize("n", [1000, 768])
@pytest.mark.parametrize("with_alive", [False, True])
def test_masked_sum_equals_reference(num, n, with_alive):
    rng = np.random.default_rng(num * 100 + n)
    m = _msgs(rng, num, n)
    alive = None
    if with_alive:
        alive = np.ones(num, np.int32)
        alive[num // 2] = 0
    m2d = _pad(m)
    got = tsa.masked_sum_2d(
        torch.tensor(m2d), K0, K1, scale_bits=20, num_clients=num,
        alive=None if alive is None else torch.tensor(alive),
        device="cpu").numpy()
    np.testing.assert_array_equal(got, _ref_kernel(m2d, 0, num, alive))
    flat = np.asarray(jsa.masked_sum_flat(
        jnp.asarray(m), jnp.asarray([K0, K1], jnp.uint32), 20,
        None if alive is None else jnp.asarray(alive)))
    np.testing.assert_array_equal(got.reshape(-1)[:n], flat)
    # secure == plain quantized (survivor) sum
    q = tsa.quantize(torch.tensor(m), 20)
    if alive is not None:
        q = q * torch.tensor(alive)[:, None]
    np.testing.assert_array_equal(got.reshape(-1)[:n],
                                  q.sum(0, dtype=torch.int32).numpy())


@pytest.mark.parametrize("i", [0, 4, 9])
def test_single_client_masked_upload_equals_reference(i):
    """One row at client_offset = i of num_clients = 10 is client i's own
    masked upload: it checks the PRF itself, which the aggregate cannot
    (the masks cancel there whatever the PRF is)."""
    rng = np.random.default_rng(i)
    m = _msgs(rng, 1, 1000)
    m2d = _pad(m)
    got = tsa.masked_sum_2d(torch.tensor(m2d), K0, K1, scale_bits=20,
                            num_clients=10, client_offset=i,
                            device="cpu").numpy()
    np.testing.assert_array_equal(got, _ref_kernel(m2d, i, 10, None))
    part = np.asarray(jsa.masked_partial_sum_flat(
        jnp.asarray(m), jnp.asarray([K0, K1], jnp.uint32), 20, i, 10))
    np.testing.assert_array_equal(got.reshape(-1)[:1000], part)
    # the upload is masked: it differs from the bare quantized message
    assert (got.reshape(-1)[:1000]
            != tsa.quantize(torch.tensor(m[0]), 20).numpy()).mean() > 0.99


def test_secure_quant_sum_dict_equals_reference():
    """The flatten / pad / unflatten wrapper over a message dict with
    awkward leaf sizes (odd, prime > 128)."""
    rng = np.random.default_rng(5)
    msgs = {"w1": (rng.standard_normal((4, 7, 13)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((4, 257)) * 0.1).astype(np.float32)}
    kd = np.asarray([K0, K1], np.uint32)
    want = jops.secure_quant_sum({k: jnp.asarray(v) for k, v in msgs.items()},
                                 jnp.asarray(kd), scale_bits=20,
                                 interpret=True)
    got = tops.secure_quant_sum({k: torch.tensor(v) for k, v in msgs.items()},
                                kd, scale_bits=20, device="cpu")
    for k in msgs:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    deq = tops.secure_dequantize(got, 20)
    for k in msgs:
        np.testing.assert_array_equal(
            deq[k].numpy(), np.asarray(jsa.dequantize(want[k], 20)))


def test_quantize_rounds_half_to_even():
    m = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5]) / 2 ** 20
    np.testing.assert_array_equal(tsa.quantize(m, 20).numpy(),
                                  [0, 2, 2, 0, -2])
