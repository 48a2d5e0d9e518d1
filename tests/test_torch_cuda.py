"""Kernels against their plain versions on the card (marker ``cuda``).

These tests need an NVIDIA GPU with ``nvcc``; without one they skip.
They import neither JAX nor the reference, so they also run on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Tolerances: none.  The SSCA kernel rounds every f32 operation separately,
in the plain version's order (no FMA contraction), and the masked sum is
ring arithmetic: both must equal their plain versions bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import partition, synthetic
from repro_torch.fed import runtime
from repro_torch.kernels import ops
from repro_torch.kernels import secure_agg as sa
from repro_torch.kernels import ssca_update as su

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dev)


@pytest.mark.parametrize("rows", [1, 13, 794, 4099])
def test_ssca_kernel_equals_plain(dev, rows):
    ins = [_randn(dev, rows, 128, seed=s) for s in range(4)]
    sc = torch.tensor([0.37, 0.81, 0.1, 1e-3], device=dev)
    before = su.ssca_update_2d.launches
    got = su.ssca_update_2d(*ins, sc)
    assert su.ssca_update_2d.launches == before + 1
    for a, b in zip(got, su.ssca_update_plain(*ins, sc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("num,offset,clients", [(10, 0, 10), (1, 0, 1),
                                                (1, 6, 10), (4, 2, 7),
                                                (3, 0, 600)])
@pytest.mark.parametrize("rows", [8, 794])
@pytest.mark.parametrize("with_alive", [False, True])
def test_masked_sum_kernel_equals_plain(dev, num, offset, clients, rows,
                                        with_alive):
    msgs = _randn(dev, num, rows, 128, scale=1e-2)
    alive = None
    if with_alive:
        alive = torch.ones(clients, dtype=torch.int32, device=dev)
        alive[::3] = 0
    kw = dict(scale_bits=20, num_clients=clients, client_offset=offset,
              alive=alive)
    got = sa.masked_sum_2d(msgs, 0xDEADBEEF, 77, **kw)
    assert torch.equal(got, sa.masked_sum_plain(msgs, 0xDEADBEEF, 77, **kw))
    if offset == 0 and num == clients:
        q = sa.quantize(msgs, 20)
        if alive is not None:
            q = q * alive[:, None, None]
        assert torch.equal(got, q.sum(0, dtype=torch.int32))


def test_masked_sum_kernel_rejects_rows_past_num_clients(dev):
    msgs = _randn(dev, 2, 8, 128)
    alive = torch.ones(10, dtype=torch.int32, device=dev)
    before = sa.masked_sum_2d.launches
    with pytest.raises(ValueError, match="do not fit"):
        sa.masked_sum_2d(msgs, 1, 2, scale_bits=20, num_clients=10,
                         client_offset=9, alive=alive)
    assert sa.masked_sum_2d.launches == before


def test_secure_quant_sum_dict_on_card(dev):
    msgs = {"w1": _randn(dev, 5, 7, 13, scale=0.1),
            "w2": _randn(dev, 5, 257, seed=1, scale=0.1)}
    kd = np.asarray([3, 4], np.uint32)
    got = ops.secure_quant_sum(msgs, kd, scale_bits=20)
    want = ops.secure_quant_sum({k: v.cpu() for k, v in msgs.items()}, kd,
                                scale_bits=20, device="cpu")
    for k in msgs:
        assert torch.equal(got[k].cpu(), want[k])


def test_run_alg1_on_card_tracks_cpu(dev):
    data = synthetic.classification_dataset(2000, 500, seed=0)
    part = partition.iid(2000, 10, seed=0)
    kw = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300,
              seed=3, secure=True, fused=True)
    n_su, n_sa = su.ssca_update_2d.launches, sa.masked_sum_2d.launches
    p_gpu, h_gpu = runtime.run_alg1(data, part, **kw)
    assert su.ssca_update_2d.launches - n_su == 6
    assert sa.masked_sum_2d.launches - n_sa == 6
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    assert h_gpu.rounds == h_cpu.rounds
    assert h_gpu.uplink_bytes_per_round == h_cpu.uplink_bytes_per_round
    np.testing.assert_allclose(h_gpu.train_cost, h_cpu.train_cost, rtol=1e-4)
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].cpu().numpy(), p_cpu[k].numpy(),
                                   rtol=1e-4, atol=2e-5)
