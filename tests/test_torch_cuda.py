"""Kernels against their plain versions on the card (marker ``cuda``).

These tests need an NVIDIA GPU with ``nvcc``; without one they skip.
They import neither JAX nor the reference, so they also run on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Tolerances: none for the four integer and update kernels.  The SSCA
kernel (both variants, ``beta`` and the β-less ``lambda0``) and the
compress kernel round every f32 operation separately, in the plain
version's order (no FMA contraction), and the masked sum and the sketch
encode are ring arithmetic: all must equal their plain versions bit for
bit (NaN compared as NaN), the masked sum on both variants its launch
plan names (``vec`` and ``rowsplit``).  Flash attention has two kernels,
chosen by dtype.  The f32 (tf32x3) one runs its products as three TF32
passes over split operands, sums its scores and its P·V in another
order than the plain version's einsums, and keeps an online softmax:
within 2e-5 absolute of the plain version (tests/test_torch_flash_attention.py
emulates it).  The bf16 (wgmma) one also rounds P
to bf16 before P·V, as the reference model does, so it is held to the
f64 softmax of the same inputs by ``bf16_error_check``: elementwise one
output ulp + 2^-8 · Σ p|v| + 1e-5, and an RMS error within 1.5x the
plain version's.  The
WKV kernel sums the plain version's chunked form on the tensor cores, each
f32 operand split into two TF32 parts (tests/test_torch_rwkv6_scan.py
emulates it): within 1e-5 of the plain version's largest |o|.  The LM
runs on the card are held to their CPU runs as the MLP runs are; so are
the reduced LMs' decode (no hand-written kernel: within 1e-4 of the
largest |logit|, TF32 off; the hybrid's past its window of 16) and
``launch.steps.make_train_step`` (one ``lambda0`` launch a step;
parameters within 1e-5 of the CPU's).  Both flash kernels take a sliding
window, and attention without causality over a key length of its own,
at head dims 16–256 (96 and the f32 kernel's 256 too), held to the same
bounds against the plain version of the same mask.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.data import partition, synthetic
from repro_torch.fed import aggregation, compression, runtime
from repro_torch.fed import sketch as fed_sketch
from repro_torch.fed.staleness import ConstantDiscount, StalenessConfig
from repro_torch.fed.tasks import rwkv6_task, transformer_task
from repro_torch.kernels import compress as kc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels import secure_agg as sa
from repro_torch.kernels import sketch as ks
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


def _shifted(t):
    """``t`` copied into a contiguous view one element past a 16-byte
    aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _ssca_equal_plain(ins, sc):
    """The kernel against the plain version, bit for bit (a −0 told from
    +0), the launch counted on its variant: ``lambda0`` for β = None."""
    variant = "lambda0" if ins[3] is None else "beta"
    before = dict(su.ssca_update_2d.launches_by_variant)
    launches = su.ssca_update_2d.launches
    got = su.ssca_update_2d(*ins, sc)
    before[variant] += 1
    assert su.ssca_update_2d.launches == launches + 1
    assert su.ssca_update_2d.launches_by_variant == before
    for a, b in zip(got, su.ssca_update_plain(*ins, sc)):
        if b is None:
            assert a is None
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("rows", [1, 13, 794, 4099])
def test_ssca_kernel_equals_plain(dev, rows):
    ins = [_randn(dev, rows, 128, seed=s) for s in range(4)]
    sc = torch.tensor([0.37, 0.81, 0.1, 1e-3], device=dev)
    _ssca_equal_plain(ins, sc)


@pytest.mark.parametrize("rows", [3, 794])
def test_ssca_kernel_takes_misaligned_views(dev, rows):
    """Inputs one element past a 16-byte aligned address (the kernel loads
    4 bytes at a time) equal the plain version."""
    ins = [_randn(dev, rows, 128, seed=s) for s in range(4)]
    ins = [ins[0], *(_shifted(x) for x in ins[1:])]
    sc = torch.tensor([0.37, 0.81, 0.1, 1e-3], device=dev)
    _ssca_equal_plain(ins, sc)


@pytest.mark.parametrize("rows,shift", [(794, False), (13, False),
                                        (794, True)])
def test_ssca_lambda0_kernel_equals_plain(dev, rows, shift):
    """The β-less variant (λ = 0) at the MLP's rows, a small shape and
    views one element past alignment."""
    ins = [_randn(dev, rows, 128, seed=s) for s in range(3)]
    if shift:
        ins = [_shifted(x) for x in ins]
    sc = torch.tensor([0.37, 0.81, 0.1, 0.0], device=dev)
    _ssca_equal_plain([*ins, None], sc)


def _masked_sum_equal_plain(msgs, variant, **kw):
    """The kernel against the plain version, and the launch counted on
    the variant its plan names."""
    _, splits, _ = sa.launch_plan(msgs[0].numel(), msgs.shape[0],
                                  kw["num_clients"],
                                  torch.cuda.get_device_properties(
                                      msgs.device).multi_processor_count)
    before = dict(sa.masked_sum_2d.launches_by_variant)
    got = sa.masked_sum_2d(msgs, 0xDEADBEEF, 77, scale_bits=20, **kw)
    before[variant] += 1
    if kw.get("alive") is not None:
        before["alive"] += 1
    assert sa.masked_sum_2d.launches_by_variant == before
    assert torch.equal(got, sa.masked_sum_plain(msgs, 0xDEADBEEF, 77,
                                                scale_bits=20, **kw))
    return got, splits


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


@pytest.mark.parametrize("num,offset,clients,rows,variant", [
    (4, 0, 4, 8, "rowsplit"),        # under one wave: streams split
    (10, 0, 10, 794, "rowsplit"),    # the MLP path's shape
    (4, 0, 4, 4608, "vec"),          # past the wave threshold
    (4, 0, 4, 33_792, "vec"),        # eight tiles a block
    (4, 2, 7, 4608, "vec"),          # client_offset
    (3, 0, 600, 4608, "vec"),        # the table in chunks
    (3, 0, 600, 8, "rowsplit"),
])
@pytest.mark.parametrize("with_alive", [False, True])
def test_masked_sum_kernel_variants_equal_plain(dev, num, offset, clients,
                                                rows, variant, with_alive):
    msgs = _randn(dev, num, rows, 128, seed=3, scale=1e-2)
    alive = None
    if with_alive:
        alive = torch.ones(clients, dtype=torch.int32, device=dev)
        alive[1::4] = 0
    got, splits = _masked_sum_equal_plain(
        msgs, variant, num_clients=clients, client_offset=offset,
        alive=alive)
    assert (splits > 1) == (variant == "rowsplit")
    if offset == 0 and num == clients:
        q = sa.quantize(msgs, 20)
        if alive is not None:
            q = q * alive[:, None, None]
        assert torch.equal(got, q.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("num,clients,rows,variant", [
    (10, 10, 794, "rowsplit"), (4, 4, 4608, "vec"), (3, 600, 8, "rowsplit")])
@pytest.mark.parametrize("with_alive", [False, True])
def test_masked_sum_kernel_takes_misaligned_views(dev, num, clients, rows,
                                                  variant, with_alive):
    """Rows one element past a 16-byte aligned address (copied first: the
    kernel's loads need 16-byte alignment) equal the plain version."""
    msgs = _shifted(_randn(dev, num, rows, 128, seed=4, scale=1e-2))
    alive = None
    if with_alive:
        alive = torch.ones(clients, dtype=torch.int32, device=dev)
        alive[::3] = 0
    _masked_sum_equal_plain(msgs, variant, num_clients=clients,
                            alive=alive)


@pytest.mark.parametrize("rows", [8, 4608])
@pytest.mark.parametrize("i", [0, 3, 9])
def test_masked_sum_kernel_single_upload_is_masked(dev, rows, i):
    """One client's upload alone (client_offset = i of 10) is its masked
    upload: the plain version's bits, and almost no element equal to its
    quantized message."""
    msgs = _randn(dev, 1, rows, 128, seed=5, scale=1e-2)
    got, _ = _masked_sum_equal_plain(
        msgs, "rowsplit" if rows == 8 else "vec", num_clients=10,
        client_offset=i)
    same = float((got == sa.quantize(msgs[0], 20)).float().mean())
    assert same < 0.01


def test_masked_sum_kernel_rejects_rows_past_num_clients(dev):
    msgs = _randn(dev, 2, 8, 128)
    alive = torch.ones(10, dtype=torch.int32, device=dev)
    before = sa.masked_sum_2d.launches
    with pytest.raises(ValueError, match="do not fit"):
        sa.masked_sum_2d(msgs, 1, 2, scale_bits=20, num_clients=10,
                         client_offset=9, alive=alive)
    assert sa.masked_sum_2d.launches == before


def _int32_rows(dev, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)


def _ring_total(q, alive=None):
    """Σ_i alive_i q_i mod 2^32, as int32."""
    q = q.long()
    if alive is not None:
        q = q * alive.long()[:, None, None]
    t = q.sum(0) & 0xFFFFFFFF
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


@pytest.mark.parametrize("num,offset,groups,rows,variant", [
    (1, 0, 1, 8, "vec"),              # one group: no streams
    (2, 0, 2, 8, "rowsplit"),         # the tree's G = 2
    (3, 0, 3, 794, "rowsplit"),       # G = 3 at the MLP's rows
    (16, 0, 16, 794, "rowsplit"),     # the S = 512 path's G = 16
    (2, 0, 2, 4608, "vec"),           # past the wave threshold
    (16, 0, 16, 4608, "vec"),
    (3, 2, 7, 4608, "vec"),           # a group offset
    (3, 5, 16, 794, "rowsplit"),
    (3, 0, 600, 4608, "vec"),         # 600 groups: the table in chunks
    (3, 0, 600, 8, "rowsplit"),
])
@pytest.mark.parametrize("with_alive", [False, True])
def test_masked_ring_sum_kernel_equals_plain(dev, num, offset, groups, rows,
                                             variant, with_alive):
    """The ring mode against its plain version bit for bit, on the
    variant its plan names, counted on its own wrapper; the whole set of
    groups sums to the plain ring sum."""
    q = _int32_rows(dev, num, rows, 128, seed=num + rows)
    alive = None
    if with_alive:
        alive = torch.ones(groups, dtype=torch.int32, device=dev)
        alive[1::3] = 0
    kw = dict(num_clients=groups, client_offset=offset, alive=alive)
    before = dict(sa.masked_ring_sum_2d.launches_by_variant)
    n_sum = sa.masked_sum_2d.launches
    got = sa.masked_ring_sum_2d(q, 0xDEADBEEF, 77, **kw)
    before[variant] += 1
    if with_alive:
        before["alive"] += 1
    assert sa.masked_ring_sum_2d.launches_by_variant == before
    assert sa.masked_sum_2d.launches == n_sum
    assert torch.equal(got, sa.masked_ring_sum_plain(q, 0xDEADBEEF, 77,
                                                     **kw))
    if offset == 0 and num == groups:
        assert torch.equal(got, _ring_total(q, alive))


@pytest.mark.parametrize("num,groups,rows,variant", [
    (2, 2, 794, "rowsplit"), (16, 16, 4608, "vec"), (3, 600, 8, "rowsplit")])
def test_masked_ring_sum_kernel_takes_misaligned_views(dev, num, groups,
                                                       rows, variant):
    q = _shifted(_int32_rows(dev, num, rows, 128, seed=9))
    before = sa.masked_ring_sum_2d.launches_by_variant[variant]
    got = sa.masked_ring_sum_2d(q, 5, 6, num_clients=groups)
    assert sa.masked_ring_sum_2d.launches_by_variant[variant] == before + 1
    assert torch.equal(got, sa.masked_ring_sum_plain(q, 5, 6,
                                                     num_clients=groups))


def test_masked_sums_write_into_out(dev):
    """Both modes write their aggregate into a row of a preallocated
    buffer (the tree's level-1 layout) with the bits of a fresh output;
    a misaligned or mistyped ``out`` is refused before any launch."""
    msgs = _randn(dev, 4, 794, 128, scale=1e-2)
    buf = torch.zeros(3, 794, 128, dtype=torch.int32, device=dev)
    kw = dict(scale_bits=20, num_clients=4)
    assert sa.masked_sum_2d(msgs, 1, 2, out=buf[1], **kw).data_ptr() \
        == buf[1].data_ptr()
    assert torch.equal(buf[1], sa.masked_sum_2d(msgs, 1, 2, **kw))
    q = _int32_rows(dev, 3, 794, 128)
    sa.masked_ring_sum_2d(q, 1, 2, num_clients=3, out=buf[2])
    assert torch.equal(buf[2], sa.masked_ring_sum_2d(q, 1, 2,
                                                     num_clients=3))
    counts = (sa.masked_sum_2d.launches, sa.masked_ring_sum_2d.launches)
    with pytest.raises(ValueError, match="out"):
        sa.masked_sum_2d(msgs, 1, 2, out=_shifted(buf[0]), **kw)
    with pytest.raises(ValueError, match="out"):
        sa.masked_ring_sum_2d(q, 1, 2, num_clients=3, out=buf[0].float())
    with pytest.raises(ValueError, match="int32"):
        sa.masked_ring_sum_2d(q.float(), 1, 2, num_clients=3)
    assert (sa.masked_sum_2d.launches,
            sa.masked_ring_sum_2d.launches) == counts


@pytest.mark.parametrize("s,groups", [(8, 2), (10, 3), (40, 16), (7, 7)])
@pytest.mark.parametrize("with_alive", [False, True])
def test_tree_combine_on_card_equals_flat(dev, s, groups, with_alive):
    """``hierarchical(secure(), G)``'s combine on the card equals the
    flat secure combine on the card bit for bit (G masked sums and one
    ring merge), and its int32 root equals the CPU's."""
    msgs = {"w1": _randn(dev, s, 784, 16, scale=1e-2),
            "w2": _randn(dev, s, 16, 10, seed=1, scale=1e-2)}
    kd = np.asarray([0x1234, 0xABCD], np.uint32)
    alive = None
    if with_alive:
        alive = torch.ones(s, dtype=torch.int32, device=dev)
        alive[::4] = 0
    hier = aggregation.hierarchical(aggregation.secure(), groups=groups)
    counts = (sa.masked_sum_2d.launches, sa.masked_ring_sum_2d.launches)
    got = hier.combine_messages(msgs, kd, alive=alive)
    assert (sa.masked_sum_2d.launches - counts[0],
            sa.masked_ring_sum_2d.launches - counts[1]) == (groups, 1)
    want = aggregation.secure().combine_messages(msgs, kd, alive=alive)
    root = hier.partial_combine(msgs, kd, 0, None, alive)
    cpu = hier.partial_combine({k: v.cpu() for k, v in msgs.items()}, kd,
                               0, None,
                               None if alive is None else alive.cpu(),
                               device="cpu")
    for k in msgs:
        assert torch.equal(got[k], want[k])
        assert torch.equal(root[k].cpu(), cpu[k])


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


@pytest.mark.parametrize("case", ["sampled_secure", "async_secure"])
def test_participation_run_on_card_tracks_cpu(dev, case):
    """A cohort run (``secure(num_sampled=4)`` of I = 16) and an async
    secure run (K = 1, dropouts through the masked sum's ``alive``) on
    the card against the same runs on the CPU."""
    data = synthetic.classification_dataset(2000, 500, seed=0)
    kw = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300,
              seed=3, fused=True)
    if case == "sampled_secure":
        part = partition.iid(2000, 16, seed=0)
        kw["aggregation"] = aggregation.secure(num_sampled=4)
    else:
        part = partition.iid(2000, 10, seed=0)
        kw.update(secure=True, staleness=StalenessConfig(
            max_staleness=1, delay_probs=[0.4, 0.3, 0.2, 0.1]))
    n_sa = sa.masked_sum_2d.launches
    n_alive = sa.masked_sum_2d.launches_by_variant["alive"]
    p_gpu, h_gpu = runtime.run_alg1(data, part, **kw)
    assert sa.masked_sum_2d.launches - n_sa == 6
    assert sa.masked_sum_2d.launches_by_variant["alive"] - n_alive == \
        (6 if case == "async_secure" else 0)
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    assert h_gpu.rounds == h_cpu.rounds and h_gpu.comm == h_cpu.comm
    if case == "async_secure":
        assert h_gpu.comm["async"]["dropped_total"] > 0
    np.testing.assert_allclose(h_gpu.train_cost, h_cpu.train_cost, rtol=1e-4)
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].cpu().numpy(), p_cpu[k].numpy(),
                                   rtol=1e-4, atol=2e-5)


def test_hierarchical_and_pipelined_runs_on_card(dev):
    """On the card: ``hierarchical(secure(), 3)`` lands on the flat secure
    run's weights bit for bit (the cohort rows permuted, each client's
    upload unchanged) with 3 masked sums and one ring merge a round, and
    tracks its CPU run; ``pipeline=True`` equals the async run at the
    constant τ ≡ 1 trace bit for bit and passes no ``alive``."""
    data = synthetic.classification_dataset(2000, 500, seed=0)
    part = partition.iid(2000, 10, seed=0)
    kw = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300,
              seed=3, fused=True)
    hier = dict(kw, aggregation=aggregation.hierarchical(
        aggregation.secure(), groups=3))
    counts = (sa.masked_sum_2d.launches, sa.masked_ring_sum_2d.launches)
    p_h, h_h = runtime.run_alg1(data, part, **hier)
    assert (sa.masked_sum_2d.launches - counts[0],
            sa.masked_ring_sum_2d.launches - counts[1]) == (18, 6)
    p_f, h_f = runtime.run_alg1(data, part, secure=True, **kw)
    for k in p_f:
        assert torch.equal(p_h[k], p_f[k])
    assert h_h.metrics == h_f.metrics
    p_c, h_c = runtime.run_alg1(data, part, device="cpu", **hier)
    assert h_h.comm == h_c.comm
    np.testing.assert_allclose(h_h.train_cost, h_c.train_cost, rtol=1e-4)
    for k in p_c:
        np.testing.assert_allclose(p_h[k].cpu().numpy(), p_c[k].numpy(),
                                   rtol=1e-4, atol=2e-5)
    alive = sa.masked_sum_2d.launches_by_variant["alive"]
    p_p, h_p = runtime.run_alg1(data, part, secure=True, pipeline=True,
                                **kw)
    assert sa.masked_sum_2d.launches_by_variant["alive"] == alive
    p_a, h_a = runtime.run_alg1(
        data, part, secure=True, staleness=StalenessConfig(
            max_staleness=1, schedule=ConstantDiscount()),
        staleness_trace=np.ones((6, 10), np.int64), **kw)
    for k in p_a:
        assert torch.equal(p_p[k], p_a[k])
    assert h_p.metrics == h_a.metrics
    assert h_p.comm["pipeline"]["enabled"] and "async" not in h_p.comm


def _same_bits(a, b):
    """Bit for bit, with every NaN mapped to one pattern."""
    nan = torch.tensor(float("nan"), device=a.device)
    return torch.equal(torch.where(torch.isnan(a), nan, a).view(torch.int32),
                       torch.where(torch.isnan(b), nan, b).view(torch.int32))


def _scalars(dev, clients, base, *, sketch=False):
    seeds = [kc.client_stream_seed(0xDEADBEEF, 77, c) for c in range(clients)]
    rows = [[s, base, 0x5EEDC0DE] if sketch else [s, base] for s in seeds]
    return torch.tensor(rows, dtype=torch.int64, device=dev)


@pytest.mark.parametrize("clients,rows", [(10, 794), (10, 784), (10, 10),
                                          (3, 1), (1, 4099)])
@pytest.mark.parametrize("quantize,masked", [(True, False), (False, True),
                                             (True, True), (False, False)])
@pytest.mark.parametrize("special", [False, True])
def test_compress_kernel_equals_plain(dev, clients, rows, quantize, masked,
                                      special):
    x = _randn(dev, clients, rows, 128, scale=1e-3)
    if special:
        x.view(-1)[:6] = torch.tensor([float("nan"), float("inf"),
                                       -float("inf"), -0.0, 3e38, 1e-45])
    sui = _scalars(dev, clients, 2 ** 32 - 300)
    exps = torch.arange(clients, device=dev) % 3 - 14
    delta = ((exps + 127) << 23).int().view(torch.float32)     # 2^exps
    sf = torch.stack([torch.full((clients,), 1e-3, device=dev), delta], dim=1)
    kw = dict(lbound=127, quantize=quantize, masked=masked)
    before = kc.compress_2d.launches
    got = kc.compress_2d(x, sui, sf, **kw)
    assert kc.compress_2d.launches == before + 1
    for a, b in zip(got, kc.compress_2d_plain(x, sui, sf, **kw)):
        assert _same_bits(a, b)


@pytest.mark.parametrize("clients,rows,sk_rows,cols", [
    (10, 794, 4, 1024), (10, 794, 4, 512), (3, 7, 3, 1), (1, 4099, 8, 64),
    (2, 794, 8, 16384), (3, 7, 4, 16384)])
@pytest.mark.parametrize("keep", [None, 256])
def test_sketch_encode_kernel_equals_plain(dev, clients, rows, sk_rows, cols,
                                           keep):
    x = _randn(dev, clients, rows, 128, scale=1e-3)
    if keep is not None:                  # pre-sparsified, as on the path
        flat = x.reshape(clients, -1)
        thr = torch.topk(flat.abs(), min(keep, flat.shape[1]),
                         dim=1).values[:, -1:]
        x = torch.where(flat.abs() >= thr, flat, 0.0).reshape(x.shape)
    sui = _scalars(dev, clients, 0, sketch=True)
    kw = dict(rows=sk_rows, cols=cols, scale_bits=20)
    before = ks.sketch_encode.launches
    got = ks.sketch_encode(x, sui, **kw)
    assert ks.sketch_encode.launches == before + 1
    assert torch.equal(got, ks.sketch_encode_plain(x, sui, **kw))


@pytest.mark.parametrize("cols", [64, 16384])
def test_sketch_encode_kernel_all_zero_and_special(dev, cols):
    x = torch.zeros(2, 3, 128, device=dev)
    sui = _scalars(dev, 2, 5, sketch=True)
    assert not ks.sketch_encode(x, sui, rows=4, cols=cols,
                                scale_bits=20).any()
    x.view(-1)[:6] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                   3e9, 0.0, -0.0])
    assert torch.equal(ks.sketch_encode(x, sui, rows=4, cols=cols,
                                        scale_bits=20),
                       ks.sketch_encode_plain(x, sui, rows=4, cols=cols,
                                              scale_bits=20))
    assert torch.equal(ks.sketch_encode(_shifted(x), sui, rows=4, cols=cols,
                                        scale_bits=20),
                       ks.sketch_encode_plain(x, sui, rows=4, cols=cols,
                                              scale_bits=20))


def test_new_wrappers_refuse_bad_arguments(dev):
    x = torch.zeros(2, 1, 128)
    su2 = torch.zeros(2, 2, dtype=torch.int64)
    su3 = torch.zeros(2, 3, dtype=torch.int64)
    sf = torch.ones(2, 2)
    # a CPU tensor with device="cuda"
    with pytest.raises(ValueError, match="asked for"):
        kc.compress_2d(x, su2, sf, lbound=127, quantize=True, masked=True,
                       device="cuda")
    with pytest.raises(ValueError, match="asked for"):
        ks.sketch_encode(x, su3, rows=4, cols=64, scale_bits=20,
                         device="cuda")
    xc = x.to(dev)
    counts = (kc.compress_2d.launches, ks.sketch_encode.launches)
    with pytest.raises(ValueError, match="f32"):
        kc.compress_2d(xc.double(), su2.to(dev), sf.to(dev), lbound=127,
                       quantize=True, masked=True)
    with pytest.raises(ValueError, match="f32"):
        ks.sketch_encode(xc.half(), su3.to(dev), rows=4, cols=64,
                         scale_bits=20)
    with pytest.raises(ValueError, match="power of two"):
        ks.sketch_encode(xc, su3.to(dev), rows=4, cols=96, scale_bits=20)
    assert (kc.compress_2d.launches, ks.sketch_encode.launches) == counts


@pytest.mark.parametrize("name", ["qsgd8", "topk8_secure", "sketch_secure"])
def test_compressed_run_alg1_on_card_tracks_cpu(dev, name):
    data = synthetic.classification_dataset(2000, 500, seed=0)
    part = partition.iid(2000, 10, seed=0)
    comp, secure, want = {
        "qsgd8": (compression.qsgd(8), False, (12, 0, 0)),
        "topk8_secure": (compression.topk(0.1, bits=8), True, (6, 0, 6)),
        "sketch_secure": (fed_sketch.sketch(4, 512, 0.015, keep=64), True,
                          (0, 6, 12))}[name]
    kw = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300,
              seed=3, secure=secure, fused=True, compressor=comp)
    counts = lambda: (kc.compress_2d.launches,  # noqa: E731
                      ks.sketch_encode.launches, sa.masked_sum_2d.launches)
    before = counts()
    p_gpu, h_gpu = runtime.run_alg1(data, part, **kw)
    assert tuple(a - b for a, b in zip(counts(), before)) == want
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    assert h_gpu.comm == h_cpu.comm
    np.testing.assert_allclose(h_gpu.train_cost, h_cpu.train_cost, rtol=1e-4)
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].cpu().numpy(), p_cpu[k].numpy(),
                                   rtol=0, atol=1e-3)


# f32 shapes, then bf16 ones: every head dim at every S in {1, 65, 77,
# 128, 129, 300, 1024}, G cycling through 1, 4, 8 and 48 (granite-34b's);
# and the LM path's shape
FLASH_SHAPES = [(1, 1, 4, 1, 16, "f32"), (2, 77, 4, 2, 64, "f32"),
                (2, 130, 4, 4, 32, "f32"), (1, 200, 8, 1, 128, "f32"),
                (2, 1024, 8, 2, 128, "f32"), (3, 77, 8, 1, 64, "f32")] + [
    (1 if s == 1024 else 2, s, g * (1 if g == 48 else 2),
     1 if g == 48 else 2, dh, "bf16")
    for i, (dh, s) in enumerate((dh, s) for dh in (16, 32, 64, 128)
                                for s in (1, 65, 77, 128, 129, 300, 1024))
    for g in [(1, 4, 8, 48)[i % 4]]] + [(8, 1024, 32, 8, 128, "bf16")]


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=[str(s) for s in FLASH_SHAPES])
def test_flash_attention_kernel_matches_plain(dev, shape):
    b, s, h, hkv, dh, dt = shape
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    q = _randn(dev, b, s, h, dh, seed=1).to(dt)
    k = _randn(dev, b, s, hkv, dh, seed=2).to(dt)
    v = _randn(dev, b, s, hkv, dh, seed=3).to(dt)
    before = fa.flash_attention_bhsd.launches
    by_variant = dict(fa.flash_attention_bhsd.launches_by_variant)
    got = fa.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    by_variant[fa.VARIANTS[dt]] += 1
    assert fa.flash_attention_bhsd.launches_by_variant == by_variant
    assert got.dtype == dt and got.shape == q.shape
    if dt == torch.float32:
        want = fa.flash_attention_plain(q, k, v)
        assert float((got - want).abs().max()) <= 2e-5
    else:
        ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got)
        assert ok, (ratio, rms_got, rms_plain)


# sliding windows (b, s, h, hkv, dh, dtype, window): inside a tile, across
# tile edges, a window of 1, and head dim 256 (wgmma only) at the hybrid
# path's shape
FLASH_WINDOWS = [(4, 32, 4, 1, 16, "f32", 16), (2, 130, 4, 1, 64, "f32", 40),
                 (3, 77, 8, 1, 64, "f32", 5), (2, 300, 8, 2, 128, "f32", 64),
                 (2, 40, 4, 2, 32, "f32", 1), (2, 300, 8, 1, 64, "bf16", 129),
                 (2, 77, 4, 4, 16, "bf16", 3), (2, 129, 4, 1, 256, "bf16", 64),
                 (1, 65, 16, 1, 256, "bf16", 0), (2, 300, 4, 2, 256, "bf16", 40),
                 (4, 1024, 16, 1, 256, "bf16", 256)]


@pytest.mark.parametrize("shape", FLASH_WINDOWS,
                         ids=[str(s) for s in FLASH_WINDOWS])
def test_flash_attention_window_kernel_matches_plain(dev, shape):
    b, s, h, hkv, dh, dt, window = shape
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    q = _randn(dev, b, s, h, dh, seed=1).to(dt)
    k = _randn(dev, b, s, hkv, dh, seed=2).to(dt)
    v = _randn(dev, b, s, hkv, dh, seed=3).to(dt)
    by_variant = dict(fa.flash_attention_bhsd.launches_by_variant)
    got = fa.flash_attention_bhsd(q, k, v, window=window)
    torch.cuda.synchronize()
    by_variant[fa.VARIANTS[dt]] += 1
    assert fa.flash_attention_bhsd.launches_by_variant == by_variant
    if dt == torch.float32:
        want = fa.flash_attention_plain(q, k, v, window)
        assert float((got - want).abs().max()) <= 2e-5
    else:
        ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got,
                                                            window)
        assert ok, (ratio, rms_got, rms_plain)


def test_flash_attention_window_past_s_is_causal_and_f32_256_raises(dev):
    # f32 at head dim 256 has an instance now (FLASH_NEW); a head dim
    # without one still raises
    q = _randn(dev, 2, 100, 4, 256, seed=1).bfloat16()
    k = _randn(dev, 2, 100, 1, 256, seed=2).bfloat16()
    assert torch.equal(fa.flash_attention_bhsd(q, k, k, window=2048),
                       fa.flash_attention_bhsd(q, k, k))
    with pytest.raises(ValueError, match="no head_dim 48 instance"):
        fa.flash_attention_bhsd(*(x[..., :48].float().contiguous()
                                  for x in (q, k, k)))


# head dim 96 (phi-3-vision) on both kernels, causal and banded; non-causal
# attention over a key length of its own (whisper's encoder at S = 1,500,
# a ragged last tile; its cross-attention, Sq 160 against Sk 1,500; Sq >
# Sk; Sk 16, below one tile); the f32 kernel at head dim 256: (b, sq, sk,
# h, hkv, dh, dtype, causal, window)
FLASH_NEW = [(2, 77, 77, 4, 2, 96, "bf16", True, 0),
             (4, 1024, 1024, 32, 32, 96, "bf16", True, 0),
             (2, 300, 300, 8, 8, 96, "f32", True, 0),
             (2, 130, 130, 4, 1, 96, "f32", True, 40),
             (2, 300, 300, 4, 1, 96, "bf16", True, 129),
             (2, 1500, 1500, 20, 20, 64, "bf16", False, 0),
             (4, 160, 1500, 20, 20, 64, "bf16", False, 0),
             (2, 200, 64, 4, 2, 64, "bf16", False, 0),
             (2, 24, 16, 4, 4, 64, "bf16", False, 0),
             (2, 77, 300, 4, 2, 96, "bf16", False, 0),
             (2, 1500, 1500, 4, 4, 64, "f32", False, 0),
             (2, 160, 1500, 4, 4, 64, "f32", False, 0),
             (2, 200, 64, 4, 2, 64, "f32", False, 0),
             (2, 24, 16, 4, 4, 64, "f32", False, 0),
             (1, 100, 129, 2, 1, 256, "f32", False, 0),
             (2, 100, 100, 4, 1, 256, "f32", True, 0),
             (2, 300, 300, 4, 2, 256, "f32", True, 40)]


@pytest.mark.parametrize("shape", FLASH_NEW, ids=[str(s) for s in FLASH_NEW])
def test_flash_attention_dh96_noncausal_f32_256_match_plain(dev, shape):
    b, sq, sk, h, hkv, dh, dt, causal, window = shape
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    q = _randn(dev, b, sq, h, dh, seed=1).to(dt)
    k = _randn(dev, b, sk, hkv, dh, seed=2).to(dt)
    v = _randn(dev, b, sk, hkv, dh, seed=3).to(dt)
    by_variant = dict(fa.flash_attention_bhsd.launches_by_variant)
    by_mask = dict(fa.flash_attention_bhsd.launches_by_mask)
    got = fa.flash_attention_bhsd(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    by_variant[fa.VARIANTS[dt]] += 1
    mask = ("band" if window else "causal") if causal \
        else ("self" if sq == sk else "cross")
    by_mask[f"{fa.VARIANTS[dt]}_{mask}"] += 1
    assert fa.flash_attention_bhsd.launches_by_variant == by_variant
    assert fa.flash_attention_bhsd.launches_by_mask == by_mask
    assert got.dtype == dt and got.shape == q.shape
    if dt == torch.float32:
        want = fa.flash_attention_plain(q, k, v, window, causal)
        assert float((got - want).abs().max()) <= 2e-5
    else:
        ok, ratio, rms_got, rms_plain = fa.bf16_error_check(
            q, k, v, got, window, causal)
        assert ok, (ratio, rms_got, rms_plain)


def test_hybrid_run_alg1_on_card_tracks_cpu(dev):
    task = transformer_task("recurrentgemma-9b")   # 3 layers, window 16
    data = task.default_data(n_train=96, n_test=24, seed=0)
    part = partition.iid(96, 4, seed=0)
    kw = dict(task=task, batch_size=4, rounds=2, eval_every=1,
              eval_samples=48, seed=1, tau=2.0, lam=0.0, secure=True,
              fused=True)
    tf32x3 = fa.flash_attention_bhsd.launches_by_variant["tf32x3"]
    p_gpu, h_gpu = runtime.run_alg1(data, part, **kw)
    # one attention layer x (2 uploads + 2 eval points x 2 forwards)
    assert fa.flash_attention_bhsd.launches_by_variant["tf32x3"] - tf32x3 \
        == 2 + 2 * 2
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    assert h_gpu.comm == h_cpu.comm
    np.testing.assert_allclose(h_gpu.train_cost, h_cpu.train_cost, rtol=1e-4)
    for a, b in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4)


def test_flash_attention_vmap_grad_on_card(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 100, 4, 64, generator=g).to(dev)
    kv = torch.randn(3, 2, 100, 2, 64, generator=g).to(dev)
    w = (torch.randn(64, 64, generator=g) * 0.1).to(dev)

    def loss(w, xi, ki):
        return (ops.flash_attention(xi @ w, ki, 0.5 * ki) ** 2).sum()

    before = fa.flash_attention_bhsd.launches_by_variant["tf32x3"]
    got = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0, 0))(
        w, x, kv)
    assert fa.flash_attention_bhsd.launches_by_variant["tf32x3"] \
        == before + 1
    want = torch.stack([torch.func.grad(loss)(w.cpu(), x[i].cpu(),
                                              kv[i].cpu()) for i in range(3)])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)


def test_lm_run_alg1_on_card_tracks_cpu(dev):
    task = transformer_task()            # head_dim 16
    data = task.default_data(n_train=96, n_test=24, seed=0)
    part = partition.iid(96, 4, seed=0)
    kw = dict(task=task, batch_size=4, rounds=4, eval_every=2,
              eval_samples=48, seed=1, tau=2.0, lam=0.0, secure=True,
              fused=True)
    before = fa.flash_attention_bhsd.launches
    tf32x3 = fa.flash_attention_bhsd.launches_by_variant["tf32x3"]
    p_gpu, h_gpu = runtime.run_alg1(data, part, **kw)
    # 2 layers x (4 uploads, one launch each for all clients, + 2 eval
    # points x 2 forwards), all on the f32 (tf32x3) kernel
    assert fa.flash_attention_bhsd.launches - before == 2 * (4 + 2 * 2)
    assert fa.flash_attention_bhsd.launches_by_variant["tf32x3"] - tf32x3 \
        == 2 * (4 + 2 * 2)
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    assert h_gpu.comm == h_cpu.comm
    np.testing.assert_allclose(h_gpu.train_cost, h_cpu.train_cost, rtol=1e-4)
    for a, b in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4)


WKV_SHAPES = [(8, 1024, 64, 64, "bf16", None, False),
              (2, 1, 4, 16, "f32", None, False),
              (2, 16, 4, 16, "f32", -5.0, True),
              (3, 40, 4, 16, "f32", 0.0, False),
              (2, 40, 2, 16, "f32", None, True),
              (2, 77, 3, 16, "bf16", -5.0, False),
              (1, 300, 2, 64, "f32", 0.0, True),
              (2, 1, 4, 64, "bf16", None, False),
              (3, 77, 4, 64, "bf16", -5.0, True),
              (2, 33, 4, 64, "bf16", 0.0, False)]


def _wkv_inputs(dev, n, s, h, d, dt, lw, per_seq, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(n, s, h, d, generator=g).to(dev, dt)
               for _ in range(3))
    if lw is None:
        lwt = torch.clamp(-torch.exp(torch.randn(n, s, h, d, generator=g)
                                     * 0.5 - 1.0), -5.0, 0.0)
    else:
        lwt = torch.full((n, s, h, d), lw)
    u = torch.randn(*((n, h, d) if per_seq else (h, d)), generator=g)
    return r, k, v, lwt.to(dev), u.to(dev)


@pytest.mark.parametrize("shape", WKV_SHAPES,
                         ids=[str(s) for s in WKV_SHAPES])
def test_rwkv6_wkv_kernel_matches_plain(dev, shape):
    n, s, h, d, dt, lw, per_seq = shape
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    x = _wkv_inputs(dev, n, s, h, d, dt, lw, per_seq)
    before = rw.rwkv6_wkv_bh.launches
    mma = rw.rwkv6_wkv_bh.launches_by_variant["mma"]
    got = rw.rwkv6_wkv_bh(*x)
    torch.cuda.synchronize()
    assert rw.rwkv6_wkv_bh.launches == before + 1
    assert rw.rwkv6_wkv_bh.launches_by_variant["mma"] == mma + 1
    assert got.dtype == torch.float32 and got.shape == x[0].shape
    want = rw.wkv_plain(*x)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_rwkv6_wkv_kernel_takes_misaligned_views(dev):
    """The kernel's cp.async loads need 16-byte aligned rows: a view at an
    odd offset is copied first, and gives the aligned tensor's output."""
    x = _wkv_inputs(dev, 2, 40, 3, 64, torch.bfloat16, None, True)
    got = rw.rwkv6_wkv_bh(*(_shifted(t) for t in x[:4]), x[4])
    assert torch.equal(got, rw.rwkv6_wkv_bh(*x))


def test_rwkv6_wkv_kernel_refuses_bad_arguments(dev):
    x = [torch.zeros(1, 4, 2, 128, device=dev) for _ in range(4)]
    u = torch.zeros(2, 128, device=dev)
    before = rw.rwkv6_wkv_bh.launches
    with pytest.raises(ValueError, match="head size"):
        rw.rwkv6_wkv_bh(*x, u)
    for d in (8, 32):
        with pytest.raises(ValueError, match="head size"):
            rw.rwkv6_wkv_bh(*(t[..., :d] for t in x), u[:, :d])
    y = [t[..., :16] for t in x]
    with pytest.raises(ValueError, match="f32 or bf16"):
        rw.rwkv6_wkv_bh(*(t.half() for t in y[:3]), y[3], u[:, :16])
    with pytest.raises(ValueError, match="f32 lw and u"):
        rw.rwkv6_wkv_bh(*y[:3], y[3].bfloat16(), u[:, :16])
    assert rw.rwkv6_wkv_bh.launches == before


@pytest.mark.parametrize("u_batched", [False, True],
                         ids=["u_shared", "u_batched"])
def test_rwkv6_wkv_vmap_grad_on_card(dev, u_batched):
    g = torch.Generator().manual_seed(0)
    m = 3
    x = torch.randn(m, 2, 50, 4, 64, generator=g).to(dev)
    lw = torch.clamp(-torch.exp(torch.randn(m, 2, 50, 4, 64, generator=g)
                                - 1), -5, 0).to(dev)
    u = torch.randn(*((m, 4, 64) if u_batched else (4, 64)),
                    generator=g).to(dev)
    w = (torch.randn(64, 64, generator=g) * 0.1).to(dev)

    def loss(w, xi, lwi, ui):
        return (rw.RWKV6WKV.apply(xi @ w, xi, 0.5 * xi, lwi, ui) ** 2).sum()

    before = rw.rwkv6_wkv_bh.launches
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 3)),
                          in_dims=(None, 0, 0, 0 if u_batched else None))(
        w, x, lw, u)
    assert rw.rwkv6_wkv_bh.launches == before + 1
    for j, gj in enumerate(got):
        want = torch.stack([
            torch.func.grad(loss, argnums=(0, 3))(
                w.cpu(), x[i].cpu(), lw[i].cpu(),
                (u[i] if u_batched else u).cpu())[j] for i in range(m)])
        torch.testing.assert_close(gj.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_rwkv_run_alg1_on_card_tracks_cpu(dev):
    task = rwkv6_task()                  # head size 16
    data = task.default_data(n_train=96, n_test=24, seed=0)
    part = partition.iid(96, 4, seed=0)
    kw = dict(task=task, batch_size=4, rounds=4, eval_every=2,
              eval_samples=48, seed=1, tau=2.0, lam=0.0, secure=True,
              fused=True)
    before = rw.rwkv6_wkv_bh.launches
    mma = rw.rwkv6_wkv_bh.launches_by_variant["mma"]
    p_gpu, h_gpu = runtime.run_alg1(data, part, **kw)
    # 2 layers x (4 uploads, one launch each for all clients, + 2 eval
    # points x 2 forwards), all on the tensor-core kernel
    assert rw.rwkv6_wkv_bh.launches - before == 2 * (4 + 2 * 2)
    assert rw.rwkv6_wkv_bh.launches_by_variant["mma"] - mma \
        == 2 * (4 + 2 * 2)
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    assert h_gpu.comm == h_cpu.comm
    np.testing.assert_allclose(h_gpu.train_cost, h_cpu.train_cost, rtol=1e-4)
    for a, b in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4)


def _reduced_lm(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import build_model
    model = build_model(reduced(get_config(arch)))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return model, params


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b",
                                  "recurrentgemma-9b"])
def test_reduced_decode_on_card_tracks_cpu(dev, arch):
    """12 decode steps of the reduced model (f32) on the card against the
    CPU (20 for the hybrid, past its window of 16): logits within 1e-4 of
    the largest |logit| (TF32 off), and no hand-written kernel
    launched."""
    model, params = _reduced_lm(arch)
    n = 20 if arch == "recurrentgemma-9b" else 12
    tok = torch.randint(0, 512, (2, n),
                        generator=torch.Generator().manual_seed(1))
    s_gpu = model.init_decode(2, n, device=dev)
    s_cpu = model.init_decode(2, n, device="cpu")
    p_gpu = tree.map(lambda w: w.to(dev), params)
    launches = (fa.flash_attention_bhsd.launches, rw.rwkv6_wkv_bh.launches,
                su.ssca_update_2d.launches)
    for t in range(n):
        l_gpu, s_gpu = model.decode_step(p_gpu, s_gpu, tok[:, t:t + 1].to(dev))
        l_cpu, s_cpu = model.decode_step(params, s_cpu, tok[:, t:t + 1])
        err = float((l_gpu.cpu() - l_cpu).abs().max())
        assert err <= 1e-4 * float(l_cpu.abs().max()), (t, err)
    assert int(s_gpu.length) == n
    assert (fa.flash_attention_bhsd.launches, rw.rwkv6_wkv_bh.launches,
            su.ssca_update_2d.launches) == launches


def test_train_step_on_card_launches_lambda0(dev):
    from repro_torch.core import ssca
    from repro_torch.launch import steps, train
    model, params = _reduced_lm("llama3-8b")
    step = steps.make_train_step(model, ssca.SSCAHyperParams(tau=2.0))
    batch = next(train.batch_stream(model.cfg, 4, 32, device="cpu"))
    p_gpu = tree.map(lambda w: w.to(dev), params)
    before = dict(su.ssca_update_2d.launches_by_variant)
    q_gpu, s_gpu, m_gpu = step(p_gpu, ssca.init(p_gpu, with_beta=False),
                               {"tokens": batch["tokens"].to(dev)})
    torch.cuda.synchronize()
    after = su.ssca_update_2d.launches_by_variant
    assert (after["lambda0"] - before["lambda0"],
            after["beta"] - before["beta"]) == (1, 0)
    q_cpu, s_cpu, m_cpu = step(params, ssca.init(params, with_beta=False),
                               batch)
    assert s_gpu.step == s_cpu.step == 2 and s_gpu.beta is None
    np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree.leaves(q_gpu), tree.leaves(q_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-large-v3"])
def test_vlm_audio_on_card_track_cpu(dev, arch):
    """The reduced vlm and audio models (f32) on the card against the
    CPU: the forward over stub embeddings (the tf32x3 kernel once a
    layer: the vlm's 2 causal, whisper's 2 encoder, 2 causal and 2 cross
    launches), logits within 1e-4 of the largest |logit|; then 8 decode
    steps (whisper after ``precompute_cross``: its 2 encoder launches),
    no kernel in the loop, within the same bound."""
    model, params = _reduced_lm(arch)
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn(2, cfg.num_image_tokens,
                                          cfg.d_model, generator=g)
    else:
        batch["frame_embeds"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                            generator=g)
    p_gpu = tree.map(lambda w: w.to(dev), params)
    b_gpu = {k: v.to(dev) for k, v in batch.items()}
    before = fa.flash_attention_bhsd.launches_by_variant["tf32x3"]
    got = model.forward(p_gpu, b_gpu).cpu()
    want = model.forward(params, batch)
    assert fa.flash_attention_bhsd.launches_by_variant["tf32x3"] - before \
        == (2 if cfg.family == "vlm" else 6)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    s_gpu = model.init_decode(2, 8, device=dev)
    s_cpu = model.init_decode(2, 8, device="cpu")
    if cfg.family == "audio":
        s_gpu = model.precompute_cross(p_gpu, b_gpu, s_gpu)
        s_cpu = model.precompute_cross(params, batch, s_cpu)
    before = fa.flash_attention_bhsd.launches
    for t in range(8):
        l_gpu, s_gpu = model.decode_step(p_gpu, s_gpu, tok[:, t:t + 1].to(dev))
        l_cpu, s_cpu = model.decode_step(params, s_cpu, tok[:, t:t + 1])
        err = float((l_gpu.cpu() - l_cpu).abs().max())
        assert err <= 1e-4 * float(l_cpu.abs().max()), (t, err)
    assert fa.flash_attention_bhsd.launches == before
