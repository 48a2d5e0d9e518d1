"""The masked-sum kernel's launch plan, and its arithmetic emulated on the
CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).
What decides its variant and grid is Python (``launch_plan``), and what
it computes differs from the plain version in
three ways that numpy can replay: the PRF in its folded form, the stream
table without its zero coefficients in no fixed order, and the streams
of each element split over groups of threads.  Ring arithmetic has no
tolerance: the emulation equals ``masked_sum_plain`` bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import secure_agg as tsa

K0, K1 = 0x9E3779B1, 0x12345
H100_SMS = 132
# threads the card holds at once at the kernel's launch bound
RESIDENT = H100_SMS * tsa.BLOCKS_PER_SM * tsa.THREADS


def _fold16(v):
    return v ^ (v >> np.uint32(16))


def _folded_mask_bits(f_seed, f_seed2, f_ctr):
    """The kernel's mask_bits: from f(seed), f(seed + kGold) and f(ctr),
    f(v) = v ^ (v >> 16), in uint32 arithmetic."""
    m1, m2 = np.uint32(tsa._M1), np.uint32(tsa._M2)
    x = (f_ctr ^ f_seed) * m1
    x = (x ^ (x >> np.uint32(15))) * m2
    x = (x ^ f_seed2) * m1
    x = (x ^ (x >> np.uint32(15))) * m2
    return x ^ (x >> np.uint32(16))


def test_folded_mask_bits_equal_mask_bits():
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    ctrs = np.concatenate([np.arange(4096, dtype=np.uint32),
                           rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                           .astype(np.uint32)])
    for seed in seeds:
        seed2 = np.uint32((int(seed) + tsa._GOLD) & tsa._MASK)
        got = _folded_mask_bits(_fold16(np.full_like(ctrs, seed)),
                                _fold16(np.full_like(ctrs, seed2)),
                                _fold16(ctrs))
        want = tsa.mask_bits(int(seed), torch.from_numpy(
            ctrs.astype(np.int64))).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)


def _emulate_kernel(msgs, *, scale_bits, num_clients, offset, alive,
                    order_seed=0, table=512):
    """csrc/secure_agg.cu on (I_loc, n) f32 messages, as numpy replays it:
    the plan's groups, each with its rows and its slice of every table
    chunk, the chunks' entries shuffled (the kernel's atomics place them
    in no fixed order), the groups' partial sums added."""
    i_loc, n = msgs.shape
    _, splits, _ = tsa.launch_plan(n, i_loc, num_clients, H100_SMS)
    rng = np.random.default_rng(order_seed)
    f_ctr = _fold16(np.arange(n, dtype=np.uint32))
    total = i_loc * num_clients
    chunks = []
    for c0 in range(0, total, table):
        entries = []
        for c in range(c0, min(c0 + table, total)):
            i, j = offset + c // num_clients, c % num_clients
            coef = 0 if j == i else 1 if i < j else tsa._MASK
            if alive is not None:
                coef = coef * int(alive[i]) * int(alive[j]) & tsa._MASK
            if coef:
                seed = tsa.pair_seed(K0, K1, min(i, j), max(i, j))
                entries.append((seed ^ seed >> 16,
                                (seed + tsa._GOLD & tsa._MASK)
                                ^ (seed + tsa._GOLD & tsa._MASK) >> 16,
                                coef))
        rng.shuffle(entries)
        chunks.append(entries)
    q = np.rint(msgs.astype(np.float32) * np.float32(2.0 ** scale_bits)) \
        .astype(np.int64).astype(np.uint32)
    out = np.zeros(n, np.uint32)
    for g in range(splits):
        acc = np.zeros(n, np.uint32)
        for li in range(g, i_loc, splits):
            a = 1 if alive is None else int(alive[offset + li])
            acc += np.uint32(a) * q[li]
        for entries in chunks:
            m = len(entries)
            mine = entries[m * g // splits:m * (g + 1) // splits]
            for f1, f2, coef in mine:
                acc += np.uint32(coef) * _folded_mask_bits(
                    np.uint32(f1), np.uint32(f2), f_ctr)
        out += acc
    return out.view(np.int32)


@pytest.mark.parametrize("num,offset,clients,rows,dropped", [
    (10, 0, 10, 8, ()),           # the MLP path's clients, 8 splits
    (10, 0, 10, 8, (1, 4)),       # two dropouts
    (1, 0, 1, 8, ()),             # one client: no stream
    (1, 6, 10, 8, ()),            # one client's upload
    (4, 2, 7, 4, (0, 3)),         # client_offset, a dropped local row
    (3, 0, 600, 2, (5,)),         # 1,800 candidates: four table chunks
])
def test_kernel_emulation_equals_plain(num, offset, clients, rows, dropped):
    rng = np.random.default_rng(7)
    m = (rng.standard_normal((num, rows * 128)) * 0.05).astype(np.float32)
    m[:, :4] = np.float32(2.5 / 2 ** 20)   # half points of the grid
    alive = None
    if dropped:
        alive = np.ones(clients, np.int64)
        alive[list(dropped)] = 0
    kw = dict(scale_bits=20, num_clients=clients, client_offset=offset)
    want = tsa.masked_sum_plain(
        torch.from_numpy(m), K0, K1, alive=None if alive is None
        else torch.from_numpy(alive), **kw).numpy()
    for order_seed in (0, 1):
        got = _emulate_kernel(m, scale_bits=20, num_clients=clients,
                              offset=offset, alive=alive,
                              order_seed=order_seed)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,i_loc,clients,plan", [
    # one row of 128: every split the streams allow
    (128, 10, 10, ("rowsplit", 8, 1)),
    (128, 1, 1, ("vec", 1, 1)),        # no stream to split
    (128, 2, 2, ("rowsplit", 2, 1)),   # two streams: two groups
    (128, 1, 3, ("rowsplit", 2, 1)),   # one client's two streams
    (128, 3, 600, ("rowsplit", 8, 1)),  # past one table chunk
    # the paper's MLP: 25,408 threads of four elements, split 4 ways
    (101_632, 10, 10, ("rowsplit", 4, 397)),
    (101_632, 1, 10, ("rowsplit", 4, 397)),  # one client's upload
    # the wave threshold: split while twice the threads fit the card
    (2 * RESIDENT, 4, 4, ("rowsplit", 2, 528)),
    (2 * RESIDENT + 128, 4, 4, ("vec", 1, 265)),
    (RESIDENT, 4, 4, ("rowsplit", 4, 528)),
    # the full-width LM paths: a persistent grid of 1,024-element tiles
    (961_564_672, 4, 4, ("vec", 1, 528)),
    (705_802_240, 4, 4, ("vec", 1, 528)),
])
def test_masked_sum_launch_plan(n, i_loc, clients, plan):
    assert tsa.launch_plan(n, i_loc, clients, H100_SMS) == plan
    variant, splits, blocks = plan
    assert variant in tsa.VARIANTS
    # the grid covers n, and the split threads fit the card at once
    tile = tsa.THREADS // splits * tsa.ELEMS
    assert blocks <= H100_SMS * tsa.BLOCKS_PER_SM
    assert blocks == min(-(-n // tile), H100_SMS * tsa.BLOCKS_PER_SM)
    if splits > 1:
        assert -(-n // tsa.ELEMS) * splits <= RESIDENT
        assert splits <= i_loc * (clients - 1)

