"""Fused count-sketch encode: the kernel wrapper, its plain version, and
the server-side estimators.

The port of ``repro/kernels/sketch.py``.  A client's flattened message
x ∈ R^n becomes a count-sketch S ∈ Z^{rows×cols} whose buckets lie on
the secure fixed-point grid 2^-s.  Per element j and sketch row r:

1. q_j = ⌊x_j·2^s⌋ + [u_j < frac], u_j the client's counter-mode
   uniform (:func:`round_to_grid`);
2. w = ``mask_bits(row_seed(sketch_seed, r), j)``: bucket h = w & (cols−1)
   (cols a power of two), sign σ = 1 − 2·(w >> 31) (:func:`hash_and_sign`);
3. S[r, h] += σ·q_j in int32 with wraparound — exact in any order, so
   sketches merge linearly in the ring.

Each client's scalars are an (I, 3) int64 row [stream seed, counter base,
sketch seed] (uint32 values).  On a CUDA tensor :func:`sketch_encode`
launches the hand-written kernel ``csrc/sketch.cu``, one launch for all
clients: each block streams a share of one client's message with 16-byte
loads, encodes only its nonzero elements and adds their levels into the
zero-filled output with integer atomics.  On a CPU tensor it runs
:func:`sketch_encode_plain`.  Both agree bit for bit.

The estimators (:func:`sketch_estimate`, :func:`sketch_estimate_median`)
run on the server once a round; the reference computes them with XLA, and
the port with plain PyTorch on whatever device holds the sketch.
"""
from __future__ import annotations

import torch

from repro_torch import Device, on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.compress import counters, uniform
from repro_torch.kernels.secure_agg import _GOLD, _MASK, _mix32, \
    _to_int32, mask_bits

LANES = 128


def row_seed(sketch_seed, r: int):
    """PRF seed of sketch row r: shared by every client and round, or the
    sketches would not merge."""
    return _mix32(sketch_seed ^ (((r + 1) * _GOLD) & _MASK))


def hash_and_sign(rseed, ctrs: torch.Tensor, cols: int):
    """One PRF word per counter → (bucket in [0, cols) as int64, sign ±1
    as int64)."""
    w = mask_bits(rseed, ctrs)
    return w & (cols - 1), 1 - 2 * (w >> 31)


def round_level(x: torch.Tensor, u: torch.Tensor,
                scale_bits: int) -> torch.Tensor:
    """The level of f32 x on the grid of 2^-s at the uniform u ∈ [0, 1],
    as int64: ⌊x·2^s⌋ + [u < frac].  +0, −0 and NaN give 0 for every u
    (u ≥ 0 never beats a zero fraction, and NaN converts to 0), which is
    why the kernel draws no u for them.  The float → int conversion
    saturates to the int32 range and sends NaN to 0, as XLA's and the
    card's conversions do."""
    y = x * float(2.0 ** scale_bits)
    low = torch.floor(y)
    q = low + (u < (y - low)).to(torch.float32)
    q = torch.nan_to_num(q.double(), nan=0.0)
    return q.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def round_to_grid(x: torch.Tensor, ctrs: torch.Tensor, seed,
                  scale_bits: int) -> torch.Tensor:
    """Unbiased stochastic round of f32 onto integer units of 2^-s, as
    int64, u the client's counter-mode uniform at each counter.  An exact
    zero stays zero."""
    return round_level(x, uniform(mask_bits(seed, ctrs)), scale_bits)


def _check_cols(cols: int) -> None:
    if not 1 <= int(cols) <= 2 ** 24 or int(cols) & (int(cols) - 1):
        raise ValueError(f"cols={cols!r} must be a power of two in "
                         "[1, 2^24] (the bucket hash is the PRF word's low "
                         "bits)")


def sketch_encode_plain(x, su, *, rows: int, cols: int,
                        scale_bits: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`sketch_encode`: (I, R, 128) f32
    → (I, rows, cols) int32 bucket sums in grid units."""
    clients = x.shape[0]
    flat = x.reshape(clients, -1)
    ctrs = counters(su, flat.shape[1])
    q = round_to_grid(flat, ctrs, su[:, 0:1], scale_bits)
    out = torch.zeros(clients, rows, cols, dtype=torch.int64,
                      device=x.device)
    for r in range(rows):
        h, sgn = hash_and_sign(row_seed(su[:, 2:3], r), ctrs, cols)
        out[:, r].scatter_add_(1, h, sgn * q)
    return _to_int32(out & _MASK)


def sketch_encode(x: torch.Tensor, su: torch.Tensor, *, rows: int,
                  cols: int, scale_bits: int,
                  device: Device = None) -> torch.Tensor:
    """x: (I, R, 128) f32; su: (I, 3) int64 [stream seed, counter base,
    sketch seed].  Returns the (I, rows, cols) int32 sketches.

    A CPU tensor goes to :func:`sketch_encode_plain` (only with
    ``device="cpu"``); a CUDA tensor launches the kernel and adds one to
    ``sketch_encode.launches``.  A message that is not 16-byte aligned, as
    the kernel's loads need, is copied first.
    """
    if x.dim() != 3 or x.shape[2] != LANES:
        raise ValueError(f"sketch_encode takes (I, R, {LANES}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"sketch_encode takes an f32 message, got "
                         f"{x.dtype}")
    _check_cols(cols)
    if not 1 <= int(rows) <= 64:
        raise ValueError(f"rows={rows!r} outside [1, 64]")
    if not 1 <= int(scale_bits) <= 30:
        raise ValueError(f"scale_bits={scale_bits} outside [1, 30]")
    if su.shape != (x.shape[0], 3) or su.dtype != torch.int64 \
            or su.device != x.device:
        raise ValueError(f"su must be ({x.shape[0]}, 3) int64 beside x")
    if not on_cuda(x, device):
        return sketch_encode_plain(x, su, rows=rows, cols=cols,
                                   scale_bits=scale_bits)
    if x.shape[0] > 65535:
        raise ValueError(f"sketch_encode kernel takes at most 65535 "
                         f"clients, got {x.shape[0]}")
    x, su = x.contiguous(), su.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    lib = build.load()
    out = torch.zeros(x.shape[0], rows, cols, dtype=torch.int32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.sketch_encode_launch(
        x.data_ptr(), su.data_ptr(), x.shape[0], x.shape[1] * LANES,
        int(rows), int(cols), int(scale_bits), out.data_ptr(), stream)
    build.check(status, "sketch_encode")
    sketch_encode.launches += 1
    return out


sketch_encode.launches = 0


def _row_terms(sk: torch.Tensor, ctrs: torch.Tensor, sketch_seed: int):
    rows, cols = sk.shape
    for r in range(rows):
        h, sgn = hash_and_sign(row_seed(sketch_seed, r), ctrs, cols)
        yield sgn.to(torch.float32) * sk[r][h]


def sketch_estimate(sk: torch.Tensor, ctrs: torch.Tensor,
                    sketch_seed: int) -> torch.Tensor:
    """Mean-of-rows estimate at the (m,) int64 counters from a (rows, cols)
    f32 sketch: unbiased over the hash stream and linear in the sketch.
    Sums the rows in order, then divides, as the reference does."""
    acc = torch.zeros(ctrs.shape, dtype=torch.float32, device=sk.device)
    for term in _row_terms(sk, ctrs, sketch_seed):
        acc = acc + term
    return acc / float(sk.shape[0])


def sketch_estimate_median(sk: torch.Tensor, ctrs: torch.Tensor,
                           sketch_seed: int) -> torch.Tensor:
    """Median-of-rows estimate, as ``jnp.median`` computes it: the sorted
    rows' middle pair (s[lo] + s[hi])·0.5, one value for odd rows.
    ``torch.median`` would return the lower middle value instead."""
    rows = sk.shape[0]
    s = torch.sort(torch.stack(list(_row_terms(sk, ctrs, sketch_seed))),
                   dim=0).values
    return (s[(rows - 1) // 2] + s[rows // 2]) * 0.5
