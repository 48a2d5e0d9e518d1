"""Fused upload compression: the kernel wrapper and its plain version.

The port of ``repro/kernels/compress.py``.  One elementwise pass over a
client's (R, 128) message fuses

1. stochastic rounding onto the lattice q·Δ (Δ a power of two):
   y = x/Δ is rounded to ⌊y⌋ + [u < y − ⌊y⌋], u the client's
   counter-mode uniform at the element's counter, then clipped to ±L;
2. threshold masking |x| ≥ θ (the top-k sparsifier's apply step);
3. the residual x − out (error feedback),

with the scalars of each client in an (I, 2) int64 row [stream seed,
counter base] (uint32 values) and an (I, 2) f32 row [θ, Δ].  The random
bits come from the same PRF as the secure-aggregation masks, keyed per
(round, client) by :func:`client_stream_seed`, so any element's draw
depends on its counter alone.

On a CUDA tensor :func:`compress_2d` launches the hand-written kernel
``csrc/compress.cu``, one launch for all clients; on a CPU tensor it runs
:func:`compress_2d_plain`.  Both round every f32 operation separately,
in the same order, and agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import Device, on_cuda
from repro_torch.kernels import build
from repro_torch.kernels.secure_agg import _GOLD, _M1, _MASK, _mix32, \
    mask_bits

LANES = 128

_U32_RES = 2.0 ** -32


def client_stream_seed(key0, key1, cid):
    """Per-(round, client) seed of the stochastic-rounding stream, from the
    round key words and the global client id (ints, or uint32 words held
    in int64 tensors)."""
    s = _mix32(key0 ^ ((cid * _GOLD) & _MASK))
    return _mix32(s ^ ((key1 * _M1) & _MASK))


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 PRF words (in int64) → f32 uniforms in [0, 1]: the int64 →
    f32 conversion rounds to nearest even, as the reference's uint32 →
    f32 does; the scaling by 2^-32 is exact."""
    return bits.to(torch.float32) * _U32_RES


def counters(su: torch.Tensor, per_client: int) -> torch.Tensor:
    """(I, per_client) uint32 counters base_i + e, held in int64."""
    e = torch.arange(per_client, dtype=torch.int64, device=su.device)
    return (su[:, 1:2] + e) & _MASK


def compress_2d_plain(x, su, sf, *, lbound: int, quantize: bool,
                      masked: bool):
    """The plain PyTorch version of :func:`compress_2d`: (I, R, 128) f32
    → (out, residual)."""
    clients = x.shape[0]
    flat = x.reshape(clients, -1)
    out = flat
    if quantize:
        delta = sf[:, 1:2]
        y = flat / delta
        low = torch.floor(y)
        u = uniform(mask_bits(su[:, 0:1], counters(su, flat.shape[1])))
        q = low + (u < (y - low)).to(torch.float32)
        q = torch.clamp(q, -float(lbound), float(lbound))
        out = q * delta
    if masked:
        out = torch.where(flat.abs() >= sf[:, 0:1], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(x.shape), (flat - out).reshape(x.shape)


def _check_scalars(x, t, width, dtype, name):
    if t.shape != (x.shape[0], width) or t.dtype != dtype \
            or t.device != x.device:
        raise ValueError(f"{name} must be ({x.shape[0]}, {width}) {dtype} "
                         f"beside x, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def compress_2d(x: torch.Tensor, su: torch.Tensor, sf: torch.Tensor, *,
                lbound: int, quantize: bool, masked: bool,
                device: Device = None):
    """x: (I, R, 128) f32; su: (I, 2) int64 [stream seed, counter base];
    sf: (I, 2) f32 [θ, Δ].  Returns (out, residual), both (I, R, 128).

    A CPU tensor goes to :func:`compress_2d_plain` (only with
    ``device="cpu"``); a CUDA tensor launches the kernel and adds one to
    ``compress_2d.launches``.
    """
    if x.dim() != 3 or x.shape[2] != LANES:
        raise ValueError(f"compress_2d takes (I, R, {LANES}), got "
                         f"{tuple(x.shape)}")
    if not 1 <= int(lbound) < 2 ** 24:
        raise ValueError(f"lbound={lbound} outside [1, 2^24)")
    if x.dtype != torch.float32:
        raise ValueError(f"compress_2d takes an f32 message, got {x.dtype}")
    _check_scalars(x, su, 2, torch.int64, "su")
    _check_scalars(x, sf, 2, torch.float32, "sf")
    if not on_cuda(x, device):
        return compress_2d_plain(x, su, sf, lbound=lbound, quantize=quantize,
                                 masked=masked)
    x = x.contiguous()
    lib = build.load()
    out, res = torch.empty_like(x), torch.empty_like(x)
    su, sf = su.contiguous(), sf.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.compress_launch(
        x.data_ptr(), su.data_ptr(), sf.data_ptr(), x.shape[0],
        x.shape[1] * LANES, int(lbound), int(bool(quantize)),
        int(bool(masked)), out.data_ptr(), res.data_ptr(), stream)
    build.check(status, "compress")
    compress_2d.launches += 1
    return out, res


compress_2d.launches = 0
