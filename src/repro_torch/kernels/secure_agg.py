"""Streaming secure aggregation: the kernel wrapper and its plain version.

The port of ``repro/kernels/secure_agg.py``.  One pass over the clients'
messages fuses

1. fixed-point quantization q_i = round(m_i · 2^scale_bits) → int32
   (round half to even),
2. counter-mode pair masks: the directed stream of client i against peer
   j is ``mask_bits(pair_seed(k0, k1, min(i, j), max(i, j)), e)`` at flat
   element index e, added for i < j and subtracted for i > j, and
3. the Z_{2^32} sum of the masked uploads,

and returns Σ_i q_i bit for bit: the masks cancel exactly in the ring.
``alive`` (0/1 over the global client positions) drops clients: a dropped
row uploads nothing and every survivor's stream against it is cancelled.
The ring mode (:func:`masked_ring_sum_2d`, the reference's
``masked_ring_partial_sum``) takes rows that are int32 ring elements
already and skips step 1: the hierarchical tree's level 2 re-masks its
group partials with it, under :func:`group_key_words`.

On a CUDA tensor :func:`masked_sum_2d` and :func:`masked_ring_sum_2d`
launch the hand-written kernel ``csrc/secure_agg.cu`` (one template, two
instances) on the plan of :func:`launch_plan`; on a CPU tensor they run
:func:`masked_sum_plain` and :func:`masked_ring_sum_plain`.

torch has no ``>>`` or ``+`` on ``uint32`` on the CPU, so the plain PRF
holds each uint32 word in an int64 and masks it to 32 bits after every
operation.  An int64 product of two words can pass 2^63 and wrap, but its
low 32 bits, the only ones kept, stay right.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch import Device, on_cuda
from repro_torch.kernels import build

LANES = 128
# the kernel's launch geometry (csrc/secure_agg.cu): threads a block,
# consecutive elements a thread, blocks an SM (its launch bound), and the
# most groups of threads that split one element tile's streams (a warp
# each)
THREADS = 256
ELEMS = 4
BLOCKS_PER_SM = 4
MAX_SPLITS = 8
VARIANTS = ("vec", "rowsplit")

_MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLD = 0x9E3779B9
# the domain-separation tag of the hierarchical tree's group level
_GROUP_TAG = 0x47525550


def _mix32(x):
    """murmur3 fmix32 on uint32 words held in int64 (or Python ints)."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


def pair_seed(key0, key1, lo, hi):
    """Shared mask-stream seed s_{lo,hi} of the ordered pair lo < hi."""
    s = _mix32(key0 ^ ((lo * _GOLD) & _MASK))
    s = _mix32(s ^ ((hi * _M1) & _MASK))
    return _mix32(s ^ key1)


def mask_bits(seed, counters):
    """Counter-mode mask words: one uint32 (in int64) per position."""
    h = _mix32(counters ^ seed)
    return _mix32(h ^ ((seed + _GOLD) & _MASK))


def quantize(m: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """Fixed-point grid 2^-scale_bits → int32 (round half to even)."""
    return torch.round(m.float() * float(2.0 ** scale_bits)).to(torch.int32)


def dequantize(q: torch.Tensor, scale_bits: int) -> torch.Tensor:
    return q.float() / float(2.0 ** scale_bits)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words in int64 → the int32 with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


def group_key_words(key0: int, key1: int) -> tuple[int, int]:
    """The round key words of the hierarchical tree's group level: each
    word avalanched through :data:`_GROUP_TAG`, so no group-level
    ``pair_seed`` shares a (seed, counter) pair with a client-level stream
    of the same round."""
    return (_mix32((int(key0) ^ _GROUP_TAG) & _MASK),
            _mix32((int(key1) ^ _GROUP_TAG) & _MASK))


def masked_ring_sum_plain(q: torch.Tensor, key0: int, key1: int, *,
                          num_clients: int, client_offset: int = 0,
                          alive: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain PyTorch version of :func:`masked_ring_sum_2d` (the
    reference's ``masked_ring_partial_sum``): each local row of int32 ring
    elements gets its masked upload formed in full, then the uploads are
    summed mod 2^32."""
    i_loc = q.shape[0]
    out_shape = q.shape[1:]
    flat = q.reshape(i_loc, -1).to(torch.int64) & _MASK
    counters = torch.arange(flat.shape[1], dtype=torch.int64,
                            device=q.device)
    alive_i = None if alive is None else [int(a) for a in alive.tolist()]
    acc = torch.zeros_like(counters)
    for li in range(i_loc):
        i = client_offset + li
        up = flat[li]
        for j in range(num_clients):
            if j == i:
                continue
            coef = 1 if i < j else _MASK                  # −1 mod 2^32
            if alive_i is not None:
                coef *= alive_i[j]
            if coef:
                bits = mask_bits(pair_seed(key0, key1, min(i, j), max(i, j)),
                                 counters)
                up = (up + coef * bits) & _MASK
        if alive_i is not None:
            up = up * alive_i[i]
        acc = (acc + up) & _MASK
    return _to_int32(acc).reshape(out_shape)


def masked_sum_plain(msgs, key0: int, key1: int, *, scale_bits: int,
                     num_clients: int, client_offset: int = 0,
                     alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`masked_sum_2d`: the messages
    quantized, then :func:`masked_ring_sum_plain`."""
    return masked_ring_sum_plain(quantize(msgs, scale_bits), key0, key1,
                                 num_clients=num_clients,
                                 client_offset=client_offset, alive=alive)


def launch_plan(n: int, i_loc: int, num_clients: int, sm_count: int
                ) -> tuple[str, int, int]:
    """``(variant, splits, blocks)`` of the kernel for n elements of I_loc
    client rows among ``num_clients``, on a card of ``sm_count`` SMs.

    One thread takes four elements.  Where those threads would fill less
    than half of what the card holds at once (``sm_count`` ×
    ``BLOCKS_PER_SM`` × ``THREADS``), the streams of each element are
    split over 2, 4 or 8 groups of threads, doubling while the card still
    holds them all and each group keeps at least one directed stream (the
    ``rowsplit`` variant); otherwise ``vec``.  The grid is persistent:
    at most ``BLOCKS_PER_SM`` blocks an SM, each striding over element
    tiles of ``THREADS // splits × ELEMS``.
    """
    streams = i_loc * (num_clients - 1)
    threads = -(-n // ELEMS)
    resident = sm_count * BLOCKS_PER_SM * THREADS
    splits = 1
    while (splits < MAX_SPLITS and threads * splits * 2 <= resident
           and splits * 2 <= streams):
        splits *= 2
    tile = THREADS // splits * ELEMS
    blocks = max(1, min(-(-n // tile), sm_count * BLOCKS_PER_SM))
    return ("rowsplit" if splits > 1 else "vec"), splits, blocks


def kernel_attributes() -> dict:
    """``(registers a thread, local (spill) bytes a thread, static shared
    bytes a block)`` of each instance of the kernel, from
    ``cudaFuncGetAttributes``: ``"f32"`` the quantizing masked sum's,
    ``"ring"`` the int32 ring mode's."""
    out = {}
    for name, ring in (("f32", 0), ("ring", 1)):
        vals = (ctypes.c_int * 3)()
        build.load().masked_sum_attributes(ring, vals)
        out[name] = tuple(vals)
    return out


def _checked(name: str, rows: torch.Tensor, key0: int, key1: int,
             num_clients: int, client_offset: int,
             alive: Optional[torch.Tensor]) -> None:
    """The arguments both modes refuse, before anything is launched."""
    if rows.dim() != 3 or rows.shape[2] != LANES:
        raise ValueError(f"{name} takes (I_loc, R, {LANES}), got "
                         f"{tuple(rows.shape)}")
    words = np.asarray([key0, key1, client_offset], np.int64)
    if ((words < 0) | (words > _MASK)).any():
        raise ValueError("key words and client_offset must be uint32")
    if client_offset + rows.shape[0] > num_clients:
        raise ValueError(
            f"rows [{client_offset}, {client_offset + rows.shape[0]}) do not "
            f"fit among num_clients={num_clients}")
    if alive is not None and alive.shape != (num_clients,):
        raise ValueError(f"alive must be ({num_clients},), got "
                         f"{tuple(alive.shape)}")


def _launch(fn, name: str, rows: torch.Tensor, scale_args: tuple,
            key0: int, key1: int, num_clients: int, client_offset: int,
            alive: Optional[torch.Tensor], out: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """Launch either mode on :func:`launch_plan`'s variant, into ``out``
    (allocated when ``None``), and count the launch on ``fn``."""
    alive_ptr = None
    if alive is not None:
        if alive.device != rows.device:
            raise ValueError("alive must lie beside the messages")
        alive = alive.to(torch.int32).contiguous()
        alive_ptr = alive.data_ptr()
    if out is None:
        out = torch.empty(rows.shape[1:], dtype=torch.int32,
                          device=rows.device)
    elif (out.shape != rows.shape[1:] or out.dtype != torch.int32
          or out.device != rows.device or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"{name}: out must be a contiguous, 16-byte "
                         f"aligned int32 {tuple(rows.shape[1:])} tensor "
                         "beside the messages")
    if rows.data_ptr() % 16:
        rows = rows.clone()
    i_loc = rows.shape[0]
    variant, splits, blocks = launch_plan(
        out.numel(), i_loc, int(num_clients), build.sm_count(rows.device))
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    status = getattr(build.load(), f"{name}_launch")(
        rows.data_ptr(), i_loc, out.numel(), *scale_args, int(key0),
        int(key1), int(client_offset), int(num_clients), alive_ptr,
        out.data_ptr(), splits, blocks, stream)
    build.check(status, name)
    fn.launches += 1
    fn.launches_by_variant[variant] += 1
    if alive_ptr is not None:
        fn.launches_by_variant["alive"] += 1
    return out


def masked_sum_2d(msgs: torch.Tensor, key0: int, key1: int, *,
                  scale_bits: int, num_clients: int, client_offset: int = 0,
                  alive: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  device: Device = None) -> torch.Tensor:
    """The streaming masked sum: (I_loc, R, 128) f32 → (R, 128) int32.

    ``key0``/``key1`` are the round key words (ints < 2^32).  The local
    rows are global clients [client_offset, client_offset + I_loc) of
    ``num_clients``; ``alive`` is an optional (num_clients,) 0/1 tensor on
    the messages' device.  ``out``, an optional contiguous (R, 128) int32
    tensor (one row of the hierarchical tree's level-1 buffer), receives
    the aggregate.  A CPU tensor goes to :func:`masked_sum_plain` (only
    with ``device="cpu"``); a CUDA tensor launches the kernel on
    :func:`launch_plan`'s variant and adds one to ``masked_sum_2d.launches``
    and to that variant's count in ``masked_sum_2d.launches_by_variant``,
    and, when ``alive`` is given, to its ``"alive"`` count.
    Messages that are not 16-byte aligned, as the kernel's loads need, are
    copied first.
    """
    if not 1 <= int(scale_bits) <= 30:
        raise ValueError(f"scale_bits={scale_bits} outside [1, 30]")
    _checked("masked_sum_2d", msgs, key0, key1, num_clients, client_offset,
             alive)
    if not on_cuda(msgs, device):
        got = masked_sum_plain(msgs, key0, key1, scale_bits=scale_bits,
                               num_clients=num_clients,
                               client_offset=client_offset, alive=alive)
        return got if out is None else out.copy_(got)
    if msgs.dtype != torch.float32 or not msgs.is_contiguous():
        raise ValueError("masked_sum_2d takes contiguous f32 messages")
    return _launch(masked_sum_2d, "masked_sum", msgs, (int(scale_bits),),
                   key0, key1, num_clients, client_offset, alive, out)


masked_sum_2d.launches = 0
# the launches of each variant, and (``"alive"``) of those with dropouts
masked_sum_2d.launches_by_variant = dict.fromkeys(VARIANTS + ("alive",), 0)


def masked_ring_sum_2d(q: torch.Tensor, key0: int, key1: int, *,
                       num_clients: int, client_offset: int = 0,
                       alive: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None,
                       device: Device = None) -> torch.Tensor:
    """The masked sum's ring mode: (G_loc, R, 128) int32 ring elements →
    (R, 128) int32, :func:`masked_sum_2d` with the quantize step removed.
    Level 2 of the hierarchical tree re-masks its group partials with it
    under :func:`group_key_words`; rows are global ids [client_offset,
    client_offset + G_loc) of ``num_clients``.  A CPU tensor goes to
    :func:`masked_ring_sum_plain` (only with ``device="cpu"``); a CUDA
    tensor launches the kernel and counts the launch on
    ``masked_ring_sum_2d.launches`` and ``.launches_by_variant``, as
    :func:`masked_sum_2d` does."""
    _checked("masked_ring_sum_2d", q, key0, key1, num_clients,
             client_offset, alive)
    if not on_cuda(q, device):
        got = masked_ring_sum_plain(q, key0, key1, num_clients=num_clients,
                                    client_offset=client_offset, alive=alive)
        return got if out is None else out.copy_(got)
    if q.dtype != torch.int32 or not q.is_contiguous():
        raise ValueError("masked_ring_sum_2d takes contiguous int32 rows")
    return _launch(masked_ring_sum_2d, "masked_ring_sum", q, (), key0, key1,
                   num_clients, client_offset, alive, out)


masked_ring_sum_2d.launches = 0
masked_ring_sum_2d.launches_by_variant = dict.fromkeys(VARIANTS + ("alive",),
                                                       0)
