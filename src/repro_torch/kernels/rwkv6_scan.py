"""RWKV-6 WKV scan: the kernel wrapper, its plain version and the
autograd op.

The port of ``repro/kernels/rwkv6_scan.py::rwkv6_wkv_bh`` (TPU kernel 6)
and of the layout of its wrapper ``repro/kernels/ops.py::rwkv6_wkv``.
Per sequence n and head h, from a zero state S ∈ R^{D×D}:

    o_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t)
    S_t = diag(e^{lw_t}) S_{t−1} + k_tᵀ v_t

with lw ≤ 0 the per-token log-decay (clamped to [−5, 0] by the caller)
and u the per-head bonus.  The reference's wrapper transposes to
(B·H, S, D) and broadcasts u to (B·H, 1, D); the port's kernel reads the
model's (N, S, H, D) r, k, v and lw in place, and u as (H, D), shared by
every sequence, or (N, H, D).  r, k and v are f32 or bf16; lw, u and the
output o are f32, as the TPU kernel's ``out_shape`` is.

On a CUDA tensor :func:`rwkv6_wkv_bh` launches the hand-written kernel
``csrc/rwkv6_scan_sm90.cu`` (variant ``"mma"``, the only one): the same
chunked form, 16 tokens a chunk, its products on the tensor cores as
three TF32 passes over a hi/lo split of each f32 operand.  On a CPU
tensor it runs :func:`wkv_plain`, the reference's chunked form (chunks
of 16 tokens, the carried state applied with cumulative decays).  The
two agree to f32 rounding, not bit for bit.  S need not be a multiple
of 16: both pad the last chunk with tokens that change nothing (r, k,
v = 0, lw = 0).

In the chunked form the in-chunk factors reach e^{±80} at the −5 floor,
so the pairs j ≥ t, which the product never uses, can overflow: they are
dropped with ``where``, never multiplied by a 0/1 mask (inf · 0 = NaN).
The kernel takes its score factors relative to the chunk's 8th token,
which halves their range, and drops the pairs by selection too.

:class:`RWKV6WKV` makes the call differentiable and batchable:

* its backward is plain PyTorch (the reference has no backward kernel):
  autograd of :func:`wkv_plain`, recomputed from the saved inputs;
* its ``vmap`` rule folds the vmapped dim (the engine's client dim under
  ``vmap(vjp(upload))``) into N, so one launch serves every client: a
  ctypes launch on ``data_ptr()`` could not see a batched tensor.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import Device, on_cuda
from repro_torch.kernels import build

CHUNK = 16                      # tokens per chunk of the plain version
HEAD_DIMS = (16, 64)            # the kernel's template instances: the
                                # card paths' head sizes (rwkv_small: 16,
                                # rwkv6-7b: 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANT = "mma"                 # the kernel every (dtype, head size) takes


def _chunked(x, chunks: int):
    """(N, S, H, D) → f32 (N, H, C, T, D), zero-padded to C·T tokens."""
    n, s, h, d = x.shape
    x = F.pad(x.float(), (0, 0, 0, 0, 0, chunks * CHUNK - s))
    return x.reshape(n, chunks, CHUNK, h, d).permute(0, 3, 1, 2, 4)


def _unchunked(x, s: int):
    """Inverse of :func:`_chunked`: (N, H, C, T, D) → (N, S, H, D)."""
    n, h, c, t, d = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(n, c * t, h, d)[:, :s]


def wkv_plain(r, k, v, lw, u):
    """The plain PyTorch version: the chunked form of the reference's
    kernel, chunks of 16, in f32.  r/k/v/lw (N, S, H, D), u (H, D) or
    (N, H, D) → o (N, S, H, D) f32.  The in-chunk terms run for every
    chunk at once; only the state entering each chunk loops."""
    s = r.shape[1]
    c = -(-s // CHUNK)
    r, k, v, lw = (_chunked(x, c) for x in (r, k, v, lw))
    uf = u.float()
    u = (uf if uf.dim() == 3 else uf[None])[:, :, None, None, :]
    cum = torch.cumsum(lw, dim=-2)                      # inclusive
    total = cum[..., -1:, :]                            # (N, H, C, 1, D)
    r_dec = r * torch.exp(cum - lw)
    k_inv = k * torch.exp(-cum)
    k_dec = k * torch.exp(total - cum)
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                     device=r.device).tril(-1)
    # strictly lower triangular: the pairs j ≥ t may overflow to inf and
    # are dropped by where, never multiplied by a mask
    att = torch.where(tri, torch.einsum("nhctk,nhcjk->nhctj", r_dec,
                                        k_inv), 0.0)
    # per chunk (unbound once: indexing a chunk in the loop would make
    # autograd zero-fill a whole (N, H, C, D, D) gradient per chunk)
    decay = torch.exp(total)[..., 0, :, None].unbind(2)   # (N, H, D, 1)
    incr = torch.einsum("nhctk,nhctv->nhckv", k_dec, v).unbind(2)
    states = [torch.zeros_like(incr[0])]
    for i in range(c - 1):
        states.append(states[-1] * decay[i] + incr[i])
    s_in = torch.stack(states, dim=2)
    o = torch.einsum("nhctk,nhckv->nhctv", r_dec, s_in) \
        + torch.einsum("nhctj,nhcjv->nhctv", att, v) \
        + (r * u * k).sum(-1, keepdim=True) * v
    return _unchunked(o, s)


def _check(r, k, v, lw, u):
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, lw)):
        raise ValueError(
            f"rwkv6_wkv takes r, k, v, lw of one shape (N, S, H, D), got "
            f"{[tuple(x.shape) for x in (r, k, v, lw)]}")
    n, _, h, d = r.shape
    if tuple(u.shape) not in ((h, d), (n, h, d)):
        raise ValueError(f"rwkv6_wkv takes u of shape (H, D) = {(h, d)} or "
                         f"(N, H, D) = {(n, h, d)}, got {tuple(u.shape)}")


def kernel_attributes() -> dict:
    """``(registers a thread, local (spill) bytes a thread, dynamic shared
    bytes a block)`` of each kernel instance, keyed ``"f32 D16"`` and so
    on, from ``cudaFuncGetAttributes``."""
    lib = build.load()
    out = {}
    for dtype, code in _DTYPE_CODES.items():
        for d in HEAD_DIMS:
            vals = (ctypes.c_int * 3)()
            lib.rwkv6_wkv_sm90_attributes(d, code, vals)
            name = str(dtype).replace("torch.float32", "f32") \
                .replace("torch.bfloat16", "bf16")
            out[f"{name} D{d}"] = tuple(vals)
    return out


def rwkv6_wkv_bh(r, k, v, lw, u, *, device: Device = None):
    """WKV of every (sequence, head): r/k/v (N, S, H, D) in one dtype
    (f32 or bf16), lw (N, S, H, D) f32 log-decay, u (H, D) or (N, H, D)
    f32 bonus, all on one device → o (N, S, H, D) f32.

    A CPU tensor goes to :func:`wkv_plain` (only with ``device="cpu"``);
    a CUDA tensor launches the kernel and adds one to
    ``rwkv6_wkv_bh.launches`` and to ``rwkv6_wkv_bh.launches_by_variant
    [VARIANT]``; a failed build or launch raises.  Use
    :func:`repro_torch.kernels.ops.rwkv6_wkv` in models: it is
    differentiable and vmappable.
    """
    _check(r, k, v, lw, u)
    if not on_cuda(r, device):
        return wkv_plain(r, k, v, lw, u)
    n, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv kernel takes head size in {HEAD_DIMS}, "
                         f"got {d}")
    if r.dtype not in _DTYPE_CODES:
        raise ValueError(f"rwkv6_wkv kernel takes f32 or bf16 r/k/v, got "
                         f"{r.dtype}")
    for x in (k, v):
        if x.dtype != r.dtype:
            raise ValueError("r, k and v must share one dtype")
    for x in (lw, u):
        if x.dtype != torch.float32:
            raise ValueError(f"rwkv6_wkv kernel takes f32 lw and u, got "
                             f"{x.dtype}")
    for x in (k, v, lw, u):
        if x.device != r.device:
            raise ValueError("r, k, v, lw and u must share one device")
    # contiguous, and 16-byte aligned for the kernel's cp.async loads (a
    # view at an odd offset is copied)
    r, k, v, lw, u = (x.contiguous() for x in (r, k, v, lw, u))
    r, k, v, lw = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (r, k, v, lw))
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    lib = build.load()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    status = lib.rwkv6_wkv_sm90_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), out.data_ptr(), n, s, h, d,
        0 if u.dim() == 2 else h * d, _DTYPE_CODES[r.dtype], stream)
    build.check(status, "rwkv6_wkv")
    rwkv6_wkv_bh.launches += 1
    rwkv6_wkv_bh.launches_by_variant[VARIANT] += 1
    return out


rwkv6_wkv_bh.launches = 0
rwkv6_wkv_bh.launches_by_variant = {VARIANT: 0}


class RWKV6WKV(torch.autograd.Function):
    """:func:`rwkv6_wkv_bh` with a plain backward and a vmap rule that
    folds the vmapped dim into N (one launch for all clients).  Routes by
    where r lies: the model's device is the caller's choice, made when
    the parameters were placed."""

    @staticmethod
    def forward(r, k, v, lw, u):
        return rwkv6_wkv_bh(r, k, v, lw, u, device=r.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, do):
        # autograd of the plain version, recomputed from the inputs (the
        # reference has no backward kernel); each gradient comes back in
        # its input's dtype and shape
        return torch.func.vjp(wkv_plain, *ctx.saved_tensors)[1](do)

    @staticmethod
    def vmap(info, in_dims, r, k, v, lw, u):
        m = info.batch_size

        def front(x, dim):
            return x.expand(m, *x.shape) if dim is None else x.movedim(dim, 0)

        r, k, v, lw = (front(x, d) for x, d in zip((r, k, v, lw), in_dims))
        n = r.shape[1]
        # u stays one (H, D) for all sequences where it can; otherwise one
        # row per folded sequence
        if in_dims[4] is not None or u.dim() == 3:
            u = front(u, in_dims[4])
            if u.dim() == 3:             # (M, H, D): one bonus per slice
                u = u[:, None].expand(m, n, *u.shape[1:])
            u = u.reshape(m * n, *u.shape[2:])
        out = RWKV6WKV.apply(*(x.reshape(m * n, *x.shape[2:])
                               for x in (r, k, v, lw)), u)
        return out.reshape(m, n, *out.shape[1:]), 0
