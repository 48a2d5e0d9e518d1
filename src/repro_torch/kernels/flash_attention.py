"""Causal flash attention: the kernel wrapper, its plain version and the
autograd op.

The port of ``repro/kernels/flash_attention.py::flash_attention_bhsd``
and of the GQA wrapper ``repro/kernels/ops.py::flash_attention``: causal
``softmax(q·kᵀ·Dh^-½)·v`` with f32 scores, probabilities and
accumulators, the output in q's dtype.  The reference's wrapper pads the
head dim to 128 lanes, transposes to (B·H, S, D) and broadcasts k/v G-fold
over each group of G = H / Hkv query heads; the port's kernel reads the
model's (B, S, H, Dh) q and un-repeated (B, S, Hkv, Dh) k/v in place:
query head h reads kv head h // G.

On a CUDA tensor :func:`flash_attention_bhsd` launches the hand-written
kernel ``csrc/flash_attention.cu``; on a CPU tensor it runs
:func:`flash_attention_plain`, the materialised softmax.  The two sum in
other orders, so they agree to f32 rounding, not bit for bit.

:class:`FlashAttention` makes the call differentiable and batchable:

* its backward is plain PyTorch (the reference has no backward kernel):
  P is recomputed in f32 from the saved q, k, v, and dK, dV are summed
  over each GQA group (:func:`flash_attention_backward_plain`);
* its ``vmap`` rule folds the vmapped dim (the engine's client dim under
  ``vmap(grad(upload))``) into the batch, so one launch serves every
  client: a ctypes launch on ``data_ptr()`` could not see a batched
  tensor.
"""
from __future__ import annotations

import torch

from repro_torch import Device, on_cuda
from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's template instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _grouped(q, k, v):
    """f32 (B, S, Hkv, G, Dh) q and (B, S, Hkv, Dh) k/v, the scale and the
    causal mask, for the plain versions."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, dh)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return qf, k.float(), v.float(), dh ** -0.5, mask


def _probs(qf, kf, scale, mask):
    """The causal softmax P, (B, Hkv, G, S, S) f32."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    return torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)


def flash_attention_plain(q, k, v):
    """The plain PyTorch version: the materialised f32 causal softmax.
    q (B, S, H, Dh), k/v (B, S, Hkv, Dh) → (B, S, H, Dh) in q's dtype."""
    qf, kf, vf, scale, mask = _grouped(q, k, v)
    o = torch.einsum("bhgqk,bkhd->bqhgd", _probs(qf, kf, scale, mask), vf)
    return o.reshape(q.shape).to(q.dtype)


def flash_attention_backward_plain(q, k, v, do):
    """(dq, dk, dv) of :func:`flash_attention_plain` at ``do``, in f32
    from P recomputed, cast to the inputs' dtypes; dk and dv summed over
    each group of query heads sharing a kv head."""
    qf, kf, vf, scale, mask = _grouped(q, k, v)
    p = _probs(qf, kf, scale, mask)
    dof = do.float().reshape(qf.shape)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bhsd(q, k, v, *, device: Device = None):
    """Causal GQA attention: q (B, S, H, Dh), k/v (B, S, Hkv, Dh), one
    dtype (f32 or bf16) and device → (B, S, H, Dh) in q's dtype.

    A CPU tensor goes to :func:`flash_attention_plain` (only with
    ``device="cpu"``); a CUDA tensor launches the kernel and adds one to
    ``flash_attention_bhsd.launches``.  Use :func:`repro_torch.kernels.
    ops.flash_attention` in models: it is differentiable and vmappable.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention takes q (B, S, H, Dh) and k/v (B, S, Hkv, Dh) "
            f"with Hkv dividing H, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if not on_cuda(q, device):
        return flash_attention_plain(q, k, v)
    b, s, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes f32 or bf16, got "
                         f"{q.dtype}")
    for x in (k, v):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
    q, k, v = (x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], dh, _DTYPE_CODES[q.dtype], dh ** -0.5, stream)
    build.check(status, "flash_attention")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_bhsd` with a plain backward and a vmap rule
    that folds the vmapped dim into the batch (one launch for all
    clients).  Routes by where q lies: the model's device is the caller's
    choice, made when the parameters were placed."""

    @staticmethod
    def forward(q, k, v):
        return flash_attention_bhsd(q, k, v, device=q.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, do):
        return flash_attention_backward_plain(*ctx.saved_tensors, do)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        n = info.batch_size

        def fold(x, dim):
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        out = FlashAttention.apply(*(fold(x, d)
                                     for x, d in zip((q, k, v), in_dims)))
        return out.reshape(n, -1, *out.shape[1:]), 0
