"""Flash attention, causal with an optional sliding window or non-causal
over a key length of its own: the kernel wrapper, its plain version and
the autograd op.

The port of ``repro/kernels/flash_attention.py::flash_attention_bhsd``
and of the GQA wrapper ``repro/kernels/ops.py::flash_attention``: causal
``softmax(q·kᵀ·Dh^-½)·v`` with f32 scores, probabilities and
accumulators, the output in q's dtype.  The reference's wrapper pads the
head dim to 128 lanes, transposes to (B·H, S, D) and broadcasts k/v G-fold
over each group of G = H / Hkv query heads; the port's kernel reads the
model's (B, S, H, Dh) q and un-repeated (B, S, Hkv, Dh) k/v in place:
query head h reads kv head h // G.

``window`` > 0 keeps a sliding band: key j is visible to query i iff
``j <= i`` and ``j > i − window``, the mask of the reference model's
``repro/models/attention.py::attend(window=)`` (the hybrid family's local
attention, which the reference runs in XLA; its Pallas kernel is causal
only).  A window of at least S is the causal case, and the wrapper
passes 0 for it.

``causal=False`` drops the mask: every query sees all Sk keys, and k/v
may be longer or shorter than q, (B, Sk, Hkv, Dh).  It is the reference
model's ``attend(causal=False)``, in XLA there, which the audio family's
encoder (self-attention over its 1,500 frames) and cross-attention (the
decoder's queries against the encoder's keys) call.  The causal and
banded cases keep Sq = Sk.

On a CUDA tensor :func:`flash_attention_bhsd` launches a hand-written
kernel, chosen by dtype (a dispatch, not a fallback: a failed build or
launch raises):

* bf16 → ``csrc/flash_attention_sm90.cu`` (variant ``"wgmma"``): the
  products on the tensor cores, fed by TMA.  It rounds the probabilities
  P to bf16 before P·V, as every tensor-core flash kernel does and as the
  reference model does before its P·V; it agrees with the f64 softmax to
  :func:`bf16_error_check`'s bound, not to one ulp of the plain version;
* f32 → ``csrc/flash_attention.cu`` (variant ``"tf32x3"``): the products
  on the tensor cores as ``mma.sync`` TF32, each f32 operand split into
  hi + lo and summed in three passes (``csrc/tf32x3.cuh``; one pass would
  break it), within 2e-5 of the plain version.

``HEAD_DIMS`` gives each variant's template instances, one for each mask
(causal, banded, none): head dims 16, 32, 64, 96 (phi-3-vision), 128 and
256 (recurrentgemma-9b) on both.  At 256 the f32 kernel takes 32-key
tiles and at most 4 warps: two 64-key K/V stages alone (256 KB) would
pass the 227 KB of shared memory a block may take.

On a CPU tensor it runs :func:`flash_attention_plain`, the materialised
f32 softmax.

:class:`FlashAttention` makes the call differentiable and batchable:

* its backward is plain PyTorch (the reference has no backward kernel):
  P is recomputed in f32 from the saved q, k, v, and dK, dV are summed
  over each GQA group (:func:`flash_attention_backward_plain`); it holds
  (B, Hkv, G, Sq, Sk) f32 a few times over, 1.44 GB each at whisper's
  encoder at B = 8;
* its ``vmap`` rule folds the vmapped dim (the engine's client dim under
  ``vmap(grad(upload))``) into the batch, so one launch serves every
  client: a ctypes launch on ``data_ptr()`` could not see a batched
  tensor.  ``window`` and ``causal`` ride along as plain values.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import Device, on_cuda
from repro_torch.kernels import build

# each variant's template instances (one for each mask)
HEAD_DIMS = {"wgmma": (16, 32, 64, 96, 128, 256),
             "tf32x3": (16, 32, 64, 96, 128, 256)}
# the kernels' masks, by the number their launch and attributes take
MASKS = {"causal": 0, "band": 1, "none": 2}
# the launch counts by mask: the unmasked instance's launches counted as
# "self" where k/v are as long as q, "cross" where not
COUNT_MASKS = ("causal", "band", "self", "cross")
# the kernel each dtype launches, and its launch entry point
VARIANTS = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
_ENTRY = {"wgmma": "flash_attention_sm90", "tf32x3": "flash_attention"}


def band_mask(s, window=0, device=None):
    """(S, S) bool, query rows by key columns: key j visible to query i
    iff j <= i and, with ``window`` > 0, j > i − window."""
    mask = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    if window:
        mask &= torch.ones_like(mask).triu(1 - window)
    return mask


def visible_mask(s, window=0, causal=True, device=None):
    """The keys each of ``s`` queries sees: :func:`band_mask` when
    ``causal``; None (every key) without."""
    return band_mask(s, window, device) if causal else None


def _grouped(q, k, v, window=0, causal=True):
    """f32 (B, Sq, Hkv, G, Dh) q and (B, Sk, Hkv, Dh) k/v, the scale and
    the mask (None: every key visible), for the plain versions."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, dh)
    return qf, k.float(), v.float(), dh ** -0.5, visible_mask(
        s, window, causal, q.device)


def _probs(qf, kf, scale, mask):
    """The softmax P over the visible keys, (B, Hkv, G, Sq, Sk) f32."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.softmax(scores, dim=-1)


def flash_attention_plain(q, k, v, window=0, causal=True):
    """The plain PyTorch version: the materialised f32 softmax, causal and
    banded by ``window`` > 0, or over every key without ``causal``.  q
    (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh) → (B, Sq, H, Dh) in q's
    dtype."""
    qf, kf, vf, scale, mask = _grouped(q, k, v, window, causal)
    o = torch.einsum("bhgqk,bkhd->bqhgd", _probs(qf, kf, scale, mask), vf)
    return o.reshape(q.shape).to(q.dtype)


def flash_attention_backward_plain(q, k, v, do, window=0, causal=True):
    """(dq, dk, dv) of :func:`flash_attention_plain` at ``do``, in f32
    from P recomputed, cast to the inputs' dtypes; dk and dv summed over
    each group of query heads sharing a kv head."""
    qf, kf, vf, scale, mask = _grouped(q, k, v, window, causal)
    p = _probs(qf, kf, scale, mask)
    dof = do.float().reshape(qf.shape)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bf16_error_check(q, k, v, got, window=0, causal=True):
    """Hold a bf16 attention output ``got`` to the f64 softmax of the same
    bf16 inputs, banded by ``window`` > 0, or over every key without
    ``causal``; returns ``(ok, max_ratio, rms_kernel, rms_plain)``.

    With o64 and p_j the float64 output and probabilities, computed one
    (batch row, kv head) at a time to bound memory:

    * elementwise, ``|got − o64| ≤ ulp_bf16(|o64|) + 2^-8 · Σ_j p_j·|v_j|
      + 1e-5``: the output's rounding; the bound of P's rounding to bf16
      before P·V (bf16 keeps 8 significant bits, so each p_j moves by at
      most 2^-8 of itself); f32 accumulation.  ``max_ratio`` is the
      largest error over its bound;
    * in aggregate, ``rms(got − o64) ≤ 1.5 · rms(plain − o64)``, with
      ``plain`` :func:`flash_attention_plain` (f32 P, one rounding at the
      end): the rigorous bound alone could let a masking slip of one key
      through at late rows, where that key's weight is small.
    """
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    plain = flash_attention_plain(q, k, v, window, causal)
    mask = visible_mask(s, window, causal, q.device)
    max_ratio, se_got, se_plain = 0.0, 0.0, 0.0
    for bi in range(b):
        for hk in range(hkv):
            heads = slice(hk * g, (hk + 1) * g)
            kf, vf = k[bi, :, hk].double(), v[bi, :, hk].double()
            scores = torch.einsum("qgd,kd->gqk", q[bi, :, heads].double(),
                                  kf) * dh ** -0.5
            if mask is not None:
                scores = scores.masked_fill(~mask, float("-inf"))
            p = torch.softmax(scores, -1)
            o64 = torch.einsum("gqk,kd->qgd", p, vf)
            spread = torch.einsum("gqk,kd->qgd", p, vf.abs())
            ulp = torch.exp2(torch.floor(torch.log2(
                o64.abs().clamp_min(1e-30))) - 7)
            err = got[bi, :, heads].double() - o64
            bound = ulp + 2.0 ** -8 * spread + 1e-5
            max_ratio = max(max_ratio, float((err.abs() / bound).max()))
            se_got += float((err * err).sum())
            d_plain = plain[bi, :, heads].double() - o64
            se_plain += float((d_plain * d_plain).sum())
    n = max(q.numel(), 1)
    rms_got, rms_plain = (se_got / n) ** 0.5, (se_plain / n) ** 0.5
    ok = (bool(torch.isfinite(got).all()) and max_ratio <= 1.0
          and rms_got <= 1.5 * rms_plain)
    return ok, max_ratio, rms_got, rms_plain


def kernel_attributes(head_dim: int, mask: str = "causal") -> dict:
    """``(registers a thread, local (spill) bytes a thread, dynamic shared
    bytes a block)`` at ``head_dim`` of each variant with an instance
    there, from ``cudaFuncGetAttributes``: the instance of ``mask``
    (``MASKS``: ``"causal"``, ``"band"`` for a window > 0, ``"none"``
    without causality)."""
    lib = build.load()
    out = {}
    for variant, entry in _ENTRY.items():
        if head_dim not in HEAD_DIMS[variant]:
            continue
        vals = (ctypes.c_int * 3)()
        getattr(lib, f"{entry}_attributes")(head_dim, MASKS[mask], vals)
        out[variant] = tuple(vals)
    return out


def _aligned(x):
    """``x`` contiguous at a 16-byte aligned address, as the wgmma
    kernel's tensor maps need (a view at an odd offset is copied)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_bhsd(q, k, v, *, window: int = 0, causal: bool = True,
                         device: Device = None):
    """GQA attention: q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh), one dtype
    (f32 or bf16) and device → (B, Sq, H, Dh) in q's dtype.  Causal (Sq =
    Sk); with ``window`` > 0 a query sees only the ``window`` keys ending
    at its own position (``window`` >= S is the causal case, and passes
    0); with ``causal=False`` every query sees all Sk >= 1 keys, and
    ``window`` must be 0.

    A CPU tensor goes to :func:`flash_attention_plain` (only with
    ``device="cpu"``); a CUDA tensor launches the kernel of its dtype's
    variant (``VARIANTS``: bf16 the wgmma kernel, f32 the 3xTF32 one)
    and adds one to ``flash_attention_bhsd.launches``, to that variant's
    count in ``flash_attention_bhsd.launches_by_variant`` and to its
    count by mask (``COUNT_MASKS``) in ``launches_by_mask``, keyed
    ``"{variant}_{mask}"``.  Use
    :func:`repro_torch.kernels.ops.flash_attention` in models: it is
    differentiable and vmappable.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2] \
            or (causal and q.shape[1] != k.shape[1]):
        raise ValueError(
            f"flash_attention takes q (B, Sq, H, Dh) and k/v (B, Sk, Hkv, "
            f"Dh) with Hkv dividing H (and Sk = Sq when causal), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0 or (not causal and window):
        raise ValueError(f"flash_attention: window must be >= 0, and 0 "
                         f"without causality, got {window}")
    if not causal and q.shape[1] and not k.shape[1]:
        raise ValueError("flash_attention: non-causal attention needs at "
                         "least one key")
    b, s, h, dh = q.shape
    window = 0 if window >= s else int(window)
    if not on_cuda(q, device):
        return flash_attention_plain(q, k, v, window, causal)
    if q.dtype not in VARIANTS:
        raise ValueError(f"flash_attention kernel takes f32 or bf16, got "
                         f"{q.dtype}")
    variant = VARIANTS[q.dtype]
    if dh not in HEAD_DIMS[variant]:
        raise ValueError(
            f"flash_attention: the {variant} kernel ({q.dtype}) has no "
            f"head_dim {dh} instance (it has {HEAD_DIMS[variant]})")
    for x in (k, v):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
    q, k, v = (_aligned(x) for x in (q, k, v))
    out = torch.empty_like(q)
    launch = getattr(build.load(), f"{_ENTRY[variant]}_launch")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, s, k.shape[1], h, k.shape[2], dh, dh ** -0.5, window,
                    int(causal), stream)
    build.check(status, f"flash_attention ({variant})")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.launches_by_variant[variant] += 1
    mask = ("band" if window else "causal") if causal \
        else ("self" if s == k.shape[1] else "cross")
    flash_attention_bhsd.launches_by_mask[f"{variant}_{mask}"] += 1
    return out


flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_by_variant = dict.fromkeys(_ENTRY, 0)
flash_attention_bhsd.launches_by_mask = {
    f"{variant}_{mask}": 0 for variant in _ENTRY for mask in COUNT_MASKS}


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_bhsd` with a plain backward and a vmap rule
    that folds the vmapped dim into the batch (one launch for all
    clients); ``window`` and ``causal`` are plain values, not tensors.
    Routes by where q lies: the model's device is the caller's choice,
    made when the parameters were placed."""

    @staticmethod
    def forward(q, k, v, window, causal):
        return flash_attention_bhsd(q, k, v, window=window, causal=causal,
                                    device=q.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])
        ctx.window, ctx.causal = inputs[3:]

    @staticmethod
    def backward(ctx, do):
        return (*flash_attention_backward_plain(*ctx.saved_tensors, do,
                                                ctx.window, ctx.causal),
                None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, window, causal):
        n = info.batch_size

        def fold(x, dim):
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        out = FlashAttention.apply(*(fold(x, d) for x, d in
                                     zip((q, k, v), in_dims[:3])), window,
                                   causal)
        return out.reshape(n, -1, *out.shape[1:]), 0
