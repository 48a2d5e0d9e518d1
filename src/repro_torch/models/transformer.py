"""The LM model zoo: the ``dense``, ``moe``, ``ssm`` and ``hybrid``
families of the reference's.

The port of ``repro/models/transformer.py``'s llama-style GQA decoder
(llama3-8b, yi-9b, granite-8b; granite-34b with its GELU MLP), its
mixture-of-experts decoder (qwen3-moe: every FFN a top-k MoE,
:mod:`repro_torch.models.moe`; llama4-maverick: a super-block of one
dense block and one MoE block with a shared expert, ``moe_every`` = 2),
its attention-free RWKV-6 stack (rwkv6-7b: time mix and channel mix,
:mod:`repro_torch.models.rwkv6`) and Griffin's hybrid (recurrentgemma-9b:
a unit of ``pattern_recurrent`` RG-LRU blocks, :mod:`repro_torch.models.
rglru`, then ``pattern_attn`` local-attention blocks at
``window=local_window``, repeated; leftover layers a recurrent tail).
``build_model(cfg, decode_window=0)`` returns a :class:`Model` with

* ``init(generator, device)`` — the layer-stacked parameter tree
  ``{"blocks": {...}, "embed", "final_norm"}`` in ``cfg.param_dtype``,
  every block leaf ``(num_layers, …)``: ``attn_norm, ffn_norm, wq, wk,
  wv, wo, <ffn>`` (dense), the FFN's leaves replaced by ``router, ewg,
  ewu, ewd`` (and ``swg, swu, swd`` with a shared expert) in a MoE block,
  or the time-mix and channel-mix leaves ``bonus, ck, cm_norm, …, wv``
  (ssm); the interleaved MoE's leaves are ``(L // moe_every, …)``, the
  dense block's prefixed ``d_`` and the MoE block's ``m_``; the hybrid's
  are ``(n_units, …)``, the recurrent blocks' prefixed ``r{r}_`` and the
  attention blocks' ``a{a}_``, beside ``"tail"``, the recurrent leaves
  ``(L mod unit, …)``, when the unit does not divide L;
* ``forward(params, batch)`` — the (B, S, padded_vocab) f32 logits;
* ``forward_with_aux(params, batch)`` — the logits and the auxiliary
  losses: the MoE load-balance losses summed over the MoE layers (moe),
  none for the other families;
* ``loss(params, batch)`` — next-token cross-entropy, f32, plus
  ``router_aux_weight`` · aux / ``num_layers`` (moe);
* ``init_decode(batch_size, max_len, device)`` — the decode state: a KV
  cache a layer (dense, moe; a ring buffer of ``decode_window`` slots
  when it is > 0), the WKV state and two token shifts a layer (ssm), or
  a ring of ``min(local_window, max_len)`` slots an attention layer and
  the RG-LRU state and conv context a recurrent layer (hybrid);
* ``decode_step(params, state, tokens)`` — one token with the cached
  state, the caches written in place.

The reference scans the stacked blocks under ``jax.checkpoint``; the port
casts the stacked leaves to the activation dtype (``_cast``: no copy of a
leaf already in it, as bf16 parameters under bf16 activations), runs a
Python loop over the layers (the hybrid's and the interleaved MoE's over
their units, each unit its blocks in order), and keeps activations for
the backward (no rematerialisation).  Decode casts them at every step
too, as the reference's scan body does.  Other families (vlm, audio)
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import Device, resolve_device, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe, rglru, rwkv6


def _ffn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn == "swiglu":
        return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    return {"wi": (d, f), "b_i": (f,), "wo2": (f, d), "b_o": (d,)}


def _block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Per-layer parameter shapes of one attention + FFN block."""
    d, hd = cfg.d_model, cfg.head_dim
    qh, kvh = cfg.num_heads, cfg.num_kv_heads
    return {"attn_norm": (d,),
            "wq": (d, qh * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd),
            "wo": (qh * hd, d),
            "ffn_norm": (d,),
            **_ffn_shapes(cfg)}


def _moe_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """A MoE FFN's shapes: the router, the experts' stacked SwiGLU, and
    the shared expert's when the config has one."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {"router": (d, e), "ewg": (e, d, f), "ewu": (e, d, f),
         "ewd": (e, f, d)}
    if cfg.shared_expert:
        s.update({"swg": (d, f), "swu": (d, f), "swd": (f, d)})
    return s


def _moe_block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One attention + MoE block: the dense block's, its FFN replaced."""
    ffn = _ffn_shapes(cfg)
    return {**{k: v for k, v in _block_shapes(cfg).items() if k not in ffn},
            **_moe_shapes(cfg)}


def _moe_unit_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The interleaved super-block's: a dense block's prefixed ``d_``, a
    MoE block's ``m_``."""
    return {**{f"d_{k}": v for k, v in _block_shapes(cfg).items()},
            **{f"m_{k}": v for k, v in _moe_block_shapes(cfg).items()}}


def _rwkv_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Per-layer parameter shapes of one RWKV-6 block: time mix, channel
    mix and their two norms."""
    d, f = cfg.d_model, cfg.d_ff
    return {**rwkv6.time_mix_params_shapes(d, cfg.rwkv_heads),
            "tm_norm": (d,), "cm_norm": (d,),
            "cmix_k": (d,), "cmix_r": (d,),
            "ck": (d, f), "cv": (f, d), "cr": (d, d)}


def _recurrent_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Per-layer parameter shapes of one Griffin recurrent block: the
    branch and gate projections, the temporal conv, the RG-LRU's gates
    (``w_ri``, r and i side by side) and Λ, the output projection, then
    the FFN."""
    d = cfg.d_model
    return {"rec_norm": (d,),
            "wx": (d, d), "wgate": (d, d), "w_ri": (d, 2 * d),
            "conv_w": (cfg.conv_width, d), "lam": (d,), "w_out": (d, d),
            "ffn_norm": (d,),
            **_ffn_shapes(cfg)}


def _unit_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One hybrid unit's shapes: the recurrent blocks' prefixed ``r{r}_``,
    the attention blocks' ``a{a}_``."""
    shapes = {}
    for r in range(cfg.pattern_recurrent):
        shapes.update({f"r{r}_{k}": v
                       for k, v in _recurrent_shapes(cfg).items()})
    for a in range(cfg.pattern_attn):
        shapes.update({f"a{a}_{k}": v for k, v in _block_shapes(cfg).items()})
    return shapes


# constant initial values, by name (every other leaf is drawn).  Λ is 0.7
# where the leaf is named ``lam``: the tail's; the units' carry a prefix
# (``r0_lam``) and are drawn, as in the reference, whose init matches the
# bare name too
_FILL = {"decay_base": -1.0, "bonus": 0.0, "ln_w": 0.0, "ln_b": 0.0,
         "lam": 0.7}


def _init_stacked(generator, n: int, shapes: Dict[str, tuple], dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Norms, biases, ``bonus`` and the group norm's ``ln_w``/``ln_b`` zero,
    the token-shift mixes 0.5, ``decay_base`` −1, every other leaf
    N(0, 0.02²), drawn in sorted name order."""
    out = {}
    for name, shape in sorted(shapes.items()):
        fill = 0.0 if name.endswith("_norm") or name.startswith("b_") \
            else 0.5 if name.startswith(("mix_", "cmix_")) \
            else _FILL.get(name)
        if fill is not None:
            out[name] = torch.full((n,) + shape, fill, dtype=dtype,
                                   device=device)
        else:
            out[name] = layers.normal(generator, (n,) + shape, 0.02, dtype,
                                      device)
    return out


def _ffn_apply(cfg, p, x):
    if cfg.ffn == "swiglu":
        return layers.swiglu(x, p["wg"], p["wu"], p["wd"])
    return layers.gelu_mlp(x, p["wi"], p["b_i"], p["wo2"], p["b_o"])


def _attn_apply(cfg, p, x, positions, *, window: int = 0):
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["attn_norm"])
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, kvh, hd)
    v = (xn @ p["wv"]).reshape(b, s, kvh, hd)
    q = layers.apply_rope(q, positions)
    k = layers.apply_rope(k, positions)
    o = attention.attend(q, k, v, causal=True, window=window)
    return x + o.reshape(b, s, h * hd) @ p["wo"]


def _attn_block(cfg, p, x, positions, *, window: int = 0):
    x = _attn_apply(cfg, p, x, positions, window=window)
    return x + _ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"]))


def _moe_ffn_apply(cfg, p, xn) -> moe.MoEOutput:
    mp = {"router": p["router"], "wg": p["ewg"], "wu": p["ewu"],
          "wd": p["ewd"]}
    if cfg.shared_expert:
        mp.update({"shared_wg": p["swg"], "shared_wu": p["swu"],
                   "shared_wd": p["swd"]})
    return moe.moe_ffn(xn, mp, num_experts=cfg.num_experts,
                       k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor)


def _moe_block(cfg, p, x, positions):
    """Attention, then the MoE FFN → (x, the layer's ``MoEOutput``)."""
    x = _attn_apply(cfg, p, x, positions)
    out = _moe_ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"]))
    return x + out.y, out


def _moe_unit(cfg, p, x, positions):
    """The interleaved super-block: its dense block, then its MoE
    block."""
    x = _attn_block(cfg, _prefixed(p, "d_"), x, positions)
    return _moe_block(cfg, _prefixed(p, "m_"), x, positions)


def _recurrent_block(cfg, p, x, *, h0=None, conv_state=None,
                     decode: bool = False):
    """Griffin's recurrent block: the branch x·Wx through the temporal
    conv and the RG-LRU, gated by gelu(x·Wgate) (tanh), projected by
    ``w_out``; then the FFN.  ``decode``: one token (x (B, 1, D)) from
    the state ``h0`` (B, D) f32 and ``conv_state`` (B, T − 1, D).
    Returns (x, the RG-LRU's last h, the conv's new context)."""
    xn = layers.rms_norm(x, p["rec_norm"])
    branch = xn @ p["wx"]
    gate = F.gelu(xn @ p["wgate"], approximate="tanh")
    branch, conv_state = rglru.temporal_conv(branch, p["conv_w"],
                                             conv_state)
    r, i = torch.sigmoid(branch @ p["w_ri"]).chunk(2, dim=-1)
    if decode:
        y, h = rglru.rg_lru_step(branch[:, 0], r[:, 0], i[:, 0], p["lam"],
                                 h0)
        y = y[:, None]
    else:
        y, h = rglru.rg_lru(branch, r, i, p["lam"], h0)
    x = x + (y * gate) @ p["w_out"]
    return (x + _ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"])), h,
            conv_state)


def _prefixed(p, prefix):
    """The leaves of ``p`` named ``prefix…``, the prefix cut off."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _hybrid_unit(cfg, p, x, positions):
    """One hybrid unit of the sequence forward: its recurrent blocks from
    a zero state, then its attention blocks at ``local_window``."""
    for r in range(cfg.pattern_recurrent):
        x = _recurrent_block(cfg, _prefixed(p, f"r{r}_"), x)[0]
    for a in range(cfg.pattern_attn):
        x = _attn_block(cfg, _prefixed(p, f"a{a}_"), x, positions,
                        window=cfg.local_window)
    return x


def _recurrent_seq_block(cfg, p, x, positions):
    """A tail layer of the sequence forward (``positions`` unused)."""
    del positions
    return _recurrent_block(cfg, p, x)[0]


def _attn_decode_only(cfg, p, x, k_cache, v_cache, length, *,
                      window: int = 0):
    """One token's attention against a layer's cache, x (B, 1, D), with
    its residual; the cache's slot ``length % C`` is written in place."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["attn_norm"])
    pos = length[None]                  # absolute position of this token
    q = layers.apply_rope((xn @ p["wq"]).reshape(b, 1, h, hd), pos)
    k = layers.apply_rope((xn @ p["wk"]).reshape(b, 1, kvh, hd), pos)
    v = (xn @ p["wv"]).reshape(b, 1, kvh, hd)
    cache = attention.cache_update(
        attention.KVCache(k_cache, v_cache, length), k, v)
    o = attention.decode_attend(q, cache, window=window)
    return x + o.reshape(b, 1, h * hd) @ p["wo"]


def _attn_decode(cfg, p, x, k_cache, v_cache, length, *, window: int = 0):
    """One-token attention block (attention, then the FFN)."""
    x = _attn_decode_only(cfg, p, x, k_cache, v_cache, length,
                          window=window)
    return x + _ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"]))


def _moe_decode(cfg, p, x, k_cache, v_cache, length, *, window: int = 0):
    """One-token MoE block (attention, then the MoE FFN over the batch's
    B tokens, one example each)."""
    x = _attn_decode_only(cfg, p, x, k_cache, v_cache, length,
                          window=window)
    return x + _moe_ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"])).y


def _rwkv_block(cfg, p, x, state=None, cm_shift=None, *,
                decode: bool = False):
    """Time mix then channel mix, each on the RMS-normed stream, from
    ``state`` and ``cm_shift`` (zero when None).  Returns (x, the time
    mix's new ``RWKVState``, the channel mix's new shift)."""
    y, new_state = rwkv6.time_mix(p, layers.rms_norm(x, p["tm_norm"]),
                                  state, cfg.rwkv_heads, decode=decode)
    x = x + y
    y, new_cm_shift = rwkv6.channel_mix(p, layers.rms_norm(x, p["cm_norm"]),
                                        cm_shift)
    return x + y, new_state, new_cm_shift


def _rwkv_seq_block(cfg, p, x, positions):
    """The sequence forward's block, from a zero state (``positions``
    unused: RWKV has none)."""
    del positions
    return _rwkv_block(cfg, p, x)[0]


def _hybrid_counts(cfg: ModelConfig):
    """(units, tail layers) of a hybrid config."""
    unit = cfg.pattern_recurrent + cfg.pattern_attn
    return cfg.num_layers // unit, cfg.num_layers % unit


def _stacks(cfg: ModelConfig):
    """The family's layer stacks in forward order: (parameter key, stack
    depth, per-layer shapes, the sequence forward's layer apply).  One
    stack of L blocks for dense and ssm; the hybrid's units, then its
    recurrent tail when the unit does not divide L; moe's L MoE blocks,
    or its L // moe_every super-blocks when interleaved (a moe block's
    apply returns (x, its ``MoEOutput``))."""
    if cfg.family == "moe":
        if cfg.moe_every == 1:
            return [("blocks", cfg.num_layers, _moe_block_shapes(cfg),
                     _moe_block)]
        return [("blocks", cfg.num_layers // cfg.moe_every,
                 _moe_unit_shapes(cfg), _moe_unit)]
    if cfg.family == "hybrid":
        units, tail = _hybrid_counts(cfg)
        stacks = [("blocks", units, _unit_shapes(cfg), _hybrid_unit)]
        if tail:
            stacks.append(("tail", tail, _recurrent_shapes(cfg),
                           _recurrent_seq_block))
        return stacks
    shapes, apply = _FAMILY[cfg.family]
    return [("blocks", cfg.num_layers, shapes(cfg), apply)]


# per family of one stack: (block shapes, block apply)
_FAMILY = {"dense": (_block_shapes, _attn_block),
           "ssm": (_rwkv_shapes, _rwkv_seq_block)}
PORTED_FAMILIES = (*_FAMILY, "moe", "hybrid")


class DecodeState(NamedTuple):
    """Per-family decode state; the fields a family does not use hold an
    empty (0,) f32 tensor.  ``kv_k``/``kv_v``: (L, B, C, Hkv, hd) in the
    activation dtype (dense; moe, the interleaved one's layer 2u its
    unit u's dense block and 2u + 1 its MoE block; the hybrid's attention
    layers, unit-major);
    ``rec_h``: the WKV states (L, B, H, hd, hd) f32 and ``rec_conv``: the
    time mix's and the channel mix's shifts (L, 2, B, D) in the
    activation dtype (ssm), or the RG-LRU states (n_rec, B, D) f32 and
    conv contexts (n_rec, B, T − 1, D) in the activation dtype of the
    hybrid's recurrent layers, the units' (unit-major) then the tail's;
    ``cross_k``/``cross_v`` (the encoder-decoder family's) stay empty."""
    length: torch.Tensor      # () int32: tokens written so far
    kv_k: torch.Tensor
    kv_v: torch.Tensor
    rec_h: torch.Tensor
    rec_conv: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def _empty(device):
    return torch.zeros((0,), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    decode_window: int = 0    # 0 = full cache; > 0 = ring buffer (long ctx)

    def init(self, generator: torch.Generator, device: Device = None):
        """Random parameters drawn from ``generator`` on its own device,
        placed on ``device`` (``cuda`` unless the caller asks for the
        CPU).  The reference draws with ``jax.random``, which the port
        does not reproduce: to start both from one point, carry weights
        with :func:`params_from_numpy`."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = cfg.pdtype
        params = {key: _init_stacked(generator, n, shapes, dt, dev)
                  for key, n, shapes, _ in _stacks(cfg)}
        params["embed"] = layers.normal(
            generator, (cfg.padded_vocab, cfg.d_model), 0.02, dt, dev)
        params["final_norm"] = torch.zeros(cfg.d_model, dtype=dt, device=dev)
        return params

    def _cast(self, p):
        """Block leaves in the activation dtype (norm weights are upcast
        again inside ``rms_norm``), as the reference's scan body casts
        each layer's slice."""
        return {k: w.to(self.cfg.adtype) for k, w in p.items()}

    def _layers(self, stack):
        """Each layer's leaves of a stack, cast: one cast and one unbind
        per stacked leaf, whose backward stacks the layers' gradients
        once, where indexing w[i] layer by layer would zero-fill a whole
        (L, …) gradient per layer and sum them."""
        stack = self._cast(stack)
        return [dict(zip(stack, ws))
                for ws in zip(*(w.unbind(0) for w in stack.values()))]

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits (auxiliary losses discarded)."""
        return self.forward_with_aux(params, batch)[0]

    def forward_with_aux(self, params, batch, dropped: list = None):
        """batch: ``{"tokens": (B, S) ints}`` → ((B, S, padded_vocab) f32
        logits, the auxiliary losses): for moe ``[Σ aux_loss]`` over its
        MoE layers, from an f32 zero in layer order, as the reference's
        scan carries it; [] for the other families.  ``dropped``, a list,
        receives each MoE layer's share of dropped assignments."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.adtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        is_moe = cfg.family == "moe"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for key, _, _, block in _stacks(cfg):
            for p in self._layers(params[key]):
                x = block(cfg, p, x, positions)
                if is_moe:
                    x, out = x
                    aux = aux + out.aux_loss
                    if dropped is not None:
                        dropped.append(out.dropped_frac)
        x = layers.rms_norm(x, params["final_norm"])
        return layers.unembed(x, params["embed"]), [aux] if is_moe else []

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy over the padded vocabulary, f32;
        moe adds ``router_aux_weight`` · Σ aux_loss / ``num_layers`` (all
        layers, not the MoE ones, as in the reference)."""
        logits, aux = self.forward_with_aux(params, batch)
        tokens = batch["tokens"]
        ce = layers.softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
        if aux:
            ce = ce + self.cfg.router_aux_weight * aux[0] \
                / self.cfg.num_layers
        return ce

    def _n_attn_layers(self) -> int:
        cfg = self.cfg
        if cfg.family == "hybrid":
            return _hybrid_counts(cfg)[0] * cfg.pattern_attn
        return cfg.num_layers if cfg.family in ("dense", "moe") else 0

    def init_decode(self, batch_size: int, max_len: int,
                    device: Device = None) -> DecodeState:
        """Zero caches on ``device`` (``cuda`` unless the caller asks for
        the CPU).  Dense, moe: a KV cache of ``max_len`` slots a layer, or a
        ring buffer of ``min(decode_window, max_len)``; ssm: the O(1)
        recurrent state; hybrid: a ring of ``min(local_window, max_len)``
        slots an attention layer (``decode_window`` unused, as in the
        reference) and the RG-LRU state and conv context a recurrent
        layer."""
        cfg = self.cfg
        dev = resolve_device(device)
        n_attn = self._n_attn_layers()
        if cfg.family == "hybrid":
            cap = min(cfg.local_window, max_len)
        elif self.decode_window:
            cap = min(self.decode_window, max_len)
        else:
            cap = max_len
        dt = cfg.adtype
        kv_shape = (n_attn, batch_size, cap, cfg.num_kv_heads, cfg.head_dim)
        kv_k = torch.zeros(kv_shape, dtype=dt, device=dev) if n_attn \
            else _empty(dev)
        kv_v = torch.zeros(kv_shape, dtype=dt, device=dev) if n_attn \
            else _empty(dev)
        rec_h = rec_conv = _empty(dev)
        if cfg.family == "ssm":
            hd = cfg.d_model // cfg.rwkv_heads
            rec_h = torch.zeros((cfg.num_layers, batch_size, cfg.rwkv_heads,
                                 hd, hd), dtype=torch.float32, device=dev)
            # shift states: one for the time mix, one for the channel mix
            rec_conv = torch.zeros((cfg.num_layers, 2, batch_size,
                                    cfg.d_model), dtype=dt, device=dev)
        if cfg.family == "hybrid":
            n_rec = cfg.num_layers - n_attn
            rec_h = torch.zeros((n_rec, batch_size, cfg.d_model),
                                dtype=torch.float32, device=dev)
            rec_conv = torch.zeros((n_rec, batch_size, cfg.conv_width - 1,
                                    cfg.d_model), dtype=dt, device=dev)
        return DecodeState(
            length=torch.zeros((), dtype=torch.int32, device=dev),
            kv_k=kv_k, kv_v=kv_v, rec_h=rec_h, rec_conv=rec_conv,
            cross_k=_empty(dev), cross_v=_empty(dev))

    @torch.no_grad()
    def decode_step(self, params, state: DecodeState, tokens):
        """One token for every sequence of the batch, tokens (B, 1) →
        ((B, 1, padded_vocab) f32 logits, the next state).

        The returned state shares ``state``'s buffers: each layer's KV
        cache takes the token's k and v at slot ``length % C``
        (``index_copy_``, no copy of the cache), and the WKV and RG-LRU
        states, shifts and conv contexts are overwritten; only ``length``
        is a new tensor, one device scalar for the batch, so the step
        never syncs with the host.  Clone a state to keep it.  Runs
        without autograd."""
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"]).to(cfg.adtype)  # (B, 1, D)
        x = {"dense": self._dense_decode, "moe": self._moe_decode,
             "ssm": self._ssm_decode,
             "hybrid": self._hybrid_decode}[cfg.family](params, state, x)
        x = layers.rms_norm(x, params["final_norm"])
        logits = layers.unembed(x, params["embed"])
        return logits, state._replace(length=state.length + 1)

    def _dense_decode(self, params, state: DecodeState, x):
        for i, p in enumerate(self._layers(params["blocks"])):
            x = _attn_decode(self.cfg, p, x, state.kv_k[i], state.kv_v[i],
                             state.length, window=self.decode_window)
        return x

    def _moe_decode(self, params, state: DecodeState, x):
        """Each MoE block against its layer's cache; interleaved, each
        unit's dense block against layer 2u's and its MoE block against
        layer 2u + 1's."""
        cfg = self.cfg
        kw = dict(length=state.length, window=self.decode_window)
        for i, p in enumerate(self._layers(params["blocks"])):
            if cfg.moe_every == 1:
                x = _moe_decode(cfg, p, x, state.kv_k[i], state.kv_v[i], **kw)
                continue
            x = _attn_decode(cfg, _prefixed(p, "d_"), x, state.kv_k[2 * i],
                             state.kv_v[2 * i], **kw)
            x = _moe_decode(cfg, _prefixed(p, "m_"), x,
                            state.kv_k[2 * i + 1], state.kv_v[2 * i + 1],
                            **kw)
        return x

    def _ssm_decode(self, params, state: DecodeState, x):
        for i, p in enumerate(self._layers(params["blocks"])):
            st = rwkv6.RWKVState(wkv=state.rec_h[i],
                                 shift=state.rec_conv[i, 0])
            x, st, cm = _rwkv_block(self.cfg, p, x, st, state.rec_conv[i, 1],
                                    decode=True)
            state.rec_h[i].copy_(st.wkv)
            state.rec_conv[i, 0].copy_(st.shift)
            state.rec_conv[i, 1].copy_(cm)
        return x

    def _hybrid_decode(self, params, state: DecodeState, x):
        """The hybrid's layers for one token: each unit's recurrent blocks
        from their RG-LRU state and conv context, then its attention
        blocks against their ring of ``local_window`` slots; then the
        tail.  Every state is written in place."""
        cfg = self.cfg
        rec, att = iter(range(len(state.rec_h))), iter(range(len(state.kv_k)))

        def recurrent(p, x):
            j = next(rec)
            x, h, conv = _recurrent_block(cfg, p, x, h0=state.rec_h[j],
                                          conv_state=state.rec_conv[j],
                                          decode=True)
            state.rec_h[j].copy_(h)
            state.rec_conv[j].copy_(conv)
            return x

        for p in self._layers(params["blocks"]):
            for r in range(cfg.pattern_recurrent):
                x = recurrent(_prefixed(p, f"r{r}_"), x)
            for a in range(cfg.pattern_attn):
                j = next(att)
                x = _attn_decode(cfg, _prefixed(p, f"a{a}_"), x,
                                 state.kv_k[j], state.kv_v[j], state.length,
                                 window=cfg.local_window)
        for p in self._layers(params["tail"]) if "tail" in params else ():
            x = recurrent(p, x)
        return x


def build_model(cfg: ModelConfig, *, decode_window: int = 0) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"build_model: the {cfg.family!r} family ({cfg.name}) is not "
            "ported to repro_torch yet (ROADMAP.md, queue 1 item 5)")
    return Model(cfg=cfg, decode_window=decode_window)


def params_from_numpy(arrays: Any, device: Device = None):
    """A tree of arrays (nested dicts, e.g. the reference's parameter
    pytree as numpy) → the same tree of tensors on ``device``, each leaf
    in its own dtype: f32 stays f32, bf16 (the published MoE configs'
    ``param_dtype``) stays bf16 through its 16 bits."""
    dev = resolve_device(device)
    if isinstance(arrays, dict):
        return {k: params_from_numpy(v, dev) for k, v in arrays.items()}
    return _to_tensor(arrays, dev)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameter tree → the same tree of numpy arrays."""
    return tree.map(lambda w: w.detach().float().cpu().numpy(), params)


def _to_tensor(a, device) -> torch.Tensor:
    """A numpy array → a tensor of its dtype; a bfloat16 array (numpy's
    ``ml_dtypes`` extension, what JAX hands out) becomes a bfloat16
    tensor through its 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def decode_state_from_numpy(state: Any, device: Device = None) -> DecodeState:
    """A decode state of arrays (any object with ``DecodeState``'s fields,
    e.g. the reference's as numpy) → a :class:`DecodeState` of tensors on
    ``device``, each field in its own dtype (int32 length, f32, bf16)."""
    dev = resolve_device(device)
    return DecodeState(*(_to_tensor(getattr(state, f), dev)
                         for f in DecodeState._fields))


def decode_state_to_numpy(state: DecodeState) -> DecodeState:
    """The port's decode state → the same fields as numpy arrays; bf16
    fields come back as f32 (exact), numpy having no bfloat16."""
    return DecodeState(*(
        x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16
        else x.detach().cpu().numpy() for x in state))
