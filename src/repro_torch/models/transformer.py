"""The LM model zoo: the six families of the reference's (``dense``,
``vlm``, ``moe``, ``ssm``, ``hybrid``, ``audio``).

The port of ``repro/models/transformer.py``'s llama-style GQA decoder
(llama3-8b, yi-9b, granite-8b; granite-34b with its GELU MLP), its
mixture-of-experts decoder (qwen3-moe: every FFN a top-k MoE,
:mod:`repro_torch.models.moe`; llama4-maverick: a super-block of one
dense block and one MoE block with a shared expert, ``moe_every`` = 2),
its attention-free RWKV-6 stack (rwkv6-7b: time mix and channel mix,
:mod:`repro_torch.models.rwkv6`) and Griffin's hybrid (recurrentgemma-9b:
a unit of ``pattern_recurrent`` RG-LRU blocks, :mod:`repro_torch.models.
rglru`, then ``pattern_attn`` local-attention blocks at
``window=local_window``, repeated; leftover layers a recurrent tail),
the vision-language decoder (phi-3-vision: the dense decoder over stub
image embeddings projected by ``img_proj`` and prepended to the text)
and whisper's encoder-decoder (whisper-large-v3: an encoder of
non-causal self-attention and GELU FFNs over stub frame embeddings with
sinusoidal positions, and a decoder whose blocks add cross-attention to
the encoder's output; the mel and conv front end is a stub, as in the
reference).  ``build_model(cfg, decode_window=0)`` returns a
:class:`Model` with

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
  ``(L mod unit, …)``, when the unit does not divide L; vlm adds
  ``img_proj`` (D, D); audio's decoder blocks add ``xattn_norm, xwq,
  xwk, xwv, xwo``, beside ``"encoder"`` (``encoder_layers`` dense blocks
  with the GELU FFN's ``wi, b_i, wo2, b_o``) and ``enc_final_norm``;
* ``forward(params, batch)`` — the (B, S, padded_vocab) f32 logits of
  ``batch["tokens"]`` (vlm: of the text after ``batch["img_embeds"]``,
  (B, num_image_tokens, D); audio: the encoder reads
  ``batch["frame_embeds"]``, (B, S_enc, D));
* ``forward_with_aux(params, batch)`` — the logits and the auxiliary
  losses: the MoE load-balance losses summed over the MoE layers (moe),
  none for the other families;
* ``loss(params, batch)`` — next-token cross-entropy, f32, plus
  ``router_aux_weight`` · aux / ``num_layers`` (moe);
* ``init_decode(batch_size, max_len, device)`` — the decode state: a KV
  cache a layer (dense, moe; a ring buffer of ``decode_window`` slots
  when it is > 0), the WKV state and two token shifts a layer (ssm), or
  a ring of ``min(local_window, max_len)`` slots an attention layer and
  the RG-LRU state and conv context a recurrent layer (hybrid); audio
  also the cross-attention's K and V a layer, which
  ``precompute_cross(params, batch, state)`` fills from one encoder run;
* ``decode_step(params, state, tokens)`` — one token with the cached
  state, the caches written in place.

The reference scans the stacked blocks under ``jax.checkpoint``; the port
casts the stacked leaves to the activation dtype (``_cast``: no copy of a
leaf already in it, as bf16 parameters under bf16 activations), runs a
Python loop over the layers (the hybrid's and the interleaved MoE's over
their units, each unit its blocks in order), and keeps activations for
the backward (no rematerialisation).  Decode casts them at every step
too, as the reference's scan body does.  No kernel runs in decode: the
vlm decodes as the dense model does, over text alone (the reference
serves no image), and audio's cross-attention reads the cached encoder
K and V through ``decode_attend``.

``build_model(cfg, mesh=..., layer_pspec_fn=...)`` runs every family's
forward and loss on one rank's blocks of a production mesh
(:class:`Model`, :mod:`repro_torch.models.sharded`; the moe family's
FFNs expert-parallel); decode raises there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import Device, resolve_device, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe, rglru, rwkv6, sharded
from repro_torch.parallel import data_axes


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


def _audio_block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One whisper decoder block: the dense block's, then its
    cross-attention's norm and projections."""
    d, hd = cfg.d_model, cfg.head_dim
    return {**_block_shapes(cfg), "xattn_norm": (d,),
            "xwq": (d, cfg.num_heads * hd), "xwk": (d, cfg.num_kv_heads * hd),
            "xwv": (d, cfg.num_kv_heads * hd),
            "xwo": (cfg.num_heads * hd, d)}


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's blocks take the GELU FFN, whatever the decoder's."""
    return dataclasses.replace(cfg, ffn="gelu")


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


def _attn_apply(cfg, p, x, positions, *, window: int = 0,
                causal: bool = True):
    """Self-attention with its residual; RoPE at ``positions`` (None:
    none, as whisper's encoder)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["attn_norm"])
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, kvh, hd)
    v = (xn @ p["wv"]).reshape(b, s, kvh, hd)
    if positions is not None:
        q = layers.apply_rope(q, positions)
        k = layers.apply_rope(k, positions)
    o = attention.attend(q, k, v, causal=causal, window=window)
    return x + o.reshape(b, s, h * hd) @ p["wo"]


def _attn_block(cfg, p, x, positions, *, window: int = 0,
                causal: bool = True):
    x = _attn_apply(cfg, p, x, positions, window=window, causal=causal)
    return x + _ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"]))


def _encoder_block(cfg, p, x):
    """Whisper's encoder block: non-causal self-attention without RoPE,
    then the GELU FFN."""
    return _attn_block(_encoder_cfg(cfg), p, x, None, causal=False)


def _cross_kv(cfg, p, enc):
    """The encoder output's K and V for a decoder layer's cross-attention,
    (B, S_enc, Hkv, hd) each."""
    b, se, _ = enc.shape
    shape = (b, se, cfg.num_kv_heads, cfg.head_dim)
    return (enc @ p["xwk"]).reshape(shape), (enc @ p["xwv"]).reshape(shape)


def _cross_attn(cfg, p, x, enc):
    """The decoder's queries against the encoder's keys and values, all
    of them (non-causal, S_enc long), with the residual."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["xattn_norm"])
    q = (xn @ p["xwq"]).reshape(b, s, h, hd)
    o = attention.attend(q, *_cross_kv(cfg, p, enc), causal=False)
    return x + o.reshape(b, s, h * hd) @ p["xwo"]


def _audio_block(cfg, p, x, positions, *, enc):
    """Whisper's decoder block: causal self-attention with RoPE, then
    cross-attention to the encoder's output ``enc``, then the FFN."""
    x = _attn_apply(cfg, p, x, positions)
    x = _cross_attn(cfg, p, x, enc)
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
    apply returns (x, its ``MoEOutput``)); audio's encoder (no apply:
    ``Model._encode`` runs it over the frames), then its decoder, whose
    apply takes the encoder's output as ``enc``."""
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
    if cfg.family == "audio":
        return [("encoder", cfg.encoder_layers,
                 _block_shapes(_encoder_cfg(cfg)), None),
                ("blocks", cfg.num_layers, _audio_block_shapes(cfg),
                 _audio_block)]
    shapes, apply = _FAMILY[cfg.family]
    return [("blocks", cfg.num_layers, shapes(cfg), apply)]


# per family of one stack: (block shapes, block apply); the vlm's blocks
# are the dense ones
_FAMILY = {"dense": (_block_shapes, _attn_block),
           "vlm": (_block_shapes, _attn_block),
           "ssm": (_rwkv_shapes, _rwkv_seq_block)}
PORTED_FAMILIES = (*_FAMILY, "moe", "hybrid", "audio")


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
    ``cross_k``/``cross_v``: the cross-attention's K and V (L, B, S_enc,
    Hkv, hd) in the activation dtype (audio; zeros until
    ``precompute_cross``)."""
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
    """``mesh`` (a :class:`repro_torch.launch.mesh.ProductionMesh`) runs
    the forward and the loss on this rank's blocks of the parameters
    (:func:`repro_torch.launch.sharding.shard_params`) and its rows of the
    batch (``sharding.local_batch``: the tokens, the vlm's image and
    whisper's frame embeddings), as :mod:`repro_torch.models.sharded`
    lays out, for every family; the moe family's FFNs run expert-parallel
    there (:attr:`expert_parallel`).
    The reference's knobs: ``layer_pspec_fn`` (each layer leaf's
    placement, which the mesh path needs: ``launch.sharding.
    layer_pspec_fn(mesh, ...)`` with the options the parameters were
    sharded with), ``shard_logits`` (``forward`` returns the rank's vocab
    block of the logits, else the block all-gathered over ``model``, a
    forward-only path; the loss is vocab-parallel either way), ``act_tp``
    (``"model"``: the residual stream between layers split over
    ``model``; None: whole), ``moe_weight_mode`` (``"fsdp"`` or
    ``"stationary"``, whose expert weights are sharded with
    ``moe_fsdp_dim="f"``) and ``dp_axes``, taken to match the
    reference's signature: the batch splits over the mesh's data axes,
    and any other value raises."""
    cfg: ModelConfig
    decode_window: int = 0    # 0 = full cache; > 0 = ring buffer (long ctx)
    mesh: Any = None
    dp_axes: Optional[tuple] = None
    shard_logits: bool = True
    layer_pspec_fn: Any = None
    act_tp: Optional[str] = "model"
    moe_weight_mode: str = "fsdp"

    @property
    def expert_parallel(self) -> bool:
        """The moe family on a mesh runs its MoE FFNs expert-parallel
        (``moe.moe_ffn_sharded``); the reference's dense dispatch under
        a mesh is not ported."""
        return self.mesh is not None and self.cfg.family == "moe"

    def __post_init__(self):
        cfg = self.cfg
        if self.moe_weight_mode not in ("fsdp", "stationary"):
            raise ValueError(f"moe_weight_mode {self.moe_weight_mode!r}")
        if self.mesh is None:
            return
        if self.layer_pspec_fn is None:
            raise ValueError(
                "a model on a production mesh reads each layer's placement: "
                "pass layer_pspec_fn=launch.sharding.layer_pspec_fn(mesh, "
                "...) as the parameters were sharded")
        if self.act_tp not in ("model", None):
            raise ValueError(f"act_tp {self.act_tp!r}: 'model' or None")
        if self.dp_axes is not None \
                and tuple(self.dp_axes) != data_axes(self.mesh):
            raise ValueError(f"dp_axes {self.dp_axes}: the batch splits over "
                             f"the mesh's data axes {data_axes(self.mesh)}")
        m = self.mesh.axis_size("model")
        if cfg.num_heads % m or cfg.d_model % m:
            raise ValueError(f"{m} model ranks do not divide {cfg.name}'s "
                             f"{cfg.num_heads} heads and width "
                             f"{cfg.d_model}")
        if cfg.family == "moe" and cfg.num_experts % m:
            raise ValueError(f"{m} model ranks do not divide {cfg.name}'s "
                             f"{cfg.num_experts} experts")
        if cfg.family == "ssm" and cfg.rwkv_heads % m:
            raise ValueError(f"{m} model ranks do not divide {cfg.name}'s "
                             f"{cfg.rwkv_heads} rwkv_heads")

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a production mesh is not ported (ROADMAP.md "
                "queue 1: decode and ckpt/io.py on the mesh)")

    def mesh_context(self) -> sharded.MeshContext:
        """What the sharded blocks read of this model's mesh."""
        return sharded.MeshContext(mesh=self.mesh, dp=data_axes(self.mesh),
                                   act_tp=self.act_tp,
                                   pspec=self.layer_pspec_fn,
                                   adtype=self.cfg.adtype)

    def _mesh_forward(self, ctx, params, batch, dropped=None):
        """The sharded forward: (this rank's (B_loc, S, V/m) f32 logits
        block, the auxiliary losses) — see :class:`Model`.  Each layer
        (a hybrid unit, an interleaved moe super-block, an encoder layer)
        runs under ``sharded.remat``."""
        cfg = self.cfg
        table = ctx.gathered("embed", params["embed"])
        x = sharded.embed(ctx, batch["tokens"], table).to(cfg.adtype)
        if cfg.family == "vlm":
            img = batch["img_embeds"].to(cfg.adtype) @ ctx.gathered(
                "img_proj", params["img_proj"]).to(cfg.adtype)
            x = torch.cat([ctx.stream(img), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc = self._mesh_encode(ctx, params, batch) \
            if cfg.family == "audio" else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for key, _, _, block in _stacks(cfg):
            if block is None:     # audio's encoder, run by _mesh_encode
                continue
            for shards in sharded.layer_shards(params[key]):
                x, out = sharded.remat(self._mesh_layer, ctx, key, shards, x,
                                       positions, enc)
                if out is not None:
                    aux = aux + out.aux_loss
                    if dropped is not None:
                        dropped.append(out.dropped_frac)
        x = layers.rms_norm(ctx.enter(x), params["final_norm"])
        logits = layers.unembed(x, table)
        if cfg.family == "vlm":
            logits = logits[:, cfg.num_image_tokens:]
        return logits, [aux] if cfg.family == "moe" else []

    def _mesh_layer(self, ctx, key, shards, x, positions, enc):
        """One layer of stack ``key`` on the mesh from this rank's shards
        of its leaves → (x, the MoE block's ``MoEOutput`` or None)."""
        cfg = self.cfg
        p = ctx.layer(shards)
        fam = cfg.family
        if fam in ("dense", "vlm"):
            return sharded.attn_block(ctx, cfg, p, x, positions), None
        if fam == "ssm":
            return sharded.rwkv_block(ctx, p, x), None
        if fam == "audio":
            return sharded.audio_block(ctx, cfg, p, x, positions, enc), None
        if fam == "hybrid":
            if key == "tail":
                return sharded.recurrent_block(ctx, cfg, p, x), None
            for r in range(cfg.pattern_recurrent):
                x = sharded.recurrent_block(ctx, cfg, _prefixed(p, f"r{r}_"),
                                            x)
            for a in range(cfg.pattern_attn):
                x = sharded.attn_block(ctx, cfg, _prefixed(p, f"a{a}_"), x,
                                       positions, window=cfg.local_window)
            return x, None
        if cfg.moe_every != 1:
            x = sharded.attn_block(ctx, cfg, _prefixed(p, "d_"), x,
                                   positions)
            p = _prefixed(p, "m_")
        return sharded.moe_block(ctx, cfg, p, x, positions,
                                 self.moe_weight_mode)

    def _mesh_encode(self, ctx, params, batch):
        """Whisper's encoder on the mesh over this rank's rows of the
        frames, in the residual stream's layout → its output whole over
        ``model`` (B_loc, S_enc, D)."""
        x = self._frames(batch)
        if ctx.act_tp is not None:     # the frames need no gradient
            x = ctx.block(x)
        for shards in sharded.layer_shards(params["encoder"]):
            x = sharded.remat(self._mesh_encoder_layer, ctx, shards, x)
        return layers.rms_norm(ctx.enter(x), params["enc_final_norm"])

    def _mesh_encoder_layer(self, ctx, shards, x):
        return sharded.attn_block(ctx, _encoder_cfg(self.cfg),
                                  ctx.layer(shards), x, None, causal=False)

    def _mesh_loss(self, params, batch):
        """This rank's share of the mean loss: its tokens' mean
        cross-entropy (plus moe's aux term, the global batch's) divided by
        the count of data ranks, which hold equal rows; the shares sum to
        the loss over the data axes."""
        ctx = self.mesh_context()
        logits, aux = self._mesh_forward(ctx, params, batch)
        tokens = batch["tokens"]
        ce = sharded.cross_entropy_mean(ctx, logits[:, :-1], tokens[:, 1:])
        if aux:
            ce = ce + self.cfg.router_aux_weight * aux[0] \
                / self.cfg.num_layers
        return ce / (self.mesh.axis_size(ctx.dp) if ctx.dp else 1)

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
        if cfg.family == "audio":
            params["enc_final_norm"] = torch.zeros(cfg.d_model, dtype=dt,
                                                   device=dev)
        if cfg.family == "vlm":
            # the stub projector of the (already encoded) image patches
            params["img_proj"] = layers.normal(
                generator, (cfg.d_model, cfg.d_model), 0.02, dt, dev)
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
        """batch: ``{"tokens": (B, S) ints}``, and ``"img_embeds"`` (B,
        num_image_tokens, D) for vlm, ``"frame_embeds"`` (B, S_enc, D)
        for audio → ((B, S, padded_vocab) f32 logits of the text, the
        auxiliary losses): for moe ``[Σ aux_loss]`` over its MoE layers,
        from an f32 zero in layer order, as the reference's scan carries
        it; [] for the other families.  ``dropped``, a list, receives each
        MoE layer's share of dropped assignments.  vlm prepends the
        projected image embeddings, the positions running over the whole
        sequence, and drops their logits."""
        if self.mesh is not None:
            logits, aux = self._mesh_forward(self.mesh_context(), params,
                                             batch, dropped)
            if not self.shard_logits:
                logits = self.mesh.all_gather(logits, "model", -1)
            return logits, aux
        cfg = self.cfg
        ad = cfg.adtype
        x = layers.embed(batch["tokens"], params["embed"]).to(ad)
        if cfg.family == "vlm":
            img = batch["img_embeds"].to(ad) @ params["img_proj"].to(ad)
            x = torch.cat([img, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        is_moe = cfg.family == "moe"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ctx = {"enc": self._encode(params, batch)} \
            if cfg.family == "audio" else {}
        for key, _, _, block in _stacks(cfg):
            if block is None:     # audio's encoder, run by _encode
                continue
            for p in self._layers(params[key]):
                x = block(cfg, p, x, positions, **ctx)
                if is_moe:
                    x, out = x
                    aux = aux + out.aux_loss
                    if dropped is not None:
                        dropped.append(out.dropped_frac)
        x = layers.rms_norm(x, params["final_norm"])
        logits = layers.unembed(x, params["embed"])
        if cfg.family == "vlm":
            logits = logits[:, cfg.num_image_tokens:]
        return logits, [aux] if is_moe else []

    def _encode(self, params, batch):
        """Whisper's encoder over ``batch["frame_embeds"]`` (B, S_enc, D):
        sinusoidal positions (the reference's exp(−i / (D/2) · ln 10⁴)
        frequencies, in f32, then cast), the encoder blocks, the final
        norm → (B, S_enc, D) in the activation dtype."""
        x = self._frames(batch)
        for p in self._layers(params["encoder"]):
            x = _encoder_block(self.cfg, p, x)
        return layers.rms_norm(x, params["enc_final_norm"])

    def _frames(self, batch):
        """The encoder's input: the frames in the activation dtype plus
        their sinusoidal positions."""
        ad = self.cfg.adtype
        frames = batch["frame_embeds"].to(ad)
        dev = frames.device
        half = self.cfg.d_model // 2
        log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32) / half
                          * log_base).to(dev)
        ang = torch.arange(frames.shape[1], dtype=torch.float32,
                           device=dev)[:, None] * freqs
        return frames + torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(ad)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy over the padded vocabulary, f32;
        moe adds ``router_aux_weight`` · Σ aux_loss / ``num_layers`` (all
        layers, not the MoE ones, as in the reference).  On a mesh, this
        rank's share (:meth:`_mesh_loss`): its tokens' mean, plus moe's
        aux term of the global batch, over the count of data ranks; the
        shares sum to the loss over the data axes."""
        if self.mesh is not None:
            return self._mesh_loss(params, batch)
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
        return cfg.num_layers if cfg.family in ("dense", "vlm", "moe",
                                                "audio") else 0

    def init_decode(self, batch_size: int, max_len: int,
                    device: Device = None) -> DecodeState:
        """Zero caches on ``device`` (``cuda`` unless the caller asks for
        the CPU).  Dense, moe: a KV cache of ``max_len`` slots a layer, or a
        ring buffer of ``min(decode_window, max_len)``; ssm: the O(1)
        recurrent state; hybrid: a ring of ``min(local_window, max_len)``
        slots an attention layer (``decode_window`` unused, as in the
        reference) and the RG-LRU state and conv context a recurrent
        layer; vlm as dense; audio as dense, and the cross-attention's K
        and V of ``encoder_seq`` frames a layer, zero until
        :meth:`precompute_cross`."""
        self._no_mesh("init_decode")
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
        cross_k = cross_v = _empty(dev)
        if cfg.family == "audio":
            cshape = (cfg.num_layers, batch_size, cfg.encoder_seq,
                      cfg.num_kv_heads, cfg.head_dim)
            cross_k = torch.zeros(cshape, dtype=dt, device=dev)
            cross_v = torch.zeros(cshape, dtype=dt, device=dev)
        return DecodeState(
            length=torch.zeros((), dtype=torch.int32, device=dev),
            kv_k=kv_k, kv_v=kv_v, rec_h=rec_h, rec_conv=rec_conv,
            cross_k=cross_k, cross_v=cross_v)

    @torch.no_grad()
    def precompute_cross(self, params, batch, state: DecodeState):
        """Whisper: run the encoder once over ``batch["frame_embeds"]``
        and return ``state`` with each decoder layer's cross-attention K
        and V, (L, B, S_enc, Hkv, hd) in the activation dtype (new
        tensors, as the reference's; S_enc is the frames' length).  The
        encoder's attention runs the flash kernel's unmasked instance on
        the card; decode then reads these without a kernel."""
        if self.cfg.family != "audio":
            raise ValueError(f"precompute_cross: the {self.cfg.family!r} "
                             "family has no cross-attention")
        enc = self._encode(params, batch)
        ks, vs = zip(*(_cross_kv(self.cfg, p, enc)
                       for p in self._layers(params["blocks"])))
        ad = self.cfg.adtype
        return state._replace(cross_k=torch.stack(ks).to(ad),
                              cross_v=torch.stack(vs).to(ad))

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
        self._no_mesh("decode_step")
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"]).to(cfg.adtype)  # (B, 1, D)
        x = {"dense": self._dense_decode, "vlm": self._dense_decode,
             "moe": self._moe_decode, "ssm": self._ssm_decode,
             "hybrid": self._hybrid_decode,
             "audio": self._audio_decode}[cfg.family](params, state, x)
        x = layers.rms_norm(x, params["final_norm"])
        logits = layers.unembed(x, params["embed"])
        return logits, state._replace(length=state.length + 1)

    def _dense_decode(self, params, state: DecodeState, x):
        for i, p in enumerate(self._layers(params["blocks"])):
            x = _attn_decode(self.cfg, p, x, state.kv_k[i], state.kv_v[i],
                             state.length, window=self.decode_window)
        return x

    def _audio_decode(self, params, state: DecodeState, x):
        """Each decoder layer for one token: causal self-attention with
        RoPE against its cache (written in place), cross-attention against
        the whole cached encoder K and V, then the FFN."""
        cfg = self.cfg
        b = x.shape[0]
        h, hd = cfg.num_heads, cfg.head_dim
        frames = torch.full((), state.cross_k.shape[2], dtype=torch.int32,
                            device=x.device)
        for i, p in enumerate(self._layers(params["blocks"])):
            x = _attn_decode_only(cfg, p, x, state.kv_k[i], state.kv_v[i],
                                  state.length, window=self.decode_window)
            q = (layers.rms_norm(x, p["xattn_norm"]) @ p["xwq"]).reshape(
                b, 1, h, hd)
            o = attention.decode_attend(q, attention.KVCache(
                state.cross_k[i], state.cross_v[i], frames))
            x = x + o.reshape(b, 1, h * hd) @ p["xwo"]
            x = x + _ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"]))
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


def build_model(cfg: ModelConfig, *, decode_window: int = 0, mesh=None,
                dp_axes: Optional[tuple] = None, shard_logits: bool = True,
                layer_pspec_fn=None, act_tp: Optional[str] = "model",
                moe_weight_mode: str = "fsdp") -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"build_model: unknown family {cfg.family!r} ({cfg.name})")
    return Model(cfg=cfg, decode_window=decode_window, mesh=mesh,
                 dp_axes=dp_axes, shard_logits=shard_logits,
                 layer_pspec_fn=layer_pspec_fn, act_tp=act_tp,
                 moe_weight_mode=moe_weight_mode)


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
