"""The LM model zoo: the ``dense`` and ``ssm`` families of the reference's.

The port of ``repro/models/transformer.py``'s llama-style GQA decoder
(llama3-8b, yi-9b, granite-8b; granite-34b with its GELU MLP) and its
attention-free RWKV-6 stack (rwkv6-7b: time mix and channel mix,
:mod:`repro_torch.models.rwkv6`).  ``build_model(cfg)`` returns a
:class:`Model` with

* ``init(generator, device)`` — the layer-stacked parameter tree
  ``{"blocks": {...}, "embed", "final_norm"}``, every block leaf
  ``(num_layers, …)``: ``attn_norm, ffn_norm, wq, wk, wv, wo, <ffn>``
  (dense) or the time-mix and channel-mix leaves ``bonus, ck, cm_norm,
  …, wv`` (ssm);
* ``forward(params, batch)`` — the (B, S, padded_vocab) f32 logits;
* ``forward_with_aux(params, batch)`` — the logits and the auxiliary
  losses (none for this family).

The reference scans the stacked blocks under ``jax.checkpoint``; the port
casts the stacked leaves to the activation dtype (``_cast``), runs a
Python loop over the layers, and keeps activations for the backward (no
rematerialisation).  Other families raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import Device, resolve_device, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, rwkv6


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


def _rwkv_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Per-layer parameter shapes of one RWKV-6 block: time mix, channel
    mix and their two norms."""
    d, f = cfg.d_model, cfg.d_ff
    return {**rwkv6.time_mix_params_shapes(d, cfg.rwkv_heads),
            "tm_norm": (d,), "cm_norm": (d,),
            "cmix_k": (d,), "cmix_r": (d,),
            "ck": (d, f), "cv": (f, d), "cr": (d, d)}


# constant initial values, by name (every other leaf is drawn)
_FILL = {"decay_base": -1.0, "bonus": 0.0, "ln_w": 0.0, "ln_b": 0.0}


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


def _attn_apply(cfg, p, x, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = layers.rms_norm(x, p["attn_norm"])
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, kvh, hd)
    v = (xn @ p["wv"]).reshape(b, s, kvh, hd)
    q = layers.apply_rope(q, positions)
    k = layers.apply_rope(k, positions)
    o = attention.attend(q, k, v, causal=True)
    return x + o.reshape(b, s, h * hd) @ p["wo"]


def _attn_block(cfg, p, x, positions):
    x = _attn_apply(cfg, p, x, positions)
    return x + _ffn_apply(cfg, p, layers.rms_norm(x, p["ffn_norm"]))


def _rwkv_block(cfg, p, x, positions):
    """Time mix then channel mix, each on the RMS-normed stream, from a
    zero state (``positions`` unused: RWKV has none)."""
    del positions
    x = x + rwkv6.time_mix(p, layers.rms_norm(x, p["tm_norm"]),
                           cfg.rwkv_heads)
    return x + rwkv6.channel_mix(p, layers.rms_norm(x, p["cm_norm"]))


# per ported family: (block shapes, block apply)
_FAMILY = {"dense": (_block_shapes, _attn_block),
           "ssm": (_rwkv_shapes, _rwkv_block)}
PORTED_FAMILIES = tuple(_FAMILY)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device: Device = None):
        """Random parameters drawn from ``generator`` on its own device,
        placed on ``device`` (``cuda`` unless the caller asks for the
        CPU).  The reference draws with ``jax.random``, which the port
        does not reproduce: to start both from one point, carry weights
        with :func:`params_from_numpy`."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = cfg.pdtype
        return {
            "blocks": _init_stacked(generator, cfg.num_layers,
                                    _FAMILY[cfg.family][0](cfg), dt, dev),
            "embed": layers.normal(generator,
                                   (cfg.padded_vocab, cfg.d_model), 0.02,
                                   dt, dev),
            "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev),
        }

    def _cast(self, p):
        """Block leaves in the activation dtype (norm weights are upcast
        again inside ``rms_norm``), as the reference's scan body casts
        each layer's slice."""
        return {k: w.to(self.cfg.adtype) for k, w in p.items()}

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits (auxiliary losses discarded)."""
        return self.forward_with_aux(params, batch)[0]

    def forward_with_aux(self, params, batch):
        """batch: ``{"tokens": (B, S) ints}`` → ((B, S, padded_vocab) f32
        logits, [])."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"]).to(cfg.adtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        # one cast and one unbind per stacked leaf: their backward stacks
        # the layers' gradients once, where indexing w[i] layer by layer
        # would zero-fill a whole (L, …) gradient per layer and sum them
        blocks = self._cast(params["blocks"])
        per_layer = zip(*(w.unbind(0) for w in blocks.values()))
        block = _FAMILY[cfg.family][1]
        for ws in per_layer:
            x = block(cfg, dict(zip(blocks, ws)), x, positions)
        x = layers.rms_norm(x, params["final_norm"])
        return layers.unembed(x, params["embed"]), []


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"build_model: the {cfg.family!r} family ({cfg.name}) is not "
            "ported to repro_torch yet (ROADMAP.md, queue 1 item 5)")
    return Model(cfg=cfg)


def params_from_numpy(arrays: Any, device: Device = None):
    """A tree of arrays (nested dicts, e.g. the reference's parameter
    pytree as numpy) → the same tree of f32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(arrays, dict):
        return {k: params_from_numpy(v, dev) for k, v in arrays.items()}
    return torch.tensor(np.asarray(arrays, np.float32), device=dev)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameter tree → the same tree of numpy arrays."""
    return tree.map(lambda w: w.detach().float().cpu().numpy(), params)
