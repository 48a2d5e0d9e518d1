"""Meta-device stand-ins for every model input — the dry run's "data".

The port of ``repro/launch/specs.py``: tensors on the ``meta`` device
(shape and dtype, no storage) where the reference has
``jax.ShapeDtypeStruct``.  ``input_specs(cfg, shape)`` gives the batch
dict of a train or prefill step (a decode step's tokens for a decode
shape), ``param_specs(model)`` the parameter tree, ``decode_specs(model,
shape)`` the decode state.  Nothing here allocates device memory.  The
reference attaches a sharding to each stand-in; a meta tensor carries
none, and the placements are :mod:`repro_torch.launch.sharding`'s
tables.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.transformer import DecodeState, Model

META = torch.device("meta")


def input_specs(cfg: ModelConfig,
                shape: InputShape) -> Dict[str, torch.Tensor]:
    """The batch for a train or prefill step.

    * text families: tokens (B, S)
    * vlm: image tokens are part of S — tokens (B, S − 576) + patch
      embeddings (B, 576, D) from the stub frontend
    * audio: decoder tokens (B, S) + encoder frame embeddings
      (B, 1500, D) from the stub frontend
    * a decode shape: tokens (B, 1)
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                      device=META)}
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        out["tokens"] = torch.empty((b, s - cfg.num_image_tokens),
                                    dtype=torch.int32, device=META)
        out["img_embeds"] = torch.empty((b, cfg.num_image_tokens,
                                         cfg.d_model), dtype=cfg.adtype,
                                        device=META)
    else:
        out["tokens"] = torch.empty((b, s), dtype=torch.int32, device=META)
    if cfg.family == "audio":
        out["frame_embeds"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                          dtype=cfg.adtype, device=META)
    return out


def param_specs(model: Model):
    """The parameter tree on the meta device (no init executed)."""
    return model.init(torch.Generator(), device=META)


def decode_specs(model: Model, shape: InputShape) -> DecodeState:
    """The decode state for (arch × decode shape) on the meta device."""
    return model.init_decode(shape.global_batch, shape.seq_len, device=META)
