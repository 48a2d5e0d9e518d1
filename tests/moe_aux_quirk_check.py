"""Subprocess body for ``test_torch_production_mesh_families``: the
reference's own loss of reduced qwen3-moe on a (2, 2) (data, model) mesh
of four virtual CPU devices, its MoE FFNs on the expert-parallel
``shard_map`` path, against its one-device loss from the same weights
and batch (``torch_production_mesh_family_cases.setup``).

The reference's sharded MoE returns its load-balance loss under the
out_spec ``P()`` with the replication check off
(``repro/models/moe.py:202,223``, ``repro/launch/mesh.py:52,58``), where
each data rank computed it from its own rows: the mesh loss then carries
one data rank's aux, not the global batch's.  Prints one JSON line: the
one-device and the mesh loss, the global aux of each MoE layer and each
data rank's rows' aux, the cross-entropy, then the marker.

Run directly:  python tests/moe_aux_quirk_check.py
"""
from _subprocess import setup_virtual_devices

setup_virtual_devices(4)

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.launch import sharding  # noqa: E402
from repro.launch.mesh import make_mesh, use_mesh  # noqa: E402
from repro.models import build_model, layers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

import torch_production_mesh_family_cases as cases  # noqa: E402
from repro_torch.models.transformer import params_to_numpy  # noqa: E402

ARCH = cases.MOE[0]


def layer_auxes(model, params, tokens):
    """Each MoE layer's load-balance loss over ``tokens``'s rows, from the
    reference's own blocks (its scan body, run layer by layer)."""
    cfg = model.cfg
    from repro.models import transformer as jt
    x = layers.embed(tokens, params["embed"]).astype(cfg.adtype)
    positions = jnp.arange(x.shape[1])[None, :]
    out = []
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda w: w[i].astype(cfg.adtype),
                         params["blocks"])
        h = jt._attn_apply(cfg, p, x, positions)
        xn = layers.rms_norm(h, p["ffn_norm"])
        _, idx, probs = jmoe.route(xn, p["router"], cfg.experts_per_token)
        out.append(float(jmoe.load_balance_loss(probs, idx,
                                                cfg.num_experts)))
        x, _ = jt._moe_block(cfg, p, x, positions)
    return out


def main():
    cfg = reduced(get_config(ARCH))
    _, params_t, batch_t = cases.setup(ARCH)
    params = jax.tree.map(jnp.asarray, params_to_numpy(params_t))
    batch = {"tokens": jnp.asarray(batch_t["tokens"].numpy())}
    one = build_model(cfg)
    loss_one = float(jax.jit(one.loss)(params, batch))
    logits = one.forward(params, batch)
    toks = batch["tokens"]
    ce = float(layers.softmax_cross_entropy(logits[:, :-1], toks[:, 1:]))
    mesh = make_mesh((2, 2), ("data", "model"))
    sh = build_model(cfg, dp_axes=("data",),
                     layer_pspec_fn=sharding.layer_pspec_fn(mesh),
                     expert_parallel=True)
    with use_mesh(mesh):
        shard = sharding.param_shardings(
            jax.eval_shape(sh.init, jax.random.key(0)), mesh)
        p = jax.device_put(params, shard)
        b = jax.device_put(batch, {"tokens": jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(("data",), None))})
        loss_mesh = float(jax.jit(sh.loss)(p, b))
    rows = toks.shape[0] // 2
    print(json.dumps({
        "loss_one_device": loss_one, "loss_mesh": loss_mesh, "ce": ce,
        "router_aux_weight": cfg.router_aux_weight,
        "num_layers": cfg.num_layers,
        "aux_global": layer_auxes(one, params, toks),
        "aux_data_rank": [layer_auxes(one, params,
                                      toks[j * rows:(j + 1) * rows])
                          for j in range(2)]}))
    print("MOE_AUX_QUIRK_OK")


if __name__ == "__main__":
    main()
