"""Subprocess body for ``test_torch_production_mesh_decode``: the
reference's own decode on a (2, 2) (data, model) mesh of four virtual CPU
devices, as ``repro/launch/dryrun.py::lower_one`` lowers it for a decode
shape: its jitted ``decode_step`` with the parameters placed by
``param_shardings``, the state by ``decode_state_shardings`` (the KV
caches' sequence over ``model``) and the tokens by ``batch_shardings``;
the moe family expert-parallel in ``"fsdp"`` mode.  The cases are
``torch_production_mesh_decode_cases.REFERENCE``, from the same weights
and tokens (``torch_production_mesh_decode_cases.setup``), teacher-forced
token by token.  Writes every step's logits, by case, to the ``.npz``
file named on the command line, then prints the marker.

Run directly:  python tests/production_mesh_decode_check.py OUT.npz
"""
from _subprocess import setup_virtual_devices

setup_virtual_devices(4)

import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import InputShape, reduced  # noqa: E402
from repro.launch import sharding  # noqa: E402
from repro.launch.mesh import make_mesh, use_mesh  # noqa: E402
from repro.models import build_model  # noqa: E402

import torch_production_mesh_decode_cases as cases  # noqa: E402
from repro_torch.models.transformer import params_to_numpy  # noqa: E402


def run(name: str, mesh) -> np.ndarray:
    """A case's logits at every step, (B, PROMPT + NEW, padded_vocab)."""
    case = cases.CASES[name]
    _, params_t, tokens_t, _ = cases.setup(name)
    cfg = reduced(get_config(case.arch))
    b, steps = tokens_t.shape
    model = build_model(cfg, decode_window=case.window, dp_axes=("data",),
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh),
                        expert_parallel=cfg.family == "moe",
                        act_tp=case.act_tp)
    shape = InputShape("decode", cases.max_len(case), b, "decode")
    with use_mesh(mesh):
        p_sh = sharding.param_shardings(
            jax.eval_shape(model.init, jax.random.key(0)), mesh)
        params = jax.device_put(
            jax.tree.map(jnp.asarray, params_to_numpy(params_t)), p_sh)
        d_abs = jax.eval_shape(lambda: model.init_decode(b, shape.seq_len))
        state = jax.device_put(
            model.init_decode(b, shape.seq_len),
            sharding.decode_state_shardings(cfg, shape, mesh, d_abs))
        tok_sh = sharding.batch_shardings(cfg, shape, mesh)["tokens"]
        step = jax.jit(model.decode_step)
        tokens = np.asarray(tokens_t.numpy())
        out = []
        for t in range(steps):
            logits, state = step(params, state, jax.device_put(
                jnp.asarray(tokens[:, t:t + 1]), tok_sh))
            out.append(np.asarray(logits, np.float32))
    return np.concatenate(out, axis=1)


def main():
    mesh = make_mesh((2, 2), ("data", "model"))
    np.savez(sys.argv[1], **{name: run(name, mesh)
                             for name in cases.REFERENCE})
    print("PRODUCTION_MESH_DECODE_OK")


if __name__ == "__main__":
    main()
