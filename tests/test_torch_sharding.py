"""The placement tables, the meta-device specs and the shape names of the
port against the reference's, on the CPU without a process group.

* Every leaf's placement (``sharding.param_shardings``, and
  ``layer_pspec_fn`` of each layer's slice) equals the reference's
  ``PartitionSpec`` entry for entry, for every arch of ``ARCH_IDS`` at
  ``reduced(...)``, on a (1, 1) and a (2, 4) (data, model) mesh and a
  (2, 16, 16) (pod, data, model) mesh, with both ``fsdp_params`` and
  both ``moe_fsdp_dim``s; so do ``state_shardings``, ``batch_shardings``
  (every ``INPUT_SHAPES`` entry, with and without ``dp_override``) and
  ``decode_state_shardings`` (the decode shapes).  The reference is
  called on ``jax.sharding.AbstractMesh``, the port on a stand-in with
  ``axis_names`` and ``shape``.
* ``specs.param_specs``, ``input_specs`` and ``decode_specs`` on the
  meta device equal ``jax.eval_shape``'s shapes and dtypes for every
  arch at its published size × every ``INPUT_SHAPES`` entry.
* ``local_block`` cuts blocks that put back together give the tensor,
  ``data_axes`` / ``arena_axes`` / ``arena_spec`` and the configs'
  shape names (``InputShape``, ``INPUT_SHAPES``, ``get_shape``,
  ``attention_free``, ``active_param_count``) equal the reference's.
"""
import dataclasses
import itertools
from typing import NamedTuple

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.core import ssca as jssca
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild_model
from repro_torch import tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, get_shape
from repro_torch.core import ssca
from repro_torch.launch import ClientMesh, GroupMesh, sharding, specs
from repro_torch.launch.mesh import (ProductionMesh, arena_axes, arena_spec,
                                     data_axes)
from repro_torch.models import build_model

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OPTIONS = list(itertools.product((True, False), ("d", "f")))
DECODE = [n for n, s in tbase.INPUT_SHAPES.items() if s.kind == "decode"]


class StandIn(NamedTuple):
    """What the port's tables read of a mesh."""
    axis_names: tuple
    shape: dict


def _meshes(name):
    sizes, axes = MESHES[name]
    return StandIn(axes, dict(zip(axes, sizes))), AbstractMesh(sizes, axes)


def _named(jtree) -> dict:
    """'a/b' → leaf of a reference pytree (dicts by key, tuples by index)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: x is None)[0]}


def _spec(sharding_or_none):
    return tuple(sharding_or_none.spec)


def _models(arch):
    tcfg, jcfg = (tbase.reduced(get_config(arch)),
                  jbase.reduced(jget_config(arch)))
    return tcfg, jcfg, build_model(tcfg), jbuild_model(jcfg)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_match_reference(arch, mesh):
    tmesh, jm = _meshes(mesh)
    _, _, tmodel, jmodel = _models(arch)
    tparams = specs.param_specs(tmodel)
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0))
    for fsdp, dim in OPTIONS:
        kw = dict(fsdp_params=fsdp, moe_fsdp_dim=dim)
        got = dict(tree.named_leaves(
            sharding.param_shardings(tparams, tmesh, **kw)))
        want = {k: _spec(v) for k, v in _named(
            jsharding.param_shardings(jparams, jm, **kw)).items()}
        assert got == want
        tfn, jfn = (sharding.layer_pspec_fn(tmesh, **kw),
                    jsharding.layer_pspec_fn(jm, **kw))
        for name, leaf in tree.named_leaves(tparams):
            if name.startswith(("blocks/", "encoder/", "tail/")):
                shape = tuple(leaf.shape[1:])
                assert tfn(name, shape) == tuple(jfn(name, shape)), name
        tstate = ssca.init(tparams, with_beta=True)
        jstate = jssca.init(jparams, with_beta=True)
        got_st = sharding.state_shardings(tstate, got, tmesh)
        want_st = jsharding.state_shardings(
            jstate, jsharding.param_shardings(jparams, jm, **kw), jm)
        assert got_st.step == _spec(want_st.step)
        assert got_st.lin == got_st.beta == got
        assert {k: _spec(v) for k, v in _named(want_st.beta).items()} \
            == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_decode_placements_match_reference(arch, mesh):
    tmesh, jm = _meshes(mesh)
    tcfg, jcfg, tmodel, jmodel = _models(arch)
    for name in tbase.INPUT_SHAPES:
        tshape, jshape = get_shape(name), jget_shape(name)
        for dp in (None, ("data",)):
            got = sharding.batch_shardings(tcfg, tshape, tmesh, dp)
            want = jsharding.batch_shardings(jcfg, jshape, jm, dp)
            assert got == {k: _spec(v) for k, v in want.items()}
    for name in DECODE:
        tshape, jshape = get_shape(name), jget_shape(name)
        state = specs.decode_specs(tmodel, tshape)
        got = sharding.decode_state_shardings(tcfg, tshape, tmesh, state)
        jstate = jax.eval_shape(lambda: jmodel.init_decode(
            jshape.global_batch, jshape.seq_len))
        want = jsharding.decode_state_shardings(jcfg, jshape, jm, jstate)
        assert tuple(got) == tuple(_spec(w) for w in want)
    assert sharding.replicated(tmesh) == _spec(jsharding.replicated(jm))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_specs_match_eval_shape(arch):
    """At the published size: no storage on the port's side."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    tmodel, jmodel = build_model(tcfg), jbuild_model(jcfg)
    got = specs.param_specs(tmodel)
    assert all(x.device.type == "meta" for _, x in tree.named_leaves(got))
    want = _named(jspecs.param_specs(jmodel))
    assert {k: (tuple(x.shape), _dtype(x))
            for k, x in tree.named_leaves(got)} \
        == {k: (tuple(x.shape), str(x.dtype)) for k, x in want.items()}
    for name in tbase.INPUT_SHAPES:
        tshape, jshape = get_shape(name), jget_shape(name)
        got = specs.input_specs(tcfg, tshape)
        want = jspecs.input_specs(jcfg, jshape)
        assert {k: (tuple(x.shape), _dtype(x)) for k, x in got.items()} \
            == {k: (tuple(x.shape), str(x.dtype)) for k, x in want.items()}
        if tshape.kind != "decode":
            continue
        got = specs.decode_specs(tmodel, tshape)
        want = jspecs.decode_specs(jmodel, jshape)
        assert [(tuple(x.shape), _dtype(x)) for x in got] \
            == [(tuple(x.shape), str(x.dtype)) for x in want]


def test_local_blocks_tile_the_tensor():
    """Every rank's block of a (2, 2, 2) mesh, put back in rank order,
    gives the tensor; an uneven split raises."""
    sizes, axes = (2, 2, 2), ("pod", "data", "model")
    x = torch.arange(8 * 4 * 16, dtype=torch.float32).reshape(8, 4, 16)
    for spec in ((("pod", "data"), None, "model"), ("model", "data"),
                 (None, None, ("pod", "data", "model")), ()):
        blocks = {}
        for coords in itertools.product(*(range(n) for n in sizes)):
            mesh = ProductionMesh(axes, sizes, coords, "gloo",
                                  torch.device("cpu"), {})
            blocks[coords] = sharding.local_block(x, spec, mesh)
        mesh = ProductionMesh(axes, sizes, (0, 0, 0), "gloo",
                              torch.device("cpu"), {})
        for coords, block in blocks.items():
            index = []
            for dim in range(x.dim()):
                entry = spec[dim] if dim < len(spec) else None
                if entry is None:
                    index.append(slice(None))
                    continue
                entry = (entry,) if isinstance(entry, str) else entry
                n = mesh.axis_size(entry)
                at = 0
                for a in entry:
                    at = at * mesh.shape[a] + coords[axes.index(a)]
                size = x.shape[dim] // n
                index.append(slice(at * size, (at + 1) * size))
            assert torch.equal(block, x[tuple(index)])
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_block(torch.zeros(3, 4), ("model",), mesh)


def test_axis_helpers_match_reference():
    for name in MESHES:
        tmesh, jm = _meshes(name)
        assert data_axes(tmesh) == jmesh.data_axes(jm)
        assert arena_axes(tmesh) == jmesh.arena_axes(jm)
        assert arena_spec(tmesh) == tuple(jmesh.arena_spec(jm))
    client = ClientMesh(group=None, rank=0, size=1, backend="gloo",
                        device=torch.device("cpu"))
    group = GroupMesh(whole=client, groups=client, clients=client,
                      shape=(1, 1))
    assert arena_axes(client) == jmesh.arena_axes(jmesh.make_client_mesh(1))
    assert arena_axes(group) == jmesh.arena_axes(jmesh.make_group_mesh(1, 1))
    assert arena_spec(group) == tuple(jmesh.arena_spec(
        jmesh.make_group_mesh(1, 1)))


def test_shape_names_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in tbase.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jbase.INPUT_SHAPES.items()}
    for name in tbase.INPUT_SHAPES:
        assert dataclasses.astuple(get_shape(name)) \
            == dataclasses.astuple(jget_shape(name))
    for arch in ARCH_IDS:
        for cut in (False, True):
            t, j = get_config(arch), jget_config(arch)
            if cut:
                t, j = tbase.reduced(t), jbase.reduced(j)
            assert t.attention_free == j.attention_free
            assert t.active_param_count() == j.active_param_count()
