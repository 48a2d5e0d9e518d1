"""The port stands alone, and its entry points never drop to the CPU.

* Importing every ``repro_torch`` module loads neither ``jax`` nor any
  ``repro`` module, and no source file of the port (nor
  ``chip_smoke.py``) imports them.
* Without a GPU, ``run_alg1``, ``run_alg2``, ``run_fedsgd``,
  ``run_fedavg``, ``run``, the kernel wrappers, the meshes, the serving
  and training launchers (``launch.serve.main``, ``launch.train.main``),
  ``Model.init_decode`` and ``ckpt.io.restore`` raise unless the caller
  passes ``device="cpu"`` (``--device cpu``).
* ``models/`` and ``ckpt/`` import nothing of ``launch/``.
* The cases modules the spawned mesh ranks import
  (``tests/torch_mesh_cases.py``, ``tests/torch_group_mesh_cases.py``)
  load neither.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data import partition, synthetic
from repro_torch.fed import aggregation, compression, runtime
from repro_torch.fed import sketch as fed_sketch
from repro_torch.fed.tasks import rwkv6_task, transformer_task
from repro_torch.kernels import build, compress, flash_attention, ops, \
    rwkv6_scan, secure_agg, sketch, ssca_update
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_the_port_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 35      # every module was imported


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b(?!_))",
    re.MULTILINE)


def test_sources_import_no_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    assert {"transformer.py", "attention.py", "layers.py", "tree.py",
            "flash_attention.py", "llama3_8b.py", "rwkv6.py",
            "rwkv6_scan.py", "constrained.py", "fedavg.py", "autodiff.py",
            "optimizers.py", "closed_form.py", "serve.py", "steps.py",
            "train.py", "io.py"} <= {f.name for f in files}
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, (f, hits)


_LAUNCH = re.compile(r"^\s*(from\s+repro_torch\.launch\b|from\s+repro_torch\s+"
                     r"import\s+[^\n]*\blaunch\b|import\s+repro_torch\."
                     r"launch\b)", re.MULTILINE)


def test_models_and_ckpt_import_nothing_of_launch():
    """The layers stay in order: ``models/`` and ``ckpt/`` read the
    mesh's placement through ``repro_torch.placement`` and the caller's
    ``layer_pspec_fn``, never from ``launch/``, which imports them; and
    importing them loads no ``launch`` module."""
    files = sorted((PKG / "models").glob("*.py")) \
        + sorted((PKG / "ckpt").glob("*.py")) + [PKG / "placement.py"]
    assert {"transformer.py", "sharded.py", "io.py"} \
        <= {f.name for f in files}
    for f in files:
        hits = _LAUNCH.findall(f.read_text())
        assert not hits, (f, hits)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.models.transformer, repro_torch.ckpt.io;"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.launch')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_alg1_refuses_the_cpu_by_default(no_gpu):
    data = synthetic.classification_dataset(40, 10, k=16, l=3)
    part = partition.iid(40, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_alg1(data, part, batch_size=5, rounds=1)
    # the same call runs when the CPU is asked for
    _, hist = runtime.run_alg1(data, part, batch_size=5, rounds=1,
                               hidden=4, device="cpu")
    assert hist.rounds == [1]


@pytest.mark.parametrize("entry", ["run_alg2", "run_fedsgd", "run_fedavg",
                                   "run"])
def test_paper_algorithms_refuse_the_cpu_by_default(no_gpu, entry):
    from repro_torch.core import fedavg, protocol
    from repro_torch.fed.tasks import LocalObjective, MLPTask
    data = synthetic.classification_dataset(40, 10, k=16, l=3)
    part = partition.iid(40, 2)
    if entry == "run":
        task = MLPTask(k=16, hidden=4, l=3)
        alg = protocol.FedAvg(LocalObjective(task, 0.0),
                              fedavg.SGDHyperParams(local_steps=2))

        def call(**kw):
            return runtime.run(task, alg, data, part, **kw)
    else:
        def call(**kw):
            return getattr(runtime, entry)(data, part, hidden=4, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(batch_size=5, rounds=1)
    before = secure_agg.masked_sum_2d.launches
    # the same call runs when the CPU is asked for, launching nothing
    _, hist = call(batch_size=5, rounds=1, aggregation=aggregation.secure(),
                   device="cpu")
    assert hist.rounds == [1] and len(hist.slack) == 1
    assert secure_agg.masked_sum_2d.launches == before


@pytest.mark.parametrize("comp", [compression.qsgd(8), compression.topk(0.1),
                                  fed_sketch.sketch(4, 64, keep=4)],
                         ids=["qsgd", "topk", "sketch"])
def test_compressed_run_alg1_refuses_the_cpu_by_default(no_gpu, comp):
    data = synthetic.classification_dataset(40, 10, k=16, l=3)
    part = partition.iid(40, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_alg1(data, part, batch_size=5, rounds=1, compressor=comp)
    before = (compress.compress_2d.launches, sketch.sketch_encode.launches)
    _, hist = runtime.run_alg1(data, part, batch_size=5, rounds=1, hidden=4,
                               compressor=comp, secure=True, device="cpu")
    assert hist.rounds == [1]
    assert (compress.compress_2d.launches,
            sketch.sketch_encode.launches) == before


def test_kernel_wrappers_refuse_the_cpu_by_default(no_gpu):
    x = torch.zeros(2, 128)
    sc = torch.tensor([0.5, 0.5, 0.1, 0.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssca_update.ssca_update_2d(x, x, x, x, sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        secure_agg.masked_sum_2d(x[None], 1, 2, scale_bits=20, num_clients=1)
    tree = {"w": torch.zeros(3, 5)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.ssca_update(tree, tree, tree, tree, rho=0.5, gamma=0.5, tau=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.secure_quant_sum({"w": torch.zeros(2, 5)},
                             np.zeros(2, np.uint32), scale_bits=20)
    su = torch.zeros(1, 3, dtype=torch.int64)
    sf = torch.ones(1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compress.compress_2d(x[None], su[:, :2], sf, lbound=127,
                             quantize=True, masked=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sketch.sketch_encode(x[None], su, rows=4, cols=64, scale_bits=20)
    counts = lambda: (ssca_update.ssca_update_2d.launches,  # noqa: E731
                      secure_agg.masked_sum_2d.launches,
                      compress.compress_2d.launches,
                      sketch.sketch_encode.launches)
    before = counts()
    ssca_update.ssca_update_2d(x, x, x, x, sc, device="cpu")
    secure_agg.masked_sum_2d(x[None], 1, 2, scale_bits=20, num_clients=1,
                             device="cpu")
    compress.compress_2d(x[None], su[:, :2], sf, lbound=127, quantize=True,
                         masked=True, device="cpu")
    sketch.sketch_encode(x[None], su, rows=4, cols=64, scale_bits=20,
                         device="cpu")
    # the plain versions launch nothing
    assert counts() == before


@pytest.mark.parametrize("num,offset,clients", [(3, 0, 2), (1, 10, 10),
                                                (4, 7, 10)])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_masked_sum_rows_must_fit_among_clients(no_gpu, num, offset,
                                                clients, device):
    # checked before the wrapper picks the kernel or the plain version, so
    # the kernel never reads alive[] past num_clients
    msgs = torch.zeros(num, 2, 128)
    alive = torch.ones(clients, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        secure_agg.masked_sum_2d(msgs, 1, 2, scale_bits=20,
                                 num_clients=clients, client_offset=offset,
                                 alive=alive, device=device)


def test_cpu_tensor_with_cuda_device_raises():
    x = torch.zeros(1, 128)
    with pytest.raises(ValueError, match="asked for"):
        ssca_update.ssca_update_2d(x, x, x, x, torch.zeros(4),
                                   device="cuda")
    su = torch.zeros(1, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="asked for"):
        compress.compress_2d(x[None], su[:, :2], torch.ones(1, 2), lbound=1,
                             quantize=True, masked=False, device="cuda")
    with pytest.raises(ValueError, match="asked for"):
        sketch.sketch_encode(x[None], su, rows=1, cols=1, scale_bits=20,
                             device="cuda")


def test_build_tag_hashes_headers_and_sources(tmp_path):
    # an edited header must rebuild the library, as an edited source does
    (tmp_path / "a.cu").write_text('#include "prf.cuh"\n')
    (tmp_path / "prf.cuh").write_text("// v1\n")
    tag = build._tag(tmp_path)
    assert build._tag(tmp_path) == tag
    (tmp_path / "prf.cuh").write_text("// v2\n")
    tag2 = build._tag(tmp_path)
    assert tag2 != tag
    (tmp_path / "a.cu").write_text('#include "prf.cuh"\n// edit\n')
    assert build._tag(tmp_path) not in (tag, tag2)
    assert build._sources(tmp_path) == [tmp_path / "a.cu"]
    # the package's own build reads every kernel source and the header
    names = {p.name for p in build.CSRC.iterdir()}
    assert {"ssca_update.cu", "secure_agg.cu", "compress.cu", "sketch.cu",
            "flash_attention.cu", "flash_attention_sm90.cu",
            "rwkv6_scan_sm90.cu", "prf.cuh"} <= names
    assert build.CSRC / "rwkv6_scan_sm90.cu" in build._sources()


def test_lm_entry_points_refuse_the_cpu_by_default(no_gpu):
    task = transformer_task(seq_len=8, d_model=32, vocab=32)
    data = task.default_data(n_train=8, n_test=4)
    part = partition.iid(8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_alg1(data, part, task=task, batch_size=2, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(task.cfg).init(torch.Generator())
    q = torch.zeros(1, 3, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention.flash_attention_bhsd(q, q, q)
    with pytest.raises(ValueError, match="asked for"):
        flash_attention.flash_attention_bhsd(q, q, q, device="cuda")
    before = flash_attention.flash_attention_bhsd.launches
    # the same calls run when the CPU is asked for; the model's attention
    # follows its tensors, which the caller placed on the CPU
    _, hist = runtime.run_alg1(data, part, task=task, batch_size=2, rounds=1,
                               secure=True, device="cpu")
    assert hist.rounds == [1]
    ops.flash_attention(q, q, q)
    assert flash_attention.flash_attention_bhsd.launches == before


def test_rwkv_entry_points_refuse_the_cpu_by_default(no_gpu):
    task = rwkv6_task(seq_len=8, d_model=32, vocab=32)
    data = task.default_data(n_train=8, n_test=4)
    part = partition.iid(8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_alg1(data, part, task=task, batch_size=2, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(task.cfg).init(torch.Generator())
    x = torch.zeros(1, 3, 2, 16)
    u = torch.zeros(2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rwkv6_scan.rwkv6_wkv_bh(x, x, x, x, u)
    with pytest.raises(ValueError, match="asked for"):
        rwkv6_scan.rwkv6_wkv_bh(x, x, x, x, u, device="cuda")
    before = rwkv6_scan.rwkv6_wkv_bh.launches
    # the same calls run when the CPU is asked for; the model's WKV scan
    # follows its tensors, which the caller placed on the CPU
    _, hist = runtime.run_alg1(data, part, task=task, batch_size=2, rounds=1,
                               secure=True, device="cpu")
    assert hist.rounds == [1]
    ops.rwkv6_wkv(x, x, x, x + 0.5, u)
    assert rwkv6_scan.rwkv6_wkv_bh.launches == before


def test_launch_subpackage_stands_alone():
    # the import walk above reaches the client mesh, the arena and the
    # snapshot ring, and their sources import neither jax nor the
    # reference
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    check = _CHECK + "\nassert 'repro_torch.launch.mesh' in names\n" \
        "assert 'repro_torch.fed.arena' in names\n" \
        "assert 'repro_torch.fed.staleness' in names\n" \
        "assert {'repro_torch.launch.serve', 'repro_torch.launch.steps', " \
        "'repro_torch.launch.train', 'repro_torch.ckpt.io'} <= set(names)\n"
    out = subprocess.run([sys.executable, "-c", check], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for f in (PKG / "launch" / "__init__.py", PKG / "launch" / "mesh.py",
              PKG / "fed" / "arena.py", PKG / "fed" / "staleness.py"):
        assert not _IMPORT.findall(f.read_text()), f


def test_make_client_mesh_refuses_the_cpu_by_default(no_gpu, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import make_client_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_client_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        make_client_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_client_mesh()
        mesh = make_client_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend, mesh.device) \
            == (0, 1, "gloo", torch.device("cpu"))
        # a run on the mesh follows the mesh's device, the CPU asked for
        data = synthetic.classification_dataset(40, 10, k=16, l=3)
        part = partition.iid(40, 2)
        p_m, h_m = runtime.run_alg1(data, part, batch_size=5, rounds=1,
                                    hidden=4, secure=True, mesh=mesh)
        p_n, h_n = runtime.run_alg1(data, part, batch_size=5, rounds=1,
                                    hidden=4, secure=True, device="cpu")
        assert h_m.metrics == h_n.metrics and mesh.psum_calls == 2
        for a, b in zip(p_m.values(), p_n.values()):
            assert a.device.type == "cpu" and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_runs_pipelined_rounds_through_psum(tmp_path):
    # on one rank the chunked ring is the psum: a pipelined secure run is
    # mesh=None's bit for bit, with the packed ring's rebuild, the weight
    # gather and the combine one psum each a round and no ring call
    import torch.distributed as dist
    from repro_torch.launch import make_client_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_client_mesh(device="cpu")
        data = synthetic.classification_dataset(40, 10, k=16, l=3)
        part = partition.iid(40, 2)
        kw = dict(batch_size=5, rounds=3, hidden=4, secure=True,
                  pipeline=True)
        p_m, h_m = runtime.run_alg1(data, part, mesh=mesh, **kw)
        p_n, h_n = runtime.run_alg1(data, part, device="cpu", **kw)
        assert h_m.metrics == h_n.metrics and h_m.comm == h_n.comm
        assert (mesh.psum_calls, mesh.ring_calls) == (3 * 3, 0)
        for a, b in zip(p_m.values(), p_n.values()):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


_CASES_CHECK = r"""
import sys
import torch_mesh_cases, torch_group_mesh_cases
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


def test_mesh_cases_modules_stand_alone():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", _CASES_CHECK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for name in ("torch_mesh_cases.py", "torch_group_mesh_cases.py"):
        assert not _IMPORT.findall((ROOT / "tests" / name).read_text())


def test_make_group_mesh_refuses_the_cpu_by_default(no_gpu, tmp_path):
    # a (1, 1) mesh on one gloo rank: each axis a subgroup of one, the
    # tree's run mesh=None's bit for bit with one psum a round on each
    # of the three (the weight gather, the group sums, the root)
    import torch.distributed as dist
    from repro_torch.launch import make_group_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_group_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        make_group_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_group_mesh(1, 1)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_group_mesh(2, 1, device="cpu")
        mesh = make_group_mesh(device="cpu")
        assert (mesh.shape, mesh.coords, mesh.size, mesh.backend,
                mesh.device) == ((1, 1), (0, 0), 1, "gloo",
                                 torch.device("cpu"))
        data = synthetic.classification_dataset(40, 10, k=16, l=3)
        part = partition.iid(40, 4)
        kw = dict(batch_size=5, rounds=3, hidden=4,
                  aggregation=aggregation.hierarchical(groups=2))
        p_m, h_m = runtime.run_alg1(data, part, mesh=mesh, **kw)
        p_n, h_n = runtime.run_alg1(data, part, device="cpu", **kw)
        assert h_m.metrics == h_n.metrics and h_m.comm == h_n.comm
        assert [a.psum_calls for a in mesh.axes()] == [3, 3, 3]
        assert mesh.psum_calls == 9 and mesh.ring_calls == 0
        for a, b in zip(p_m.values(), p_n.values()):
            assert a.device.type == "cpu" and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_launch_entry_points_refuse_the_cpu_by_default(no_gpu, tmp_path,
                                                       capsys):
    # serve.main, train.main and Model.init_decode raise without a card
    # unless the CPU is asked for; then they run there
    from repro_torch.ckpt import io as ckpt_io
    from repro_torch.launch import serve, train
    small = ["--arch", "llama3-8b", "--requests", "1", "--batch", "1",
             "--prompt-len", "2", "--max-new", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(small + ["--device", "cuda"])
    steps = ["--arch", "rwkv6-7b", "--steps", "1", "--batch", "2", "--seq",
             "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(steps)
    model = build_model(transformer_task(seq_len=8, d_model=32,
                                         vocab=32).cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_decode(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt_io.restore(tmp_path)
    launches = flash_attention.flash_attention_bhsd.launches
    (gen, _, _), = serve.main(small + ["--device", "cpu"])
    assert gen.shape == (1, 2)
    params, losses = train.main(steps + ["--device", "cpu"])
    assert len(losses) == 1 and params["embed"].device.type == "cpu"
    state = model.init_decode(1, 4, device="cpu")
    assert state.kv_k.device.type == "cpu" and state.length.dtype \
        == torch.int32
    assert flash_attention.flash_attention_bhsd.launches == launches
    assert "device=cpu" in capsys.readouterr().out
