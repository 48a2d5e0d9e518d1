"""Training launcher: ``python -m repro_torch.launch.train --arch ID``.

The port of ``repro/launch/train.py``: trains an architecture of a
family the port builds (reduced by default; ``--full`` takes the
published configuration) with the paper's mini-batch SSCA as the server
optimizer (``launch.steps.make_train_step``: the fused update, its
``lambda0`` kernel on the card), or ``--optimizer fedsgd`` for the
first-order baseline, with checkpoint save and restore
(:mod:`repro_torch.ckpt.io`).  Runs on ``cuda`` unless ``--device cpu``
is given, and raises without a card otherwise.

Resume: the reference's checkpoint holds the parameters only, and a
restored run starts a fresh SSCA state and its batch stream from the
top.  The port's also holds the optimizer state (SSCA's ``lin``, its
step in the manifest), and the restored run draws past the batches the
steps before it took, so that a resumed run is the uninterrupted one bit
for bit.  The reference reads the port's checkpoint (it takes
``params``), and the port reads the reference's (a fresh state then).
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device, tree
from repro_torch.ckpt import io as ckpt_io
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch.core.schedules import PowerLaw
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.models import build_model


def min_seq(cfg) -> int:
    """The least ``--seq`` of ``cfg``: its image tokens (the vlm's; none
    for the other families) and two text tokens, one next-token
    target."""
    return cfg.num_image_tokens + 2


def batch_stream(cfg, batch: int, seq: int, seed: int = 0,
                 device: Device = None):
    """An endless stream of ``{"tokens": (batch, seq) int32}`` on
    ``device``: rows of the reference's synthetic token dataset, drawn
    with its numpy generator, so both sides see the same batches.  The
    ``vlm`` family's rows are cut to the ``seq − num_image_tokens`` text
    tokens beside ``"img_embeds"`` (batch, num_image_tokens, D), and the
    ``audio`` family's come with ``"frame_embeds"`` (batch, encoder_seq,
    D): f32 N(0, 1) stub embeddings, drawn from a generator on ``device``
    seeded with ``seed`` (the reference draws them with ``jax.random``,
    which the port does not reproduce).  A ``seq`` below :func:`min_seq`
    raises ``ValueError`` here, before any step: the vlm's text would be
    empty (the reference computes a NaN loss and stops at its first
    logged step)."""
    if seq < min_seq(cfg):
        raise ValueError(
            f"batch_stream: seq {seq} leaves {cfg.name} no next-token "
            f"target beside its {cfg.num_image_tokens} image tokens: seq "
            f"must be at least {min_seq(cfg)}")
    dev = resolve_device(device)
    docs = synthetic.token_dataset(max(64, 4 * batch), seq, cfg.vocab_size,
                                   seed=seed)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def stub(rows):
        return torch.randn(batch, rows, cfg.d_model, generator=gen,
                           device=dev)

    def stream():
        while True:
            idx = rng.integers(0, docs.shape[0], size=batch)
            out = {"tokens": torch.as_tensor(docs[idx], device=dev)}
            if cfg.family == "vlm":
                out["tokens"] = out["tokens"][:, :seq - cfg.num_image_tokens]
                out["img_embeds"] = stub(cfg.num_image_tokens)
            if cfg.family == "audio":
                out["frame_embeds"] = stub(cfg.encoder_seq)
            yield out
    return stream()


def _restore(ckpt_dir, params, device):
    """(params, SSCA lin or None, start step) from the latest checkpoint
    under ``ckpt_dir``, each leaf cast to the dtype of ``params``'; None
    without one."""
    try:
        path = ckpt_io.latest(ckpt_dir)
    except FileNotFoundError:
        return None
    restored, meta = ckpt_io.restore(path, device=device)

    def like(tree_):
        return tree.map(lambda a, b: b.to(a.dtype), params, tree_)

    lin = restored.get("ssca_lin")
    print(f"restored {path} (step {meta['step']})")
    return (like(restored["params"]), None if lin is None else like(lin),
            meta["step"])


def main(argv: Optional[List[str]] = None):
    """The command line; returns (params, the losses of the steps run)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--optimizer", choices=("ssca", "fedsgd"),
                    default="ssca")
    ap.add_argument("--tau", type=float, default=2.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device == "cuda" else args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg)
    # before the weights: a vlm --seq too short for its image tokens
    # raises here
    stream = batch_stream(cfg, args.batch, args.seq, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    print(f"arch={cfg.name} params={tree.numel(params) / 1e6:.2f}M "
          f"optimizer={args.optimizer} device={dev}")

    start, lin = 0, None
    if args.ckpt_dir and Path(args.ckpt_dir).exists():
        got = _restore(args.ckpt_dir, params, dev)
        if got is not None:
            params, lin, start = got

    if args.optimizer == "ssca":
        hp = ssca.SSCAHyperParams(tau=args.tau, rho=PowerLaw(0.9, 0.3),
                                  gamma=PowerLaw(0.9, 0.35))
        step_fn = steps.make_train_step(model, hp)
        state = ssca.init(params, with_beta=False)
        if lin is not None:
            state = state._replace(step=start + 1, lin=lin)
    else:
        step_fn = steps.make_sgd_train_step(model, PowerLaw(0.1, 0.5))
        state = torch.tensor(start + 1, dtype=torch.int32, device=dev)

    for _ in range(start):            # the batches the earlier steps took
        next(stream)
    losses = []
    t0 = time.perf_counter()
    for t in range(start + 1, start + args.steps + 1):
        params, state, metrics = step_fn(params, state, next(stream))
        losses.append(metrics["loss"])
        if t % args.log_every == 0 or t == start + 1:
            loss = float(metrics["loss"])
            extra = ""
            if "kkt_residual" in metrics:
                extra = f" kkt={float(metrics['kkt_residual']):.3f}"
            print(f"step {t}: loss={loss:.4f}{extra} "
                  f"({(time.perf_counter() - t0) / max(t - start, 1):.2f}"
                  "s/step)")
            if not math.isfinite(loss):
                raise RuntimeError("loss diverged")
        if args.ckpt_dir and args.ckpt_every and t % args.ckpt_every == 0:
            ckpt = {"params": params}
            if args.optimizer == "ssca":
                ckpt["ssca_lin"] = state.lin
            ckpt_io.save(Path(args.ckpt_dir) / f"step_{t}", ckpt, step=t)
            print(f"saved checkpoint step_{t}")
    print("done")
    return params, [float(x) for x in losses]


if __name__ == "__main__":
    main()
