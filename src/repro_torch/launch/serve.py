"""Serving launcher: ``python -m repro_torch.launch.serve --arch ID``.

The port of ``repro/launch/serve.py``: batched prefill and greedy decode
against the model API (``Model.init_decode`` / ``Model.decode_step``).
Reduced configurations by default; ``--full`` takes the published one.
Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card otherwise.

Request model: a queue of (prompt, max_new_tokens) served in batches of
a fixed size (the tail batch padded with its last request), greedy
sampling over the true vocabulary; each batch's prefill and decode time,
and the aggregate tokens/s, are printed.  The audio family (whisper)
decodes against stub frame embeddings, (batch, encoder_seq, D) drawn
once from a generator seeded 2 (the reference draws them with
``jax.random``, which the port does not reproduce), run through the
encoder once a batch (``Model.precompute_cross``); the vlm family serves
text alone, as the reference's does.
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import reduced
from repro_torch.models import build_model


class Request(NamedTuple):
    prompt: np.ndarray        # (L,) int32
    max_new: int


def synth_requests(n: int, cfg, prompt_len: int, max_new: int,
                   seed: int = 0) -> List[Request]:
    """``n`` prompts of uniform token ids, the reference's numpy draws."""
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size,
                                 size=prompt_len).astype(np.int32), max_new)
            for _ in range(n)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(model, params, requests: List[Request], *, window: int = 0,
                frame_embeds=None, record: Optional[list] = None):
    """Serve one batch: a cache-filling prefill, token by token through
    ``decode_step`` (prompts right-padded with 0 to the longest), then
    ``max(max_new)`` greedy steps over ``logits[..., :vocab_size]``.
    Returns (generated (B, max_new) int32, prefill seconds, decode
    seconds), each phase timed on the host clock ending in a device sync.

    Runs on the device of ``params``.  ``record``, a list, receives every
    step's (B, 1, padded_vocab) f32 logits, prefill steps first.
    ``window`` is unused, as in the reference (the model's
    ``decode_window`` sets the ring buffer).  ``frame_embeds`` (B, S_enc,
    D), for the audio family, go through the encoder once
    (``Model.precompute_cross``) before the prefill's clock starts, as in
    the reference; without them an audio model decodes against zero
    cross-attention K and V, as the reference's does."""
    del window
    cfg = model.cfg
    device = params["embed"].device
    b = len(requests)
    prompt_len = max(len(r.prompt) for r in requests)
    max_new = max(r.max_new for r in requests)
    state = model.init_decode(b, prompt_len + max_new, device=device)
    if cfg.family == "audio" and frame_embeds is not None:
        state = model.precompute_cross(
            params, {"frame_embeds": torch.as_tensor(frame_embeds,
                                                     device=device)}, state)
    prompts = torch.as_tensor(np.stack([
        np.pad(r.prompt, (0, prompt_len - len(r.prompt)))
        for r in requests]), device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):                      # cache-filling prefill
        logits, state = model.decode_step(params, state,
                                          prompts[:, t:t + 1])
        if record is not None:
            record.append(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = torch.argmax(logits[:, :, :cfg.vocab_size], -1)
    t0 = time.perf_counter()
    for _ in range(max_new):
        out.append(tok)
        logits, state = model.decode_step(params, state, tok)
        if record is not None:
            record.append(logits)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], -1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    return gen, t_prefill, t_decode


def main(argv: Optional[List[str]] = None):
    """The command line; returns each batch's (generated, prefill s,
    decode s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device == "cuda" else args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg, decode_window=args.window)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    reqs = synth_requests(args.requests, cfg, args.prompt_len, args.max_new)
    frames = None
    if cfg.family == "audio":
        frames = torch.randn(args.batch, cfg.encoder_seq, cfg.d_model,
                             generator=torch.Generator(
                                 device=dev).manual_seed(2), device=dev)

    results = []
    done = 0
    tput_tokens = 0
    t_all = time.perf_counter()
    while done < len(reqs):
        batch = reqs[done:done + args.batch]
        if len(batch) < args.batch:   # pad the tail batch
            batch = batch + [batch[-1]] * (args.batch - len(batch))
        gen, tp, td = serve_batch(model, params, batch, window=args.window,
                                  frame_embeds=frames)
        results.append((gen, tp, td))
        done += args.batch
        tput_tokens += gen.size
        print(f"batch done: prefill {tp:.2f}s decode {td:.2f}s "
              f"({gen.shape[1] * gen.shape[0] / max(td, 1e-9):.1f} tok/s)")
    dt = time.perf_counter() - t_all
    print(f"served {min(done, len(reqs))} requests in {dt:.1f}s "
          f"({tput_tokens / dt:.1f} generated tok/s incl. prefill) on {dev}")
    return results


if __name__ == "__main__":
    main()
