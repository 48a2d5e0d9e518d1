"""The synchronous single-device federated driver.

The port of ``repro/fed/engine.py``'s round body for one device, without
scan, mesh, async rounds or pipelining.  Per run:

1. the mini-batch schedule (T, I, B) is drawn up front on the host
   (:func:`build_schedule`, the reference's draw) and staged on the
   device once, with the training arrays;
2. each round, a Python loop step, gathers the clients' batches on the
   device and forms the aggregate:

   * linear aggregation (plain), no compressor: one gradient on the
     weighted super-batch — the upload is additive in the batch, so no
     per-client message is materialized;
   * otherwise per-client gradients under ``torch.func.vmap`` (each
     client's λ_i folded into its per-sample weights), compressed when a
     compressor is set (:func:`_compressed_round`, :func:`_sketched_round`,
     with the error-feedback residuals of a population-resident (I, …)
     arena), then the strategy's combine — for secure aggregation
     quantize, mask and sum in one kernel launch;

   then ``server_step`` (the fused SSCA kernel when ``fused=True``);
3. eval probes at every ``eval_every``-th round return device scalars
   that are read back once, after the loop, so no round waits on the
   host.

The exact wire bytes of every round are recorded in the ledger.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.func import vmap

from repro_torch import Device, resolve_device, tree
from repro_torch.data.partition import Partition, sample_schedule
from repro_torch.fed import compression as compression_mod
from repro_torch.fed.aggregation import PlainAggregation
from repro_torch.fed.keys import phase2_key, round_keys
from repro_torch.kernels.compress import client_stream_seed


@dataclasses.dataclass
class History:
    """Per-eval-point metrics plus the communication ledger.

    ``metrics`` maps each task-declared metric name to its series, aligned
    with ``rounds``.  ``uplink_bytes_per_round`` / ``downlink_bytes_per_
    round`` are the exact wire bytes of one round (see
    :func:`repro_torch.fed.compression.round_bytes`, breakdown in
    ``comm``); ``cum_uplink_bytes`` is the cumulative uplink at each eval
    point.  ``wall_seconds`` is the host time of the round loop, ending
    after the device has finished.
    """
    rounds: List[int] = dataclasses.field(default_factory=list)
    metrics: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    cum_uplink_bytes: List[int] = dataclasses.field(default_factory=list)
    uplink_bytes_per_round: int = 0
    downlink_bytes_per_round: int = 0
    comm: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0

    @property
    def train_cost(self) -> List[float]:
        return self.metrics.get("train_cost", [])

    @property
    def test_accuracy(self) -> List[float]:
        return self.metrics.get("test_accuracy", [])

    @property
    def sparsity(self) -> List[float]:
        return self.metrics.get("sparsity", [])


def evaluator(task, data, eval_samples: int, device: torch.device,
              seed: int = 123):
    """The task's metric probe on a fixed eval subset (the reference's
    rng(123) draw of ``eval_samples`` training rows, and the whole test
    set), staged on ``device``.  Returns ``measure(params) -> {name: 0-d
    tensor}``."""
    rng = np.random.default_rng(seed)
    tr = rng.choice(len(data.x_train), size=min(eval_samples,
                                                len(data.x_train)),
                    replace=False)
    arrays = [torch.as_tensor(a, device=device) for a in
              (data.x_train[tr], data.y_train[tr], data.x_test, data.y_test)]

    @torch.no_grad()
    def measure(params):
        return task.measure(params, *arrays)
    return measure


def build_schedule(part: Partition, batch_size: int, rounds: int,
                   seed: int) -> np.ndarray:
    """Per-round batches (T, I, B) at full participation, drawn exactly as
    the reference's ``build_schedule`` draws them for sum-combine
    algorithms (its cohort is the identity when every client uploads)."""
    ids = np.arange(1, rounds + 1, dtype=np.int64)
    return sample_schedule(part, batch_size, ids, seed)


def _check_compressor(compressor, aggregation):
    """``None`` for no compressor or the identity (the same trajectory as
    none); refuses what is not a compressor, and a grid-emitting
    compressor whose fixed-point grid differs from the aggregation's (the
    masked sum of its values would no longer be exact)."""
    if compressor is None:
        return None
    if not hasattr(compressor, "is_identity") \
            or not hasattr(compressor, "payload_bytes"):
        raise TypeError(f"compressor={compressor!r} is not a compressor "
                        "(see repro_torch.fed.compression and .sketch)")
    if compressor.is_identity:
        return None
    comp_grid = getattr(compressor, "scale_bits", None)
    agg_grid = getattr(aggregation, "scale_bits", None)
    if comp_grid is not None and agg_grid is not None \
            and int(comp_grid) != int(agg_grid):
        raise ValueError(
            f"compressor scale_bits={int(comp_grid)} != aggregation "
            f"scale_bits={int(agg_grid)}: the compressor emits values on "
            "the 2^-scale_bits fixed-point grid and the secure masked sum "
            "is only exact when the grids match")
    return compressor


def _compressed_round(compressor, aggregation, msgs, resid, seeds,
                      key_words, dev):
    """qsgd / top-k: compress every client's message (one kernel launch
    per call), then combine.  Returns (aggregate, new residuals)."""
    comp, new_resid = compressor.compress(msgs, resid, seeds, device=dev)
    return aggregation.combine_messages(comp, key_words, device=dev), \
        new_resid


def _sketched_round(compressor, aggregation, msgs, resid, seeds,
                    key_words, dev):
    """The count-sketch's two phases (the reference's sketched branch):
    sketch every client's message plus residual, combine the sketches
    under the round key, take the support from the aggregate, combine the
    clients' on-grid values at the support under ``fold_in(round key,
    0x5EED)``, and debit each client's residual by its own values.
    Returns (the k-sparse update, new residuals)."""
    inp = tree.map(lambda m, r: m.float() + r, msgs, resid)
    like = tree.map(lambda v: v[0], inp)
    sk = compressor.encode(inp, seeds, device=dev)
    support = compressor.support(
        aggregation.combine_messages(sk, key_words, device=dev), like)
    vals = compressor.values(inp, support, seeds)
    agg_v = aggregation.combine_messages(vals, phase2_key(key_words),
                                         device=dev)
    return compressor.reassemble(agg_v, support, like), \
        compressor.update_residual(inp, support, vals)


@contextlib.contextmanager
def _full_f32_matmuls():
    """Matrix products in full f32 inside the block, as the reference's
    are (TF32 would keep about three decimal digits); the caller's
    setting is restored after it, as the reference changes no global
    setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@_full_f32_matmuls()
def run(algorithm, data, part: Partition, *, task, batch_size: int,
        rounds: int, params=None, seed: int = 0, eval_every: int = 1,
        eval_samples: int = 10000, aggregation=None, compressor=None,
        device: Device = None) -> tuple:
    """Run ``algorithm`` on ``task`` for ``rounds`` rounds on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``params=None`` initializes from ``task.init_params`` with a CPU
    generator seeded by ``seed``.  ``seed`` also keys the batch schedule
    and the per-round aggregation key words.  ``compressor`` (qsgd, top-k
    or the count-sketch) compresses every client's upload; a stateful one
    keeps its error-feedback residuals in an (I, …) arena on ``device``.
    Returns the final parameters (on ``device``) and the
    :class:`History`.
    """
    dev = resolve_device(device)
    aggregation = aggregation if aggregation is not None \
        else PlainAggregation()
    if algorithm.combine != "sum":
        raise NotImplementedError(
            "only sum-combine algorithms are ported to repro_torch yet")
    compressor = _check_compressor(compressor, aggregation)
    num_clients = part.num_clients
    if params is None:
        params = task.init_params(torch.Generator().manual_seed(seed))
    params = tree.map(lambda v: v.detach().to(dev, torch.float32, copy=True),
                      params)
    schedule = torch.as_tensor(build_schedule(part, batch_size, rounds, seed),
                               device=dev)
    x_train = torch.as_tensor(data.x_train, device=dev)
    y_train = torch.as_tensor(data.y_train, device=dev)
    weights = torch.as_tensor(algorithm.client_weights(part, batch_size),
                              device=dev)
    keyw = round_keys(seed, rounds)
    state = algorithm.init_state(params)
    measure = evaluator(task, data, eval_samples, dev)
    ledger = compression_mod.round_bytes(algorithm, aggregation, compressor,
                                         params, num_clients)
    arena = None
    if compressor is not None:
        if compressor.stateful:
            arena = compressor.init_client_state(params, num_clients)
        # full participation: every client, by its global id, every round
        cids = torch.arange(num_clients, device=dev)
        # the per-(round, client) stream seeds, from the round key's
        # first and last words, staged once
        seeds = torch.as_tensor(np.asarray(
            [[client_stream_seed(int(kw[0]), int(kw[-1]), c)
              for c in range(num_clients)] for kw in keyw], np.int64),
            device=dev).reshape(rounds, num_clients)
        round_fn = _sketched_round if getattr(compressor, "sketched", False) \
            else _compressed_round
    hist = History(uplink_bytes_per_round=ledger.uplink_total,
                   downlink_bytes_per_round=ledger.downlink_total,
                   comm=ledger.as_dict())

    def upload(batch):
        return algorithm.client_upload(params, state, batch)

    def aggregate(t):
        """Round t's aggregate.  The (I, …) per-client uploads are locals
        here, so they are freed before the server step."""
        idx_t = schedule[t]                                  # (I, B)
        if compressor is None and not aggregation.needs_messages:
            # linear fast path: one upload on the weighted super-batch
            flat = idx_t.reshape(-1)
            return upload((x_train[flat], y_train[flat],
                           weights.repeat_interleave(idx_t.shape[1])))
        ws = weights[:, None].expand(idx_t.shape)            # λ_i per sample
        msgs = vmap(upload)((x_train[idx_t], y_train[idx_t], ws))
        if compressor is None:
            return aggregation.combine_messages(msgs, keyw[t], device=dev)
        resid = None if arena is None else tree.map(lambda a: a[cids], arena)
        agg, new_resid = round_fn(compressor, aggregation, msgs, resid,
                                  seeds[t], keyw[t], dev)
        if arena is not None:
            for a, r in zip(tree.leaves(arena), tree.leaves(new_resid)):
                a[cids] = r
        return agg

    evals = []
    t0 = time.perf_counter()
    for t in range(rounds):
        params, state = algorithm.server_step(params, state, aggregate(t),
                                              device=dev)
        if (t + 1) % eval_every == 0 or t + 1 == rounds:
            evals.append((t + 1, measure(params)))
    names = list(evals[0][1]) if evals else []
    values = torch.stack([torch.stack([v[k].float() for k in names])
                          for _, v in evals]).cpu().tolist() if evals else []
    hist.wall_seconds = time.perf_counter() - t0
    for (t_pt, _), row in zip(evals, values):
        hist.rounds.append(t_pt)
        for k, v in zip(names, row):
            hist.metrics.setdefault(k, []).append(v)
        hist.cum_uplink_bytes.append(t_pt * hist.uplink_bytes_per_round)
    return params, hist
