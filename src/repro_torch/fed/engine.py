"""The synchronous single-device federated driver.

The port of ``repro/fed/engine.py``'s round body for one device, without
scan, mesh, cohorts, async rounds or pipelining.  Per run:

1. the mini-batch schedule is drawn up front on the host
   (:func:`build_schedule`, the reference's draw: (T, I, B) for
   sum-combine algorithms, (T, I, E, B) for mean-combine ones) and staged
   on the device once, with the training arrays;
2. each round, a Python loop step, gathers the clients' batches on the
   device and forms the aggregate:

   * sum-combine (Algorithms 1 and 2, FedSGD), linear aggregation
     (plain), no compressor: one upload on the weighted super-batch —
     the upload is additive in the batch, so no per-client message is
     materialized;
   * otherwise per-client uploads under ``torch.func.vmap``: sum-combine
     ones with each client's λ_i folded into its per-sample weights,
     mean-combine ones (FedAvg's E local steps) weighted by λ_i = N_i/N
     after the upload; compressed when a compressor is set (qsgd, top-k,
     or the count-sketch's two phases, :func:`_sketched_round`, with the
     error-feedback residuals of a population-resident (I, …) arena; a
     mean-combine message is compressed as its delta from the model),
     then the strategy's combine — for secure aggregation quantize, mask
     and sum in one kernel launch;

   then ``server_step`` (the fused SSCA kernel when ``fused=True``);
3. eval probes and the algorithm's round metrics (Algorithm 2's slack)
   at every ``eval_every``-th round return device scalars that are read
   back once, after the loop, so no round waits on the host.

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


_MLP_METRICS = ("train_cost", "test_accuracy", "sparsity")


@dataclasses.dataclass
class History:
    """Per-eval-point metrics plus the communication ledger.

    ``metrics`` maps each task-declared metric name to its series, aligned
    with ``rounds``; ``slack`` is the algorithm's slack s^t at each eval
    point (Algorithm 2; 0.0 for algorithms without one).
    ``uplink_bytes_per_round`` / ``downlink_bytes_per_round`` are the
    exact wire bytes of one round (see
    :func:`repro_torch.fed.compression.round_bytes`, breakdown in
    ``comm``); ``cum_uplink_bytes`` is the cumulative uplink at each eval
    point.  ``wall_seconds`` is the host time of the round loop, ending
    after the device has finished.
    """
    rounds: List[int] = dataclasses.field(default_factory=list)
    metrics: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    slack: List[float] = dataclasses.field(default_factory=list)
    cum_uplink_bytes: List[int] = dataclasses.field(default_factory=list)
    uplink_bytes_per_round: int = 0
    downlink_bytes_per_round: int = 0
    comm: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0

    def metric(self, name: str) -> List[float]:
        """The (live, appendable) series for ``name``; inserts the series
        if absent."""
        return self.metrics.setdefault(name, [])

    @property
    def train_cost(self) -> List[float]:
        return self.metrics.get("train_cost", [])

    @property
    def test_accuracy(self) -> List[float]:
        return self.metrics.get("test_accuracy", [])

    @property
    def sparsity(self) -> List[float]:
        return self.metrics.get("sparsity", [])

    def as_dict(self) -> Dict[str, Any]:
        d = {"rounds": list(self.rounds),
             "metrics": {k: list(v) for k, v in self.metrics.items()},
             "slack": list(self.slack),
             "cum_uplink_bytes": list(self.cum_uplink_bytes),
             "uplink_bytes_per_round": self.uplink_bytes_per_round,
             "downlink_bytes_per_round": self.downlink_bytes_per_round,
             "comm": dict(self.comm),
             "wall_seconds": self.wall_seconds}
        # the MLP's metrics also as flat keys, as the reference writes them
        for k in _MLP_METRICS:
            d[k] = list(self.metrics.get(k, []))
        return d


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


def _round_ids(rounds: int, local_steps: int, e_axis: bool) -> np.ndarray:
    """The per-(round, local-step) sampling ids: t for the one-shot
    (sum-combine) algorithms, t·1000 + e for the local-step (mean-combine)
    ones, E = 1 included, as the reference draws them."""
    ts = np.arange(1, rounds + 1, dtype=np.int64)
    if not e_axis:
        return ts
    return (ts[:, None] * 1000 + np.arange(local_steps)).reshape(-1)


def build_schedule(part: Partition, batch_size: int, rounds: int,
                   local_steps: int, seed: int,
                   e_axis: bool = False) -> np.ndarray:
    """Per-round batches at full participation, drawn exactly as the
    reference's ``build_schedule`` draws them (its cohort is the identity
    when every client uploads): (T, I, B) for sum-combine algorithms, or
    (T, I, E, B) when ``e_axis`` (mean-combine local-step algorithms, the
    E axis kept even at E = 1; each local step drawn under its own id
    t·1000 + e)."""
    ids = _round_ids(rounds, local_steps, e_axis)
    idx = sample_schedule(part, batch_size, ids, seed)       # (T·E, I, B)
    if e_axis:
        idx = idx.reshape(rounds, local_steps, part.num_clients,
                          batch_size).transpose(0, 2, 1, 3)
    return idx


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
    keeps its error-feedback residuals, shaped like one client's message,
    in an (I, …) arena on ``device``.  Returns the final parameters (on
    ``device``) and the :class:`History`.
    """
    dev = resolve_device(device)
    aggregation = aggregation if aggregation is not None \
        else PlainAggregation()
    combine = algorithm.combine
    compressor = _check_compressor(compressor, aggregation)
    num_clients = part.num_clients
    if params is None:
        params = task.init_params(torch.Generator().manual_seed(seed))
    params = tree.map(lambda v: v.detach().to(dev, torch.float32, copy=True),
                      params)
    schedule = build_schedule(part, batch_size, rounds,
                              algorithm.local_steps, seed,
                              e_axis=combine == "mean")
    schedule = torch.as_tensor(schedule, device=dev)
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
        # full participation: every client, by its global id, every round
        cids = torch.arange(num_clients, device=dev)
        # the per-(round, client) stream seeds, from the round key's
        # first and last words, staged once
        seeds = torch.as_tensor(np.asarray(
            [[client_stream_seed(int(kw[0]), int(kw[-1]), c)
              for c in range(num_clients)] for kw in keyw], np.int64),
            device=dev).reshape(rounds, num_clients)
    hist = History(uplink_bytes_per_round=ledger.uplink_total,
                   downlink_bytes_per_round=ledger.downlink_total,
                   comm=ledger.as_dict())

    def upload(batch):
        return algorithm.client_upload(params, state, batch)

    def weighted(msgs):
        """λ_i · m_i for each client's leaf row."""
        return tree.map(lambda m: m * weights.reshape(
            (-1,) + (1,) * (m.ndim - 1)), msgs)

    def aggregate(t):
        """Round t's aggregate.  The (I, …) per-client uploads are locals
        here, so they are freed before the server step."""
        nonlocal arena
        idx_t = schedule[t]                          # (I, B) or (I, E, B)
        if combine == "sum":
            if compressor is None and not aggregation.needs_messages:
                # linear fast path: one upload on the weighted super-batch
                flat = idx_t.reshape(-1)
                return upload((x_train[flat], y_train[flat],
                               weights.repeat_interleave(idx_t.shape[1])))
            ws = weights[:, None].expand(idx_t.shape)        # λ_i per sample
            raw = vmap(upload)((x_train[idx_t], y_train[idx_t], ws))
        else:                                                # mean: models
            models = vmap(upload)((x_train[idx_t], y_train[idx_t]))
            raw = models if compressor is None else \
                tree.map(lambda m, p: m - p, models, params)
        if compressor is None:
            msgs = raw if combine == "sum" else weighted(raw)
            return aggregation.combine_messages(msgs, keyw[t], device=dev)
        if compressor.stateful and arena is None:
            arena = compressor.init_client_state(
                tree.map(lambda v: v[0], raw), num_clients)
        resid = None if arena is None else tree.map(lambda a: a[cids], arena)
        if getattr(compressor, "sketched", False):
            # λ_i is applied before the encode (the bucket values must
            # stay on the fixed-point grid); a sum-combine message carries
            # it already
            msgs = raw if combine == "sum" else weighted(raw)
            agg, new_resid = _sketched_round(compressor, aggregation, msgs,
                                             resid, seeds[t], keyw[t], dev)
            if combine == "mean":
                agg = tree.map(lambda p, d: p + d, params, agg)
        else:
            comp, new_resid = compressor.compress(raw, resid, seeds[t],
                                                  device=dev)
            msgs = comp if combine == "sum" else weighted(
                tree.map(lambda d, p: p + d, comp, params))
            agg = aggregation.combine_messages(msgs, keyw[t], device=dev)
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
            slack = algorithm.round_metrics(state).get("slack")
            if slack is None:       # a fill, not a copy the host waits on
                slack = torch.zeros((), device=dev)
            evals.append((t + 1, measure(params), slack))
    names = list(evals[0][1]) if evals else []
    values = torch.stack([torch.stack([*(v[k].float() for k in names),
                                       s.float()])
                          for _, v, s in evals]).cpu().tolist() \
        if evals else []
    hist.wall_seconds = time.perf_counter() - t0
    for (t_pt, _, _), row in zip(evals, values):
        hist.rounds.append(t_pt)
        for k, v in zip(names, row):
            hist.metric(k).append(v)
        hist.slack.append(row[-1])
        hist.cum_uplink_bytes.append(t_pt * hist.uplink_bytes_per_round)
    return params, hist
