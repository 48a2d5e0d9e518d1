"""The synchronous single-device federated driver.

The port of ``repro/fed/engine.py``'s round body for one device, without
scan, mesh, async rounds, compressors or pipelining.  Per run:

1. the mini-batch schedule (T, I, B) is drawn up front on the host
   (:func:`build_schedule`, the reference's draw) and staged on the
   device once, with the training arrays;
2. each round, a Python loop step, gathers the clients' batches on the
   device and forms the aggregate:

   * linear aggregation (plain): one gradient on the weighted
     super-batch — the upload is additive in the batch, so no per-client
     message is materialized;
   * secure aggregation: per-client gradients under ``torch.func.vmap``
     (each client's λ_i folded into its per-sample weights), then the
     strategy's combine — quantize, mask and sum in one kernel launch;

   then ``server_step`` (the fused SSCA kernel when ``fused=True``);
3. eval probes at every ``eval_every``-th round return device scalars
   that are read back once, after the loop, so no round waits on the
   host.

The exact wire bytes of every round are recorded in the ledger.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.func import vmap

from repro_torch import Device, resolve_device
from repro_torch.data.partition import Partition, sample_schedule
from repro_torch.fed import compression as compression_mod
from repro_torch.fed.aggregation import PlainAggregation
from repro_torch.fed.keys import round_keys


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


def run(algorithm, data, part: Partition, *, task, batch_size: int,
        rounds: int, params=None, seed: int = 0, eval_every: int = 1,
        eval_samples: int = 10000, aggregation=None,
        device: Device = None) -> tuple:
    """Run ``algorithm`` on ``task`` for ``rounds`` rounds on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``params=None`` initializes from ``task.init_params`` with a CPU
    generator seeded by ``seed``.  ``seed`` also keys the batch schedule
    and the per-round aggregation key words.  Returns the
    final parameters (on ``device``) and the :class:`History`.
    """
    dev = resolve_device(device)
    # the MLP's matrix products run in full f32, as the reference's do;
    # TF32 would keep about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    aggregation = aggregation if aggregation is not None \
        else PlainAggregation()
    if algorithm.combine != "sum":
        raise NotImplementedError(
            "only sum-combine algorithms are ported to repro_torch yet")
    num_clients = part.num_clients
    if params is None:
        params = task.init_params(torch.Generator().manual_seed(seed))
    params = {k: v.detach().to(dev, torch.float32, copy=True)
              for k, v in params.items()}
    schedule = torch.as_tensor(build_schedule(part, batch_size, rounds, seed),
                               device=dev)
    x_train = torch.as_tensor(data.x_train, device=dev)
    y_train = torch.as_tensor(data.y_train, device=dev)
    weights = torch.as_tensor(algorithm.client_weights(part, batch_size),
                              device=dev)
    keyw = round_keys(seed, rounds)
    state = algorithm.init_state(params)
    measure = evaluator(task, data, eval_samples, dev)
    ledger = compression_mod.round_bytes(algorithm, aggregation, params,
                                         num_clients)
    hist = History(uplink_bytes_per_round=ledger.uplink_total,
                   downlink_bytes_per_round=ledger.downlink_total,
                   comm=ledger.as_dict())

    def upload(batch):
        return algorithm.client_upload(params, state, batch)

    evals = []
    t0 = time.perf_counter()
    for t in range(rounds):
        idx_t = schedule[t]                                  # (I, B)
        if not aggregation.needs_messages:
            # linear fast path: one upload on the weighted super-batch
            flat = idx_t.reshape(-1)
            agg = upload((x_train[flat], y_train[flat],
                          weights.repeat_interleave(idx_t.shape[1])))
        else:
            ws = weights[:, None].expand(idx_t.shape)        # λ_i per sample
            msgs = vmap(upload)((x_train[idx_t], y_train[idx_t], ws))
            agg = aggregation.combine_messages(msgs, keyw[t], device=dev)
        params, state = algorithm.server_step(params, state, agg,
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
