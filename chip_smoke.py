#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero without its
last line):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time;
2. hold every kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge shapes: ``ssca_update`` bit for bit
   (both round every f32 operation separately), ``masked_sum`` bit for
   bit, including one client's masked upload at ``client_offset = i``;
3. drive the main path once — ``run_alg1(secure=True, fused=True)`` on
   the paper's MLP (784 → 128 → 10) at full width: 60,000 samples over
   10 iid clients, B = 100, 20 rounds — with every launch counter set to
   0 just before and read just after; check that each kernel launched
   once per round, that the costs are finite and falling, the ledger's
   uplink bytes, and that the run tracks the port's own CPU run of the
   same configuration;
4. run the main path once more under ``torch.profiler`` and print the
   device time by kind and the device's busy share of the round loop;
5. time each kernel and its plain version on the main path's shapes
   (CUDA events around the replay of a CUDA graph of 50 calls, so the
   host's launch overhead does not gate the device) and print one
   ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth
# and FP32.  The data sheet gives no int32 rate; this one is an estimate,
# 132 SMs x 64 INT32 lanes (Hopper architecture white paper) x 1.98 GHz
# (the clock behind the 67 TFLOP/s FP32 figure: 132 x 128 x 2 x 1.98 GHz).
# If the multiplies issue on the FP32 pipe beside the INT32 one, the card
# is faster than this, so the integer bound below is an upper estimate of
# the least time.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_FLOPS_PER_S = 67e12

# integer operations per element of one directed mask stream: two murmur3
# finalizers (3 shifts, 3 xors, 2 multiplies each), the xors with the two
# seed words (2: both words depend only on the pair, not the element), and
# the accumulate into the upload (1: the coefficient is +-1); per client
# row, the quantize (2) and the running sum (1)
OPS_PER_STREAM = 2 * 8 + 2 + 1
OPS_PER_ROW = 3
# f32 operations per element of the fused SSCA update
FLOPS_SSCA = 14

SCALE_BITS = 20
ROUNDS = 20
CLIENTS = 10


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=50, repeats=7, graph=True):
    """Median over ``repeats`` of the mean device time of one call, from
    CUDA events.  With ``graph`` the ``iters`` calls are captured once in
    a CUDA graph and replayed, so the host's launch overhead does not
    gate the device; without it they are launched eagerly."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_kernel_parity(torch, su, sa):
    """Kernel against plain version on the card; returns the max abs
    errors at the main path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    errs = {}
    sc = torch.tensor([0.9 / 7 ** 0.3, 0.9 / 7 ** 0.35, 0.1, 1e-5],
                      device=dev)
    for rows in (794, 13):
        ins = [randn(rows, 128) for _ in range(4)]
        got = su.ssca_update_2d(*ins, sc)
        want = su.ssca_update_plain(*ins, sc)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"ssca_update differs at R={rows}: {err}")
        errs.setdefault("ssca_update", err)
    log("ssca_update: kernel == plain bit for bit at R=794 and R=13")

    key0, key1 = 0x8BADF00D, 0x1234567

    def check(msgs, name, **kw):
        got = sa.masked_sum_2d(msgs, key0, key1, scale_bits=SCALE_BITS, **kw)
        want = sa.masked_sum_plain(msgs, key0, key1, scale_bits=SCALE_BITS,
                                   **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"masked_sum differs from plain: {name}, "
                                 f"max abs difference {err}")
        log(f"masked_sum: kernel == plain bit for bit: {name}")
        return got, err

    main = randn(CLIENTS, 794, 128, scale=1e-3)
    agg, errs["masked_sum"] = check(main, "(10, 794, 128)",
                                    num_clients=CLIENTS)
    quant = sa.quantize(main, SCALE_BITS).sum(0, dtype=torch.int32)
    if not torch.equal(agg, quant):
        raise AssertionError("masked aggregate != sum of quantized messages")
    log("masked_sum: aggregate == sum_i quantize(m_i) bit for bit")
    check(randn(1, 794, 128, scale=1e-3), "I=1", num_clients=1)
    ragged = torch.nn.functional.pad(randn(3, 1000, scale=1e-3), (0, 24))
    check(ragged.reshape(3, 8, 128), "ragged n=1000 padded to 1024",
          num_clients=3)
    alive = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1, 1, 1], device=dev)
    check(main, "alive with two dropouts", num_clients=CLIENTS,
          alive=alive)
    for i in (0, 3, 9):
        up, _ = check(main[i:i + 1].contiguous(),
                      f"client {i}'s masked upload (client_offset={i} of 10)",
                      num_clients=CLIENTS, client_offset=i)
        same = float((up == sa.quantize(main[i], SCALE_BITS)).float().mean())
        if same > 0.01:
            raise AssertionError(f"client {i}'s upload is not masked")
    return errs


def phase_main_path(torch, su, sa, data, part, params, runtime):
    """The secure fused main path on the card, with counted launches."""
    kw = dict(batch_size=100, rounds=ROUNDS, eval_every=10, seed=0,
              secure=True, fused=True, params=params)
    # warm-up: the process's first rounds load CUDA modules and create
    # the cuBLAS handles, a one-time cost kept out of the round time
    t0 = time.perf_counter()
    runtime.run_alg1(data, part, device="cuda", **dict(kw, rounds=2))
    log(f"warm-up: 2 rounds in {time.perf_counter() - t0:.2f} s "
        "(one-time CUDA and cuBLAS initialisation)")
    su.ssca_update_2d.launches = 0
    sa.masked_sum_2d.launches = 0
    p_gpu, h_gpu = runtime.run_alg1(data, part, device="cuda", **kw)
    launches = {"ssca_update": su.ssca_update_2d.launches,
                "masked_sum": sa.masked_sum_2d.launches}
    log(f"main path launches over {ROUNDS} rounds: {launches}")
    for name, n in launches.items():
        if n != ROUNDS:
            raise AssertionError(f"{name} launched {n} times, not {ROUNDS}")
    cost = h_gpu.train_cost
    if not all(math.isfinite(c) for c in cost) or not cost[-1] < cost[0]:
        raise AssertionError(f"train cost not finite and falling: {cost}")
    n_params = sum(v.numel() for v in p_gpu.values())
    want_up = CLIENTS * (4 * n_params + 4 * (CLIENTS - 1))
    if n_params != 101_632 or h_gpu.uplink_bytes_per_round != want_up:
        raise AssertionError(f"ledger: {n_params} params, "
                             f"{h_gpu.uplink_bytes_per_round} B uplink")
    log(f"ledger: {h_gpu.uplink_bytes_per_round} uplink bytes per round "
        f"= 10 x (4 x {n_params} + 4 x 9)")

    t0 = time.perf_counter()
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    diffs = {k: max(abs(a - b) / abs(b) for a, b in
                    zip(h_gpu.metrics[k], h_cpu.metrics[k]))
             for k in ("train_cost", "sparsity")}
    diffs["test_accuracy_abs"] = max(
        abs(a - b) for a, b in zip(h_gpu.test_accuracy, h_cpu.test_accuracy))
    diffs["params_abs"] = max(float((p_gpu[k].cpu() - p_cpu[k]).abs().max())
                              for k in p_cpu)
    log("card vs CPU run of the same configuration:",
        json.dumps(diffs), f"(CPU run {cpu_s:.1f} s)")
    # tolerance: the card's and the CPU's matmuls round differently, and
    # a different rounding can move a gradient entry across a 2^-20 grid
    # point of the secure quantizer.  Measured on an H100: cost and
    # sparsity 7e-8 relative, accuracy 6e-8, weights 6.2e-6 absolute.
    limits = {"train_cost": 1e-5, "sparsity": 1e-5,
              "test_accuracy_abs": 1e-3, "params_abs": 5e-5}
    for k, lim in limits.items():
        if not diffs[k] <= lim:
            raise AssertionError(f"card run drifts from CPU run: {k} "
                                 f"{diffs[k]} > {lim}")
    log(f"train cost {cost}, test accuracy {h_gpu.test_accuracy}")
    return launches, h_gpu


def phase_profile(torch, data, part, params, runtime):
    """Where the main path's round time goes: the same run once more
    under ``torch.profiler``, device activity summed by kind.  The
    profiler slows the host, so the busy share it gives is a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile
    kw = dict(batch_size=100, rounds=ROUNDS, eval_every=10, seed=0,
              secure=True, fused=True, params=params)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, hist = runtime.run_alg1(data, part, device="cuda", **kw)
    us = {"staging_htod": 0.0, "masked_sum": 0.0, "ssca_update": 0.0,
          "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("staging_htod" if "HtoD" in e.name else
                "masked_sum" if "masked_sum_kernel" in e.name else
                "ssca_update" if "ssca_update_kernel" in e.name else "other")
        us[kind] += e.time_range.elapsed_us()
    loop_us = us["masked_sum"] + us["ssca_update"] + us["other"]
    out = {"rounds": ROUNDS, "profiled_wall_ms": hist.wall_seconds * 1e3,
           "device_us": us,
           "device_busy_share_of_round_loop":
               loop_us / (hist.wall_seconds * 1e6)}
    log("profile (round loop under torch.profiler):", json.dumps(out))


def phase_timing(torch, su, sa, launches, errs):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    n = 794 * 128
    w, lin, grad, beta = (torch.randn(794, 128, generator=g).to(dev)
                          for _ in range(4))
    sc = torch.tensor([0.5, 0.6, 0.1, 1e-5], device=dev)
    msgs = (torch.randn(CLIENTS, 794, 128, generator=g) * 1e-3).to(dev)
    kw = dict(scale_bits=SCALE_BITS, num_clients=CLIENTS)
    ssca_bytes = (7 * n + 4) * 4
    ms_bytes = (CLIENTS * n + n) * 4
    ms_ops = n * CLIENTS * ((CLIENTS - 1) * OPS_PER_STREAM + OPS_PER_ROW)
    rows = []
    for name, src, replaces, kern, plain, nbytes, ops, rate in (
            ("ssca_update", "src/repro_torch/kernels/csrc/ssca_update.cu",
             "src/repro/kernels/ssca_update.py:54",
             lambda: su.ssca_update_2d(w, lin, grad, beta, sc),
             lambda: su.ssca_update_plain(w, lin, grad, beta, sc),
             ssca_bytes, FLOPS_SSCA * n, FP32_FLOPS_PER_S),
            ("masked_sum", "src/repro_torch/kernels/csrc/secure_agg.cu",
             "src/repro/kernels/secure_agg.py:346",
             lambda: sa.masked_sum_2d(msgs, 1, 2, **kw),
             lambda: sa.masked_sum_plain(msgs, 1, 2, **kw),
             ms_bytes, ms_ops, INT32_OPS_PER_S)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / rate * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": time_ms(kern),
            "plain_ms": time_ms(plain, iters=5, repeats=3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
        log(f"{name}: {time_ms(kern, graph=False):.4f} ms a call when "
            "launched eagerly from Python (wrapper overhead included)")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import partition, synthetic
    from repro_torch.fed import runtime
    from repro_torch.kernels import build
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.kernels import ssca_update as su
    from repro_torch.mlpapp import model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")

    errs = phase_kernel_parity(torch, su, sa)

    t0 = time.perf_counter()
    data = synthetic.classification_dataset(60000, 10000, seed=0)
    part = partition.iid(60000, CLIENTS, seed=0)
    params = model.init_params(torch.Generator().manual_seed(0), 784, 128, 10)
    log(f"data: {data.x_train.shape} train, {data.x_test.shape} test "
        f"({time.perf_counter() - t0:.1f} s)")
    launches, hist = phase_main_path(torch, su, sa, data, part, params,
                                     runtime)
    log(f"round time {hist.wall_seconds / ROUNDS * 1e3:.3f} ms "
        f"(secure fused, I={CLIENTS}, B=100, eval every 10 rounds "
        f"included) on {card}")

    phase_profile(torch, data, part, params, runtime)
    kernels = phase_timing(torch, su, sa, launches, errs)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
