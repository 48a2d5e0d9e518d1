#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero without its
last line):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, eight in
   parallel) and print the build time, and each flash-attention variant's
   registers, spill bytes and shared memory at every head dim, the WKV
   kernel's at each of its instances and the masked sum's, and the masked
   sum's stream loop in SASS by pipe (``cuobjdump``), which must issue no
   fewer operations a stream than the bound below counts;
2. hold every kernel against its plain PyTorch version on the card, at
   the paths' shapes and at edge shapes, each launch counted on the
   variant its wrapper's launch plan names: ``ssca_update`` (also on
   views one element past 16-byte alignment) and ``compress`` (both round
   every f32 operation separately), ``masked_sum`` (``rowsplit`` under
   one wave of the card, ``vec`` past it, misaligned views, which the
   wrapper copies; dropouts, a client offset, 600 clients whose streams
   pass one shared-memory table, one client's masked upload at
   ``client_offset = i``, Algorithm 2's upload at (10, 795, 128)) and
   ``sketch_encode`` (ring arithmetic; at the path's 4 x 1024 sketch and
   at 8 x 16,384) bit for bit; ``flash_attention``
   to stated tolerances: its bf16 (wgmma) kernel, which rounds P to bf16
   before P·V, to ``bf16_error_check``'s bound against the f64 softmax,
   at the LM path's shape (B·I = 8, S = 1024, H = 32, Hkv = 8, Dh = 128)
   and at edge shapes (Dh 16, 32, 64 and 128; S = 1, 65, 77, 128, 129,
   300 and 1024; G = 1, 4, 8 and 48), with SDPA's error against the
   same f64 softmax printed for the record; its f32 (3xTF32) kernel
   within 2e-5 of the plain version (S = 1, 77 and 300, Dh 16, 64 and
   128, the small LM's shape and llama3-8b's attention in f32);
   ``rwkv6_wkv`` to a stated tolerance (the kernel sums the plain
   version's chunked form on the tensor cores, each f32 operand split
   into two TF32 parts), each call counted on its variant, at the RWKV
   path's shape (N = 8, S = 1024, H = 64, D = 64, bf16 r/k/v, model-like
   decays) and at edge shapes (S = 1, 16, 33, 40, 77 and 1,000, D = 16
   and 64, log-decay at the −5 floor and at 0, u shared and per
   sequence);
3. drive the main path once — ``run_alg1(secure=True, fused=True)`` on
   the paper's MLP (784 → 128 → 10) at full width: 60,000 samples over
   10 iid clients, B = 100, 20 rounds — with every launch counter set to
   0 just before and read just after; check that each kernel launched
   once per round, that the costs are finite and falling, the ledger's
   uplink bytes, and that the run tracks the port's own CPU run of the
   same configuration;
4. drive the compressed paths the same way, each at the main path's
   data, partition and weights, 20 rounds, counters set to 0 just before
   each run and read just after: ``topk(0.1, bits=8)`` + ``secure()``,
   ``qsgd(8)`` plain, ``sketch(4, 1024, 0.02, keep=256)`` + ``secure()``;
   check the launch counts, the ledger, finite costs (falling for qsgd
   and top-k), and that a 5-round run on the card tracks the port's
   5-round CPU run; print each path's round time and its device time by
   kind under ``torch.profiler``; then the paper's other algorithms the
   same way, at the main path's data and weights, 20 rounds each:
   ``run_alg2(limit_u=0.13)`` plain and secure (B = 100; the secure
   (value, gradient) upload is 795 rows of 128), ``run_fedsgd`` secure
   (B = 100) and ``run_fedavg(local_steps=2)`` secure, alone and with
   ``topk(0.1, bits=8)`` on its model deltas (B = 50, Fig. 1's FedAvg
   batch); check every kernel's launches (``masked_sum`` once a round on
   the secure paths, ``compress`` once a round on the top-k one, nothing
   else), the ledger, finite costs, Algorithm 2's slack finite and ≥ 0
   (its final cost printed against U), and a 5-round run against the
   port's CPU run;
5. drive the decoder-only LM (``transformer_task()``: llama3-8b cut to
   2 layers of width 64) secure and fused on the card for 5 rounds,
   counters set to 0 just before and read just after, and hold it to
   the port's CPU run of the same configuration; then the same for
   RWKV-6 (``rwkv6_task()``: rwkv6-7b cut to 2 layers of width 64);
6. drive the LM path at the full width of llama3-8b (2 of its 32
   layers): ``run_alg1(secure=True, fused=True, tau=2, lam=0)`` on 256
   Zipf token documents of 1,024 tokens over 4 iid clients, B = 2, 4
   rounds, eval every 2 rounds on 8 documents and the 8 test documents;
   check the launch counts (flash attention once per layer per upload
   forward for all clients and per eval forward, all of them the wgmma
   variant; the small LM's f32 ones all the tf32x3 variant), finite costs, the
   first cost within [ln V − 1, ln V + 3], the ledger against
   ``round_bytes`` computed from the parameter shapes; print the round
   time, the peak device memory and the device time by kind and busy
   share of one more round under ``torch.profiler``; then the same for
   rwkv6-7b at full width (2 of its 32 layers), whose WKV scan launches
   its tensor-core kernel once per layer per forward; and rwkv6-7b's path once more at τ = 2,
   8 and 32 with the cost read after each of its 4 rounds (finite
   costs), to tell the step size from the port in the cost's rise;
7. time ``masked_sum`` (I = 4) and ``ssca_update`` directly at both
   full-width LM paths' widths, once those paths have freed their
   memory: the median of 5 eager launches after 2 warm-ups, from CUDA
   events, each output checked (the aggregate against Σ quantize(m_i),
   the update against its plain version bit for bit); then run the main
   path once more under ``torch.profiler`` and print the device time by
   kind and the device's busy share of the round loop;
8. time each kernel and its plain version on the paths' shapes (CUDA
   events around the replay of a CUDA graph of 50 calls, so the host's
   launch overhead does not gate the device), and, for flash attention,
   ``scaled_dot_product_attention`` as the library yardstick (the port
   never calls it; no single PyTorch call computes the WKV scan): the
   wgmma variant at the LM path's shape, with its achieved TFLOP/s, and
   the tf32x3 variant at the small LM's and at llama3-8b's attention in
   f32 (``flash_attention_f32_wide``, SDPA's backend named); the launch
   floor, an empty kernel's graph replay, beside ``ssca_update``,
   ``masked_sum`` and ``sketch_encode`` at the MLP shape; each row gives
   its bound's parts (bytes, and each kind of operation at its rate), the
   ``masked_sum`` row its launches by variant,
   and the ``masked_sum`` and ``ssca_update`` rows, for each
   full-width LM path, the launches, the profiled round's launch time,
   the direct launches' time and the bound at that path's parameter
   count; print one
   ``{"kernels": [...]}`` line, then the result line ``{"ok": true,
   "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth
# and FP32.  The data sheet gives no int32 rate; two are derived here, at
# 1.98 GHz (the clock behind the 67 TFLOP/s FP32 figure: 132 x 128 x 2 x
# 1.98 GHz).  INT32_ALU_OPS_PER_S is the ALU pipe alone, 132 SMs x 64
# INT32 lanes (Hopper architecture white paper): logic operations and
# shifts issue only there.  INT32_OPS_PER_S is the SM's issue ceiling, 132
# SMs x 4 schedulers x 32 lanes: integer multiplies and multiply-adds
# issue on the FMA pipe (SASS IMAD), and each scheduler issues one warp
# instruction a cycle.  Integer work is bounded by both: its ALU-pipe
# operations at the first rate and all of its operations at the second.
HBM_BYTES_PER_S = 3.35e12
INT32_ALU_OPS_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
FP32_FLOPS_PER_S = 67e12
# dense bf16 and TF32 tensor-core peaks (data sheet, SXM, without
# sparsity).  tf32x3: an f32-accurate FLOP as three TF32 passes over the
# hi + lo split of each operand (csrc/tf32x3.cuh)
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
RATES = {"int32": INT32_OPS_PER_S, "int32_alu": INT32_ALU_OPS_PER_S,
         "f32": FP32_FLOPS_PER_S, "bf16": BF16_FLOPS_PER_S,
         "tf32": TF32_FLOPS_PER_S, "tf32x3": TF32_FLOPS_PER_S / 3}

# integer operations per element of one directed mask stream, the least
# the function needs: mask_bits is two murmur3 finalizers (3 shifts, 3
# xors, 2 multiplies each) and the xors with the two seed words, but
# f(v) = v ^ (v >> 16) is linear over xor and its own inverse, so with
# f(seed) and f(seed + kGold) made once per stream and f(e) once per
# element it takes 5 xors, 3 shifts and 4 multiplies (csrc/secure_agg.cu);
# then the accumulate into the upload times the coefficient (1).  Of
# these, the 8 xors and shifts issue only on the ALU pipe.  Per client
# row: the quantize (2) and the running sum (1)
OPS_PER_STREAM = 5 + 3 + 4 + 1
ALU_OPS_PER_STREAM = 5 + 3
OPS_PER_ROW = 3
# f32 operations per element of the fused SSCA update
FLOPS_SSCA = 14
# one PRF word at a counter: the counter add, the xors with the two seed
# words and two murmur3 finalizers of 8, then the word's conversion to f32
OPS_PRF_WORD = 1 + 2 + 2 * 8 + 1
# compress, per element: the PRF word (integer) and, in f32, the divide,
# floor, subtract, scale of u, compare, add, two clip compares, the
# multiply by the step, |x|, the threshold compare and the residual
FLOPS_COMPRESS = 12
# sketch_encode: per element, the zero test (f32); per nonzero element,
# the rounding draw (integer) and 5 f32 operations (scale, floor,
# subtract, compare, add) and the int convert (an exact zero or a NaN
# rounds to 0 for every draw, so it needs none); per nonzero level and
# sketch row, the row seed (1 + 1 + 8), the hash word (19), the bucket
# mask, the sign select and the add
FLOPS_SKETCH = 5
OPS_SKETCH_ROW = 10 + 19 + 3

SCALE_BITS = 20
ROUNDS = 20
CLIENTS = 10

# the LM path at full width: llama3-8b cut to 2 of its 32 layers
LM_LAYERS = 2
LM_SEQ = 1024
LM_CLIENTS = 4
LM_BATCH = 2
LM_ROUNDS = 4
LM_EVAL_EVERY = 2
LM_PARAMS = 961_564_672
# flash attention's shape on that path: the 4 clients' 2 sequences
# folded into the batch
FLASH_PATH = (LM_CLIENTS * LM_BATCH, LM_SEQ, 32, 8, 128)
# bf16 edge shapes (B, S, H, Hkv, Dh): every head dim, S in {1, 65, 77,
# 128, 129, 300, 1024} (ragged and whole 128-row tiles) and G in {1, 4, 8,
# 48} (48: granite-34b's grouping)
FLASH_BF16_EDGES = [(2, 1, 4, 1, 128), (1, 65, 8, 1, 64), (2, 77, 4, 4, 16),
                    (1, 128, 8, 2, 32), (1, 129, 48, 1, 128),
                    (2, 300, 8, 1, 64), (1, 1024, 48, 1, 128),
                    (1, 300, 4, 4, 32), (1, 1024, 4, 1, 16),
                    (2, 65, 16, 2, 128)]
FLASH_F32_EDGES = [(2, 1, 4, 1, 64), (2, 77, 8, 8, 16), (3, 77, 8, 1, 64),
                   (2, 300, 8, 1, 128)]
# the small LM's (f32) flash shape: 4 clients' 4 sequences of 32 tokens
# folded into the batch, 4 heads of 16 on 4 kv heads
FLASH_SMALL = (16, 32, 4, 4, 16)
# llama3-8b's attention at the LM path's shape in f32, the width a user
# reaches with activ_dtype="float32": the f32 kernel timed where its
# design, not the launch, sets the time
FLASH_F32_WIDE = FLASH_PATH
# the sketched path's sketch (rows, cols), and one of 131,072 buckets
SKETCH_PATH = (4, 1024)
SKETCH_LARGE = (8, 16384)
# the RWKV path at full width: rwkv6-7b cut to 2 of its 32 layers, on the
# LM path's data, clients, batch and rounds; the parameter tree holds
# final_norm, which the config's param_count() leaves out
RWKV_PARAMS = 705_802_240
# the WKV scan's shape on that path (N, S, H, D): the 4 clients' 2
# sequences folded into N
WKV_PATH = (LM_CLIENTS * LM_BATCH, LM_SEQ, 64, 64)


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


def eager_ms(fn, warm=2, reps=5):
    """Median over ``reps`` eager calls, after ``warm`` more, of each
    call's device time from CUDA events around it."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# SASS opcodes by the pipe that issues them on Hopper
SASS_ALU = {"LOP3", "SHF", "IADD3", "ISETP", "SEL", "LEA", "PRMT", "VIADD",
            "IMNMX", "VIMNMX", "POPC", "FLO", "MOV", "PLOP3"}
SASS_FMA = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"}


def stream_loop_mix():
    """The masked sum's stream loop in SASS (``cuobjdump -sass`` of the
    built library): the innermost loop (a backward branch's span holding
    no other) with the most ``LOP3``.  Prints its opcodes and its
    instructions by pipe a stream-element (each ``LDS.128`` reads one
    table entry, one stream for four elements), and raises if the kernel
    touches local memory or the loop issues fewer xors and shifts, or
    fewer operations, a stream-element than the bound counts."""
    import collections
    import re
    import shutil
    from repro_torch.kernels import build
    from repro_torch.kernels import secure_agg as sa
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path())],
                          check=True, capture_output=True, text=True).stdout
    body = next(c for c in sass.split("Function : ")[1:]
                if "masked_sum_kernel" in c.split("\n", 1)[0])
    insns = [(int(a, 16), t.strip()) for a, t in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    spans = [(int(m.group(1), 16), a) for a, t in insns
             for m in [re.search(r"\bBRA\b.*?\b0x([0-9a-f]+)\b", t)]
             if m and int(m.group(1), 16) <= a]
    inner = [(a, b) for a, b in spans if not any(
        a <= c and d <= b and (c, d) != (a, b) for c, d in spans)]

    def opcodes(a, b):
        return collections.Counter(
            t.split()[1 if t.startswith("@") else 0]
            for x, t in insns if a <= x <= b)

    ops = max((opcodes(a, b) for a, b in inner),
              key=lambda o: o["LOP3.LUT"])
    elems = ops["LDS.128"] * sa.ELEMS
    pipes = collections.Counter()
    for op, k in ops.items():
        base = op.split(".")[0]
        pipes["alu" if base in SASS_ALU else "fma" if base in SASS_FMA
              else "other"] += k
    xor_shift = sum(k for op, k in ops.items()
                    if op.split(".")[0] in ("LOP3", "SHF")) / elems
    ring = xor_shift + ops["IMAD"] / elems
    log(f"masked_sum stream loop (SASS): {sum(ops.values())} instructions "
        f"for {elems} stream-elements; a stream-element: "
        f"{pipes['alu'] / elems} ALU-pipe, {pipes['fma'] / elems} FMA-pipe, "
        f"{xor_shift} xors and shifts, {ops['IMAD'] / elems} IMAD;",
        json.dumps(dict(ops.most_common())))
    if re.search(r"\b(LDL|STL)\b", body):
        raise AssertionError("masked_sum touches local memory")
    if xor_shift < ALU_OPS_PER_STREAM or ring < OPS_PER_STREAM:
        raise AssertionError(
            f"masked_sum issues {xor_shift} xors and shifts and {ring} "
            f"operations a stream-element, under the bound's "
            f"{ALU_OPS_PER_STREAM} and {OPS_PER_STREAM}")


def launch_floor_ms(torch):
    """Device time of one launch of an empty kernel, from a CUDA-graph
    replay as ``time_ms`` times the kernels: the least time any launch at
    the MLP shape can take."""
    from repro_torch.kernels import build
    lib = build.load()
    return time_ms(lambda: build.check(lib.empty_launch(
        torch.cuda.current_stream().cuda_stream), "empty"))


# the full-width LM paths' parameter counts, at which the server kernels
# run once a round
FULL_WIDTH = {"lm_full_width": LM_PARAMS, "rwkv_full_width": RWKV_PARAMS}


def server_kernels_full_width(torch, su, sa):
    """``masked_sum`` (I = 4 clients) and ``ssca_update`` at each
    full-width LM path's padded parameter count, timed directly: the
    median of 5 eager launches after 2 warm-ups, from CUDA events.  Each
    output is checked: the aggregate against Σ_i quantize(m_i) and the
    update against its plain version, bit for bit (in slices of 2^20
    rows).  Buffers: 19.2 GB for llama3-8b's masked sum, 26.9 GB for its
    update."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    sc = torch.tensor([0.5, 0.6, 0.1, 1e-5], device="cuda")
    for path, n_params in FULL_WIDTH.items():
        rows = -(-n_params // 128)
        msgs = torch.randn(LM_CLIENTS, rows, 128, device="cuda",
                           generator=gen).mul_(1e-3)
        kw = dict(scale_bits=SCALE_BITS, num_clients=LM_CLIENTS)
        ms_sum = eager_ms(lambda: sa.masked_sum_2d(msgs, 1, 2, **kw))
        agg = sa.masked_sum_2d(msgs, 1, 2, **kw)
        want = torch.zeros_like(agg)
        for m in msgs:
            want += sa.quantize(m, SCALE_BITS)
        if not torch.equal(agg, want):
            raise AssertionError(f"masked_sum at {path}'s width: aggregate "
                                 "!= sum_i quantize(m_i)")
        del msgs, agg, want
        torch.cuda.empty_cache()
        ins = [torch.randn(rows, 128, device="cuda", generator=gen)
               for _ in range(4)]
        ms_upd = eager_ms(lambda: su.ssca_update_2d(*ins, sc))
        got = su.ssca_update_2d(*ins, sc)
        for r0 in range(0, rows, 1 << 20):
            part = [x[r0:r0 + (1 << 20)] for x in ins]
            want = su.ssca_update_plain(*part, sc)
            if not all(torch.equal(a[r0:r0 + (1 << 20)], b)
                       for a, b in zip(got, want)):
                raise AssertionError(f"ssca_update at {path}'s width "
                                     f"differs from plain at rows {r0}+")
        del ins, got, want
        torch.cuda.empty_cache()
        out[path] = {"rows": rows, "masked_sum_ms": ms_sum,
                     "ssca_update_ms": ms_upd}
    return out


def phase_kernel_parity(torch, su, sa):
    """Kernel against plain version on the card; returns the max abs
    errors at the main path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def on_variant(fn, variant, call):
        """``call()``, which must launch ``fn`` once on ``variant``."""
        before = dict(fn.launches_by_variant)
        out = call()
        before[variant] += 1
        if fn.launches_by_variant != before:
            raise AssertionError(f"launched {fn.launches_by_variant}, want "
                                 f"one more {variant}: {before}")
        return out

    errs = {}
    sc = torch.tensor([0.9 / 7 ** 0.3, 0.9 / 7 ** 0.35, 0.1, 1e-5],
                      device=dev)
    # the paths' shape, a small one, views one element past alignment
    for rows, shift in ((794, False), (13, False), (794, True)):
        ins = [randn(rows, 128) for _ in range(4)]
        if shift:
            ins = [misaligned(torch, x) for x in ins]
        got = su.ssca_update_2d(*ins, sc)
        want = su.ssca_update_plain(*ins, sc)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"ssca_update differs at R={rows}: {err}")
        errs.setdefault("ssca_update", err)
        log(f"ssca_update: kernel == plain bit for bit at R={rows}"
            f"{' one element past alignment' if shift else ''}")

    key0, key1 = 0x8BADF00D, 0x1234567
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(msgs, name, **kw):
        plan = sa.launch_plan(msgs[0].numel(), msgs.shape[0],
                              kw["num_clients"], sms)
        got = on_variant(sa.masked_sum_2d, plan[0], lambda: sa.masked_sum_2d(
            msgs, key0, key1, scale_bits=SCALE_BITS, **kw))
        want = sa.masked_sum_plain(msgs, key0, key1, scale_bits=SCALE_BITS,
                                   **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"masked_sum differs from plain: {name}, "
                                 f"max abs difference {err}")
        log(f"masked_sum: kernel == plain bit for bit: {name} ({plan[0]}, "
            f"{plan[1]} split{'s' if plan[1] > 1 else ''}, {plan[2]} "
            "blocks)")
        return got, err

    main = randn(CLIENTS, 794, 128, scale=1e-3)
    agg, errs["masked_sum"] = check(main, "(10, 794, 128)",
                                    num_clients=CLIENTS)
    quant = sa.quantize(main, SCALE_BITS).sum(0, dtype=torch.int32)
    if not torch.equal(agg, quant):
        raise AssertionError("masked aggregate != sum of quantized messages")
    log("masked_sum: aggregate == sum_i quantize(m_i) bit for bit")
    # Algorithm 2's upload: the value, then 101,632 gradient entries, in
    # 795 rows with a 127-element zero tail
    alg2 = torch.nn.functional.pad(randn(CLIENTS, 101_633, scale=1e-3),
                                   (0, 127)).reshape(CLIENTS, 795, 128)
    agg, _ = check(alg2, "(10, 795, 128), Algorithm 2's (value, gradient)",
                   num_clients=CLIENTS)
    if not torch.equal(agg, sa.quantize(alg2, SCALE_BITS).sum(
            0, dtype=torch.int32)):
        raise AssertionError("masked aggregate != sum of quantized messages "
                             "at (10, 795, 128)")
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
    # past the wave threshold (vec), with dropouts and an offset; 600
    # clients, whose streams pass one shared-memory table; rows one
    # element past alignment (copied by the wrapper)
    big = randn(4, 4608, 128, scale=1e-3)
    check(big, "(4, 4608, 128)", num_clients=4)
    check(big, "(4, 4608, 128) at client_offset 2 of 7, two dropouts",
          num_clients=7, client_offset=2,
          alive=torch.tensor([1, 1, 0, 1, 1, 0, 1], device=dev))
    check(big[:3], "(3, 4608, 128) of 600 clients", num_clients=600)
    check(big[:3, :8].contiguous(), "(3, 8, 128) of 600 clients",
          num_clients=600)
    check(misaligned(torch, main), "(10, 794, 128) one element past "
          "alignment", num_clients=CLIENTS, alive=alive)
    check(misaligned(torch, big), "(4, 4608, 128) one element past "
          "alignment", num_clients=4)
    errs["compress"] = phase_compress_parity(torch, randn)
    errs["sketch_encode"] = phase_sketch_parity(torch, randn)
    return errs


def misaligned(torch, t):
    """``t`` copied into a contiguous view one element past a 16-byte
    aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def same_bits(torch, a, b):
    """Bit for bit, with every NaN mapped to one pattern."""
    nan = torch.tensor(float("nan"), device=a.device)
    return torch.equal(torch.where(torch.isnan(a), nan, a).view(torch.int32),
                       torch.where(torch.isnan(b), nan, b).view(torch.int32))


def stream_scalars(torch, clients, base, sketch_seed=None):
    """(I, 2) or (I, 3) int64 kernel scalars for clients 0..I-1."""
    from repro_torch.kernels.compress import client_stream_seed
    rows = [[client_stream_seed(0x8BADF00D, 0x1234567, c), base]
            + ([] if sketch_seed is None else [sketch_seed])
            for c in range(clients)]
    return torch.tensor(rows, dtype=torch.int64, device="cuda")


def compress_inputs(torch, x, *, topk_frac=None, bits=8, base=0):
    """The scalars the compressed paths hand the kernel: θ from the top-k
    of each client's message (or none) and Δ from its max."""
    from repro_torch.fed.compression import _pow2_step
    flat = x.reshape(x.shape[0], -1)
    lbound = 2 ** (bits - 1) - 1
    thr = torch.zeros(x.shape[0], device=x.device)
    if topk_frac is not None:
        k = math.ceil(topk_frac * flat.shape[1])
        thr = torch.topk(flat.abs(), k, dim=1).values[:, k - 1]
    delta = _pow2_step(flat.abs().amax(dim=1), lbound)
    return (stream_scalars(torch, x.shape[0], base),
            torch.stack([thr, delta], dim=1), lbound)


def phase_compress_parity(torch, randn):
    from repro_torch.kernels import compress as kc
    errs = []

    def check(x, su, sf, name, **kw):
        got = kc.compress_2d(x, su, sf, **kw)
        want = kc.compress_2d_plain(x, su, sf, **kw)
        torch.cuda.synchronize()
        if not all(same_bits(torch, a, b) for a, b in zip(got, want)):
            raise AssertionError(f"compress differs from plain: {name}")
        log(f"compress: kernel == plain bit for bit: {name}")
        ok = [torch.isfinite(a) & torch.isfinite(b) for a, b in zip(got, want)]
        return max(float((a - b)[m].abs().max()) if m.any() else 0.0
                   for a, b, m in zip(got, want, ok))

    # the paths' shapes: top-k over the flattened message, qsgd per leaf
    x = randn(CLIENTS, 794, 128, scale=1e-3)
    su, sf, lb = compress_inputs(torch, x, topk_frac=0.1)
    errs.append(check(x, su, sf, "topk(0.1, bits=8) at (10, 794, 128)",
                      lbound=lb, quantize=True, masked=True))
    for rows, base in ((784, 0), (10, 784 * 128)):
        x = randn(CLIENTS, rows, 128, scale=1e-3)
        su, sf, lb = compress_inputs(torch, x, base=base)
        errs.append(check(x, su, sf, f"qsgd(8) leaf at (10, {rows}, 128), "
                          f"counter base {base}", lbound=lb, quantize=True,
                          masked=False))
    # edges: a ragged leaf, NaN/inf/subnormal inputs, counters that wrap,
    # every (quantize, masked) case
    x = torch.nn.functional.pad(randn(3, 1000, scale=1e-3), (0, 24))
    x = x.reshape(3, 8, 128)
    x.view(-1)[:6] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), -0.0, 3e38, 1e-45])
    su, sf, lb = compress_inputs(torch, torch.nan_to_num(x), topk_frac=0.1,
                                 base=2 ** 32 - 300)
    for quantize in (False, True):
        for masked in (False, True):
            check(x, su, sf, f"ragged n=1000, NaN/inf, counters wrapping, "
                  f"quantize={quantize}, masked={masked}", lbound=lb,
                  quantize=quantize, masked=masked)
    return max(errs)


def phase_sketch_parity(torch, randn):
    """``sketch_encode`` against its plain version bit for bit, each call
    counted; returns the largest difference at the path's shape (0)."""
    from repro_torch.kernels import sketch as ks
    errs = []

    def check(x, su, name, **kw):
        before = ks.sketch_encode.launches
        got = ks.sketch_encode(x, su, **kw)
        want = ks.sketch_encode_plain(x, su, **kw)
        torch.cuda.synchronize()
        if ks.sketch_encode.launches != before + 1:
            raise AssertionError(f"sketch_encode at {name} launched "
                                 f"{ks.sketch_encode.launches - before} "
                                 "times, want once")
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"sketch_encode differs from plain: {name}, "
                                 f"max abs difference {err}")
        log(f"sketch_encode: kernel == plain bit for bit: "
            f"{name}")
        return got, err

    rows, cols = SKETCH_PATH
    # the path's shape: each client's top-256 pre-sparsified message
    x = presparsified(torch, randn(CLIENTS, 794, 128, scale=1e-3), 256)
    su = stream_scalars(torch, CLIENTS, 0, 0x5EEDC0DE)
    sk, err = check(x, su, f"(10, 794, 128) top-256, rows {rows}, cols "
                    f"{cols}", rows=rows, cols=cols, scale_bits=SCALE_BITS)
    errs.append(err)
    if not sk.any():
        raise AssertionError("the sketch of a nonzero message is all zero")
    lrows, lcols = SKETCH_LARGE
    for keep in (None, 256):
        xl = randn(2, 794, 128, scale=1e-3)
        if keep is not None:
            xl = presparsified(torch, xl, keep)
        check(xl, su[:2].contiguous(), f"(2, 794, 128) "
              f"{'dense' if keep is None else f'top-{keep}'}, rows {lrows}, "
              f"cols {lcols}", rows=lrows, cols=lcols, scale_bits=SCALE_BITS)
    dense = randn(3, 7, 128, scale=1e-3)
    su3 = stream_scalars(torch, 3, 2 ** 32 - 200, 0x5EEDC0DE)
    check(dense, su3, "dense ragged (3, 7, 128), counters wrapping, cols 1",
          rows=3, cols=1, scale_bits=SCALE_BITS)
    check(dense, su3, "dense (3, 7, 128), rows 8, cols 64", rows=8, cols=64,
          scale_bits=SCALE_BITS)
    check(misaligned(torch, dense), su3, "dense (3, 7, 128) one element "
          "past alignment, rows 4, cols 4096", rows=4, cols=4096,
          scale_bits=SCALE_BITS)
    zero, _ = check(torch.zeros_like(dense), su3, "all-zero message",
                    rows=rows, cols=cols, scale_bits=SCALE_BITS)
    if zero.any():
        raise AssertionError("the sketch of a zero message is not zero")
    dense.view(-1)[:6] = torch.tensor([float("nan"), float("inf"),
                                       -float("inf"), 3e9, 0.0, -0.0])
    check(dense, su3, "NaN/inf/+-0 inputs (saturating)", rows=4, cols=64,
          scale_bits=SCALE_BITS)
    check(dense, su3, "NaN/inf/+-0 inputs, rows 8, cols 16384", rows=lrows,
          cols=lcols, scale_bits=SCALE_BITS)
    return max(errs)


def presparsified(torch, x, keep):
    """Each client's top-``keep`` entries, the rest zero: what the
    count-sketch hands its encode kernel."""
    flat = x.reshape(x.shape[0], -1)
    thr = torch.topk(flat.abs(), keep, dim=1).values[:, keep - 1:]
    return torch.where(flat.abs() >= thr, flat, 0.0).reshape(x.shape)


def flash_inputs(torch, b, s, h, hkv, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g).to("cuda", dtype)
                 for shape in ((b, s, h, dh), (b, s, hkv, dh),
                               (b, s, hkv, dh)))


def phase_flash_parity(torch):
    """flash_attention on the card, each call counted on its variant;
    returns the max abs differences from the plain version (the wgmma
    kernel's at the LM path's shape; the tf32x3 kernel's at the small
    LM's shape and at ``FLASH_F32_WIDE``, by shape) and the bf16 check's
    numbers at the path's shape.  Tolerances: f32 (the tf32x3 kernel,
    whose products are three TF32 passes over split operands) within 2e-5
    absolute of the plain version, whose einsums sum in another order
    than the kernel's online softmax; bf16
    (the wgmma kernel, which rounds P to bf16 before P·V as the reference
    model does) to ``bf16_error_check``'s bound against the f64 softmax of
    the same inputs: elementwise one output ulp + 2^-8 · Σ p|v| + 1e-5,
    and an RMS error within 1.5x the plain version's."""
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    path_err, f32_err, stats = None, {}, None
    for shape, dt in ([(FLASH_PATH, torch.bfloat16)]
                      + [(x, torch.bfloat16) for x in FLASH_BF16_EDGES]
                      + [(x, torch.float32) for x in FLASH_F32_EDGES
                         + [FLASH_SMALL, FLASH_F32_WIDE]]):
        q, k, v = flash_inputs(torch, *shape, dt)
        variant = fa.VARIANTS[dt]
        before = dict(fa.flash_attention_bhsd.launches_by_variant)
        got = fa.flash_attention_bhsd(q, k, v)
        torch.cuda.synchronize()
        before[variant] += 1
        name = (f"(B, S, H, Hkv, Dh) = {shape}, "
                f"{str(dt).replace('torch.', '')}")
        if fa.flash_attention_bhsd.launches_by_variant != before:
            raise AssertionError(f"flash_attention at {name} did not launch "
                                 f"its {variant} kernel once")
        err = float((got.float() - fa.flash_attention_plain(q, k, v).float())
                    .abs().max())
        if dt == torch.float32:
            ok = err <= 2e-5 and bool(torch.isfinite(got).all())
            detail = f"max abs {err:.3e} from plain"
            f32_err[shape] = err
        else:
            ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got)
            detail = (f"max error / bound {ratio:.3f}, rms error vs f64 "
                      f"{rms_got:.3e} (plain {rms_plain:.3e}, ratio "
                      f"{rms_got / max(rms_plain, 1e-30):.3f}), max abs "
                      f"{err:.3e} from plain")
        if not ok:
            raise AssertionError(f"flash_attention ({variant}) outside its "
                                 f"tolerance at {name}: {detail}")
        log(f"flash_attention ({variant}): within tolerance at {name}: "
            f"{detail}")
        if path_err is None:
            path_err = err
            stats = {"max_error_over_bound": ratio,
                     "rms_error_vs_f64": rms_got,
                     "plain_rms_error_vs_f64": rms_plain}
            lib = sdpa(*(x.transpose(1, 2).contiguous() for x in (q, k, v)),
                       is_causal=True, enable_gqa=True).transpose(1, 2)
            _, lib_ratio, lib_rms, _ = fa.bf16_error_check(q, k, v, lib)
            stats["sdpa_rms_error_vs_f64"] = lib_rms
            log(f"scaled_dot_product_attention at {name}, for the record: "
                f"rms error vs f64 {lib_rms:.3e}, max error / bound "
                f"{lib_ratio:.3f}")
            del lib
        del q, k, v, got
    return path_err, f32_err, stats


def wkv_inputs(torch, n, s, h, d, dtype, lw=None, per_seq=False, seed=0):
    """r, k, v (N(0, 1) in ``dtype``), the f32 log-decay and the f32 bonus
    on the card.  The log-decay is ``lw`` everywhere, or drawn as the
    model's: −exp(N(−1, 0.5²)) clamped to [−5, 0] (its decay_base is −1)."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(n, s, h, d, generator=g).to("cuda", dtype)
               for _ in range(3))
    if lw is None:
        lwt = torch.clamp(-torch.exp(torch.randn(n, s, h, d, generator=g)
                                     * 0.5 - 1.0), -5.0, 0.0)
    else:
        lwt = torch.full((n, s, h, d), float(lw))
    u = torch.randn(*((n, h, d) if per_seq else (h, d)), generator=g)
    return r, k, v, lwt.cuda(), u.cuda()


def phase_wkv_parity(torch):
    """The WKV kernel against its plain version on the card, each call
    counted on its variant; returns the max abs error at the RWKV path's
    shape.  Tolerance: within 1e-5 of the largest |o| of the plain
    version, and finite: the kernel sums the plain version's chunked form
    on the tensor cores, each f32 operand split into two TF32 parts, in
    another order and with its score factors taken relative to the
    chunk's 8th token; both are f32 from the same inputs."""
    from repro_torch.kernels import rwkv6_scan as rw
    path_err = None
    for shape, dt, lw, per_seq in (
            (WKV_PATH, torch.bfloat16, None, False),
            ((2, 1, 4, 16), torch.float32, None, False),
            ((2, 16, 4, 16), torch.float32, -5.0, True),
            ((3, 40, 4, 16), torch.float32, 0.0, False),
            ((2, 40, 4, 16), torch.float32, -5.0, True),
            ((2, 40, 8, 64), torch.bfloat16, None, True),
            ((2, 33, 4, 16), torch.float32, None, False),
            ((2, 1, 4, 64), torch.bfloat16, None, False),
            ((3, 77, 4, 64), torch.bfloat16, -5.0, True),
            ((2, 1000, 8, 64), torch.bfloat16, 0.0, False)):
        x = wkv_inputs(torch, *shape, dt, lw=lw, per_seq=per_seq)
        before = dict(rw.rwkv6_wkv_bh.launches_by_variant)
        got = rw.rwkv6_wkv_bh(*x)
        torch.cuda.synchronize()
        before[rw.VARIANT] += 1
        want = rw.wkv_plain(*x)
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        name = (f"(N, S, H, D) = {shape}, {str(dt).replace('torch.', '')}, "
                f"lw {'model-like' if lw is None else lw}, u "
                f"{'per sequence' if per_seq else 'shared'}")
        if rw.rwkv6_wkv_bh.launches_by_variant != before:
            raise AssertionError(f"rwkv6_wkv at {name} did not launch its "
                                 f"{rw.VARIANT} kernel once")
        if not bool(torch.isfinite(got).all()) or not err <= 1e-5 * top:
            raise AssertionError(f"rwkv6_wkv differs from plain at {name}: "
                                 f"max abs {err}, max |o| {top}")
        log(f"rwkv6_wkv ({rw.VARIANT}): kernel == plain within tolerance at "
            f"{name}: max abs {err:.3e} ({err / top:.2e} of max |o| "
            f"{top:.3e})")
        if path_err is None:
            path_err = err
        del x, got, want
    return path_err


def card_vs_cpu(h_gpu, h_cpu, p_gpu, p_cpu):
    """Largest differences of a card run from the CPU run of the same
    configuration: costs relative, accuracy and weights absolute."""
    from repro_torch import tree
    diffs = {"train_cost": max(abs(a - b) / abs(b) for a, b in
                               zip(h_gpu.train_cost, h_cpu.train_cost)),
             "test_accuracy_abs": max(abs(a - b) for a, b in
                                      zip(h_gpu.test_accuracy,
                                          h_cpu.test_accuracy)),
             "params_abs": max(float((a.cpu() - b).abs().max())
                               for a, b in zip(tree.leaves(p_gpu),
                                               tree.leaves(p_cpu)))}
    return diffs


def reset_counts(kernels):
    """Every launch counter to 0, the per-variant ones too."""
    for fn in kernels.values():
        fn.launches = 0
        for variant in getattr(fn, "launches_by_variant", {}):
            fn.launches_by_variant[variant] = 0


def variant_counts(kernels):
    """The launches of each kernel with variants (masked_sum, flash
    attention, the WKV scan), by variant, since the last reset:
    ``flash_attention_wgmma``, ``masked_sum_rowsplit`` and so on."""
    return {f"{name}_{k}": n for name, fn in kernels.items()
            for k, n in getattr(fn, "launches_by_variant", {}).items()}


def lm_bf16_forward(torch):
    """The full-width path's attention configuration at a small width —
    bf16 activations, head_dim 128, four query heads on one kv head —
    forward on the card against the same forward on the CPU.  Tolerance
    5e-2 absolute on logits below 4 in size: the card's and the CPU's
    bf16 GEMMs round their outputs differently, and bf16 keeps 8 bits
    (the same forward with f32 activations moves these logits by up to
    1.8e-2 on the CPU)."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import build_model
    cfg = dataclasses.replace(
        reduced(get_config("llama3-8b"), d_model=512, d_ff=1024, vocab=512),
        num_kv_heads=1, activ_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 512, (2, 300),
                           generator=torch.Generator().manual_seed(1))
    want = model.forward(params, {"tokens": tokens})
    got = model.forward(tree.map(lambda w: w.cuda(), params),
                        {"tokens": tokens.cuda()}).cpu()
    err = float((got - want).abs().max())
    log(f"lm bf16 forward (Dh 128, G 4, S 300): card vs CPU logits max abs "
        f"{err:.3e} (logits up to {float(want.abs().max()):.3e})")
    if not err <= 5e-2 or not float(want.abs().max()) < 4:
        raise AssertionError(f"lm bf16 forward: card vs CPU {err}")


def phase_lm_small(torch, kernels, runtime, name, task, layer_kernel,
                   variant):
    """A small LM on the card against the port's CPU run, 5 rounds, with
    counted launches: ``layer_kernel`` once per layer per forward, each
    launch on ``variant``; returns the launches, also by variant."""
    from repro_torch.data import partition
    data = task.default_data(n_train=96, n_test=24, seed=0)
    part = partition.iid(96, 4, seed=0)
    rounds = 5
    kw = dict(task=task, batch_size=4, rounds=rounds, eval_every=1,
              eval_samples=48, seed=1, tau=2.0, lam=0.0, secure=True,
              fused=True)
    reset_counts(kernels)
    p_gpu, h_gpu = runtime.run_alg1(data, part, device="cuda", **kw)
    launches = {k: fn.launches for k, fn in kernels.items()}
    launches.update(variant_counts(kernels))
    want = {k: 0 for k in launches}
    # 2 layers x (one upload forward for all clients + 2 eval forwards)
    want.update({layer_kernel: 2 * 3 * rounds, "ssca_update": rounds,
                 "masked_sum": rounds})
    want[variant] = want[layer_kernel]
    from repro_torch import tree
    want.update(server_variants(torch, tree.numel(p_gpu), 4, rounds))
    log(f"{name}: launches over {rounds} rounds: {launches}")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **kw)
    diffs = card_vs_cpu(h_gpu, h_cpu, p_gpu, p_cpu)
    log(f"{name}: card vs CPU over {rounds} rounds:", json.dumps(diffs),
        f"train cost {h_gpu.train_cost}")
    # tolerance: as the MLP paths', a last-bit gradient difference can
    # move an entry across a 2^-20 grid point of the secure quantizer
    limits = {"train_cost": 1e-4, "test_accuracy_abs": 1 / 744 + 1e-6,
              "params_abs": 1e-4}
    if h_gpu.comm != h_cpu.comm:
        raise AssertionError(f"{name}: card and CPU ledgers differ")
    for k, lim in limits.items():
        if not diffs[k] <= lim:
            raise AssertionError(f"{name}: card run drifts from CPU run: "
                                 f"{k} {diffs[k]} > {lim}")
    return launches


def server_variants(torch, n_params, clients, rounds):
    """The launches of each variant of ``masked_sum`` in ``rounds``
    secure rounds of ``clients`` clients at ``n_params`` parameters
    (padded to whole rows of 128), from its wrapper's launch plan."""
    from repro_torch.kernels import secure_agg as sa
    n = -(-n_params // 128) * 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {f"masked_sum_{v}": 0 for v in sa.VARIANTS}
    want[f"masked_sum_{sa.launch_plan(n, clients, clients, sms)[0]}"] = \
        rounds
    return want


def lm_full_width(arch):
    """The LM task at ``arch``'s full width, 2 layers, and its data."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.fed.tasks import LMTask
    cfg = dataclasses.replace(get_config(arch), num_layers=LM_LAYERS)
    task = LMTask(cfg=cfg, seq_len=LM_SEQ)
    data = task.default_data(n_train=256, n_test=8, seed=0)
    return task, data


def phase_lm_full(torch, kernels, runtime, card, name, arch, n_params,
                  layer_kernel, variant):
    """An LM path at ``arch``'s full width on the card, with counted
    launches: ``layer_kernel`` once per layer per forward, each launch on
    ``variant``; returns the launches, also by variant, and the device
    time by kind of one profiled round."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.core import protocol, ssca
    from repro_torch.data import partition
    from repro_torch.fed import aggregation, compression
    from repro_torch.fed.tasks import SumLoss
    t0 = time.perf_counter()
    task, data = lm_full_width(arch)
    part = partition.iid(len(data.x_train), LM_CLIENTS, seed=0)
    log(f"{name}: data {data.x_train.shape} train, {data.x_test.shape} "
        f"test, vocab {task.cfg.vocab_size} "
        f"({time.perf_counter() - t0:.1f} s)")

    def init():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return task.init_params(gen)

    kw = dict(task=task, batch_size=LM_BATCH, eval_every=LM_EVAL_EVERY,
              eval_samples=8, seed=0, secure=True, fused=True, tau=2.0,
              lam=0.0, device="cuda")
    # warm-up: the first round at these shapes picks the GEMM kernels
    t0 = time.perf_counter()
    runtime.run_alg1(data, part, params=init(), rounds=1, **kw)
    torch.cuda.synchronize()
    log(f"{name}: warm-up round in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    params, hist = runtime.run_alg1(data, part, params=init(),
                                    rounds=LM_ROUNDS, **kw)
    launches = {k: fn.launches for k, fn in kernels.items()}
    launches.update(variant_counts(kernels))
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    n_evals = LM_ROUNDS // LM_EVAL_EVERY
    want.update({layer_kernel: LM_LAYERS * (LM_ROUNDS + 2 * n_evals),
                 "ssca_update": LM_ROUNDS, "masked_sum": LM_ROUNDS})
    want[variant] = want[layer_kernel]
    want.update(server_variants(torch, n_params, LM_CLIENTS, LM_ROUNDS))
    log(f"{name}: launches over {LM_ROUNDS} rounds: {launches}")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    n = tree.numel(params)
    cost = hist.train_cost
    ln_v = math.log(task.cfg.vocab_size)
    log(f"{name}: {n} parameters; train cost {cost}, test accuracy "
        f"{hist.test_accuracy} (ln V = {ln_v:.4f})")
    if n != n_params:
        raise AssertionError(f"{name}: {n} parameters, want {n_params}")
    if not all(math.isfinite(c) for c in cost + hist.test_accuracy):
        raise AssertionError(f"{name}: metrics not finite: {hist.metrics}")
    if not ln_v - 1 <= cost[0] <= ln_v + 3:
        raise AssertionError(f"{name}: first cost {cost[0]} outside "
                             f"[ln V - 1, ln V + 3]")
    # the ledger, from the parameter shapes alone (meta tensors, no data)
    shapes = tree.map(lambda w: torch.empty(w.shape, dtype=w.dtype,
                                            device="meta"), params)
    alg = protocol.SSCAUnconstrained(
        loss_fn=SumLoss(task), hp=ssca.SSCAHyperParams(tau=2.0, lam=0.0))
    ledger = compression.round_bytes(alg, aggregation.secure(), None, shapes,
                                     LM_CLIENTS)
    want_up = LM_CLIENTS * (4 * n_params + 4 * (LM_CLIENTS - 1))
    if not hist.uplink_bytes_per_round == ledger.uplink_total == want_up:
        raise AssertionError(f"{name}: ledger {hist.uplink_bytes_per_round}"
                             f" B uplink, round_bytes {ledger.uplink_total},"
                             f" want {want_up}")
    log(f"{name}: ledger {hist.uplink_bytes_per_round} uplink bytes per "
        f"round = {LM_CLIENTS} x (4 x {n_params} + 4 x {LM_CLIENTS - 1})")
    round_s = hist.wall_seconds / LM_ROUNDS
    log(f"{name}: round time {round_s * 1e3:.1f} ms (I={LM_CLIENTS}, "
        f"B={LM_BATCH}, S={LM_SEQ}, eval every {LM_EVAL_EVERY} rounds "
        f"included), peak device memory {peak / 2 ** 30:.2f} GiB "
        f"({peak} B) on {card}")
    del params
    torch.cuda.empty_cache()

    # one more round under the profiler (its eval point included)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, h_prof = runtime.run_alg1(data, part, params=init(), rounds=1,
                                     **kw)
    us, top_other = device_us_by_kind(torch, prof)
    busy = sum(v for k, v in us.items() if k != "staging_htod")
    # where the host spends the round, for the device's idle share
    host = sorted(((e.key[:60], e.self_cpu_time_total)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])[:6]
    log(f"{name}: profile of one round:", json.dumps({
        "profiled_wall_ms": h_prof.wall_seconds * 1e3, "device_us": us,
        "device_busy_share_of_round_loop":
            busy / (h_prof.wall_seconds * 1e6),
        "largest_other_us": top_other, "largest_host_self_us": host}))
    torch.cuda.empty_cache()
    return launches, us


def phase_tau_witness(torch, runtime, name, arch):
    """``arch``'s full-width path again at τ = 2, 8 and 32 (the server's
    step shrinks about as 1/τ), 4 rounds with the cost read after each:
    whether the rise of the cost after round 2 at τ = 2 comes from the
    step size or from the port.  Fails only on a cost that is not
    finite."""
    from repro_torch.data import partition
    task, data = lm_full_width(arch)
    part = partition.iid(len(data.x_train), LM_CLIENTS, seed=0)
    costs = {}
    for tau in (2.0, 8.0, 32.0):
        gen = torch.Generator(device="cuda").manual_seed(0)
        _, hist = runtime.run_alg1(
            data, part, params=task.init_params(gen), task=task,
            batch_size=LM_BATCH, rounds=LM_ROUNDS, eval_every=1,
            eval_samples=8, seed=0, secure=True, fused=True, tau=tau,
            lam=0.0, device="cuda")
        costs[tau] = hist.train_cost
        if not all(math.isfinite(c) for c in hist.train_cost):
            raise AssertionError(f"{name}: cost not finite at tau {tau}: "
                                 f"{hist.train_cost}")
        del hist
        torch.cuda.empty_cache()
    log(f"{name}: train cost after rounds 1..{LM_ROUNDS} by tau:",
        json.dumps(costs))


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
    reset_counts({"ssca_update": su.ssca_update_2d,
                  "masked_sum": sa.masked_sum_2d})
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


# the compressed paths: (name, compressor, secure, launches over ROUNDS
# rounds, uplink bytes per round, downlink bytes per round)
def compressed_paths():
    from repro_torch.fed import compression, sketch
    per = ROUNDS
    return [
        ("topk8_secure", compression.topk(0.1, bits=8), True,
         {"compress": per, "sketch_encode": 0, "masked_sum": per,
          "ssca_update": per, "flash_attention": 0, "rwkv6_wkv": 0},
         4_065_640, 4_065_280),
        ("qsgd8_plain", compression.qsgd(8), False,
         {"compress": 2 * per, "sketch_encode": 0, "masked_sum": 0,
          "ssca_update": per, "flash_attention": 0, "rwkv6_wkv": 0},
         1_016_400, 4_065_280),
        ("sketch_secure", sketch.sketch(4, 1024, 0.02, keep=256), True,
         {"compress": 0, "sketch_encode": per, "masked_sum": 2 * per,
          "ssca_update": per, "flash_attention": 0, "rwkv6_wkv": 0},
         245_520, 4_146_600),
    ]


CARD_CPU_ROUNDS = 5


def device_us_by_kind(torch, prof):
    """Device time (µs) of one profiled run, summed by kind: each port
    kernel, the GEMMs (cuBLAS), host-to-device staging and the rest; and
    the five largest names among the "other" kind."""
    kinds = ("masked_sum", "ssca_update", "compress", "sketch_encode",
             "flash_attention", "rwkv6_wkv")
    us = {k: 0.0 for k in kinds}
    us.update(gemm=0.0, staging_htod=0.0, other=0.0)
    other = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = next((k for k in kinds if f"{k}_kernel" in name), None)
        if kind is None:
            kind = ("staging_htod" if "htod" in name else
                    "gemm" if any(t in name for t in ("gemm", "cutlass",
                                                      "xmma", "cublas",
                                                      "nvjet"))
                    else "other")
        us[kind] += e.time_range.elapsed_us()
        if kind == "other":
            other[e.name[:80]] = other.get(e.name[:80], 0.0) \
                + e.time_range.elapsed_us()
    return us, sorted(other.items(), key=lambda kv: -kv[1])[:5]


def phase_compressed_paths(torch, kernels, data, part, params, runtime,
                           card):
    """The compressed and sketched uploads at full width on the card, with
    counted launches; returns the launches of each path."""
    from torch.profiler import ProfilerActivity, profile
    by_path = {}
    for name, comp, secure, want, up, down in compressed_paths():
        kw = dict(batch_size=100, eval_every=10, seed=0, secure=secure,
                  fused=True, params=params, compressor=comp)
        reset_counts(kernels)
        p_gpu, h_gpu = runtime.run_alg1(data, part, device="cuda",
                                        rounds=ROUNDS, **kw)
        launches = {k: fn.launches for k, fn in kernels.items()}
        log(f"{name}: launches over {ROUNDS} rounds: {launches}")
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        by_path[name] = {**launches, **variant_counts(kernels)}
        if (h_gpu.uplink_bytes_per_round, h_gpu.downlink_bytes_per_round) \
                != (up, down):
            raise AssertionError(
                f"{name}: ledger {h_gpu.uplink_bytes_per_round} up, "
                f"{h_gpu.downlink_bytes_per_round} down; want {up}, {down}")
        cost = h_gpu.train_cost
        if not all(math.isfinite(c) for c in cost):
            raise AssertionError(f"{name}: train cost not finite: {cost}")
        if not name.startswith("sketch") and not cost[-1] < cost[0]:
            raise AssertionError(f"{name}: train cost not falling: {cost}")
        log(f"{name}: ledger {up} uplink / {down} downlink bytes per round; "
            f"train cost {cost}, test accuracy {h_gpu.test_accuracy}")
        log(f"{name}: round time {h_gpu.wall_seconds / ROUNDS * 1e3:.3f} ms "
            f"(I={CLIENTS}, B=100, eval every 10 rounds included) on {card}")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, h_prof = runtime.run_alg1(data, part, device="cuda",
                                         rounds=ROUNDS, **kw)
        us, top_other = device_us_by_kind(torch, prof)
        busy = sum(v for k, v in us.items() if k != "staging_htod")
        log(f"{name}: profile:", json.dumps({
            "rounds": ROUNDS, "profiled_wall_ms": h_prof.wall_seconds * 1e3,
            "device_us": us, "device_busy_share_of_round_loop":
                busy / (h_prof.wall_seconds * 1e6),
            "largest_other_us": top_other}))

        # the card against the port's CPU run, over fewer rounds
        short = dict(kw, rounds=CARD_CPU_ROUNDS, eval_every=1)
        p_gpu, h_gpu = runtime.run_alg1(data, part, device="cuda", **short)
        t0 = time.perf_counter()
        p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **short)
        cpu_s = time.perf_counter() - t0
        diffs = {k: max(abs(a - b) / abs(b) for a, b in
                        zip(h_gpu.metrics[k], h_cpu.metrics[k]))
                 for k in ("train_cost", "sparsity")}
        diffs["test_accuracy_abs"] = max(
            abs(a - b) for a, b in zip(h_gpu.test_accuracy,
                                       h_cpu.test_accuracy))
        diffs["params_abs"] = max(
            float((p_gpu[k].cpu() - p_cpu[k]).abs().max()) for k in p_cpu)
        log(f"{name}: card vs CPU over {CARD_CPU_ROUNDS} rounds:",
            json.dumps(diffs), f"(CPU run {cpu_s:.1f} s)")
        # tolerance: the card's and the CPU's gradients differ in their
        # last bits, and stochastic rounding (qsgd, the top-k levels, the
        # sketch's grid) can then round a level the other way, a
        # difference of one lattice step in one weight, which later
        # rounds carry; the top-k threshold can likewise keep another
        # entry.  The costs move far less.  Measured on an H100: cost
        # and sparsity 1.5e-7 relative, accuracy 3e-8, weights 1.8e-4
        # (topk8_secure), 7.9e-6 (qsgd8_plain), 4.0e-6 (sketch_secure).
        limits = {"train_cost": 1e-4, "sparsity": 1e-4,
                  "test_accuracy_abs": 2e-3, "params_abs": 2e-3}
        if h_gpu.comm != h_cpu.comm:
            raise AssertionError(f"{name}: card and CPU ledgers differ")
        for k, lim in limits.items():
            if not diffs[k] <= lim:
                raise AssertionError(f"{name}: card run drifts from CPU run: "
                                     f"{k} {diffs[k]} > {lim}")
    return by_path


# the paper's other algorithms (Figs. 1-3) on the main path's data and
# weights: (name, runtime entry, arguments, launches over ROUNDS rounds
# other than 0, uplink bytes per round; downlink is 4,065,280 on each)
def paper_paths():
    from repro_torch.fed import aggregation, compression
    per = ROUNDS
    fedavg = dict(local_steps=2, lr_a=2.0, lr_alpha=0.3, batch_size=50)
    return [
        ("alg2_plain", "run_alg2", dict(limit_u=0.13, batch_size=100),
         {}, 4_065_320),
        ("alg2_secure", "run_alg2",
         dict(limit_u=0.13, secure=True, batch_size=100),
         {"masked_sum": per}, 4_065_680),
        ("fedsgd_secure", "run_fedsgd",
         dict(aggregation=aggregation.secure(), lr_a=2.0, lr_alpha=0.3,
              batch_size=100), {"masked_sum": per}, 4_065_640),
        ("fedavg_secure", "run_fedavg",
         dict(fedavg, aggregation=aggregation.secure()),
         {"masked_sum": per}, 4_065_640),
        ("fedavg_topk8_secure", "run_fedavg",
         dict(fedavg, aggregation=aggregation.secure(),
              compressor=compression.topk(0.1, bits=8)),
         {"compress": per, "masked_sum": per}, 4_065_640),
    ]


def phase_paper_algorithms(torch, kernels, data, part, params, runtime,
                           card):
    """Algorithm 2 and the FedSGD / FedAvg baselines at full width on the
    card, with counted launches, the ledger, Algorithm 2's slack, and a
    5-round run held to the port's CPU run; returns each path's
    launches."""
    by_path = {}
    for name, entry, extra, nonzero, up in paper_paths():
        run = getattr(runtime, entry)
        kw = dict(extra, eval_every=10, seed=0, params=params)
        reset_counts(kernels)
        p_gpu, h_gpu = run(data, part, device="cuda", rounds=ROUNDS, **kw)
        launches = {k: fn.launches for k, fn in kernels.items()}
        want = {k: nonzero.get(k, 0) for k in kernels}
        log(f"{name}: launches over {ROUNDS} rounds: {launches}")
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        by_path[name] = {**launches, **variant_counts(kernels)}
        if (h_gpu.uplink_bytes_per_round, h_gpu.downlink_bytes_per_round) \
                != (up, 4_065_280):
            raise AssertionError(
                f"{name}: ledger {h_gpu.uplink_bytes_per_round} up, "
                f"{h_gpu.downlink_bytes_per_round} down; want {up}, "
                "4065280")
        cost = h_gpu.train_cost
        if not all(math.isfinite(c) for c in cost):
            raise AssertionError(f"{name}: train cost not finite: {cost}")
        if entry == "run_alg2":
            if not all(math.isfinite(v) and v >= 0.0 for v in h_gpu.slack):
                raise AssertionError(f"{name}: slack {h_gpu.slack}")
            log(f"{name}: final train cost {cost[-1]} against U = "
                f"{extra['limit_u']}, slack {h_gpu.slack}")
        log(f"{name}: ledger {up} uplink bytes per round; train cost "
            f"{cost}, test accuracy {h_gpu.test_accuracy}; round time "
            f"{h_gpu.wall_seconds / ROUNDS * 1e3:.3f} ms (I={CLIENTS}, "
            f"B={extra['batch_size']}, eval every 10 rounds included) on "
            f"{card}")

        short = dict(kw, rounds=CARD_CPU_ROUNDS, eval_every=1)
        p_gpu, h_gpu = run(data, part, device="cuda", **short)
        t0 = time.perf_counter()
        p_cpu, h_cpu = run(data, part, device="cpu", **short)
        cpu_s = time.perf_counter() - t0
        diffs = card_vs_cpu(h_gpu, h_cpu, p_gpu, p_cpu)
        diffs["slack_abs"] = max(abs(a - b) for a, b in
                                 zip(h_gpu.slack, h_cpu.slack))
        log(f"{name}: card vs CPU over {CARD_CPU_ROUNDS} rounds:",
            json.dumps(diffs), f"(CPU run {cpu_s:.1f} s)")
        # tolerance: the main path's, as the card's and the CPU's
        # matmuls round differently and a gradient entry can cross a
        # 2^-20 grid point of the secure quantizer; the slack (about 2)
        # to 1.5e-5 relative; top-k's levels as the compressed paths'.
        # Measured on an H100: cost 1.1e-7 to 2.1e-7 relative, accuracy
        # 6e-8, weights 3.7e-8 (alg2_plain), 4.0e-6 (alg2_secure), 1.9e-6
        # (fedsgd_secure), 6.7e-6 (fedavg_secure, two local steps), 0
        # (fedavg_topk8_secure); slack 3.8e-6.
        limits = {"train_cost": 1e-5, "test_accuracy_abs": 1e-3,
                  "params_abs": 5e-5, "slack_abs": 3e-5}
        if "compressor" in extra:
            limits.update(train_cost=1e-4, params_abs=2e-3)
        if h_gpu.comm != h_cpu.comm or h_gpu.rounds != h_cpu.rounds:
            raise AssertionError(f"{name}: card and CPU ledgers differ")
        for k, lim in limits.items():
            if not diffs[k] <= lim:
                raise AssertionError(f"{name}: card run drifts from CPU run: "
                                     f"{k} {diffs[k]} > {lim}")
    return by_path


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


def wkv_work(n, s, h, d):
    """(bytes, {"tf32": product FLOPs, "f32": elementwise FLOPs}, chunk) of
    the WKV scan at (N, S, H, D) with bf16 r/k/v, f32 lw and o, and a
    shared f32 u (H, D): each input read once, the output written once.
    The operations are those of the chunked form at the chunk length T
    (T = 1 is the per-token recurrence) whose least time is the least,
    the products at the TF32 tensor-core rate (the kernel's f32 operands
    need more than bf16) and the elementwise terms at the f32 rate, on
    their separate units.  For each (sequence, head) and chunk of t
    tokens: products, the in-chunk pairs j < t only, 2 D each for the
    score and for its product with v; the carry r·S_in (2 D² a token, none
    in the first chunk, whose state is zero); the state update's k_decᵀv
    (2 D² a token, none after the last chunk); elementwise, 15 D a token
    (the prefix sum of lw, r·e^{cum−lw}, k·e^{−cum}, k·e^{total−cum}, the
    bonus r·u·k and its product with v, the sum of the three terms) and
    the decay of the state, D² + D a chunk (none after the last)."""
    nbytes = n * s * h * d * (3 * 2 + 4 + 4) + h * d * 4

    def ops(t_max):
        c = -(-s // t_max)
        lens = [t_max] * (c - 1) + [s - t_max * (c - 1)]
        prod = sum(2 * d * t * (t - 1) + (2 * d * d * t if i else 0)
                   + (2 * d * d * t if i < c - 1 else 0)
                   for i, t in enumerate(lens))
        elem = sum(15 * d * t + (d * d + d if i < c - 1 else 0)
                   for i, t in enumerate(lens))
        return {"tf32": n * h * prod, "f32": n * h * elem}

    def least(t_max):
        w = ops(t_max)
        return max(w["tf32"] / TF32_FLOPS_PER_S, w["f32"] / FP32_FLOPS_PER_S)

    chunk = min(range(1, s + 1), key=least)
    return nbytes, ops(chunk), chunk


def sdpa_backend(torch, lib_inputs, enable_gqa=True):
    """The backend PyTorch's own selection gives causal
    ``scaled_dot_product_attention`` on ``lib_inputs`` (for example
    ``MATH`` or ``EFFICIENT_ATTENTION``)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        *lib_inputs, is_causal=True, enable_gqa=enable_gqa)).name


def phase_timing(torch, su, sa, kc, ks, fa, rw, launches, by_path, errs,
                 flash_stats):
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
    ms_alu = n * CLIENTS * (CLIENTS - 1) * ALU_OPS_PER_STREAM
    # compress at the top-k path's shape and scalars; each input read
    # once (x, 2 int64 and 2 f32 scalars a client), each output written
    # once (out, residual)
    csu, csf, clb = compress_inputs(torch, msgs, topk_frac=0.1)
    ckw = dict(lbound=clb, quantize=True, masked=True)
    c_bytes = 3 * CLIENTS * n * 4 + CLIENTS * (2 * 8 + 2 * 4)
    c_int, c_f32 = CLIENTS * n * OPS_PRF_WORD, CLIENTS * n * FLOPS_COMPRESS
    # sketch_encode at the sketched path's shape: a top-256 message; the
    # hash work runs only for the levels this data rounds to nonzero
    sx = presparsified(torch, msgs, 256)
    ssu = stream_scalars(torch, CLIENTS, 0, 0x5EEDC0DE)
    sk_rows, sk_cols = SKETCH_PATH
    skw = dict(rows=sk_rows, cols=sk_cols, scale_bits=SCALE_BITS)
    live = int((sx != 0).sum())
    nonzero = int((ks.round_to_grid(
        sx.reshape(CLIENTS, -1), ks.counters(ssu, n), ssu[:, 0:1],
        SCALE_BITS) != 0).sum())
    s_bytes = CLIENTS * n * 4 + CLIENTS * 3 * 8 \
        + CLIENTS * sk_rows * sk_cols * 4
    s_int = live * OPS_PRF_WORD + nonzero * sk_rows * OPS_SKETCH_ROW
    s_f32 = CLIENTS * n + live * FLOPS_SKETCH
    log(f"sketch_encode timing input: {live} nonzero elements, {nonzero} "
        f"nonzero levels of {CLIENTS * n}")
    # flash attention: each input read once and the output written once;
    # the causal half of Q.K^T and P.V, 2·Dh FLOPs per (query, visible
    # key) pair for each.  The wgmma variant at the LM path's shape, at
    # the bf16 tensor-core peak (the inputs' type).  The tf32x3 variant
    # at the small LM's f32 shape and at FLASH_F32_WIDE: f32-accurate
    # FLOPs take either f32 FMAs at the SIMT peak or three TF32 passes at
    # the tensor cores' rate, and the least time is the faster route
    # (the three passes, at a third of 495 TFLOP/s, against 67)
    def flash_work(b, s, h, hkv, dh, dtype, seed):
        x = flash_inputs(torch, b, s, h, hkv, dh, dtype, seed=seed)
        nbytes = x[0].element_size() * (2 * x[0].numel() + 2 * x[1].numel())
        # the library's layout is (B, H, S, Dh): transposed once, outside
        # the timed call
        lib = tuple(t.transpose(1, 2).contiguous() for t in x)
        return x, lib, nbytes, 2 * 2 * dh * b * h * s * (s + 1) // 2

    def f32_route(flops):
        kind = min(("f32", "tf32x3"), key=lambda k: flops / RATES[k])
        return {kind: flops}

    fx, flib, f_bytes, f_flops = flash_work(*FLASH_PATH, torch.bfloat16, 2)
    sx_, slib, fs_bytes, fs_flops = flash_work(*FLASH_SMALL, torch.float32,
                                               2)
    wx, wlib, fw_bytes, fw_flops = flash_work(*FLASH_F32_WIDE, torch.float32,
                                              2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_backends = {"flash_attention_tf32x3": sdpa_backend(torch, slib),
                     "flash_attention_f32_wide": sdpa_backend(torch, wlib)}
    # the WKV scan at the RWKV path's shape, model-like decays; no single
    # PyTorch call computes it
    wkx = wkv_inputs(torch, *WKV_PATH, torch.bfloat16, seed=2)
    w_bytes, w_ops, w_chunk = wkv_work(*WKV_PATH)
    rows = []
    # the flash row is the wgmma kernel's; the tf32x3 kernel has a row at
    # the small LM's shape and a timing row at FLASH_F32_WIDE, a width no
    # path runs in f32, whose launches are 0
    launch_key = {"flash_attention": "flash_attention_wgmma",
                  "rwkv6_wkv": "rwkv6_wkv_mma"}
    timing_only = {"flash_attention_f32_wide"}
    for name, src, replaces, kern, plain, library, nbytes, ops in (
            ("ssca_update", "src/repro_torch/kernels/csrc/ssca_update.cu",
             "src/repro/kernels/ssca_update.py:54",
             lambda: su.ssca_update_2d(w, lin, grad, beta, sc),
             lambda: su.ssca_update_plain(w, lin, grad, beta, sc), None,
             ssca_bytes, {"f32": FLOPS_SSCA * n}),
            ("masked_sum", "src/repro_torch/kernels/csrc/secure_agg.cu",
             "src/repro/kernels/secure_agg.py:346",
             lambda: sa.masked_sum_2d(msgs, 1, 2, **kw),
             lambda: sa.masked_sum_plain(msgs, 1, 2, **kw), None,
             ms_bytes, {"int32": ms_ops, "int32_alu": ms_alu}),
            ("compress", "src/repro_torch/kernels/csrc/compress.cu",
             "src/repro/kernels/compress.py:142",
             lambda: kc.compress_2d(msgs, csu, csf, **ckw),
             lambda: kc.compress_2d_plain(msgs, csu, csf, **ckw), None,
             c_bytes, {"int32": c_int, "f32": c_f32}),
            ("sketch_encode", "src/repro_torch/kernels/csrc/sketch.cu",
             "src/repro/kernels/sketch.py:166",
             lambda: ks.sketch_encode(sx, ssu, **skw),
             lambda: ks.sketch_encode_plain(sx, ssu, **skw), None,
             s_bytes, {"int32": s_int, "f32": s_f32}),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:78",
             lambda: fa.flash_attention_bhsd(*fx),
             lambda: fa.flash_attention_plain(*fx),
             lambda: sdpa(*flib, is_causal=True, enable_gqa=True),
             f_bytes, {"bf16": f_flops}),
            ("flash_attention_tf32x3",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:78",
             lambda: fa.flash_attention_bhsd(*sx_),
             lambda: fa.flash_attention_plain(*sx_),
             lambda: sdpa(*slib, is_causal=True, enable_gqa=True),
             fs_bytes, f32_route(fs_flops)),
            ("flash_attention_f32_wide",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:78",
             lambda: fa.flash_attention_bhsd(*wx),
             lambda: fa.flash_attention_plain(*wx),
             lambda: sdpa(*wlib, is_causal=True, enable_gqa=True),
             fw_bytes, f32_route(fw_flops)),
            ("rwkv6_wkv", "src/repro_torch/kernels/csrc/rwkv6_scan_sm90.cu",
             "src/repro/kernels/rwkv6_scan.py:71",
             lambda: rw.rwkv6_wkv_bh(*wkx), lambda: rw.wkv_plain(*wkx),
             None, w_bytes, w_ops)):
        # each kind of work at its rate; integer and f32 work run on
        # separate pipes, and the ALU pipe takes only part of the integer
        # work: the least time is the largest part.  compress and
        # sketch_encode count their integer work at the issue ceiling
        # only: their bytes bound them well above it
        parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        parts.update({k: v / RATES[k] * 1e3 for k, v in ops.items()})
        bytes_ms = parts["bytes"]
        ops_ms = max(v for k, v in parts.items() if k != "bytes")
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (0 if name in timing_only
                         else launches[launch_key.get(name, name)]),
            "launches_by_path": ({} if name in timing_only else
                                 {p: v.get(launch_key.get(name, name), 0)
                                  for p, v in by_path.items()}),
            "max_abs_err": errs[name], "ms": time_ms(kern),
            "plain_ms": time_ms(plain, iters=5, repeats=3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if library is None else time_ms(library),
            "bound_parts_ms": parts})
        if name == "masked_sum":
            rows[-1]["launches_by_variant"] = {
                v: launches[f"masked_sum_{v}"]
                for v in sa.masked_sum_2d.launches_by_variant}
        if name.startswith("flash_attention"):
            rows[-1]["shape"] = list(
                {"flash_attention": FLASH_PATH,
                 "flash_attention_tf32x3": FLASH_SMALL}.get(name,
                                                            FLASH_F32_WIDE))
            rows[-1]["achieved_tflops"] = sum(ops.values()) \
                / (rows[-1]["ms"] * 1e-3) / 1e12
        if name in sdpa_backends:
            # the f32 FLOPs at the other route's rate, for the record
            flops = sum(ops.values())
            rows[-1]["bound_parts_ms"]["routes_ms"] = {
                k: flops / RATES[k] * 1e3 for k in ("f32", "tf32x3")}
            rows[-1]["library_backend"] = sdpa_backends[name]
        if name == "flash_attention_f32_wide":
            # SDPA takes its math backend for grouped heads in f32; on k/v
            # repeated G-fold beforehand (outside the timed call) its
            # memory-efficient one, for the record
            g = FLASH_F32_WIDE[2] // FLASH_F32_WIDE[3]
            rep = (wlib[0], *(t.repeat_interleave(g, dim=1)
                              for t in wlib[1:]))
            rows[-1]["library_repeated_kv_ms"] = time_ms(
                lambda: sdpa(*rep, is_causal=True))
            rows[-1]["library_repeated_kv_backend"] = sdpa_backend(
                torch, rep, enable_gqa=False)
            del rep
        if name == "flash_attention":
            rows[-1]["bf16_check"] = flash_stats
        if name == "rwkv6_wkv":
            rows[-1]["shape"] = list(WKV_PATH)
            rows[-1]["launches_by_variant"] = {
                v: launches[f"rwkv6_wkv_{v}"]
                for v in rw.rwkv6_wkv_bh.launches_by_variant}
        log(f"{name}: {time_ms(kern, graph=False):.4f} ms a call when "
            "launched eagerly from Python (wrapper overhead included)")
    floor = launch_floor_ms(torch)
    for row in rows:
        if row["name"] in ("masked_sum", "ssca_update", "sketch_encode",
                           "flash_attention_tf32x3"):
            row["launch_floor_ms"] = floor
    log(f"launch floor: {floor * 1e3:.4f} us a launch of an empty kernel "
        f"(graph replay), beside ssca_update {rows[0]['ms'] * 1e3:.4f} us, "
        f"masked_sum {rows[1]['ms'] * 1e3:.4f} us and sketch_encode "
        f"{rows[3]['ms'] * 1e3:.4f} us at the MLP shape")
    log(f"rwkv6_wkv bound at (N, S, H, D) = {WKV_PATH}: "
        f"{w_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes ({w_bytes} B), "
        f"{w_ops['tf32'] / TF32_FLOPS_PER_S * 1e3:.4f} ms by products "
        f"({w_ops['tf32']} FLOP at the TF32 rate), "
        f"{w_ops['f32'] / FP32_FLOPS_PER_S * 1e3:.4f} ms by elementwise "
        f"terms ({w_ops['f32']} f32 FLOP), the chunked form at chunk "
        f"{w_chunk}, the causal pairs only")
    return rows


def full_width_rows(rows, by_path, profiled, direct):
    """The server-side kernels at the full-width LM paths' shapes: the
    ``masked_sum`` and ``ssca_update`` rows gain, for each path, the
    launches, the device time of the profiled round's one launch, the
    time of :func:`server_kernels_full_width`'s direct launches, and the
    bound at that path's padded parameter count (I = 4 clients)."""
    for row in rows:
        if row["name"] not in ("masked_sum", "ssca_update"):
            continue
        row["full_width"] = {}
        for path, n in FULL_WIDTH.items():
            n = -(-n // 128) * 128
            if row["name"] == "masked_sum":
                nbytes = (LM_CLIENTS * n + n) * 4
                ops = n * LM_CLIENTS * ((LM_CLIENTS - 1) * OPS_PER_STREAM
                                        + OPS_PER_ROW)
                alu = n * LM_CLIENTS * (LM_CLIENTS - 1) * ALU_OPS_PER_STREAM
                ops_ms = max(ops / INT32_OPS_PER_S,
                             alu / INT32_ALU_OPS_PER_S) * 1e3
            else:
                nbytes = (7 * n + 4) * 4
                ops_ms = FLOPS_SSCA * n / FP32_FLOPS_PER_S * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row["full_width"][path] = {
                "elements": n,
                "launches": by_path[path][row["name"]],
                "ms": profiled[path][row["name"]] / 1e3,
                "direct_ms": direct[path][f"{row['name']}_ms"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_parts_ms": {"bytes": bytes_ms, "operations": ops_ms}}
        log(f"{row['name']} at the full-width LM paths (ms: the profiled "
            "round's launch; direct_ms: the median of 5 eager launches):",
            json.dumps(row["full_width"]))


def main() -> int:
    # the full-width LM path allocates and frees many tensors of 4-8 GB;
    # growable segments keep the freed ones reusable (set before CUDA
    # starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    from repro_torch.kernels import compress as kc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.kernels import sketch as ks
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
    log("flash_attention (registers a thread, spill bytes a thread, shared "
        "bytes a block) by head dim:", json.dumps(
            {dh: fa.kernel_attributes(dh) for dh in fa.HEAD_DIMS}))
    log("rwkv6_wkv (registers a thread, spill bytes a thread, shared bytes "
        "a block) by instance:", json.dumps(rw.kernel_attributes()))
    log("masked_sum (registers a thread, spill bytes a thread, shared bytes "
        "a block):", json.dumps(sa.kernel_attributes()))
    stream_loop_mix()

    errs = phase_kernel_parity(torch, su, sa)
    errs["flash_attention"], f32_err, flash_stats = phase_flash_parity(torch)
    errs["flash_attention_tf32x3"] = f32_err[FLASH_SMALL]
    errs["flash_attention_f32_wide"] = f32_err[FLASH_F32_WIDE]
    errs["rwkv6_wkv"] = phase_wkv_parity(torch)

    t0 = time.perf_counter()
    data = synthetic.classification_dataset(60000, 10000, seed=0)
    part = partition.iid(60000, CLIENTS, seed=0)
    params = model.init_params(torch.Generator().manual_seed(0), 784, 128, 10)
    log(f"data: {data.x_train.shape} train, {data.x_test.shape} test "
        f"({time.perf_counter() - t0:.1f} s)")
    kernels = {"ssca_update": su.ssca_update_2d,
               "masked_sum": sa.masked_sum_2d, "compress": kc.compress_2d,
               "sketch_encode": ks.sketch_encode,
               "flash_attention": fa.flash_attention_bhsd,
               "rwkv6_wkv": rw.rwkv6_wkv_bh}
    reset_counts(kernels)
    _, hist = phase_main_path(torch, su, sa, data, part, params, runtime)
    log(f"round time {hist.wall_seconds / ROUNDS * 1e3:.3f} ms "
        f"(secure fused, I={CLIENTS}, B=100, eval every 10 rounds "
        f"included) on {card}")
    by_path = {"secure_dense": {k: fn.launches
                                for k, fn in kernels.items()}}
    by_path["secure_dense"].update(variant_counts(kernels))
    log(f"main path launches by variant: {variant_counts(kernels)}")
    if any(by_path["secure_dense"][k] for k in ("compress", "sketch_encode",
                                                "flash_attention",
                                                "rwkv6_wkv")):
        raise AssertionError(f"main path launched a compressor or "
                             f"sequence-mixing kernel: "
                             f"{by_path['secure_dense']}")
    by_path.update(phase_compressed_paths(torch, kernels, data, part, params,
                                          runtime, card))
    t0 = time.perf_counter()
    by_path.update(phase_paper_algorithms(torch, kernels, data, part, params,
                                          runtime, card))
    log(f"paper algorithms phase: {time.perf_counter() - t0:.1f} s")
    from repro_torch.fed.tasks import rwkv6_task, transformer_task
    lm_bf16_forward(torch)
    by_path["lm_small"] = phase_lm_small(torch, kernels, runtime, "lm_small",
                                         transformer_task(),
                                         "flash_attention",
                                         "flash_attention_tf32x3")
    profiled = {}
    by_path["lm_full_width"], profiled["lm_full_width"] = phase_lm_full(
        torch, kernels, runtime, card, "lm_full", "llama3-8b", LM_PARAMS,
        "flash_attention", "flash_attention_wgmma")
    by_path["rwkv_small"] = phase_lm_small(torch, kernels, runtime,
                                           "rwkv_small", rwkv6_task(),
                                           "rwkv6_wkv", "rwkv6_wkv_mma")
    by_path["rwkv_full_width"], profiled["rwkv_full_width"] = phase_lm_full(
        torch, kernels, runtime, card, "rwkv_full", "rwkv6-7b", RWKV_PARAMS,
        "rwkv6_wkv", "rwkv6_wkv_mma")
    phase_tau_witness(torch, runtime, "rwkv_full", "rwkv6-7b")
    total = {k: sum(p.get(k, 0) for p in by_path.values())
             for k in [*kernels, *variant_counts(kernels)]}
    log(f"launches over all paths: {total}")

    direct = server_kernels_full_width(torch, su, sa)
    log("masked_sum and ssca_update at the full-width LM paths' widths, "
        "direct launches, checked against Σ quantize(m_i) and the plain "
        "update:", json.dumps(direct))
    phase_profile(torch, data, part, params, runtime)
    rows = phase_timing(torch, su, sa, kc, ks, fa, rw, total, by_path, errs,
                        flash_stats)
    full_width_rows(rows, by_path, profiled, direct)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
