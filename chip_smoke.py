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
   fewer operations a stream than the bound below counts (the flash
   kernels' attributes for the causal, the banded and the unmasked
   instance of each head dim: 16, 32, 64, 96, 128 and 256 on both);
2. hold every kernel against its plain PyTorch version on the card, at
   the paths' shapes and at edge shapes, each launch counted on the
   variant its wrapper's launch plan names: ``ssca_update`` (both
   variants, ``beta`` and the β-less ``lambda0``, at (794, 128), (13, 128)
   and on views one element past 16-byte alignment) and ``compress``
   (both round every f32 operation separately), ``masked_sum``
   (``rowsplit`` under one wave of the card, ``vec`` past it, misaligned
   views, which the wrapper copies; dropouts, a client offset, 600
   clients whose streams pass one shared-memory table, one client's
   masked upload at ``client_offset = i``, Algorithm 2's upload at (10,
   795, 128)) and
   ``sketch_encode`` (ring arithmetic; at the path's 4 x 1024 sketch and
   at 8 x 16,384) bit for bit; ``flash_attention``
   to stated tolerances: its bf16 (wgmma) kernel, which rounds P to bf16
   before P·V, to ``bf16_error_check``'s bound against the f64 softmax,
   at the LM path's shape (B·I = 8, S = 1024, H = 32, Hkv = 8, Dh = 128)
   and at edge shapes (Dh 16, 32, 64 and 128; S = 1, 65, 77, 128, 129,
   160, 300 and 1024; G = 1, 4, 5, 8, 16 and 48), with SDPA's error
   against the same f64 softmax printed for the record, and at the moe
   serve forward's grouped heads (``phase_flash_moe_parity``: (4, 160,
   64, 4, 128), G = 16, and (4, 160, 40, 8, 128), G = 5); its f32
   (3xTF32) kernel within 2e-5 of the plain version (S = 1, 77 and 300,
   Dh 16, 64 and 128, the small LM's shape and llama3-8b's attention in
   f32); then the
   hybrid's instances (``phase_flash_band_parity``): the wgmma kernel at
   head dim 256 on the hybrid path's (4, 1024, 16, 1, 256) at window
   2048 (the path's; it covers S, so the causal instance runs, and its
   output equals window 0's bit for bit), 256 and 0, each to
   ``bf16_error_check``'s bound against the f64 softmax of its band,
   and the tf32x3 kernel's band within 2e-5 of the plain version at
   hybrid_small's (16, 32, 4, 1, 16) and at (4, 32, 4, 1, 16) (window
   16) and (2, 130, 4, 1, 64) (window 40); then the vlm's and audio's
   instances (``phase_flash_new_parity``), q (B, Sq, H, Dh) against k, v
   (B, Sk, Hkv, Dh): head dim 96 on both kernels at phi-3-vision's train
   forward (4, 1024, 1024, 32, 32, 96) and serve forward with its image
   (4, 736, 736, 32, 32, 96), causal, and a band on each; the wgmma
   kernel without causality at whisper's encoder (4, 1500, 1500, 20, 20,
   64) and cross-attention (4, 160, 1500, 20, 20, 64); the tf32x3 kernel
   without causality at Sq = Sk = 1,500, Sq 160 against Sk 1,500 and the
   reduced whisper's (8, 32, 16, 4, 4, 64), and at head dim 256 (causal
   at (4, 1024, 1024, 16, 1, 256), banded and non-causal); Sq > Sk (200
   against 64) and Sk = 16 on both, each to its kernel's tolerance
   against the plain version of the same mask;
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
   port's CPU run; then partial participation and async rounds
   (``phase_participation``), at the same data and weights: Algorithm 1
   fused with ``sampled(10)``, ``secure(num_sampled=10)`` and that with
   ``topk(0.1, bits=8)`` of I = 100 clients (20 rounds), a population of
   I = 10,000 clients of 6 samples with ``secure(num_sampled=8)`` and
   top-k (B = 6, 10 rounds, a 4.07 GB residual arena on the card), and
   async rounds over the main path's 10 clients with the trace of
   ``StalenessConfig(max_staleness=2, delay_probs=(0.5, 0.2, 0.15, 0.1,
   0.05))``: secure, drop-stragglers (K = 0), plain, FedAvg secure with
   top-k and Algorithm 1 secure with the sketch; check each path's
   launches (every async masked sum carries ``alive``, counted on
   ``launches_by_variant["alive"]``), its ledger with
   ``comm["async"]``, finite costs, its round time, device busy share
   and peak memory, and a 5-round run against the port's CPU run; check
   bit for bit that S = I is full participation, that an all-zero trace
   is the synchronous run (secure dense, FedAvg with top-k), that the
   population's residual rows of clients never drawn stay zero, and that
   the masked sum through ``alive`` is the survivors' quantized sum; and
   run rwkv_small under FedSGD with ``sampled(2)`` of 4 clients, its WKV
   launches counted; then the engine's single-device modes
   (``phase_engine_modes``), at the same data and weights, 20 rounds:
   the masked sum's ring mode (``masked_ring_sum_2d``, the hierarchical
   tree's level 2) first held bit for bit against its plain version
   (G = 2, 3, 16 and 600 groups, both variants, dropouts, a group offset,
   rows one element past alignment); ``hierarchical(secure(), G)`` at
   G = 2 and 3 (``masked_sum`` G times a round, the ring mode once; final
   weights bit for bit those of flat secure), at G = 2 with
   ``topk(0.1, bits=8)`` and with async rounds (the participation
   phase's K = 2 trace: 33 drops at 16 B each, the ``alive`` launches
   counted), ``pipeline=True`` flat and under the tree (bit for bit the
   async run at the constant τ ≡ 1 trace, no ``alive`` launch), and the
   pipelined secure run once more with ``profile_dir`` (its one trace
   file must name ``masked_sum_kernel``): each path's launches, ledger
   (the tree's edge hop included), ``comm`` entry, finite costs, round
   time, device time by kind, and a 5-round run against the port's CPU
   run; and a cohort of 512 of the 10,000-client population under
   ``hierarchical(secure(num_sampled=512), groups=16)`` beside flat
   ``secure(num_sampled=512)`` (B = 6, 10 rounds, the card only), after
   ``masked_sum`` is held bit for bit at its level-1 shape (32, 794, 128)
   under a folded group key: final weights bit for bit, the ledgers, root
   ingest and mask pairs by the reference's formulas, each path's
   masked-sum device time and round time;
5. drive the decoder-only LM (``transformer_task()``: llama3-8b cut to
   2 layers of width 64) secure and fused on the card for 5 rounds,
   counters set to 0 just before and read just after, and hold it to
   the port's CPU run of the same configuration; then the same for
   RWKV-6 (``rwkv6_task()``: rwkv6-7b cut to 2 layers of width 64); the
   LM paths run λ = 0, so their server update launches only ``lambda0``
   and keeps no β, where every MLP Algorithm-1 path (λ = 1e-5) launches
   only ``beta`` (``check_ssca_variants``);
6. drive the LM path at the full width of llama3-8b (2 of its 32
   layers): ``run_alg1(secure=True, fused=True, tau=2, lam=0)`` on 256
   Zipf token documents of 1,024 tokens over 4 iid clients, B = 2, 4
   rounds, eval every 2 rounds on 8 documents and the 8 test documents;
   check the launch counts (flash attention once per layer per upload
   forward for all clients and per eval forward, all of them the wgmma
   variant; the small LM's f32 ones all the tf32x3 variant), finite costs, the
   first cost within [ln V − 1, ln V + 3], the ledger against
   ``round_bytes`` computed from the parameter shapes; print the round
   time, the peak device memory and the device time by kind (the
   update's kernel, and the largest entries of "other") and busy share
   of one more round under ``torch.profiler``, and the "other" and
   device-to-device copy time of two more rounds with every tree copied
   and read in place (``copies_saved``); then the same for
   rwkv6-7b at full width (2 of its 32 layers), whose WKV scan launches
   its tensor-core kernel once per layer per forward; and rwkv6-7b's path once more at τ = 2,
   8 and 32 with the cost read after each of its 4 rounds (finite
   costs), to tell the step size from the port in the cost's rise;
   then the hybrid family: ``transformer_task("recurrentgemma-9b")``
   (3 layers of width 64, window 16) and its 5-layer cut (a unit and a
   recurrent tail of 2) as the small LM runs, against their CPU runs, the
   f32 flash kernel's band launched once a forward (one attention
   layer); and recurrentgemma-9b at full width, 3 of its 38 layers
   (n = 1,705,054,208), I = 2, B = 2, S = 1,024, τ = 8, eval every
   round, 4 rounds: the wgmma kernel's head-dim-256 instance once a
   forward, the costs after each round and τ printed, the first cost
   within [ln V − 1, ln V + 3], the ledger, the round time, the peak and
   a profiled round; then the moe family: ``transformer_task(
   "qwen3-moe-235b-a22b")`` (every layer MoE, top-2 of 4 experts) and
   ``("llama4-maverick-400b-a17b")`` (a dense block and a MoE block,
   top-1 and the shared expert), 2 layers of width 64, as the small LM
   runs, against their CPU runs (``moe_small``,
   ``moe_small_interleaved``);
   then the launch entry points (``phase_launch``), counters set to 0
   before each part and read after: ``launch.serve.serve_batch`` (no
   kernel launched; logits within 1e-4 of the largest of the CPU's,
   TF32 off; the tokens equal, or parted first at a near-tie) and one
   ``launch.steps.make_train_step`` (one ``lambda0`` launch; loss and
   parameters within 1e-5 of the CPU's) on the reduced llama3-8b and
   rwkv6-7b, and the reduced recurrentgemma-9b at 3 and 5 layers (16
   prompt and 16 new tokens: decode past its window of 16), and the
   reduced qwen3-moe and llama4-maverick (``launch_small_moe``: also a
   train step resumed from a checkpoint, bit for bit the uninterrupted
   one, and one on bf16 parameters that must return f32 ones);
   llama3-8b and rwkv6-7b at full width (2 of 32 layers), and
   recurrentgemma-9b (3 of 38),
   serving 8 ``synth_requests`` in batches of 4 (prompt 128, 32 new
   tokens): no launch in the decode loop, the decode logits against a
   teacher-forced ``forward`` over prompt and generated tokens and
   ``make_prefill_step`` against the decode at the last prompt token,
   within 2e-2 of the largest |logit|, the layer kernel (bf16 flash,
   WKV) once a layer a forward; llama3-8b at ``decode_window=64`` (finite,
   its first 64 positions within the same bound of the full cache's);
   qwen3-moe (2 of 94 layers) and llama4-maverick (2 of 48) in bf16,
   whose decode never drops: its checks run the forward and prefill at
   ``capacity_factor`` E / k (``dropless``: C > S, so they drop nothing;
   the reference's own check uses 8.0) on the experts decode chose, the
   forward's own choice differing only within ROUTE_TIE of a tie, and
   the forward at the config's 1.25 and at 8.0 gives the share it drops;
   the prefill and decode step times, tokens/s, peak memory and the
   decode step's byte floor, and a short batch (32 steps) profiled: a
   step's device time by kind, busy share and host CUDA calls; then
   ``launch/train.py``'s defaults at
   llama3-8b (2 layers, batch 8, seq 128) and recurrentgemma-9b (3
   layers; a 13.6 GB checkpoint): 4 steps (the first loss
   within [ln V − 1, ln V + 3], one ``lambda0`` launch a step), a
   checkpoint of the parameters and SSCA's lin after step 2 saved and
   restored in a temporary directory (removed after; seconds and bytes
   printed), and the resumed steps 3–4 bit for bit the uninterrupted
   ones; then the vlm and audio families: the reduced phi-3-vision and
   whisper as the small ones above (``serve_batch`` against the CPU,
   whisper's over stub frames through ``precompute_cross``: the f32
   kernel's unmasked instance once an encoder layer, none in decode; one
   train step on ``batch_stream``'s stub image or frame embeddings),
   phi-3-vision at full width (2 of 32 layers) served as above, its
   decode held to the dense model's forward on the same blocks over the
   text (the reference serves no image) and one forward a batch with 576
   stub image tokens (head dim 96 at S = 736), its text logits held to
   the same forward on the plain attention, and its train step at B =
   4, 1,024 tokens (576 image + 448 text); whisper at full width (2 of 32
   encoder and 2 of 32 decoder layers) served against (4, 1500, 1280)
   stub frames (the encoder once a batch, its time printed), its decode
   held to the teacher-forced forward on the same frames (the encoder
   non-causal at S = 1,500, the cross-attention at 160 against 1,500),
   and its train step at B = 8, S = 128 over (8, 1500, 1280) frames; each
   with a checkpoint after step 2, resumed bit for bit, and the launches
   of each part by mask (the wrapper's ``launches_by_mask``); then the
   production (data, model) mesh (``phase_production_mesh``): on a
   one-rank NCCL group, ``make_host_mesh()``: llama3-8b at full width
   (2 layers, batch 8, seq 128, τ = 2), 3 train steps bit for bit
   ``mesh=None`` (parameters and lin; the same wgmma and ``lambda0``
   launches), qwen3-moe (2 of 94 layers, bf16, (4, 160)) through
   the expert-parallel forward in both weight modes against ``moe_ffn``
   (equal drops, logits bit for bit), and rwkv6-7b, recurrentgemma-9b
   (3 layers), phi-3-vision (B = 4, 1,024 tokens) and whisper (2 + 2
   layers, 1,500 frames): 3 train steps and a prefill each, bit for bit
   ``mesh=None`` in parameters, lin, losses and prefill logits (the twin
   run's outputs kept on the host); then four gloo ranks on ``cuda:0``
   at (2, 2): the reduced llama3-8b (both ``act_tp``) and granite-34b
   (one kv head) train steps, the reduced qwen3-moe forward in both
   modes, and the reduced qwen3-moe, llama4-maverick, rwkv6-7b,
   recurrentgemma-9b, phi-3-vision and whisper train and prefill steps,
   the ranks bit for bit each other and within 1e-5 of the same cases in
   one process; every run's collectives by axes as predicted, the layer
   kernels' forwards twice a layer a step (the remat), step and forward
   times and peaks printed;
7. time ``masked_sum`` (I = 4) and both ``ssca_update`` variants
   directly at both full-width LM paths' widths, once those paths have
   freed their memory: the median of 5 eager launches after 2 warm-ups,
   from CUDA events, each output checked (the aggregate against
   Σ quantize(m_i), the update against its plain version bit for bit),
   and the ring mode (G = 2 group rows) at llama3-8b's width the same
   way, checked against the int32 sum; then run the main path once more
   under ``torch.profiler`` and print the device time by kind, the
   device's busy share of the round loop and the host's kernel
   launches, copies and fills a round, also with every tree copied;
8. time each kernel and its plain version on the paths' shapes (CUDA
   events around the replay of a CUDA graph of 50 calls, so the host's
   launch overhead does not gate the device), and, for flash attention,
   ``scaled_dot_product_attention`` as the library yardstick (the port
   never calls it; no single PyTorch call computes the WKV scan): the
   wgmma variant at the LM path's shape, with its achieved TFLOP/s, and
   the tf32x3 variant at the small LM's and at llama3-8b's attention in
   f32 (``flash_attention_f32_wide``, SDPA's backend named), the wgmma
   variant at head dim 256 on the hybrid path's shape at window 2048
   (``flash_attention_hd256``, the causal pairs) and at window 256
   (``flash_attention_hd256_band``, timing only: SDPA takes the band as
   a boolean mask), and the tf32x3 band at hybrid_small's shape
   (``flash_attention_tf32x3_band``), the wgmma variant at the moe serve
   forward's (4, 160, 64, 4, 128) and (4, 160, 40, 8, 128)
   (``flash_attention_g16``, ``flash_attention_g5``), and the vlm's and
   audio's: the wgmma kernel at head dim 96 at phi-3-vision's train and
   serve forwards (``flash_attention_hd96``, ``_hd96_serve``), without
   causality at whisper's encoder and cross-attention
   (``flash_attention_encoder``, ``flash_attention_cross``), the tf32x3
   kernel without causality at the reduced whisper's cross-attention
   (``flash_attention_tf32x3_noncausal``) and, timing only, at head dim
   96 (``flash_attention_tf32x3_hd96``) and 256
   (``flash_attention_f32_hd256``); each flash row counts the launches
   of its instance's paths (the hybrid's, the moe serves', the vlm's and
   audio's apart, these by instance); the launch
   floor, an empty kernel's graph replay, beside ``ssca_update`` (its
   ``beta`` variant; ``ssca_update_lambda0`` has a row of its own, each
   bound by its own bytes), ``masked_sum`` and ``sketch_encode`` at the
   MLP shape; each row gives
   its bound's parts (bytes, and each kind of operation at its rate; the
   masked sum's count only the streams its output needs,
   ``streams_needed``: none where every row is local), the
   ``masked_sum`` row its launches by variant, the ring mode's row
   (``masked_ring_sum``) its time at the S = 512 tree's level 2,
   (16, 794, 128) int32, and at llama3-8b's width, and both rows a
   ``shard`` timing where the streams are real (3 of 10 clients, 3 of
   16 groups, at offset 5),
   and the ``masked_sum`` and both ``ssca_update`` rows, for each
   full-width LM path, the launches, the profiled round's launch time
   (``lambda0`` only: those paths run λ = 0), the direct launches' time
   and the bound at that path's parameter count;
9. drive the client-sharded rounds (``phase_client_mesh``): first
   ``masked_sum`` against its plain version bit for bit at a rank's
   shard of the async paths, (5, 794, 128) at ``client_offset`` 5 of 10,
   with the dropouts of three rounds of their trace; then in a one-rank
   NCCL group (a ``FileStore`` in a temporary directory),
   ``mesh=make_client_mesh()`` on secure dense, ``topk(0.1, bits=8)`` +
   secure with arena ``"sharded"`` and ``"replicated"``, the secure
   sketch, FedAvg secure with top-k, ``secure(num_sampled=10)`` of 100
   clients and ``secure(num_sampled=3)`` of 10, and the participation
   phase's async paths (secure, drop-stragglers, plain, FedAvg secure
   with top-k, the secure sketch), ``pipeline=True`` secure and the
   async run at the constant τ ≡ 1 trace, 20 rounds each, counters set
   to 0 just before each run and read just after: each bit for bit its
   ``mesh=None`` run on the card (weights, every metric, ``comm``), the
   same launches (the ``alive`` ones as predicted), the predicted psum
   calls a round (``PERF.md`` §4), and each async and pipelined path bit
   for bit under arena ``"replicated"`` (the snapshot ring as a list)
   against ``"sharded"`` (the packed ring, column-sharded); the vmapped
   upload over 2 x 5 slots against 10 on the card; then two spawned gloo
   ranks sharing ``cuda:0``: ``ring_psum_chunked`` bit for bit the psum
   on the reference's mixed tree (int32 and f32 leaves on the card,
   staged through host memory), then secure dense, the cohort of 3
   (padded to 4), the sketch, FedAvg with top-k, async secure, pipelined
   secure, async τ ≡ 1 secure and async FedAvg with top-k: the ranks bit
   for bit each other, cost within 5e-5 and accuracy within 2e-3 of
   ``mesh=None``, the masked sum launched per rank at (S_loc, R, 128)
   with ``client_offset = rank·S_loc`` of S_pad (with ``alive`` on the
   async paths, their dropped slots the trace's), the psums and ring
   calls a round as predicted, pipelined bit for bit async τ ≡ 1; each
   path's round time, device busy share and peak memory printed; then
   the hierarchical tree on the (groups, clients) mesh
   (``make_group_mesh``): a (1, 1) mesh of the NCCL rank on
   ``hierarchical(secure(), 2)`` alone, with top-k, async (both arenas)
   and pipelined, each bit for bit ``mesh=None`` with its launches, and
   on G = 4 (12 slots uploaded against 10) within 5e-5 in cost; gloo
   ranks on ``cuda:0`` at (2, 1) and (1, 2) (G = 4, async and pipelined
   G = 2) and at (2, 2) (G = 4): the ranks bit for bit each other, within
   5e-5 in cost and 1e-5 in weights of ``mesh=None``, the masked sum
   launched G_loc times a round at each rank's member offset of M_pad
   and the ring mode once at its group offset, the psums and ring calls
   a round on each axis as predicted; the masked sum and its ring mode
   are held bit for bit at a tile's shapes in the parity phases and
   timed there (``group_shard``), and the ``{"kernels": [...]}`` rows of
   both carry their launches on each group-mesh path;
then print one ``{"kernels": [...]}`` line, then the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
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
# f32 operations per element of the fused SSCA update, by variant: lin'
# 5, β' 3, ω̄ 3 (with λβ') or 1, ω' 3
FLOPS_SSCA = {"beta": 14, "lambda0": 9}
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
# 128, 129, 160, 300, 1024} (ragged and whole 128-row tiles) and G in {1,
# 4, 5, 8, 16, 48} (48: granite-34b's grouping; 16: qwen3-moe's 64 query
# heads on 4 kv heads; 5: llama4-maverick's 40 on 8, not a power of two)
FLASH_BF16_EDGES = [(2, 1, 4, 1, 128), (1, 65, 8, 1, 64), (2, 77, 4, 4, 16),
                    (1, 128, 8, 2, 32), (1, 129, 48, 1, 128),
                    (2, 300, 8, 1, 64), (1, 1024, 48, 1, 128),
                    (1, 300, 4, 4, 32), (1, 1024, 4, 1, 16),
                    (2, 65, 16, 2, 128), (1, 160, 64, 4, 128),
                    (2, 77, 40, 8, 128)]
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
# the hybrid at full width: recurrentgemma-9b cut to one unit, 3 of its
# 38 layers (two RG-LRU blocks, then local attention), on the LM path's
# data, batch and rounds at I = 2 clients (I = 4 would pass 80 GB), eval
# every round; tau = 8, where rwkv6-7b's witness cost falls (tau = 2
# diverges there, PERF.md §4)
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_LAYERS = 3
HYBRID_CLIENTS = 2
HYBRID_TAU = 8.0
HYBRID_PARAMS = 1_705_054_208
# its attention at that path (B, S, H, Hkv, Dh): the 2 clients' 2
# sequences folded into the batch, 16 heads of 256 on one kv head; its
# local window (2048) covers S, so the wgmma kernel's causal instance
# runs; and a window inside S at that shape, the banded instance, timed
FLASH_HYBRID = (HYBRID_CLIENTS * LM_BATCH, LM_SEQ, 16, 1, 256)
HYBRID_WINDOW = 2048
FLASH_BAND = 256
# the f32 kernel's band: hybrid_small's attention (4 clients' 4
# sequences of 32 tokens, 4 heads of 16 on one kv head, window 16), and
# two edge shapes, (shape, window)
FLASH_F32_BAND = ((16, 32, 4, 1, 16), 16)
FLASH_F32_BAND_EDGES = [((4, 32, 4, 1, 16), 16), ((2, 130, 4, 1, 64), 40)]


# the moe family: qwen3-moe (every layer MoE, 128 experts top-8, 64 query
# heads on 4 kv heads) and llama4-maverick (a dense block, then a MoE
# block: 128 experts top-1 and a shared expert, 40 query heads on 8 kv
# heads), served at full width in bf16, 2 of their 94 and 48 layers
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_INTERLEAVED_ARCH = "llama4-maverick-400b-a17b"
# the serve forward's attention (B, S, H, Hkv, Dh), by timing row: a batch
# of 4 requests of prompt 128 and 32 new tokens
FLASH_MOE = {"flash_attention_g16": (4, 160, 64, 4, 128),
             "flash_attention_g5": (4, 160, 40, 8, 128)}
# the reference's capacity factor for its check of MoE decode against
# the forward (tests/test_models_smoke.py)
REFERENCE_DROPLESS = 8.0


def dropless(cfg):
    """The capacity factor E / k, at which C = int(S·k·cf/E) + 1 > S: an
    expert takes at most one assignment a token, so the forward drops
    nothing whatever the routing, as decode (one token an example) never
    does.  The reference's REFERENCE_DROPLESS is above E / k at its
    reduced configs; at full width E / k is 16 (qwen3-moe) and 128
    (llama4-maverick), and what the forward drops at 8.0 is printed."""
    return cfg.num_experts / cfg.experts_per_token


# a token whose k-th and (k + 1)-th expert probabilities lie within this
# share of the k-th may route differently in decode and in the forward:
# the two round the router's bf16 input at other places (at qwen3-moe's
# full width 64 of 1,280 token-layers of a batch routed apart, at
# relative margins of up to 4.26e-2: this script, NVIDIA H100 80GB HBM3,
# 700.00 W)
ROUTE_TIE = 2.0 ** -4

# the vlm and audio families at full width: phi-3-vision-4.2b (head dim
# 96, 32 heads on 32 kv heads, 576 stub image tokens) and whisper-large-v3
# (an encoder over 1,500 stub frames, 20 heads of 64), 2 of their 32
# layers (whisper: 2 of 32 encoder and 2 of 32 decoder layers); their
# train steps: the vlm at B = 4 and 1,024 tokens (576 image + 448 text),
# whisper at B = 8 and 128 text tokens beside its 1,500 frames
VLM_ARCH = "phi-3-vision-4.2b"
AUDIO_ARCH = "whisper-large-v3"
VLM_TRAIN = (4, 1024)
AUDIO_TRAIN = (8, 128)
# the flash kernels' instances these families launch, by timing row:
# ((B, Sq, Sk, H, Hkv, Dh), causal).  wgmma: phi-3-vision's train forward
# and its serve forward with the image (576 + 160 tokens); whisper's
# encoder at serve (non-causal over its 1,500 frames), its
# cross-attention in the teacher-forced forward (160 queries against
# 1,500 keys) and its decoder's causal self-attention there (head dim
# 64).  tf32x3: head dim 96 at the vlm's train shape and 256 at
# the hybrid path's (no path runs either in f32: timing only), and the
# reduced whisper's cross-attention at its train step (8 x 32 text tokens
# against 16 frames, 4 heads of 64), non-causal
FLASH_NEW_ROWS = {
    "flash_attention_hd96": ((4, 1024, 1024, 32, 32, 96), True),
    "flash_attention_hd96_serve": ((4, 736, 736, 32, 32, 96), True),
    "flash_attention_encoder": ((4, 1500, 1500, 20, 20, 64), False),
    "flash_attention_cross": ((4, 160, 1500, 20, 20, 64), False),
    "flash_attention_audio_decoder": ((4, 160, 160, 20, 20, 64), True)}
FLASH_NEW_F32_ROWS = {
    "flash_attention_tf32x3_hd96": ((4, 1024, 1024, 32, 32, 96), True),
    "flash_attention_tf32x3_noncausal": ((8, 32, 16, 4, 4, 64), False),
    "flash_attention_f32_hd256": ((4, 1024, 1024, 16, 1, 256), True)}
FLASH_NEW_TIMING_ONLY = ("flash_attention_tf32x3_hd96",
                         "flash_attention_f32_hd256")
# edge shapes of the new instances, each against the plain version:
# (B, Sq, Sk, H, Hkv, Dh, dtype, causal, window).  Head dim 96 on both
# kernels (a band on each too); non-causal at Sq = Sk = 1,500 (a ragged
# last tile at every tile width), Sq 160 against Sk 1,500, Sq > Sk (200
# against 64), Sk 16 (the reduced whisper's frames, below one tile), head
# dim 96 against 300 keys; the f32 kernel at head dim 256, causal, banded
# and non-causal
FLASH_NEW_EDGES = [(2, 77, 77, 4, 2, 96, "bf16", True, 0),
                   (1, 300, 300, 8, 8, 96, "bf16", True, 0),
                   (2, 300, 300, 4, 1, 96, "bf16", True, 129),
                   (2, 77, 77, 4, 2, 96, "f32", True, 0),
                   (1, 300, 300, 8, 8, 96, "f32", True, 0),
                   (2, 130, 130, 4, 1, 96, "f32", True, 40),
                   (2, 1500, 1500, 4, 4, 64, "f32", False, 0),
                   (2, 160, 1500, 4, 4, 64, "f32", False, 0),
                   (2, 200, 64, 4, 2, 64, "bf16", False, 0),
                   (2, 200, 64, 4, 2, 64, "f32", False, 0),
                   (2, 24, 16, 4, 4, 64, "bf16", False, 0),
                   (4, 16, 16, 4, 4, 64, "f32", False, 0),
                   (2, 77, 300, 4, 2, 96, "bf16", False, 0),
                   (2, 77, 300, 4, 2, 96, "f32", False, 0),
                   (2, 100, 100, 4, 1, 256, "f32", True, 0),
                   (2, 300, 300, 4, 2, 256, "f32", True, 40),
                   (1, 100, 129, 2, 1, 256, "f32", False, 0)]


# the card's name and power limit (nvidia-smi), once main has read them
CARD = None


def log(*args):
    """Print a line; once the card is known, with its name and power
    limit beside the line's numbers, unless the line names it already."""
    text = " ".join(str(a) for a in args)
    if CARD and CARD not in text:
        text = f"{text} [{CARD}]"
    print(text, flush=True)


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
    """``masked_sum`` (I = 4 clients) and both ``ssca_update`` variants
    (``beta`` at λ = 1e-5, ``lambda0`` at λ = 0) at each full-width LM
    path's padded parameter count, timed directly: the median of 5 eager
    launches after 2 warm-ups, from CUDA events.  Each output is checked:
    the aggregate against Σ_i quantize(m_i) and the update against its
    plain version, bit for bit (in slices of 2^20 rows).  Buffers: 19.2 GB
    for llama3-8b's masked sum, 26.9 GB for its update (beta; 19.2 GB
    lambda0)."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    sc = torch.tensor([0.5, 0.6, 0.1, 1e-5], device="cuda")
    sc0 = torch.tensor([0.5, 0.6, 0.1, 0.0], device="cuda")
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
        out[path] = {"rows": rows, "masked_sum_ms": ms_sum}
        for variant in su.VARIANTS:
            if variant == "lambda0":
                ins[3] = None
            scalars = sc0 if variant == "lambda0" else sc
            out[path][f"{SSCA_ROW[variant]}_ms"] = eager_ms(
                lambda: su.ssca_update_2d(*ins, scalars))
            got = su.ssca_update_2d(*ins, scalars)
            for r0 in range(0, rows, 1 << 20):
                part = [None if x is None else x[r0:r0 + (1 << 20)]
                        for x in ins]
                ssca_check(torch, [None if a is None else a[r0:r0 + (1 << 20)]
                                   for a in got],
                           su.ssca_update_plain(*part, scalars),
                           f"{variant} at {path}'s width, rows {r0}+")
            del got
            torch.cuda.empty_cache()
        del ins
        torch.cuda.empty_cache()
    return out


def phase_kernel_parity(torch, su, sa):
    """Kernel against plain version on the card; returns the max abs
    errors at the main path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def on_variant(fn, variant, call, alive=False):
        """``call()``, which must launch ``fn`` once on ``variant`` (and
        count it as carrying ``alive`` when it does)."""
        before = dict(fn.launches_by_variant)
        out = call()
        before[variant] += 1
        if alive:
            before["alive"] += 1
        if fn.launches_by_variant != before:
            raise AssertionError(f"launched {fn.launches_by_variant}, want "
                                 f"one more {variant}: {before}")
        return out

    errs = {}
    sc = torch.tensor([0.9 / 7 ** 0.3, 0.9 / 7 ** 0.35, 0.1, 1e-5],
                      device=dev)
    sc0 = torch.tensor([0.9 / 7 ** 0.3, 0.9 / 7 ** 0.35, 0.1, 0.0],
                       device=dev)
    # both variants (lambda0: no β, λ = 0) at the paths' shape, a small
    # one, views one element past alignment
    for variant, rows, shift in ((v, r, s) for v in su.VARIANTS
                                 for r, s in ((794, False), (13, False),
                                              (794, True))):
        ins = [randn(rows, 128) for _ in range(4)]
        if shift:
            ins = [misaligned(torch, x) for x in ins]
        if variant == "lambda0":
            ins[3] = None
        scalars = sc0 if variant == "lambda0" else sc
        got = on_variant(su.ssca_update_2d, variant,
                         lambda: su.ssca_update_2d(*ins, scalars))
        err = ssca_check(torch, got, su.ssca_update_plain(*ins, scalars),
                         f"{variant} at R={rows}")
        errs.setdefault(SSCA_ROW[variant], err)
        log(f"ssca_update ({variant}): kernel == plain bit for bit at "
            f"R={rows}{' one element past alignment' if shift else ''}")

    key0, key1 = 0x8BADF00D, 0x1234567
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(msgs, name, **kw):
        plan = sa.launch_plan(msgs[0].numel(), msgs.shape[0],
                              kw["num_clients"], sms)
        got = on_variant(sa.masked_sum_2d, plan[0], lambda: sa.masked_sum_2d(
            msgs, key0, key1, scale_bits=SCALE_BITS, **kw),
            alive=kw.get("alive") is not None)
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
    # the group mesh's level 1 at (1, 2): a rank's 2 members at
    # member_offset 2 of a group's 4, with the group's whole member row
    # of alive bits (a member dropped on the other rank, then on this one)
    tile = randn(2, 794, 128, scale=1e-3)
    for row in ([1, 0, 1, 1], [1, 1, 1, 0]):
        check(tile, f"(2, 794, 128) at member_offset 2 of 4, alive {row}",
              num_clients=4, client_offset=2,
              alive=torch.tensor(row, device=dev))
    errs["compress"] = phase_compress_parity(torch, randn)
    errs["sketch_encode"] = phase_sketch_parity(torch, randn)
    return errs


# the {"kernels": [...]} row of each ssca_update variant
SSCA_ROW = {"beta": "ssca_update", "lambda0": "ssca_update_lambda0"}


def ssca_check(torch, got, want, what):
    """An ssca_update launch's outputs against its plain version's, bit
    for bit (a −0 told from +0); returns the max abs difference."""
    torch.cuda.synchronize()
    if [a is None for a in got] != [b is None for b in want]:
        raise AssertionError(f"ssca_update: {what}: outputs {got} against "
                             "the plain version's")
    pairs = [(a, b) for a, b in zip(got, want) if b is not None]
    err = max(float((a - b).abs().max()) for a, b in pairs)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in pairs):
        raise AssertionError(f"ssca_update differs from plain: {what}, "
                             f"max abs difference {err}")
    return err


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


def phase_flash_band_parity(torch, card):
    """The flash kernels' hybrid instances on the card, each call counted
    on its variant.  The wgmma kernel at head dim 256, at the hybrid
    path's shape FLASH_HYBRID, at window 2048 (the path's: it covers S,
    so the causal instance runs), FLASH_BAND and 0, each held by
    ``bf16_error_check`` to the f64 softmax of its band; the window-2048
    output must equal the causal one bit for bit.  Then the tf32x3
    kernel's banded instance within 2e-5 of the plain version, whose
    einsums sum in another order than the kernel's online softmax, at
    hybrid_small's shape and two edges.  Returns the max abs differences
    from the plain version by ``{"kernels": [...]}`` row, and the bf16
    check's numbers by window."""
    from repro_torch.kernels import flash_attention as fa
    errs, stats, outs = {}, {}, {}

    def counted(variant, call):
        before = dict(fa.flash_attention_bhsd.launches_by_variant)
        got = call()
        torch.cuda.synchronize()
        before[variant] += 1
        if fa.flash_attention_bhsd.launches_by_variant != before:
            raise AssertionError(f"flash_attention did not launch its "
                                 f"{variant} kernel once")
        return got

    q, k, v = flash_inputs(torch, *FLASH_HYBRID, torch.bfloat16)
    for window in (HYBRID_WINDOW, FLASH_BAND, 0):
        got = counted("wgmma", lambda: fa.flash_attention_bhsd(
            q, k, v, window=window))
        band = window if window < FLASH_HYBRID[1] else 0
        ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got,
                                                            band)
        err = float((got.float() - fa.flash_attention_plain(q, k, v, band)
                     .float()).abs().max())
        stats[window] = {"max_error_over_bound": ratio,
                         "rms_error_vs_f64": rms_got,
                         "plain_rms_error_vs_f64": rms_plain,
                         "max_abs_from_plain": err}
        name = f"(B, S, H, Hkv, Dh) = {FLASH_HYBRID}, bf16, window {window}"
        log(f"flash_attention (wgmma): at {name}: {json.dumps(stats[window])}"
            f" on {card}")
        if not ok:
            raise AssertionError(f"flash_attention (wgmma) outside its "
                                 f"tolerance at {name}: {stats[window]}")
        outs[window] = got
    if not torch.equal(outs[HYBRID_WINDOW], outs[0]):
        raise AssertionError(f"flash_attention (wgmma) at window "
                             f"{HYBRID_WINDOW} >= S differs from the causal "
                             "output")
    log(f"flash_attention (wgmma): window {HYBRID_WINDOW} equals window 0 "
        "bit for bit")
    errs["flash_attention_hd256"] = stats[HYBRID_WINDOW]["max_abs_from_plain"]
    errs["flash_attention_hd256_band"] = \
        stats[FLASH_BAND]["max_abs_from_plain"]
    del q, k, v, outs
    for shape, window in [FLASH_F32_BAND] + FLASH_F32_BAND_EDGES:
        x = flash_inputs(torch, *shape, torch.float32)
        got = counted("tf32x3", lambda: fa.flash_attention_bhsd(
            *x, window=window))
        err = float((got - fa.flash_attention_plain(*x, window)).abs().max())
        name = f"(B, S, H, Hkv, Dh) = {shape}, f32, window {window}"
        log(f"flash_attention (tf32x3): max abs {err:.3e} from plain at "
            f"{name} on {card}")
        if not (err <= 2e-5 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_attention (tf32x3) outside its "
                                 f"tolerance at {name}: {err}")
        errs.setdefault("flash_attention_tf32x3_band", err)
    return errs, stats


def flash_inputs_qk(torch, b, sq, sk, h, hkv, dh, dtype, seed=0):
    """q (B, Sq, H, Dh) and k, v (B, Sk, Hkv, Dh), N(0, 1) in ``dtype`` on
    the card."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g).to("cuda", dtype)
                 for shape in ((b, sq, h, dh), (b, sk, hkv, dh),
                               (b, sk, hkv, dh)))


def phase_flash_new_parity(torch, card):
    """The flash kernels' instances of the vlm and audio families on the
    card, each call counted on its variant: head dim 96 on both kernels,
    non-causal attention over a key length of its own, and the f32
    kernel at head dim 256, at the paths' shapes (FLASH_NEW_ROWS,
    FLASH_NEW_F32_ROWS) and at the edge shapes FLASH_NEW_EDGES.  bf16 (the
    wgmma kernel) is held by ``bf16_error_check`` to the f64 softmax of
    the same mask, f32 (tf32x3) within 2e-5 of the plain version.
    Returns the max abs differences from the plain version and the
    check's numbers, by ``{"kernels": [...]}`` row."""
    from repro_torch.kernels import flash_attention as fa
    errs, stats = {}, {}
    cases = ([(row, shape, "bf16", causal, 0)
              for row, (shape, causal) in FLASH_NEW_ROWS.items()]
             + [(row, shape, "f32", causal, 0)
                for row, (shape, causal) in FLASH_NEW_F32_ROWS.items()]
             + [(None, e[:6], e[6], e[7], e[8]) for e in FLASH_NEW_EDGES])
    for row, shape, dt, causal, window in cases:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        q, k, v = flash_inputs_qk(torch, *shape, dt)
        variant = fa.VARIANTS[dt]
        before = dict(fa.flash_attention_bhsd.launches_by_variant)
        got = fa.flash_attention_bhsd(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        before[variant] += 1
        name = (f"(B, Sq, Sk, H, Hkv, Dh) = {shape}, "
                f"{str(dt).replace('torch.', '')}, causal {causal}, window "
                f"{window}")
        if fa.flash_attention_bhsd.launches_by_variant != before:
            raise AssertionError(f"flash_attention at {name} did not launch "
                                 f"its {variant} kernel once")
        err = float((got.float() - fa.flash_attention_plain(
            q, k, v, window, causal).float()).abs().max())
        info = {"max_abs_from_plain": err}
        if dt == torch.float32:
            ok = err <= 2e-5 and bool(torch.isfinite(got).all())
        else:
            ok, ratio, rms_got, rms_plain = fa.bf16_error_check(
                q, k, v, got, window, causal)
            info.update({"max_error_over_bound": ratio,
                         "rms_error_vs_f64": rms_got,
                         "plain_rms_error_vs_f64": rms_plain})
        log(f"flash_attention ({variant}): at {name}: {json.dumps(info)} "
            f"on {card}")
        if not ok:
            raise AssertionError(f"flash_attention ({variant}) outside its "
                                 f"tolerance at {name}: {info}")
        if row is not None:
            errs[row], stats[row] = err, info
        del q, k, v, got
    torch.cuda.empty_cache()
    return errs, stats


def phase_flash_moe_parity(torch):
    """The wgmma kernel at the moe serve forward's shapes (FLASH_MOE: G =
    16 and G = 5 at head dim 128), each call counted on its variant and
    held by ``bf16_error_check`` to the f64 softmax.  Returns the max abs
    differences from the plain version and the check's numbers, by
    ``{"kernels": [...]}`` row."""
    from repro_torch.kernels import flash_attention as fa
    errs, stats = {}, {}
    for row, shape in FLASH_MOE.items():
        q, k, v = flash_inputs(torch, *shape, torch.bfloat16)
        before = dict(fa.flash_attention_bhsd.launches_by_variant)
        got = fa.flash_attention_bhsd(q, k, v)
        torch.cuda.synchronize()
        before["wgmma"] += 1
        if fa.flash_attention_bhsd.launches_by_variant != before:
            raise AssertionError(f"flash_attention at {shape} did not "
                                 "launch its wgmma kernel once")
        ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got)
        errs[row] = float((got.float() - fa.flash_attention_plain(q, k, v)
                           .float()).abs().max())
        stats[row] = {"max_error_over_bound": ratio,
                      "rms_error_vs_f64": rms_got,
                      "plain_rms_error_vs_f64": rms_plain,
                      "max_abs_from_plain": errs[row]}
        log(f"flash_attention (wgmma): at (B, S, H, Hkv, Dh) = {shape}, "
            f"bf16: {json.dumps(stats[row])}")
        if not ok:
            raise AssertionError(f"flash_attention (wgmma) outside its "
                                 f"tolerance at {shape}: {stats[row]}")
        del q, k, v, got
    return errs, stats


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
    """Every launch counter to 0, the per-variant and per-mask ones too."""
    for fn in kernels.values():
        fn.launches = 0
        for by in ("launches_by_variant", "launches_by_mask"):
            for key in getattr(fn, by, {}):
                getattr(fn, by)[key] = 0


def variant_counts(kernels):
    """The launches of each kernel with variants (masked_sum, flash
    attention, the WKV scan), by variant, since the last reset:
    ``flash_attention_wgmma``, ``masked_sum_rowsplit`` and so on; and
    flash attention's by variant and mask (``launches_by_mask``, counted
    where the wrapper launches: ``flash_attention_wgmma_causal``,
    ``flash_attention_tf32x3_cross`` and so on), which must sum to each
    variant's launches."""
    out = {f"{name}_{k}": n for name, fn in kernels.items()
           for k, n in getattr(fn, "launches_by_variant", {}).items()}
    for name, fn in kernels.items():
        by_mask = getattr(fn, "launches_by_mask", {})
        for variant in fn.launches_by_variant if by_mask else ():
            if sum(n for k, n in by_mask.items() if k.startswith(
                    f"{variant}_")) != fn.launches_by_variant[variant]:
                raise AssertionError(f"{name}: launches by mask {by_mask} "
                                     f"against {fn.launches_by_variant}")
        out.update({f"{name}_{k}": n for k, n in by_mask.items()})
    return out


def mask_keys(kernels):
    """The keys of :func:`variant_counts` that count by mask."""
    return {f"{name}_{k}" for name, fn in kernels.items()
            for k in getattr(fn, "launches_by_mask", {})}


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
    counted launches: ``layer_kernel`` once per layer that launches it
    (``kernel_layers``) per forward, each launch on ``variant``; returns
    the launches, also by variant."""
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
    # the counts by mask are left to variant_counts' own check
    masks = mask_keys(kernels)
    want = {k: 0 for k in launches if k not in masks}
    # kernel layers x (one upload forward for all clients + 2 eval
    # forwards)
    want.update({layer_kernel: kernel_layers(task.cfg) * 3 * rounds,
                 "ssca_update": rounds,
                 "masked_sum": rounds})
    want[variant] = want[layer_kernel]
    from repro_torch import tree
    want.update(server_variants(torch, tree.numel(p_gpu), 4, rounds,
                                "lambda0"))
    log(f"{name}: launches over {rounds} rounds: {launches}")
    if {k: launches[k] for k in want} != want:
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


def server_variants(torch, n_params, clients, rounds, ssca_variant):
    """The launches of each variant of the server kernels in ``rounds``
    secure Algorithm-1 rounds of ``clients`` clients at ``n_params``
    parameters (padded to whole rows of 128): ``masked_sum``'s from its
    wrapper's launch plan, ``ssca_update``'s all on ``ssca_variant``
    (``lambda0`` at λ = 0, else ``beta``)."""
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.kernels import ssca_update as su
    n = -(-n_params // 128) * 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {f"masked_sum_{v}": 0 for v in sa.VARIANTS}
    want[f"masked_sum_{sa.launch_plan(n, clients, clients, sms)[0]}"] = \
        rounds
    want.update({f"ssca_update_{v}": rounds if v == ssca_variant else 0
                 for v in su.VARIANTS})
    return want


def lm_full_width(arch, layers=LM_LAYERS):
    """The LM task at ``arch``'s full width, cut to ``layers`` layers, and
    its data."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.fed.tasks import LMTask
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    task = LMTask(cfg=cfg, seq_len=LM_SEQ)
    data = task.default_data(n_train=256, n_test=8, seed=0)
    return task, data


def phase_lm_full(torch, kernels, runtime, card, name, arch, n_params,
                  layer_kernel, variant, layers=LM_LAYERS,
                  clients=LM_CLIENTS, tau=2.0, eval_every=LM_EVAL_EVERY,
                  profile_copies=True):
    """An LM path at ``arch``'s full width, cut to ``layers`` layers, on
    the card over ``clients`` clients at ``tau``, with counted launches:
    ``layer_kernel`` once per layer that launches it (``kernel_layers``)
    per forward, each launch on ``variant``; returns the launches, also
    by variant, and the device time by kind of one profiled round.
    ``profile_copies``: two more rounds profiled with every tree copied
    and read in place (``copies_saved``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.core import protocol, ssca
    from repro_torch.data import partition
    from repro_torch.fed import aggregation, compression
    from repro_torch.fed.tasks import SumLoss
    t0 = time.perf_counter()
    task, data = lm_full_width(arch, layers)
    part = partition.iid(len(data.x_train), clients, seed=0)
    log(f"{name}: data {data.x_train.shape} train, {data.x_test.shape} "
        f"test, vocab {task.cfg.vocab_size} "
        f"({time.perf_counter() - t0:.1f} s)")

    def init():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return task.init_params(gen)

    kw = dict(task=task, batch_size=LM_BATCH, eval_every=eval_every,
              eval_samples=8, seed=0, secure=True, fused=True, tau=tau,
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
    # the counts by mask are left to variant_counts' own check
    masks = mask_keys(kernels)
    want = {k: 0 for k in launches if k not in masks}
    n_evals = LM_ROUNDS // eval_every
    want.update({layer_kernel: kernel_layers(task.cfg)
                 * (LM_ROUNDS + 2 * n_evals),
                 "ssca_update": LM_ROUNDS, "masked_sum": LM_ROUNDS})
    want[variant] = want[layer_kernel]
    want.update(server_variants(torch, n_params, clients, LM_ROUNDS,
                                "lambda0"))
    log(f"{name}: launches over {LM_ROUNDS} rounds: {launches}")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    n = tree.numel(params)
    cost = hist.train_cost
    ln_v = math.log(task.cfg.vocab_size)
    log(f"{name}: {n} parameters; tau {tau}; train cost {cost} after "
        f"rounds {hist.rounds}, test accuracy {hist.test_accuracy} "
        f"(ln V = {ln_v:.4f}) on {card}")
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
        loss_fn=SumLoss(task), hp=ssca.SSCAHyperParams(tau=tau, lam=0.0))
    ledger = compression.round_bytes(alg, aggregation.secure(), None, shapes,
                                     clients)
    want_up = clients * (4 * n_params + 4 * (clients - 1))
    if not hist.uplink_bytes_per_round == ledger.uplink_total == want_up:
        raise AssertionError(f"{name}: ledger {hist.uplink_bytes_per_round}"
                             f" B uplink, round_bytes {ledger.uplink_total},"
                             f" want {want_up}")
    log(f"{name}: ledger {hist.uplink_bytes_per_round} uplink bytes per "
        f"round = {clients} x (4 x {n_params} + 4 x {clients - 1})")
    round_s = hist.wall_seconds / LM_ROUNDS
    log(f"{name}: round time {round_s * 1e3:.1f} ms (I={clients}, "
        f"B={LM_BATCH}, S={LM_SEQ}, eval every {eval_every} rounds "
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
    log(f"{name}: profile of one round on {card}:", json.dumps({
        "profiled_wall_ms": h_prof.wall_seconds * 1e3, "device_us": us,
        "device_busy_share_of_round_loop":
            busy / (h_prof.wall_seconds * 1e6),
        "largest_other_us": top_other, "largest_host_self_us": host}))
    torch.cuda.empty_cache()
    if profile_copies:
        # that round is a run's first, whose params and lin come from the
        # init and are copied; two rounds show the second's in-place reads
        log(f"{name}: two profiled rounds, every tree copied against in "
            f"place, on {card}:", json.dumps(copies_saved(
                torch, lambda: runtime.run_alg1(
                    data, part, params=init(), rounds=2, **kw))))
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


# the launch entry points (launch/serve.py, launch/steps.py, ckpt/io.py)
# at full width: 8 requests in batches of 4, a 128-token prompt and 32
# new tokens; the train step at launch/train.py's defaults, 4 steps with a
# checkpoint after step 2
SERVE_REQUESTS = 8
SERVE_BATCH = 4
SERVE_PROMPT = 128
SERVE_NEW = 32
SERVE_WINDOW = 64
TRAIN_BATCH = 8
TRAIN_SEQ = 128
TRAIN_STEPS = 4
TRAIN_CKPT_AT = 2
# the decode logits against the teacher-forced forward (the reference's
# own bound, tests/test_models_smoke.py), a share of the largest |logit|
DECODE_VS_FORWARD = 2e-2
# the small width's decode on the card against the CPU's, a share of the
# largest |logit|: the f32 GEMMs (TF32 off) sum in other orders
SMALL_DECODE = 1e-4
LAYER_KERNEL = {"llama3-8b": ("flash_attention", "flash_attention_wgmma"),
                "rwkv6-7b": ("rwkv6_wkv", "rwkv6_wkv_mma"),
                HYBRID_ARCH: ("flash_attention", "flash_attention_wgmma"),
                MOE_ARCH: ("flash_attention", "flash_attention_wgmma"),
                MOE_INTERLEAVED_ARCH: ("flash_attention",
                                       "flash_attention_wgmma"),
                VLM_ARCH: ("flash_attention", "flash_attention_wgmma"),
                AUDIO_ARCH: ("flash_attention", "flash_attention_wgmma")}
SMALL_KERNEL = {"llama3-8b": ("flash_attention", "flash_attention_tf32x3"),
                "rwkv6-7b": ("rwkv6_wkv", "rwkv6_wkv_mma"),
                HYBRID_ARCH: ("flash_attention", "flash_attention_tf32x3"),
                MOE_ARCH: ("flash_attention", "flash_attention_tf32x3"),
                MOE_INTERLEAVED_ARCH: ("flash_attention",
                                       "flash_attention_tf32x3"),
                VLM_ARCH: ("flash_attention", "flash_attention_tf32x3"),
                AUDIO_ARCH: ("flash_attention", "flash_attention_tf32x3")}


def kernel_layers(cfg):
    """The layer kernel's launches in one forward of ``cfg``: one a layer,
    but for the hybrid only its attention layers, and for audio its
    encoder layers and two a decoder layer (self- and cross-attention)."""
    if cfg.family == "hybrid":
        unit = cfg.pattern_recurrent + cfg.pattern_attn
        return cfg.num_layers // unit * cfg.pattern_attn
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def encoder_counts(cfg, name, variant):
    """The launches of one ``precompute_cross`` (the encoder's
    self-attention, one a layer; none for a family without it), by name,
    variant and mask."""
    n = cfg.encoder_layers if cfg.family == "audio" else 0
    return {name: n, variant: n, f"{variant}_self": n} if n else {}


def audio_masks(cfg, variant, forwards=1):
    """An audio config's launches by mask in ``forwards`` forwards: one a
    layer for the encoder's self-attention, the decoder's causal
    self-attention and its cross-attention; none for the other
    families."""
    if cfg.family != "audio":
        return {}
    return {f"{variant}_self": forwards * cfg.encoder_layers,
            f"{variant}_causal": forwards * cfg.num_layers,
            f"{variant}_cross": forwards * cfg.num_layers}


def stub_frames(torch, cfg, batch, dev):
    """Stub frame embeddings (batch, encoder_seq, D), f32 N(0, 1) from a
    generator seeded 2 on ``dev`` (``launch/serve.py``'s), for an audio
    config; None for the others."""
    if cfg.family != "audio":
        return None
    return torch.randn(batch, cfg.encoder_seq, cfg.d_model,
                       generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev)


def counts(kernels):
    """Every kernel's launches since the last reset, also by variant."""
    return {**{k: fn.launches for k, fn in kernels.items()},
            **variant_counts(kernels)}


def want_counts(kernels, **launches):
    """The counts a path should show: ``launches`` by name, else 0; the
    counts by mask are left to :func:`variant_counts`'s own check."""
    masks = mask_keys(kernels)
    want = {k: 0 for k in counts(kernels) if k not in masks}
    want.update(launches)
    return want


def check_counts(kernels, what, want):
    """All of :func:`counts` (the counts by mask too) where they are
    ``want``."""
    got = counts(kernels)
    if {k: got.get(k) for k in want} != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def first_split_near_tie(torch, gen_a, gen_b, record, prompt_len, bound,
                         vocab, what):
    """Tokens of two greedy runs agree, or part first where the run that
    ``record`` logged had its top two logits within ``bound``."""
    import numpy as np
    if np.array_equal(gen_a, gen_b):
        return
    b, j = min(zip(*np.nonzero(gen_a != gen_b)), key=lambda bj: bj[1])
    top = torch.topk(record[prompt_len - 1 + j][b, 0, :vocab], 2).values
    margin = float(top[0] - top[1])
    log(f"{what}: tokens part at request {b}, step {j}: top-2 margin "
        f"{margin:.3e} against the bound {bound:.3e}")
    if not margin <= bound:
        raise AssertionError(f"{what}: tokens differ at a margin {margin}")


def launch_small(torch, kernels, card, arch, dev="cuda", layers=2):
    """The reduced ``arch`` (f32, ``layers`` layers) on the card against
    the port's CPU run: ``serve_batch`` of 16 prompt and 16 new tokens
    (no kernel launched in decode, audio's encoder once a layer in
    ``precompute_cross`` over stub frames; logits within SMALL_DECODE of
    the largest, the tokens equal but for a near-tie; past the hybrid's
    window of 16) and one ``make_train_step`` (one ``lambda0`` launch,
    the layer kernel once a layer that launches it, ``kernel_layers``;
    loss rtol 1e-5, parameters within 1e-5 of the CPU's) on
    ``batch_stream``'s batch (the vlm's and audio's stub embeddings
    too)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core import ssca
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import build_model
    model = build_model(reduced(get_config(arch), layers=layers))
    cfg = model.cfg
    what = f"{arch} ({cfg.num_layers} layers)"
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    p_dev = tree.map(lambda w: w.to(dev), p_cpu)
    reqs = serve.synth_requests(4, cfg, 16, 16, seed=0)
    frames = stub_frames(torch, cfg, 4, "cpu")
    name, variant = SMALL_KERNEL[arch]
    reset_counts(kernels)
    rec_dev, rec_cpu = [], []
    gen_dev, _, _ = serve.serve_batch(
        model, p_dev, reqs, record=rec_dev,
        frame_embeds=None if frames is None else frames.to(dev))
    serve_counts = check_counts(kernels, f"serve_small {what}", want_counts(
        kernels, **encoder_counts(cfg, name, variant)))
    gen_cpu, _, _ = serve.serve_batch(model, p_cpu, reqs, record=rec_cpu,
                                      frame_embeds=frames)
    got = torch.cat(rec_dev, dim=1).cpu()
    want = torch.cat(rec_cpu, dim=1)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    log(f"serve_small {what}: card vs CPU decode logits max abs {err:.3e} "
        f"(largest |logit| {scale:.3e}, bound {SMALL_DECODE} of it); "
        f"tokens equal: {bool((gen_dev == gen_cpu).all())}; on {card}")
    if not err <= SMALL_DECODE * scale:
        raise AssertionError(f"serve_small {what}: card vs CPU {err}")
    first_split_near_tie(torch, gen_dev, gen_cpu, rec_cpu, 16,
                         SMALL_DECODE * scale, cfg.vocab_size,
                         f"serve_small {what}")

    step = steps.make_train_step(model, ssca.SSCAHyperParams(tau=2.0))
    batch = next(train.batch_stream(cfg, 8, 32, device="cpu"))
    reset_counts(kernels)
    q_dev, s_dev, m_dev = step(p_dev, ssca.init(p_dev, with_beta=False),
                               {k: v.to(dev) for k, v in batch.items()})
    n_k = kernel_layers(cfg)
    train_counts = check_counts(kernels, f"train_small {what}", want_counts(
        kernels, ssca_update=1, ssca_update_lambda0=1,
        **{name: n_k, variant: n_k}, **audio_masks(cfg, variant)))
    q_cpu, _, m_cpu = step(p_cpu, ssca.init(p_cpu, with_beta=False), batch)
    loss_rel = abs(float(m_dev["loss"]) - float(m_cpu["loss"])) \
        / abs(float(m_cpu["loss"]))
    w_err = max(float((a.cpu() - b).abs().max())
                for a, b in zip(tree.leaves(q_dev), tree.leaves(q_cpu)))
    log(f"train_small {what}: card vs CPU loss rel {loss_rel:.3e}, "
        f"parameters max abs {w_err:.3e} on {card}; launches "
        f"{train_counts}")
    if not (loss_rel <= 1e-5 and w_err <= 1e-5):
        raise AssertionError(f"train_small {what}: card vs CPU {loss_rel}, "
                             f"{w_err}")
    return serve_counts, train_counts


def launch_small_moe(torch, kernels, card, arch, dev="cuda"):
    """The reduced moe ``arch`` (f32, 2 layers of width 256, 4 experts):
    :func:`launch_small` (``serve_batch`` and one ``make_train_step``
    against the CPU); then on the card two steps with a checkpoint of the
    parameters and SSCA's lin after the first, saved and restored in a
    temporary directory (removed after), the second step run again from
    it: bit for bit the uninterrupted one, which needs a deterministic
    forward and backward (the MoE dispatch and combine are one-hot
    einsums, no float atomics); and one step of the same config with
    bf16 parameters and activations, whose parameters and lin must come
    back as f32 leaves, as the reference's do.  Returns the launches of
    each part."""
    import dataclasses
    import tempfile
    from repro_torch import tree
    from repro_torch.ckpt import io as ckpt_io
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core import ssca
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    parts = dict(zip(("serve", "train"),
                     launch_small(torch, kernels, card, arch, dev)))
    cfg = reduced(get_config(arch))
    n_k = kernel_layers(cfg)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    step = steps.make_train_step(model, ssca.SSCAHyperParams(tau=2.0))
    stream = train.batch_stream(cfg, 8, 32, device=dev)
    batches = [next(stream) for _ in range(2)]
    name, variant = SMALL_KERNEL[arch]
    reset_counts(kernels)
    p1, s1, _ = step(params, ssca.init(params, with_beta=False), batches[0])
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    try:
        ckpt_io.save(root / "step_1", {"params": p1, "ssca_lin": s1.lin},
                     step=1)
        p2, s2, m2 = step(p1, s1, batches[1])
        restored, meta = ckpt_io.restore(ckpt_io.latest(root), device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    state = ssca.init(restored["params"], with_beta=False)._replace(
        step=meta["step"] + 1, lin=restored["ssca_lin"])
    r2, rs2, rm2 = step(restored["params"], state, batches[1])
    parts["resume"] = check_counts(
        kernels, f"train_small resume {arch}", want_counts(
            kernels, ssca_update=3, ssca_update_lambda0=3,
            **{name: 3 * n_k, variant: 3 * n_k}))
    same = float(rm2["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(tree.leaves((r2, rs2.lin)),
                                          tree.leaves((p2, s2.lin))))
    del p1, s1, p2, s2, r2, rs2, restored, state

    cfg_b = dataclasses.replace(cfg, param_dtype="bfloat16",
                                activ_dtype="bfloat16")
    model_b = build_model(cfg_b)
    params_b = model_b.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    reset_counts(kernels)
    q, sq, mq = steps.make_train_step(model_b, ssca.SSCAHyperParams(
        tau=2.0))(params_b, ssca.init(params_b, with_beta=False), batches[0])
    parts["bf16"] = check_counts(
        kernels, f"train_small bf16 {arch}", want_counts(
            kernels, ssca_update=1, ssca_update_lambda0=1,
            **{name: n_k, "flash_attention_wgmma": n_k}))
    dtypes_in = sorted({str(w.dtype) for w in tree.leaves(params_b)})
    dtypes_out = sorted({str(w.dtype) for w in tree.leaves((q, sq.lin))})
    loss_b = float(mq["loss"])
    ln_v = math.log(cfg.vocab_size)
    log(f"train_small {arch}: resumed from a checkpoint after step 1, bit "
        f"for bit the uninterrupted step 2: {same} (loss {float(m2['loss'])}"
        f"); bf16 parameters {dtypes_in} → {dtypes_out} after one step, "
        f"loss {loss_b} (ln V = {ln_v:.4f}), kkt_residual "
        f"{float(mq['kkt_residual'])}, on {card}")
    if not same:
        raise AssertionError(f"train_small {arch}: the resumed step differs "
                             "from the uninterrupted one")
    if dtypes_in != ["torch.bfloat16"] or dtypes_out != ["torch.float32"]:
        raise AssertionError(f"train_small bf16 {arch}: {dtypes_in} in, "
                             f"{dtypes_out} out")
    if not ln_v - 1 <= loss_b <= ln_v + 3:
        raise AssertionError(f"train_small bf16 {arch}: loss {loss_b}")
    return parts


def decode_floor_ms(cfg, params, cache_bytes=0):
    """The least time of one full-width decode step: each layer weight
    read in its dtype and, where that is not the activation dtype, its
    cast written and read again (f32 parameters under bf16 activations:
    4 + 2 + 2 bytes; bf16 under bf16: 2, no cast); the embedding table
    read (the lookup and the tied unembedding), and where it is not f32
    the unembedding's f32 copy written and read (bf16: 2 + 4 + 4); and
    ``cache_bytes`` of KV cache, over the card's memory rate.  Every
    weight counts: the MoE's expert einsum reads every expert's weights
    each step, as the reference's dense buffer einsum does; but for
    whisper's cross-attention K and V projections, which only
    ``precompute_cross`` reads (its encoder, the vlm's ``img_proj``: not
    in the stacks counted).  Activations are left out."""
    act = cfg.adtype.itemsize
    nbytes = cache_bytes
    for key in ("blocks", "tail"):
        for k, w in params.get(key, {}).items():
            if k in ("xwk", "xwv"):
                continue
            nbytes += w.numel() * (w.element_size() + (
                2 * act if w.dtype != cfg.adtype else 0))
    emb = params["embed"]
    nbytes += emb.numel() * (emb.element_size() + (
        8 if emb.element_size() != 4 else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


@contextlib.contextmanager
def plain_attention(torch):
    """While open, the flash op computes its plain version (the
    materialised f32 softmax) where it lies, launching nothing: the
    reference that a forward through the kernels is held to."""
    from repro_torch.kernels import flash_attention as fa
    inner = fa.FlashAttention.forward
    fa.FlashAttention.forward = staticmethod(fa.flash_attention_plain)
    try:
        yield
    finally:
        fa.FlashAttention.forward = staticmethod(inner)


@contextlib.contextmanager
def moe_routes(torch, on=True, forced=None):
    """While ``on``: every MoE router call's own expert ids and top-(k +
    1) probabilities, in call order (``repro_torch.models.moe.route``
    wrapped).  With ``forced``, one (B, S, k) id tensor a call in order,
    each call routes to those experts instead, its gates renormalised
    from its own probabilities there, as ``route`` does."""
    from repro_torch.models import moe
    calls = []
    if not on:
        yield calls
        return
    route, ids = moe.route, iter(forced or ())

    def wrapped(x, w_router, k):
        gates, idx, probs = route(x, w_router, k)
        calls.append((idx, torch.topk(probs, k + 1, dim=-1).values))
        if forced is not None:
            idx = next(ids)
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return gates, idx, probs
    moe.route = wrapped
    try:
        yield calls
    finally:
        moe.route = route


def decode_routes(torch, calls, steps):
    """The decode steps' router calls (step-major, ids (B, 1, k)) → one
    (B, steps, k) id tensor a MoE layer."""
    n = len(calls) // steps
    return [torch.cat([c[0] for c in calls[layer::n]], dim=1)
            for layer in range(n)]


def route_ties(own, forced, k):
    """Where a forward's own top-k (``own``: its router calls, ids and
    top-(k + 1) probabilities) differs from the experts it was forced to
    (decode's), by MoE layer: the count of such tokens, and the largest
    relative margin between its k-th and (k + 1)-th probability there (0
    without one)."""
    flips, worst = [], 0.0
    for (idx, top), want in zip(own, forced):
        flip = (idx.sort(-1).values != want.sort(-1).values).any(-1)
        margin = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
        flips.append(int(flip.sum()))
        if flips[-1]:
            worst = max(worst, float(margin[flip].max()))
    return flips, worst


def decode_profile(torch, model, params, batch):
    """``batch`` served once more under ``torch.profiler``, its prompts
    cut to 16 tokens and 16 new (32 decode steps): a step's host wall
    time, its device time by kind, the device's busy share, the largest
    "other" kernels and the host's CUDA calls a step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    short = [serve.Request(r.prompt[:16], 16) for r in batch]
    steps = 32
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.serve_batch(model, params, short)
        wall = time.perf_counter() - t0
    us, top = device_us_by_kind(torch, prof)
    busy = sum(v for k, v in us.items() if k != "staging_htod")
    return {"wall_ms_per_step": wall * 1e3 / steps,
            "device_us_per_step": {k: v / steps for k, v in us.items()},
            "device_busy_share": busy / (wall * 1e6),
            "largest_other_us": top,
            "host_calls_per_step": host_calls_per_round(prof, steps)}


def launch_full_serve(torch, kernels, card, arch, dev="cuda", cut=None):
    """``arch`` at full width, 2 of its layers (or as ``cut`` cuts its
    config), serving SERVE_REQUESTS
    synthetic requests in batches of SERVE_BATCH: no hand-written kernel
    in the decode loop; the decode logits against a teacher-forced
    ``forward`` over prompt and generated tokens and ``make_prefill_step``
    against the decode at the last prompt token, within
    DECODE_VS_FORWARD of the largest |logit|, the layer kernel once a
    layer a forward; on llama3-8b a ring buffer of SERVE_WINDOW slots:
    finite, and its first SERVE_WINDOW positions within the same bound
    of the full cache's.  The moe family's decode (one token an example)
    never drops an assignment, so its forward and prefill checks run on
    the same weights at ``capacity_factor`` ``dropless(cfg)``, where the
    forward drops none either (checked), and route to the experts decode
    chose (a router in bf16 whose k-th and (k + 1)-th probabilities lie
    within the two paths' rounding picks either, and a token routed
    apart perturbs every later layer through attention); where the
    forward's own choice differs, it must sit within ROUTE_TIE of a tie,
    and the forward at the config's own capacity factor and at the
    reference's 8.0 gives the share it drops.  The vlm serves text alone,
    as the reference does, so its checks run the dense model on the same
    blocks (no ``img_proj``), and one forward a batch with 576 stub image
    tokens before the text runs the head-dim-96 kernel at the served
    length plus 576, its text logits within DECODE_VS_FORWARD of the
    largest of the same forward on the plain attention
    (:func:`plain_attention`).  Audio serves against stub frames
    (:func:`stub_frames`), which ``serve_batch`` runs through the encoder
    once a batch (``precompute_cross``: the only launches of the decode
    part); its checks run the teacher-forced forward and the prefill step
    on the same frames, and the encoder's time is printed.  Returns the
    launches of each part over its batches: ``decode`` (the decode loops,
    and audio's ``precompute_cross``), ``check`` (the forwards and
    prefill steps) and, on llama3-8b, ``ring``, flash attention's by mask
    too (:func:`variant_counts`)."""
    import dataclasses
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    published = get_config(arch)
    cfg = dataclasses.replace(published, num_layers=LM_LAYERS)
    if cut is not None:
        cfg = cut(cfg)
    n_k = kernel_layers(cfg)
    model = build_model(cfg)
    is_moe = cfg.family == "moe"
    check = build_model(dataclasses.replace(
        cfg, capacity_factor=dropless(cfg))) if is_moe else model
    if cfg.family == "vlm":
        check = build_model(dataclasses.replace(cfg, family="dense"))
    frames = stub_frames(torch, cfg, SERVE_BATCH, dev)
    extra = {} if frames is None else {"frame_embeds": frames}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree.leaves(params)
    n_params = sum(w.numel() for w in leaves)
    param_bytes = sum(w.numel() * w.element_size() for w in leaves)
    log(f"serve {arch}: {n_params} parameters, {param_bytes} B in "
        f"{sorted({str(w.dtype) for w in leaves})}, drawn in {init_s:.2f} s")
    del leaves
    reqs = serve.synth_requests(SERVE_REQUESTS, cfg, SERVE_PROMPT, SERVE_NEW)
    # warm-up: the first steps at these shapes pick the GEMM kernels
    serve.serve_batch(model, params, [serve.Request(r.prompt[:8], 4)
                                      for r in reqs[:SERVE_BATCH]],
                      frame_embeds=frames)
    name, variant = LAYER_KERNEL[arch]
    prefill = steps.make_prefill_step(check)
    by_part = {"decode": want_counts(kernels), "check": want_counts(kernels)}
    stats, dropped = [], None
    for i in range(0, SERVE_REQUESTS, SERVE_BATCH):
        batch = reqs[i:i + SERVE_BATCH]
        record = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        with moe_routes(torch, is_moe) as routes:
            gen, t_prefill, t_decode = serve.serve_batch(
                model, params, batch, record=record, frame_embeds=frames)
        # the experts decode chose, a MoE layer: the checks' forwards
        # route there, so that they compare the same function
        forced = decode_routes(torch, routes, len(record)) if is_moe \
            else None
        del routes
        got = check_counts(kernels, f"serve {arch} decode loop", want_counts(
            kernels, **encoder_counts(cfg, name, variant)))
        by_part["decode"] = {k: by_part["decode"].get(k, 0) + n
                             for k, n in got.items()}
        peak = torch.cuda.max_memory_allocated()
        prompt = torch.as_tensor(np.stack([r.prompt for r in batch]),
                                 device=dev)
        tokens = torch.cat([prompt, torch.as_tensor(gen, device=dev)], 1)
        reset_counts(kernels)
        check_dropped = []
        with moe_routes(torch, is_moe, forced) as fwd_routes:
            full = check.forward_with_aux(params, {"tokens": tokens, **extra},
                                          dropped=check_dropped)[0]
        if any(float(d) for d in check_dropped):
            raise AssertionError(f"serve {arch}: the check's forward drops "
                                 f"{[float(d) for d in check_dropped]}")
        with moe_routes(torch, is_moe, forced and [
                f[:, :SERVE_PROMPT] for f in forced]) as pre_routes:
            last = prefill(params, {"tokens": prompt, **extra})
            if cfg.family == "vlm":
                # the image forward: 576 stub image tokens before the text
                img = torch.randn(len(batch), cfg.num_image_tokens,
                                  cfg.d_model, device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(3))
                img_batch = {"tokens": tokens, "img_embeds": img}
                with_img = model.forward(params, img_batch)
                with plain_attention(torch):
                    img_plain = model.forward(params, img_batch)
                img_err = float((with_img - img_plain).abs().max())
                img_scale = float(img_plain.abs().max())
                log(f"serve {arch}: the image forward's text logits vs the "
                    f"same forward on the plain attention: max abs "
                    f"{img_err:.3e} (largest |logit| {img_scale:.3e}, bound "
                    f"{DECODE_VS_FORWARD} of it)")
                if with_img.shape != full.shape \
                        or not bool(torch.isfinite(with_img).all()) \
                        or not img_err <= DECODE_VS_FORWARD * img_scale:
                    raise AssertionError(
                        f"serve {arch}: the image forward gives "
                        f"{tuple(with_img.shape)}, {img_err} from the plain "
                        f"attention's")
                del img, img_batch, with_img, img_plain
        n_fwd = 3 if cfg.family == "vlm" else 2
        if is_moe and i == 0:
            # the share the served config's forward drops, a MoE layer,
            # and the forward at the reference's check capacity
            dropped = {}
            for cf in (cfg.capacity_factor, REFERENCE_DROPLESS):
                got = []
                build_model(dataclasses.replace(
                    cfg, capacity_factor=cf)).forward_with_aux(
                        params, {"tokens": tokens}, dropped=got)
                dropped[cf] = [float(d) for d in got]
            n_fwd = 4
        got = check_counts(
            kernels, f"serve {arch} forward and prefill", want_counts(
                kernels, **{name: n_fwd * n_k, variant: n_fwd * n_k},
                **audio_masks(cfg, variant, n_fwd)))
        by_part["check"] = {k: by_part["check"].get(k, 0) + n
                            for k, n in got.items()}
        dec = torch.cat(record, dim=1)
        scale = float(full.abs().max())
        err = float((dec - full).abs().max())
        err_pre = float((last - record[SERVE_PROMPT - 1][:, 0]).abs().max())
        flips = {}
        if is_moe:
            # where the forward's own top-k differs from decode's choice,
            # the two must sit at a near-tie of the router
            by_layer, worst = route_ties(fwd_routes, forced,
                                         cfg.experts_per_token)
            flips = {"tokens_routed_apart_by_moe_layer": by_layer,
                     "tokens": dec.shape[0] * dec.shape[1],
                     "largest_margin_routed_apart": worst}
            if worst > ROUTE_TIE:
                raise AssertionError(
                    f"serve {arch}: decode and forward route apart off a "
                    f"near-tie: {flips}; decode vs forward {err}, prefill "
                    f"step {err_pre}, scale {scale}")
        stats.append({"prefill_s": t_prefill, "decode_s": t_decode,
                      "peak_bytes": peak, "decode_vs_forward": err,
                      "prefill_step_vs_decode": err_pre,
                      "largest_logit": scale, **flips})
        if not (err <= DECODE_VS_FORWARD * scale
                and err_pre <= DECODE_VS_FORWARD * scale
                and bool(torch.isfinite(dec).all())):
            raise AssertionError(f"serve {arch}: decode vs forward {err}, "
                                 f"prefill step {err_pre}, scale {scale}")
        if i == 0:
            first = (batch, dec)
        del full, dec, record, forced, fwd_routes, pre_routes
    # the K and V caches a decode step reads, every slot of every
    # attention layer
    cache_bytes = 2 * model._n_attn_layers() * SERVE_BATCH \
        * (SERVE_PROMPT + SERVE_NEW + (cfg.encoder_seq if frames is not None
                                       else 0)) \
        * cfg.num_kv_heads * cfg.head_dim * cfg.adtype.itemsize
    floor_ms, floor_bytes = decode_floor_ms(cfg, params, cache_bytes)
    encoder_s = None
    if frames is not None:
        # whisper's encoder and cross K, V once (precompute_cross), timed
        # alone: serve_batch runs it before the prefill's clock
        state = model.init_decode(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW,
                                  device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.precompute_cross(params, extra, state)
        torch.cuda.synchronize()
        encoder_s = time.perf_counter() - t0
        del state
    profiled = decode_profile(torch, model, params, reqs[:SERVE_BATCH])
    b = SERVE_BATCH
    step_ms = [s["decode_s"] / SERVE_NEW * 1e3 for s in stats]
    log(f"serve {arch} ({cfg.num_layers} of {published.num_layers} layers, "
        f"{SERVE_REQUESTS} requests in batches of {b}, prompt "
        f"{SERVE_PROMPT}, {SERVE_NEW} new tokens) on {card}:", json.dumps({
            "parameters": n_params, "parameter_bytes": param_bytes,
            "init_s": init_s, "encoder_layers": cfg.encoder_layers,
            "precompute_cross_s": encoder_s,
            "capacity_factor": cfg.capacity_factor if is_moe else None,
            "check_capacity_factor": dropless(cfg) if is_moe else None,
            "forward_dropped_share_by_capacity_and_moe_layer": dropped,
            "routed_apart": [{k: s[k] for k in (
                "tokens_routed_apart_by_moe_layer", "tokens",
                "largest_margin_routed_apart")} for s in stats]
            if is_moe else None,
            "decode_step_floor_cache_bytes": cache_bytes,
            "cache_filling_prefill_s": [s["prefill_s"] for s in stats],
            "prefill_tokens_per_s": [b * SERVE_PROMPT / s["prefill_s"]
                                     for s in stats],
            "decode_step_ms": step_ms,
            "decode_tokens_per_s": [b * SERVE_NEW / s["decode_s"]
                                    for s in stats],
            "decode_step_floor_ms": floor_ms,
            "decode_step_floor_bytes": floor_bytes,
            "peak_device_bytes": [s["peak_bytes"] for s in stats],
            "decode_vs_forward_max_abs": [s["decode_vs_forward"]
                                          for s in stats],
            "prefill_step_vs_decode_max_abs": [s["prefill_step_vs_decode"]
                                               for s in stats],
            "largest_logit": [s["largest_logit"] for s in stats],
            "profiled_short_batch": profiled}))
    if arch == "llama3-8b":
        batch, dec = first
        ring = build_model(cfg, decode_window=SERVE_WINDOW)
        record = []
        reset_counts(kernels)
        serve.serve_batch(ring, params, batch, record=record)
        by_part["ring"] = check_counts(
            kernels, f"serve {arch} ring decode loop", want_counts(kernels))
        got = torch.cat(record, dim=1)
        err = float((got[:, :SERVE_WINDOW] - dec[:, :SERVE_WINDOW])
                    .abs().max())
        scale = float(dec[:, :SERVE_WINDOW].abs().max())
        log(f"serve {arch} decode_window={SERVE_WINDOW}: every logit finite "
            f"{bool(torch.isfinite(got).all())}; first {SERVE_WINDOW} "
            f"positions vs the full cache max abs {err:.3e} (largest "
            f"|logit| {scale:.3e}, bound {DECODE_VS_FORWARD} of it)")
        if not (bool(torch.isfinite(got).all())
                and err <= DECODE_VS_FORWARD * scale):
            raise AssertionError(f"serve {arch} ring buffer: {err}")
        del got, record
    del params, first, frames, extra
    torch.cuda.empty_cache()
    return by_part


def launch_full_train(torch, kernels, card, arch="llama3-8b", dev="cuda",
                      cut=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """``launch/train.py``'s defaults (batch 8, seq 128, τ = 2, the
    reference's schedules; or ``batch`` and ``seq``, the vlm's stub image
    tokens inside ``seq`` and whisper's frames beside it) at ``arch``'s
    full width, 2 of its layers (or as ``cut`` cuts its config):
    TRAIN_STEPS steps of ``make_train_step`` (one ``lambda0`` launch a
    step, the layer kernel once a layer), a checkpoint of the parameters
    and SSCA's lin after step TRAIN_CKPT_AT in a temporary directory
    (removed after), restored and run to the end again: the resumed
    steps equal the uninterrupted ones bit for bit."""
    import dataclasses
    import tempfile
    from repro_torch import tree
    from repro_torch.ckpt import io as ckpt_io
    from repro_torch.configs import get_config
    from repro_torch.core import ssca
    from repro_torch.core.schedules import PowerLaw
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    published = get_config(arch)
    cfg = dataclasses.replace(published, num_layers=LM_LAYERS)
    if cut is not None:
        cfg = cut(cfg)
    n_k = kernel_layers(cfg)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    hp = ssca.SSCAHyperParams(tau=2.0, rho=PowerLaw(0.9, 0.3),
                              gamma=PowerLaw(0.9, 0.35))
    step_fn = steps.make_train_step(model, hp)
    state = ssca.init(params, with_beta=False)
    stream = train.batch_stream(cfg, batch, seq, device=dev)
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    name, variant = LAYER_KERNEL[arch]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    losses, times, ckpt = [], [], None
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        for t in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batches[t - 1])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            if t == TRAIN_CKPT_AT:
                t0 = time.perf_counter()
                nbytes = ckpt_io.save(root / f"step_{t}",
                                      {"params": params,
                                       "ssca_lin": state.lin}, step=t)
                save_s = time.perf_counter() - t0
        launches = check_counts(kernels, f"train {arch}", want_counts(
            kernels, ssca_update=TRAIN_STEPS,
            ssca_update_lambda0=TRAIN_STEPS,
            **{name: TRAIN_STEPS * n_k, variant: TRAIN_STEPS * n_k},
            **audio_masks(cfg, variant, TRAIN_STEPS)))
        peak = torch.cuda.max_memory_allocated()
        whole = tree.leaves(params)
        t0 = time.perf_counter()
        restored, meta = ckpt_io.restore(ckpt_io.latest(root), device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params
    start = meta["step"]
    params = restored["params"]
    state = ssca.init(params, with_beta=False)._replace(
        step=start + 1, lin=restored["ssca_lin"])
    del restored
    resumed = []
    for t in range(start + 1, TRAIN_STEPS + 1):
        params, state, metrics = step_fn(params, state, batches[t - 1])
        resumed.append(float(metrics["loss"]))
    same = resumed == losses[start:] and all(
        torch.equal(a, b) for a, b in zip(tree.leaves(params), whole))
    ln_v = math.log(cfg.vocab_size)
    log(f"train {arch} ({cfg.num_layers} of {published.num_layers} layers, "
        f"batch {batch}, seq {seq}, tau 2) on {card}:",
        json.dumps({
            "losses": losses, "ln_V": ln_v, "step_s": times,
            "parameters": sum(w.numel() for w in whole),
            "encoder_layers": cfg.encoder_layers,
            "peak_device_bytes": peak, "checkpoint_bytes": nbytes,
            "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
            "resumed_losses": resumed, "resumed_bit_for_bit": same,
            "launches": launches}))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: losses not finite: {losses}")
    if not ln_v - 1 <= losses[0] <= ln_v + 3:
        raise AssertionError(f"train {arch}: first loss {losses[0]} outside "
                             "[ln V - 1, ln V + 3]")
    if not same:
        raise AssertionError(f"train {arch}: the resumed steps differ from "
                             f"the uninterrupted ones")
    del params, state, whole
    torch.cuda.empty_cache()
    return launches


def phase_launch(torch, kernels, card):
    """The launch entry points: the small width against the CPU, then
    serving and the train step at full width.  Returns each path's
    launches for the ``{"kernels": [...]}`` line."""
    import dataclasses
    t0 = time.perf_counter()
    by_path = {}
    for arch, short, layers in (("llama3-8b", "llama", 2),
                                ("rwkv6-7b", "rwkv", 2),
                                (HYBRID_ARCH, "hybrid", 3),
                                (HYBRID_ARCH, "hybrid_tail", 5)):
        by_path[f"serve_small_{short}"], by_path[f"train_small_{short}"] = \
            launch_small(torch, kernels, card, arch, layers=layers)
    hybrid_cut = lambda c: dataclasses.replace(c, num_layers=HYBRID_LAYERS)
    for arch, short, cut in (("llama3-8b", "llama", None),
                             ("rwkv6-7b", "rwkv", None),
                             (HYBRID_ARCH, "hybrid", hybrid_cut)):
        parts = launch_full_serve(torch, kernels, card, arch, cut=cut)
        by_path[f"serve_{short}_full_decode"] = parts["decode"]
        by_path[f"serve_{short}_full_forward"] = parts["check"]
        if "ring" in parts:
            by_path[f"serve_{short}_full_ring"] = parts["ring"]
    by_path["train_llama_full"] = launch_full_train(torch, kernels, card)
    by_path["train_hybrid_full"] = launch_full_train(
        torch, kernels, card, HYBRID_ARCH, cut=hybrid_cut)
    # the moe family: the reduced models against the CPU (and a resume and
    # a bf16 step on the card), then serving at full width in bf16, 2 of
    # 94 and 2 of 48 layers
    for arch, short in ((MOE_ARCH, "moe"),
                        (MOE_INTERLEAVED_ARCH, "moe_interleaved")):
        parts = launch_small_moe(torch, kernels, card, arch)
        by_path[f"serve_small_{short}"] = parts["serve"]
        by_path[f"train_small_{short}"] = parts["train"]
        by_path[f"train_small_{short}_resume"] = parts["resume"]
        by_path[f"train_small_{short}_bf16"] = parts["bf16"]
    for arch, short in ((MOE_ARCH, "moe"),
                        (MOE_INTERLEAVED_ARCH, "moe_interleaved")):
        t1 = time.perf_counter()
        parts = launch_full_serve(torch, kernels, card, arch)
        by_path[f"serve_{short}_full_decode"] = parts["decode"]
        by_path[f"serve_{short}_full_forward"] = parts["check"]
        log(f"serve_{short}_full: {time.perf_counter() - t1:.1f} s")
    # the vlm and audio families: the reduced models against the CPU, then
    # serving and train steps at full width, 2 of 32 layers (whisper's
    # encoder 2 of 32 too): head dim 96 and non-causal attention
    t1 = time.perf_counter()
    encoder_cut = lambda c: dataclasses.replace(c, encoder_layers=LM_LAYERS)
    for arch, short, train_shape, cut in (
            (VLM_ARCH, "vlm", VLM_TRAIN, None),
            (AUDIO_ARCH, "audio", AUDIO_TRAIN, encoder_cut)):
        by_path[f"serve_small_{short}"], by_path[f"train_small_{short}"] = \
            launch_small(torch, kernels, card, arch)
        parts = launch_full_serve(torch, kernels, card, arch, cut=cut)
        by_path[f"serve_{short}_full_decode"] = parts["decode"]
        by_path[f"serve_{short}_full_forward"] = parts["check"]
        by_path[f"train_{short}_full"] = launch_full_train(
            torch, kernels, card, arch, cut=cut, batch=train_shape[0],
            seq=train_shape[1])
    log(f"vlm and audio launch paths: {time.perf_counter() - t1:.1f} s")
    log(f"launch phase: {time.perf_counter() - t0:.1f} s")
    return by_path


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


# partial participation and async rounds (phase_participation): the
# delay distribution of the staleness trace (the reference bench's),
# the 10,000-client population's cohort, batch and rounds
ASYNC_PROBS = (0.5, 0.2, 0.15, 0.1, 0.05)
POP_CLIENTS, POP_COHORT, POP_BATCH, POP_ROUNDS = 10_000, 8, 6, 10


def async_ledger(k, dropped, rec_per):
    """``History.comm["async"]`` of the phase's 20 x 10 trace (seed 0:
    107 of its 200 slots delayed)."""
    return {"max_staleness": k, "stale_fraction": 107 / 200,
            "dropped_total": dropped, "dropout_rate": dropped / 200,
            "recovery_bytes_per_drop": rec_per,
            "recovery_bytes_total": dropped * rec_per}


class KeptArenaTopK:
    """Builds a top-k compressor whose residual arena the phase can read
    back (the engine keeps it to itself)."""
    arenas = []

    @classmethod
    def make(cls, compression, fraction, bits):
        class KeptArena(compression.TopKCompressor):
            def init_client_state(self, like, num_clients):
                arena = super().init_client_state(like, num_clients)
                cls.arenas.append(arena)
                return arena
        return KeptArena(fraction=fraction, bits=bits)


# (name, runtime entry, partition, arguments, rounds, launches other than
# 0, launches with alive, uplink / downlink bytes a round, comm["async"])
def participation_paths():
    from repro_torch.fed import aggregation, compression, sketch
    from repro_torch.fed.staleness import StalenessConfig
    per = ROUNDS
    k2 = StalenessConfig(max_staleness=2, delay_probs=ASYNC_PROBS)
    k0 = StalenessConfig(max_staleness=0, delay_probs=ASYNC_PROBS)
    alg1 = dict(batch_size=100, fused=True)
    fedavg = dict(local_steps=2, lr_a=2.0, lr_alpha=0.3, batch_size=50)
    topk8 = compression.topk(0.1, bits=8)
    secure_k2 = async_ledger(2, 33, 36)
    return [
        ("sampled_plain", "run_alg1", "i100",
         dict(alg1, aggregation=aggregation.sampled(10)), per,
         {"ssca_update": per}, 0, 4_065_280, 4_065_280, None),
        ("sampled_secure", "run_alg1", "i100",
         dict(alg1, aggregation=aggregation.secure(num_sampled=10)), per,
         {"ssca_update": per, "masked_sum": per}, 0, 4_065_640, 4_065_280,
         None),
        ("sampled_topk8_secure", "run_alg1", "i100",
         dict(alg1, aggregation=aggregation.secure(num_sampled=10),
              compressor=topk8), per,
         {"ssca_update": per, "masked_sum": per, "compress": per}, 0,
         4_065_640, 4_065_280, None),
        ("population10k_topk8_secure", "run_alg1", "i10k",
         dict(batch_size=POP_BATCH, fused=True,
              aggregation=aggregation.secure(num_sampled=POP_COHORT),
              compressor=KeptArenaTopK.make(compression, 0.1, 8)),
         POP_ROUNDS, {"ssca_update": POP_ROUNDS, "masked_sum": POP_ROUNDS,
                      "compress": POP_ROUNDS}, 0, 3_252_448, 3_252_224,
         None),
        ("async_secure", "run_alg1", "main",
         dict(alg1, secure=True, staleness=k2), per,
         {"ssca_update": per, "masked_sum": per}, per, 4_065_640,
         4_065_280, secure_k2),
        ("drop_secure", "run_alg1", "main",
         dict(alg1, secure=True, staleness=k0), per,
         {"ssca_update": per, "masked_sum": per}, per, 4_065_640,
         4_065_280, async_ledger(0, 107, 36)),
        ("async_plain", "run_alg1", "main", dict(alg1, staleness=k2), per,
         {"ssca_update": per}, 0, 4_065_280, 4_065_280,
         async_ledger(2, 33, 0)),
        ("async_fedavg_topk8_secure", "run_fedavg", "main",
         dict(fedavg, aggregation=aggregation.secure(), compressor=topk8,
              staleness=k2), per,
         {"masked_sum": per, "compress": per}, per, 4_065_640, 4_065_280,
         secure_k2),
        ("async_sketch_secure", "run_alg1", "main",
         dict(alg1, secure=True, staleness=k2,
              compressor=sketch.sketch(4, 1024, 0.02, keep=256)), per,
         {"ssca_update": per, "sketch_encode": per, "masked_sum": 2 * per},
         2 * per, 245_520, 4_146_600, secure_k2),
    ]


def phase_participation(torch, kernels, data, parts, params, runtime,
                        card):
    """Cohorts (``sampled(S)``, ``secure(num_sampled=S)``, a population of
    10,000) and async rounds (bounded staleness, drop-stragglers, the
    masked sum's ``alive`` path) at the MLP's full width on the card, with
    counted launches, exact ledgers, the bitwise invariants of the
    reference, and a 5-round run held to the port's CPU run; returns each
    path's launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.data import partition
    from repro_torch.fed import aggregation, compression
    from repro_torch.fed import staleness as staleness_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import secure_agg as sa
    # the trace every async path draws: (cohort 10, rounds 1..20, seed 0)
    trace = partition.sample_staleness(10, range(1, ROUNDS + 1), 0,
                                       ASYNC_PROBS)
    drops = {k: int(staleness_mod.dropped_per_round(trace, k).sum())
             for k in (0, 2)}
    log(f"participation: the trace drops {drops[2]} slots at K = 2 (in "
        f"{int((trace > 2).any(axis=1).sum())} of {ROUNDS} rounds) and "
        f"{drops[0]} at K = 0; stale share {float((trace > 0).mean())}")
    if drops != {0: 107, 2: 33} or int((trace > 0).sum()) != 107:
        raise AssertionError(f"participation: trace drops {drops}")
    by_path = {}
    for name, entry, pkey, extra, rounds, nonzero, alive, up, down, \
            want_async in participation_paths():
        run, part = getattr(runtime, entry), parts[pkey]
        kw = dict(extra, eval_every=10, seed=0, params=params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        p_gpu, h_gpu = run(data, part, device="cuda", rounds=rounds, **kw)
        launches = {k: fn.launches for k, fn in kernels.items()}
        want = {k: nonzero.get(k, 0) for k in kernels}
        log(f"{name}: launches over {rounds} rounds: {launches}, with "
            f"alive {sa.masked_sum_2d.launches_by_variant['alive']}")
        if launches != want or \
                sa.masked_sum_2d.launches_by_variant["alive"] != alive:
            raise AssertionError(f"{name}: launches {launches} ("
                                 f"{variant_counts(kernels)}), want {want} "
                                 f"and {alive} with alive")
        by_path[name] = {**launches, **variant_counts(kernels)}
        if (h_gpu.uplink_bytes_per_round, h_gpu.downlink_bytes_per_round) \
                != (up, down) or h_gpu.comm.get("async") != want_async:
            raise AssertionError(
                f"{name}: ledger {h_gpu.uplink_bytes_per_round} up, "
                f"{h_gpu.downlink_bytes_per_round} down, async "
                f"{h_gpu.comm.get('async')}; want {up}, {down}, {want_async}")
        cost = h_gpu.train_cost
        if not all(math.isfinite(c) for c in cost + h_gpu.test_accuracy):
            raise AssertionError(f"{name}: metrics not finite: {cost}")
        log(f"{name}: ledger {up} up / {down} down bytes a round, async "
            f"{json.dumps(h_gpu.comm.get('async'))}; train cost {cost}, "
            f"test accuracy {h_gpu.test_accuracy}; round time "
            f"{h_gpu.wall_seconds / rounds * 1e3:.3f} ms (I = "
            f"{part.num_clients}, B = {extra['batch_size']}, eval every 10 "
            f"rounds included), peak device memory "
            f"{torch.cuda.max_memory_allocated()} B on {card}")
        if name.startswith("population"):
            check_population_arena(torch, partition, part.num_clients,
                                   rounds)
            # the arena's birth, in the first round: allocate and zero
            # one more of its size
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh = torch.zeros(part.num_clients, 101_632, device="cuda")
            torch.cuda.synchronize()
            log(f"{name}: a fresh {fresh.numel() * 4} B zero arena takes "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms to allocate "
                "and fill")
            del fresh
        del p_gpu
        torch.cuda.empty_cache()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, h_prof = run(data, part, device="cuda", rounds=rounds, **kw)
        us, top_other = device_us_by_kind(torch, prof)
        busy = sum(v for k, v in us.items() if k != "staging_htod")
        # where the host spends the run, for the device's idle share
        host = sorted(((e.key[:60], e.self_cpu_time_total)
                       for e in prof.key_averages()), key=lambda kv: -kv[1])
        log(f"{name}: profile:", json.dumps({
            "rounds": rounds, "profiled_wall_ms": h_prof.wall_seconds * 1e3,
            "device_us": us, "device_busy_share_of_round_loop":
                busy / (h_prof.wall_seconds * 1e6),
            "largest_other_us": top_other,
            "largest_host_self_us": host[:6]}))
        KeptArenaTopK.arenas.clear()
        torch.cuda.empty_cache()

        # the card against the port's CPU run, over fewer rounds
        short = dict(kw, rounds=CARD_CPU_ROUNDS, eval_every=1)
        p_gpu, h_gpu = run(data, part, device="cuda", **short)
        t0 = time.perf_counter()
        p_cpu, h_cpu = run(data, part, device="cpu", **short)
        cpu_s = time.perf_counter() - t0
        KeptArenaTopK.arenas.clear()
        diffs = card_vs_cpu(h_gpu, h_cpu, p_gpu, p_cpu)
        log(f"{name}: card vs CPU over {CARD_CPU_ROUNDS} rounds:",
            json.dumps(diffs), f"(CPU run {cpu_s:.1f} s)")
        # tolerance: the paper algorithms' phase's.  A last-bit gradient
        # difference can move an entry across a 2^-20 grid point of the
        # secure quantizer; top-k's threshold and stochastic levels can
        # then keep or round an entry the other way
        limits = {"train_cost": 1e-6, "test_accuracy_abs": 1e-3,
                  "params_abs": 1e-3 if "topk" in name else 2e-5}
        if h_gpu.comm != h_cpu.comm or h_gpu.rounds != h_cpu.rounds:
            raise AssertionError(f"{name}: card and CPU ledgers differ")
        for k, lim in limits.items():
            if not diffs[k] <= lim:
                raise AssertionError(f"{name}: card run drifts from CPU run: "
                                     f"{k} {diffs[k]} > {lim}")
        del p_gpu, p_cpu
        torch.cuda.empty_cache()

    base = dict(batch_size=100, fused=True, eval_every=10, seed=0,
                params=params, rounds=ROUNDS, device="cuda")
    # S = I is full participation, bit for bit
    same_run(torch, "secure(num_sampled=10) at I = 10 against secure()",
             runtime.run_alg1(data, parts["main"], secure=True, **base),
             runtime.run_alg1(data, parts["main"], **base,
                              aggregation=aggregation.secure(
                                  num_sampled=CLIENTS)))
    # an all-zero trace is the synchronous run, bit for bit
    zero = staleness_mod.StalenessConfig(max_staleness=2)
    same_run(torch, "secure dense, all-zero trace against sync",
             runtime.run_alg1(data, parts["main"], secure=True, **base),
             runtime.run_alg1(data, parts["main"], secure=True,
                              staleness=zero, **base))
    fedavg = {k: v for k, v in base.items() if k != "fused"}
    fedavg.update(local_steps=2, lr_a=2.0, lr_alpha=0.3, batch_size=50,
                  aggregation=aggregation.secure())
    same_run(torch, "fedavg_topk8_secure, all-zero trace against sync",
             runtime.run_fedavg(data, parts["main"], **fedavg,
                                compressor=compression.topk(0.1, bits=8)),
             runtime.run_fedavg(data, parts["main"], **fedavg,
                                compressor=compression.topk(0.1, bits=8),
                                staleness=zero))
    check_alive_combine(torch, sa, ops, tree, runtime, aggregation, data,
                        parts["main"], dict(base, rounds=CARD_CPU_ROUNDS),
                        participation_paths()[4][3]["staleness"])
    by_path["rwkv_small_sampled"] = phase_rwkv_sampled(torch, kernels,
                                                       runtime)
    return by_path


def same_run(torch, what, run_a, run_b):
    """Two runs' weights and histories equal bit for bit."""
    from repro_torch import tree
    (p_a, h_a), (p_b, h_b) = run_a, run_b
    if not all(torch.equal(a, b) for a, b in zip(tree.leaves(p_a),
                                                 tree.leaves(p_b))) \
            or h_a.metrics != h_b.metrics:
        raise AssertionError(f"{what}: runs differ: {h_a.metrics} against "
                             f"{h_b.metrics}")
    log(f"participation: {what}: weights and metrics bit for bit")


def check_population_arena(torch, partition, num_clients, rounds):
    """After the 10,000-client run: the residual rows of every client never
    drawn still hold their initial zeros, and every drawn client's row has
    moved, read back row by row."""
    import numpy as np
    arena = KeptArenaTopK.arenas[-1]
    drawn = np.unique(partition.sample_cohorts(
        num_clients, POP_COHORT, np.arange(1, rounds + 1), 0))
    moved = torch.zeros(num_clients, dtype=torch.bool, device="cuda")
    nbytes = 0
    for leaf in arena.values():
        moved |= (leaf != 0).flatten(1).any(dim=1)
        nbytes += leaf.numel() * leaf.element_size()
    moved = moved.cpu().numpy()
    if moved[drawn].sum() != len(drawn) or moved.sum() != len(drawn):
        raise AssertionError(f"population: {int(moved.sum())} rows moved, "
                             f"{len(drawn)} clients drawn")
    log(f"population: residual arena {tuple(arena['w1'].shape[:1])} rows, "
        f"{nbytes} B on the card; the {num_clients - len(drawn)} rows of "
        f"clients never drawn are all zero, the {len(drawn)} drawn rows "
        "have moved")


def check_alive_combine(torch, sa, ops, tree, runtime, aggregation, data,
                        part, kw, staleness):
    """On the async secure path, every round's masked sum through
    ``alive`` equals the plain sum of the survivors' quantized messages,
    bit for bit, and the engine's aggregate is its dequantization."""
    calls = []

    class Recording(aggregation.SecureAggregation):
        def combine_messages(self, wmsgs, key_words, *, alive=None,
                             device=None):
            out = super().combine_messages(wmsgs, key_words, alive=alive,
                                           device=device)
            calls.append((wmsgs, key_words, alive, out))
            return out

    runtime.run_alg1(data, part, aggregation=Recording(),
                     staleness=staleness, **kw)
    dropped = 0
    for wmsgs, key_words, alive, out in calls:
        msgs = ops.flatten_padded(wmsgs, lead=1)
        agg = sa.masked_sum_2d(msgs, int(key_words[0]), int(key_words[-1]),
                               scale_bits=SCALE_BITS,
                               num_clients=msgs.shape[0], alive=alive,
                               device=msgs.device)
        want = (sa.quantize(msgs, SCALE_BITS)
                * alive.reshape(-1, 1, 1)).sum(0, dtype=torch.int32)
        flat = torch.cat([v.reshape(-1) for v in tree.leaves(out)])
        if not torch.equal(agg, want) or not torch.equal(
                flat, sa.dequantize(agg, SCALE_BITS).reshape(-1)[
                    :flat.numel()]):
            raise AssertionError("async_secure: the masked sum through "
                                 "alive is not the survivor sum")
        dropped += int((alive == 0).sum())
    if len(calls) != kw["rounds"] or not dropped:
        raise AssertionError(f"async_secure: {len(calls)} combines, "
                             f"{dropped} dropped slots")
    log(f"async_secure: {len(calls)} rounds' masked sums through alive "
        f"({dropped} dropped slots) == sum of the survivors' "
        "quantize(lambda'_i m_i), bit for bit")


def phase_rwkv_sampled(torch, kernels, runtime):
    """rwkv_small (the reduced RWKV-6) under FedSGD with ``sampled(2)`` of
    4 clients, 3 rounds: finite costs, the WKV scan launched once per
    layer per forward (one super-batch upload and two eval forwards a
    round); returns the launches."""
    from repro_torch.data import partition
    from repro_torch.fed import aggregation
    from repro_torch.fed.tasks import rwkv6_task
    task = rwkv6_task()
    data = task.default_data(n_train=96, n_test=24, seed=0)
    part = partition.iid(96, 4, seed=0)
    rounds = 3
    reset_counts(kernels)
    _, hist = runtime.run_fedsgd(
        data, part, task=task, batch_size=4, rounds=rounds, lr_a=0.5,
        eval_every=1, eval_samples=48, seed=1,
        aggregation=aggregation.sampled(2), device="cuda")
    launches = {k: fn.launches for k, fn in kernels.items()}
    launches.update(variant_counts(kernels))
    # the counts by mask are left to variant_counts' own check
    masks = mask_keys(kernels)
    want = {k: 0 for k in launches if k not in masks}
    want.update(rwkv6_wkv=2 * 3 * rounds, rwkv6_wkv_mma=2 * 3 * rounds)
    log(f"rwkv_small_sampled: launches over {rounds} rounds: {launches}; "
        f"train cost {hist.train_cost}, participants "
        f"{hist.comm['participants']}")
    if {k: launches[k] for k in want} != want \
            or hist.comm["participants"] != 2 or not all(
            math.isfinite(c) for c in hist.train_cost):
        raise AssertionError(f"rwkv_small_sampled: launches {launches}, "
                             f"want {want}; cost {hist.train_cost}")
    return launches


# the engine's single-device modes: (name, runtime entry, arguments,
# launches over ROUNDS rounds other than 0, launches with alive, uplink
# bytes a round, the comm entry to check ("async" or "pipeline") and its
# value, the run it equals bit for bit: None or (what, arguments))
MLP_N = 101_632


def tree_uplink(s, g, n=MLP_N):
    """The hierarchical secure ledger's uplink a round: S client uploads
    with M − 1 group peers' seed shares, and G edge partials with G − 1
    group-level ones."""
    m = -(-s // g)
    return s * (4 * n + 4 * (m - 1)) + g * (4 * n + 4 * (g - 1))


def engine_mode_paths():
    from repro_torch.fed import aggregation, compression
    from repro_torch.fed.staleness import ConstantDiscount, StalenessConfig
    per = ROUNDS
    alg1 = dict(batch_size=100, fused=True)
    hier2 = aggregation.hierarchical(aggregation.secure(), groups=2)
    tau1 = dict(staleness=StalenessConfig(max_staleness=1,
                                          schedule=ConstantDiscount()),
                staleness_trace=[[1] * CLIENTS] * ROUNDS)
    pipe = ("pipeline", {"enabled": True, "depth": 1,
                         "extra_snapshot_slots": 1})
    return [
        ("hier2_secure", dict(alg1, aggregation=hier2),
         {"ssca_update": per, "masked_sum": 2 * per,
          "masked_ring_sum": per}, 0, tree_uplink(CLIENTS, 2), None,
         ("flat secure", dict(alg1, secure=True))),
        ("hier3_secure", dict(alg1, aggregation=aggregation.hierarchical(
            aggregation.secure(), groups=3)),
         {"ssca_update": per, "masked_sum": 3 * per,
          "masked_ring_sum": per}, 0, tree_uplink(CLIENTS, 3), None,
         ("flat secure", dict(alg1, secure=True))),
        ("hier2_topk8_secure", dict(alg1, aggregation=hier2,
                                    compressor=compression.topk(0.1,
                                                                bits=8)),
         {"ssca_update": per, "masked_sum": 2 * per, "masked_ring_sum": per,
          "compress": per}, 0, tree_uplink(CLIENTS, 2), None, None),
        ("async_hier2_secure", dict(alg1, aggregation=hier2,
                                    staleness=StalenessConfig(
                                        max_staleness=2,
                                        delay_probs=ASYNC_PROBS)),
         {"ssca_update": per, "masked_sum": 2 * per,
          "masked_ring_sum": per}, 2 * per, tree_uplink(CLIENTS, 2),
         ("async", async_ledger(2, 33, 16)), None),
        ("pipeline_secure", dict(alg1, secure=True, pipeline=True),
         {"ssca_update": per, "masked_sum": per}, 0, 4_065_640, pipe,
         ("async τ ≡ 1", dict(alg1, secure=True, **tau1))),
        ("pipeline_hier2_secure", dict(alg1, aggregation=hier2,
                                       pipeline=True),
         {"ssca_update": per, "masked_sum": 2 * per,
          "masked_ring_sum": per}, 0, tree_uplink(CLIENTS, 2), pipe,
         ("async τ ≡ 1", dict(alg1, aggregation=hier2, **tau1))),
    ]


def masked_us(torch, prof):
    """Device µs of the masked sum's two instances in one profiled run:
    the quantizing one (``masked_sum``) and the ring mode
    (``masked_ring_sum``)."""
    us = {"masked_sum": 0.0, "masked_ring_sum": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "masked_sum_kernel" in e.name:
            kind = "masked_ring_sum" if "masked_sum_kernel<int" in e.name \
                else "masked_sum"
            us[kind] += e.time_range.elapsed_us()
    return us


def phase_ring_parity(torch, sa):
    """The masked sum's ring mode against its plain version on the card,
    bit for bit: the tree's level-2 shapes at the MLP's 794 rows (G = 2,
    3, 16; both variants), dropouts, group offsets (5 of 16; 2 of 4, a
    (2, 1) group mesh's tile), 600 groups (the table in chunks) and rows
    one element past alignment; the whole set
    of groups sums to the plain int32 sum.  Returns the max abs error."""
    g = torch.Generator().manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rows(num, r):
        return torch.randint(-2 ** 31, 2 ** 31, (num, r, 128), generator=g,
                             dtype=torch.int64).to(torch.int32).cuda()

    err = 0
    for num, groups, r, offset, alive, shift in (
            (2, 2, 794, 0, None, False), (3, 3, 794, 0, None, False),
            (16, 16, 794, 0, None, False), (16, 16, 4608, 0, None, False),
            (16, 16, 794, 0, [1, 0] * 8, False), (3, 16, 794, 5, None, False),
            (3, 600, 4608, 0, None, False), (3, 600, 8, 0, None, False),
            (16, 16, 794, 0, None, True),
            # the group mesh's level 2 at (2, 1): a rank's 2 groups at
            # group_offset 2 of 4
            (2, 4, 794, 2, None, False)):
        q = rows(num, r)
        if shift:
            q = misaligned(torch, q)
        a = None if alive is None else torch.tensor(alive, device="cuda")
        kw = dict(num_clients=groups, client_offset=offset, alive=a)
        variant = sa.launch_plan(r * 128, num, groups, sms)[0]
        before = dict(sa.masked_ring_sum_2d.launches_by_variant)
        got = sa.masked_ring_sum_2d(q, 0x8BADF00D, 0x1234567, **kw)
        before[variant] += 1
        if a is not None:
            before["alive"] += 1
        want = sa.masked_ring_sum_plain(q, 0x8BADF00D, 0x1234567, **kw)
        torch.cuda.synchronize()
        err = max(err, int((got.long() - want.long()).abs().max()))
        name = (f"({num}, {r}, 128) of {groups} groups at offset {offset}"
                f"{', dropouts' if a is not None else ''}"
                f"{', one element past alignment' if shift else ''}")
        if not torch.equal(got, want) or \
                sa.masked_ring_sum_2d.launches_by_variant != before:
            raise AssertionError(
                f"masked_ring_sum differs from plain: {name} "
                f"({sa.masked_ring_sum_2d.launches_by_variant})")
        if offset == 0 and num == groups and a is None:
            total = q.long().sum(0) & 0xFFFFFFFF
            total = torch.where(total >= 2 ** 31, total - 2 ** 32, total)
            if not torch.equal(got, total.to(torch.int32)):
                raise AssertionError(f"masked_ring_sum != plain ring sum: "
                                     f"{name}")
        log(f"masked_ring_sum: kernel == plain bit for bit: {name} "
            f"({variant})")
    return err


def phase_engine_modes(torch, kernels, data, parts, params, runtime, card):
    """The engine's single-device modes at the MLP's full width on the
    card: the hierarchical secure tree (G = 2 and 3, with top-k, async
    with dropouts), pipelined rounds (flat and under the tree), a
    profiled pipelined run, and the tree at a cohort of 512 of 10,000
    clients beside flat secure.  Exact launches (the ring mode too),
    ledgers and bitwise equalities, finite costs, and a 5-round run held
    to the port's CPU run; returns each path's launches."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.fed import aggregation
    from repro_torch.kernels import secure_agg as sa
    by_path = {}
    part = parts["main"]
    for name, extra, nonzero, alive, up, entry, same in engine_mode_paths():
        kw = dict(extra, eval_every=10, seed=0, params=params)
        reset_counts(kernels)
        p_gpu, h_gpu = runtime.run_alg1(data, part, device="cuda",
                                        rounds=ROUNDS, **kw)
        launches = {k: fn.launches for k, fn in kernels.items()}
        want = {k: nonzero.get(k, 0) for k in kernels}
        n_alive = sa.masked_sum_2d.launches_by_variant["alive"] \
            + sa.masked_ring_sum_2d.launches_by_variant["alive"]
        log(f"{name}: launches over {ROUNDS} rounds: {launches}, with "
            f"alive {n_alive}")
        if launches != want or n_alive != alive:
            raise AssertionError(f"{name}: launches {launches} ("
                                 f"{variant_counts(kernels)}), want {want} "
                                 f"and {alive} with alive")
        by_path[name] = {**launches, **variant_counts(kernels)}
        got_entry = {k: h_gpu.comm.get(k) for k in ("async", "pipeline")}
        want_entry = {"async": None, "pipeline": None}
        if entry is not None:
            want_entry[entry[0]] = entry[1]
        if (h_gpu.uplink_bytes_per_round, h_gpu.downlink_bytes_per_round) \
                != (up, 4_065_280) or got_entry != want_entry:
            raise AssertionError(
                f"{name}: ledger {h_gpu.uplink_bytes_per_round} up, "
                f"{h_gpu.downlink_bytes_per_round} down, {got_entry}; want "
                f"{up}, 4065280, {want_entry}")
        cost = h_gpu.train_cost
        if not all(math.isfinite(c) for c in cost + h_gpu.test_accuracy):
            raise AssertionError(f"{name}: metrics not finite: {cost}")
        log(f"{name}: ledger {up} up / 4065280 down bytes a round "
            f"(group hop {h_gpu.comm['breakdown']['group_uplink_bytes']}), "
            f"{json.dumps(got_entry)}; train cost {cost}, test accuracy "
            f"{h_gpu.test_accuracy}; round time "
            f"{h_gpu.wall_seconds / ROUNDS * 1e3:.3f} ms (I = {CLIENTS}, "
            f"B = 100, eval every 10 rounds included) on {card}")
        if same is not None:
            same_run(torch, f"{name} against {same[0]}", (p_gpu, h_gpu),
                     runtime.run_alg1(data, part, device="cuda",
                                      rounds=ROUNDS,
                                      **dict(same[1], eval_every=10, seed=0,
                                             params=params)))
        del p_gpu
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, h_prof = runtime.run_alg1(data, part, device="cuda",
                                         rounds=ROUNDS, **kw)
        us, top_other = device_us_by_kind(torch, prof)
        busy = sum(v for k, v in us.items() if k != "staging_htod")
        log(f"{name}: profile:", json.dumps({
            "rounds": ROUNDS, "profiled_wall_ms": h_prof.wall_seconds * 1e3,
            "device_us": us, "masked_sum_us_by_mode": masked_us(torch, prof),
            "device_busy_share_of_round_loop":
                busy / (h_prof.wall_seconds * 1e6),
            "largest_other_us": top_other}))

        # the card against the port's CPU run, over fewer rounds (the
        # participation phase's limits)
        short = dict(kw, rounds=CARD_CPU_ROUNDS, eval_every=1)
        p_gpu, h_gpu = runtime.run_alg1(data, part, device="cuda", **short)
        t0 = time.perf_counter()
        p_cpu, h_cpu = runtime.run_alg1(data, part, device="cpu", **short)
        cpu_s = time.perf_counter() - t0
        diffs = card_vs_cpu(h_gpu, h_cpu, p_gpu, p_cpu)
        log(f"{name}: card vs CPU over {CARD_CPU_ROUNDS} rounds:",
            json.dumps(diffs), f"(CPU run {cpu_s:.1f} s)")
        limits = {"train_cost": 1e-6, "test_accuracy_abs": 1e-3,
                  "params_abs": 1e-3 if "topk" in name else 2e-5}
        if h_gpu.comm != h_cpu.comm or h_gpu.rounds != h_cpu.rounds:
            raise AssertionError(f"{name}: card and CPU ledgers differ")
        for k, lim in limits.items():
            if not diffs[k] <= lim:
                raise AssertionError(f"{name}: card run drifts from CPU run: "
                                     f"{k} {diffs[k]} > {lim}")
        del p_gpu, p_cpu
        torch.cuda.empty_cache()

    # profile_dir: the pipelined secure run writes one Chrome trace, which
    # names the masked sum's kernel
    with tempfile.TemporaryDirectory() as tmp:
        runtime.run_alg1(data, part, device="cuda", rounds=ROUNDS,
                         secure=True, pipeline=True, batch_size=100,
                         fused=True, eval_every=10, seed=0, params=params,
                         profile_dir=tmp)
        traces = [p for p in Path(tmp).rglob("*") if p.is_file()]
        if len(traces) != 1 or "masked_sum_kernel" not in \
                traces[0].read_text():
            raise AssertionError(f"profile_dir wrote {traces}, or its trace "
                                 "names no masked_sum_kernel")
        log(f"pipeline_secure with profile_dir: one trace, "
            f"{traces[0].stat().st_size} B, names masked_sum_kernel")

    by_path["hier16_S512"] = phase_hier16_s512(torch, kernels, data,
                                               parts["i10k"], runtime, tree,
                                               aggregation, card)
    return by_path


HIER_COHORT, HIER_GROUPS, HIER_ROUNDS = 512, 16, 10


def level1_parity(torch, members):
    """``masked_sum`` at the S = 512 tree's level-1 shape, (M, 794, 128)
    f32 of M = 32 members, under the key of the last group of round 1
    (the round key folded by the group id), against its plain version bit
    for bit: M(M − 1) = 992 directed streams.  With the ring mode's
    parity and the tree's bitwise equality with flat secure, it holds
    the flat path's (512, 794, 128) too."""
    from repro_torch.fed import keys
    from repro_torch.kernels import secure_agg as sa
    kd = keys.fold_in(keys.round_keys(0, 1)[0], [HIER_GROUPS - 1])[0]
    g = torch.Generator().manual_seed(8)
    msgs = (torch.randn(members, 794, 128, generator=g) * 1e-3).cuda()
    kw = dict(scale_bits=SCALE_BITS, num_clients=members)
    got = sa.masked_sum_2d(msgs, int(kd[0]), int(kd[-1]), **kw)
    want = sa.masked_sum_plain(msgs, int(kd[0]), int(kd[-1]), **kw)
    if not torch.equal(got, want):
        raise AssertionError(f"masked_sum at the tree's level-1 shape "
                             f"({members}, 794, 128) != plain")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variant = sa.launch_plan(794 * 128, members, members, sms)[0]
    log(f"masked_sum: kernel == plain bit for bit at the S = 512 tree's "
        f"level-1 shape ({members}, 794, 128) of {members} members under a "
        f"folded group key ({variant})")


def phase_hier16_s512(torch, kernels, data, part, runtime, tree, aggregation,
                      card):
    """A cohort of 512 of the 10,000-client population (6 samples each,
    B = 6, 10 rounds) under ``hierarchical(secure(num_sampled=512),
    groups=16)`` beside flat ``secure(num_sampled=512)``, on the card only
    (the CPU's plain masked sum at S = 512 is too slow): final weights bit
    for bit, the ledgers by the reference's formulas, each path's
    masked-sum device time and round time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.mlpapp import model
    s, g, rounds = HIER_COHORT, HIER_GROUPS, HIER_ROUNDS
    params = model.init_params(torch.Generator().manual_seed(0), 784, 128,
                               10)
    hier = aggregation.hierarchical(aggregation.secure(num_sampled=s),
                                    groups=g)
    flat = aggregation.secure(num_sampled=s)
    m = hier.members(part.num_clients)
    want = {"hier16": dict(agg=hier, up=tree_uplink(s, g),
                           launches={"ssca_update": rounds,
                                     "masked_sum": g * rounds,
                                     "masked_ring_sum": rounds},
                           root=g * 4 * MLP_N,
                           pairs=g * m * (m - 1) // 2 + g * (g - 1) // 2),
            "flat": dict(agg=flat, up=s * (4 * MLP_N + 4 * (s - 1)),
                         launches={"ssca_update": rounds,
                                   "masked_sum": rounds},
                         root=s * 4 * MLP_N, pairs=s * (s - 1) // 2)}
    if (want["hier16"]["up"], want["flat"]["up"], want["hier16"]["root"],
            want["hier16"]["pairs"], want["flat"]["pairs"]) != (
            214_711_232, 209_188_864, 6_504_448, 8_056, 130_816) or \
            hier.root_ingest_bytes(MLP_N, part.num_clients) \
            != want["hier16"]["root"] or \
            hier.mask_pair_count(part.num_clients) != want["hier16"]["pairs"]:
        raise AssertionError("hier16_S512: the tree's hooks differ from the "
                             "reference's formulas")
    level1_parity(torch, m)
    runs, launches_out = {}, {}
    for key, w in want.items():
        kw = dict(batch_size=POP_BATCH, rounds=rounds, eval_every=rounds,
                  seed=0, fused=True, params=params, aggregation=w["agg"])
        # warm-up at the path's shapes, kept out of the round time
        runtime.run_alg1(data, part, device="cuda", **dict(kw, rounds=2))
        reset_counts(kernels)
        p, h = runtime.run_alg1(data, part, device="cuda", **kw)
        launches = {k: fn.launches for k, fn in kernels.items()}
        if launches != {k: w["launches"].get(k, 0) for k in kernels} \
                or h.uplink_bytes_per_round != w["up"] \
                or h.downlink_bytes_per_round != s * 4 * MLP_N \
                or not all(math.isfinite(c) for c in h.train_cost):
            raise AssertionError(f"hier16_S512 ({key}): launches {launches},"
                                 f" ledger {h.uplink_bytes_per_round} / "
                                 f"{h.downlink_bytes_per_round}, cost "
                                 f"{h.train_cost}")
        if key == "hier16":
            launches_out = {**launches, **variant_counts(kernels)}
        runs[key] = (p, h)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, h_prof = runtime.run_alg1(data, part, device="cuda", **kw)
        us = masked_us(torch, prof)
        kinds, _ = device_us_by_kind(torch, prof)
        busy = sum(v for k, v in kinds.items() if k != "staging_htod") \
            / (h_prof.wall_seconds * 1e6)
        log(f"hier16_S512 ({key}): device busy {busy:.4f} of the profiled "
            f"round loop, device us by kind {json.dumps(kinds)}")
        log(f"hier16_S512 ({key}): uplink {h.uplink_bytes_per_round} B, "
            f"root ingest {w['root']} B, mask pairs {w['pairs']} a round; "
            f"round time {h.wall_seconds / rounds * 1e3:.3f} ms; masked-sum "
            "device time a round "
            f"{json.dumps({k: v / rounds for k, v in us.items()})} us "
            f"(profiled run {h_prof.wall_seconds / rounds * 1e3:.3f} ms a "
            f"round); train cost {h.train_cost} on {card}")
    same_run(torch, "hier16_S512 against flat secure(num_sampled=512)",
             runs["hier16"], runs["flat"])
    return launches_out


def phase_profile(torch, data, part, params, runtime):
    """Where the main path's round time goes: the same run once more
    under ``torch.profiler``, device activity summed by kind, and the
    host's CUDA calls a round.  The profiler slows the host, so the busy
    share it gives is a lower bound.  Then the calls once more with
    ``ops.flat_buffer`` made to find nothing, so the update copies every
    tree as it did before it read flat state in place: the difference is
    the copies that reading in place saves."""
    from torch.profiler import ProfilerActivity, profile
    kw = dict(batch_size=100, rounds=ROUNDS, eval_every=10, seed=0,
              secure=True, fused=True, params=params)
    with every_tree_copied(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p_copy, _ = runtime.run_alg1(data, part, device="cuda", **kw)
    copying = host_calls_per_round(prof, ROUNDS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_flat, hist = runtime.run_alg1(data, part, device="cuda", **kw)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(p_flat.values(), p_copy.values())):
        raise AssertionError("the main path with every tree copied is not "
                             "the in-place run bit for bit")
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
               loop_us / (hist.wall_seconds * 1e6),
           "host_calls_per_round": host_calls_per_round(prof, ROUNDS),
           "host_calls_per_round_every_tree_copied": copying}
    log("profile (round loop under torch.profiler):", json.dumps(out))


@contextlib.contextmanager
def every_tree_copied():
    """``ops.flat_buffer`` made to find nothing, so the fused update
    copies every tree into a padded buffer, as it did before it read
    flat state in place: the same bits, more copies."""
    from repro_torch.kernels import ops
    flat_buffer = ops.flat_buffer
    ops.flat_buffer = lambda tree: None
    try:
        yield
    finally:
        ops.flat_buffer = flat_buffer


def copies_saved(torch, run):
    """Device time (µs) of ``run`` under ``torch.profiler`` with every
    tree copied and reading in place: "other" and its device-to-device
    copies."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for mode in ("every_tree_copied", "in_place"):
        with (every_tree_copied() if mode == "every_tree_copied"
              else contextlib.nullcontext()), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            run()
        us, _ = device_us_by_kind(torch, prof)
        out[mode] = {"other_us": us["other"], "memcpy_dtod_us": sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.name.startswith("Memcpy DtoD"))}
    return out


# the host's calls that put work on the card: kernel launches, and the
# copies and fills the runtime issues without a kernel
HOST_CALLS = {"kernel_launches": ("cudaLaunchKernel", "cuLaunchKernel"),
              "memcpy": ("cudaMemcpyAsync",), "memset": ("cudaMemsetAsync",)}


def host_calls_per_round(prof, rounds):
    """The host's CUDA calls of a profiled run by kind, divided by its
    rounds (the run's set-up and eval included)."""
    counts = dict.fromkeys(HOST_CALLS, 0)
    for e in prof.events():
        for kind, names in HOST_CALLS.items():
            if e.name.startswith(names):
                counts[kind] += 1
    return {k: n / rounds for k, n in counts.items()}


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


def sdpa_backend(torch, lib_inputs, enable_gqa=True, causal=True):
    """The backend PyTorch's own selection gives
    ``scaled_dot_product_attention`` on ``lib_inputs`` (for example
    ``MATH`` or ``EFFICIENT_ATTENTION``), causal unless ``causal`` is
    False."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        *lib_inputs, is_causal=causal, enable_gqa=enable_gqa)).name


def band_pairs(s, window=0):
    """(query, visible key) pairs of one (batch row, head) at sequence
    length ``s``: query i sees min(i + 1, window) keys (all i + 1 without
    a window)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


# the paths whose flash launches are the hybrid's instances (head dim
# 256 on the wgmma kernel, the band on the tf32x3 one): the flash rows
# count their launches apart
def hybrid_path(name):
    return "hybrid" in name


# the moe serve paths at full width, whose flash launches run its grouped
# heads (G = 16, G = 5 at head dim 128): by flash timing row
def moe_flash_row(name):
    if name.startswith("serve_moe_interleaved_full"):
        return "flash_attention_g5"
    if name.startswith(("serve_moe_full", "mesh_moe_full")):
        return "flash_attention_g16"
    return None


# the vlm paths at full width (head dim 96 on the wgmma kernel: the train
# forward's row, the production mesh's twin steps included, and the serve
# forwards' row)
def vlm_flash_row(name):
    if name == "train_vlm_full" or name.startswith("mesh_host_vlm_full"):
        return "flash_attention_hd96"
    if name.startswith("serve_vlm_full"):
        return "flash_attention_hd96_serve"
    return None


# the audio paths, whose flash launches the rows count by mask
# (``launches_by_mask``): the decoder's causal ones, the encoder's
# self-attention and the cross-attention apart
def audio_path(name):
    return "audio" in name


def lm_path(name):
    """A path whose flash launches are the LM rows' (the dense, rwkv and
    the reduced moe and vlm paths)."""
    return not (hybrid_path(name) or audio_path(name)
                or moe_flash_row(name) or vlm_flash_row(name))


def mixed_path(name):
    """The production mesh's reduced gloo paths, which run every family's
    case: their flash launches are credited by instance (mask)."""
    return name.startswith("mesh_gloo")


def flash_row_paths():
    """Each flash row's (paths, the counts it reads there) pairs: the
    hybrid's instances (by variant) on its rows, the moe serve paths' and
    the vlm's on theirs, the audio paths' on theirs by mask (the decoder's
    causal self-attention, the encoder's, the cross-attention), the other
    paths' causal launches on the LM rows; the mixed gloo paths' band and
    unmasked launches on the f32 band and unmasked rows."""
    wgmma, tf32x3 = "flash_attention_wgmma", "flash_attention_tf32x3"
    return {
        "flash_attention": [(lm_path, (f"{wgmma}_causal",))],
        "flash_attention_tf32x3": [(lambda p: not hybrid_path(p),
                                    (f"{tf32x3}_causal",))],
        "flash_attention_hd256": [(hybrid_path, (wgmma,))],
        "flash_attention_tf32x3_band": [(hybrid_path, (tf32x3,)),
                                        (mixed_path, (f"{tf32x3}_band",))],
        **{row: [(lambda p, r=row: moe_flash_row(p) == r, (wgmma,))]
           for row in FLASH_MOE},
        **{row: [(lambda p, r=row: vlm_flash_row(p) == r, (wgmma,))]
           for row in ("flash_attention_hd96", "flash_attention_hd96_serve")},
        "flash_attention_audio_decoder": [(audio_path, (f"{wgmma}_causal",))],
        "flash_attention_encoder": [(audio_path, (f"{wgmma}_self",))],
        "flash_attention_cross": [(audio_path, (f"{wgmma}_cross",))],
        "flash_attention_tf32x3_noncausal": [
            (lambda p: audio_path(p) or mixed_path(p),
             (f"{tf32x3}_self", f"{tf32x3}_cross"))]}


def flash_row_launches(pairs, by_path):
    """A flash row's launches by path, from its :func:`flash_row_paths`
    pairs."""
    per = {}
    for paths, keys in pairs:
        for p, v in by_path.items():
            if paths(p):
                per[p] = per.get(p, 0) + sum(v.get(k, 0) for k in keys)
    return per


def phase_timing(torch, su, sa, kc, ks, fa, rw, launches, by_path, errs,
                 flash_stats, band_stats):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    n = 794 * 128
    w, lin, grad, beta = (torch.randn(794, 128, generator=g).to(dev)
                          for _ in range(4))
    sc = torch.tensor([0.5, 0.6, 0.1, 1e-5], device=dev)
    sc0 = torch.tensor([0.5, 0.6, 0.1, 0.0], device=dev)
    msgs = (torch.randn(CLIENTS, 794, 128, generator=g) * 1e-3).to(dev)
    kq = dict(scale_bits=SCALE_BITS)
    kw = dict(kq, num_clients=CLIENTS)
    ssca_bytes = {v: ssca_bytes_of(v, n) for v in su.VARIANTS}
    # the masked sum: every client local at offset 0, so its output needs
    # no stream (streams_needed)
    ms_bytes = (CLIENTS * n + n) * 4
    ms_streams = streams_needed(CLIENTS, 0, CLIENTS)
    ms_ops = n * (ms_streams * OPS_PER_STREAM + CLIENTS * OPS_PER_ROW)
    ms_alu = n * ms_streams * ALU_OPS_PER_STREAM
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
    def flash_work(b, s, h, hkv, dh, dtype, seed, window=0):
        x = flash_inputs(torch, b, s, h, hkv, dh, dtype, seed=seed)
        nbytes = x[0].element_size() * (2 * x[0].numel() + 2 * x[1].numel())
        # the library's layout is (B, H, S, Dh): transposed once, outside
        # the timed call
        lib = tuple(t.transpose(1, 2).contiguous() for t in x)
        return x, lib, nbytes, 2 * 2 * dh * b * h * band_pairs(s, window)

    def f32_route(flops):
        kind = min(("f32", "tf32x3"), key=lambda k: flops / RATES[k])
        return {kind: flops}

    fx, flib, f_bytes, f_flops = flash_work(*FLASH_PATH, torch.bfloat16, 2)
    sx_, slib, fs_bytes, fs_flops = flash_work(*FLASH_SMALL, torch.float32,
                                               2)
    wx, wlib, fw_bytes, fw_flops = flash_work(*FLASH_F32_WIDE, torch.float32,
                                              2)
    # the hybrid's: head dim 256 at its path's shape (window 2048 >= S:
    # the causal pairs), the same inputs at FLASH_BAND (the band's pairs),
    # and the f32 band at hybrid_small's shape; the library takes the
    # band as a boolean mask (True: attend)
    hx, hlib, fh_bytes, fh_flops = flash_work(*FLASH_HYBRID, torch.bfloat16,
                                              2)
    fb_flops = 2 * 2 * FLASH_HYBRID[4] * FLASH_HYBRID[0] * FLASH_HYBRID[2] \
        * band_pairs(FLASH_HYBRID[1], FLASH_BAND)
    hmask = fa.band_mask(FLASH_HYBRID[1], FLASH_BAND, "cuda")
    f32_band_shape, f32_band = FLASH_F32_BAND
    bx, blib, fbs_bytes, fbs_flops = flash_work(*f32_band_shape,
                                                torch.float32, 2, f32_band)
    bmask = fa.band_mask(f32_band_shape[1], f32_band, "cuda")
    # the moe serve forward's grouped heads: G = 16 and G = 5
    gx, glib, g_bytes, g_flops = {}, {}, {}, {}
    for row, shape in FLASH_MOE.items():
        gx[row], glib[row], g_bytes[row], g_flops[row] = flash_work(
            *shape, torch.bfloat16, 2)

    # the vlm's and audio's: q (B, Sq, H, Dh) against k, v (B, Sk, Hkv,
    # Dh), the causal pairs or, without causality, all Sq x Sk
    def flash_work_qk(b, sq, sk, h, hkv, dh, dtype, causal):
        x = flash_inputs_qk(torch, b, sq, sk, h, hkv, dh, dtype, seed=2)
        nbytes = x[0].element_size() * (2 * x[0].numel() + 2 * x[1].numel())
        lib = tuple(t.transpose(1, 2).contiguous() for t in x)
        pairs = band_pairs(sq) if causal else sq * sk
        return x, lib, nbytes, 2 * 2 * dh * b * h * pairs

    nx, nlib, n_bytes, n_flops, n_causal = {}, {}, {}, {}, {}
    for rows_, dtype in ((FLASH_NEW_ROWS, torch.bfloat16),
                         (FLASH_NEW_F32_ROWS, torch.float32)):
        for row, (shape, causal) in rows_.items():
            nx[row], nlib[row], n_bytes[row], n_flops[row] = flash_work_qk(
                *shape, dtype, causal)
            n_causal[row] = causal
    new_ops = {row: ({"bf16": n_flops[row]} if row in FLASH_NEW_ROWS
                     else f32_route(n_flops[row])) for row in n_flops}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_backends = {"flash_attention_tf32x3": sdpa_backend(torch, slib),
                     "flash_attention_f32_wide": sdpa_backend(torch, wlib),
                     **{row: sdpa_backend(torch, nlib[row],
                                          causal=n_causal[row])
                        for row in FLASH_NEW_F32_ROWS}}
    # the WKV scan at the RWKV path's shape, model-like decays; no single
    # PyTorch call computes it
    wkx = wkv_inputs(torch, *WKV_PATH, torch.bfloat16, seed=2)
    w_bytes, w_ops, w_chunk = wkv_work(*WKV_PATH)
    rows = []
    # the flash row is the wgmma kernel's; the tf32x3 kernel has a row at
    # the small LM's shape and a timing row at FLASH_F32_WIDE, a width no
    # path runs in f32, whose launches are 0
    launch_key = {"rwkv6_wkv": "rwkv6_wkv_mma",
                  "ssca_update": "ssca_update_beta"}
    timing_only = {"flash_attention_f32_wide", "flash_attention_hd256_band",
                   *FLASH_NEW_TIMING_ONLY}
    flash_rows = flash_row_paths()

    def row_launches(name):
        if name in timing_only:
            return 0, {}
        if name in flash_rows:
            per = flash_row_launches(flash_rows[name], by_path)
            return sum(per.values()), per
        key = launch_key.get(name, name)
        return launches[key], {p: v.get(key, 0) for p, v in by_path.items()}

    # every flash launch of every path on one row, and on one only
    credited = sum(row_launches(row)[0] for row in flash_rows)
    flash_total = sum(v.get("flash_attention", 0) for v in by_path.values())
    if credited != flash_total:
        raise AssertionError(f"the flash rows count {credited} launches, "
                             f"the paths {flash_total}")
    for name, src, replaces, kern, plain, library, nbytes, ops in (
            ("ssca_update", "src/repro_torch/kernels/csrc/ssca_update.cu",
             "src/repro/kernels/ssca_update.py:54",
             lambda: su.ssca_update_2d(w, lin, grad, beta, sc),
             lambda: su.ssca_update_plain(w, lin, grad, beta, sc), None,
             ssca_bytes["beta"], {"f32": FLOPS_SSCA["beta"] * n}),
            ("ssca_update_lambda0",
             "src/repro_torch/kernels/csrc/ssca_update.cu",
             "src/repro/kernels/ssca_update.py:54",
             lambda: su.ssca_update_2d(w, lin, grad, None, sc0),
             lambda: su.ssca_update_plain(w, lin, grad, None, sc0), None,
             ssca_bytes["lambda0"], {"f32": FLOPS_SSCA["lambda0"] * n}),
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
            ("flash_attention_hd256",
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:78",
             lambda: fa.flash_attention_bhsd(*hx, window=HYBRID_WINDOW),
             lambda: fa.flash_attention_plain(*hx),
             lambda: sdpa(*hlib, is_causal=True, enable_gqa=True),
             fh_bytes, {"bf16": fh_flops}),
            ("flash_attention_hd256_band",
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:78",
             lambda: fa.flash_attention_bhsd(*hx, window=FLASH_BAND),
             lambda: fa.flash_attention_plain(*hx, FLASH_BAND),
             lambda: sdpa(*hlib, attn_mask=hmask, enable_gqa=True),
             fh_bytes, {"bf16": fb_flops}),
            ("flash_attention_tf32x3_band",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:78",
             lambda: fa.flash_attention_bhsd(*bx, window=f32_band),
             lambda: fa.flash_attention_plain(*bx, f32_band),
             lambda: sdpa(*blib, attn_mask=bmask, enable_gqa=True),
             fbs_bytes, f32_route(fbs_flops)),
            *((row, "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
               "src/repro/kernels/flash_attention.py:78",
               lambda r=row: fa.flash_attention_bhsd(*gx[r]),
               lambda r=row: fa.flash_attention_plain(*gx[r]),
               lambda r=row: sdpa(*glib[r], is_causal=True,
                                  enable_gqa=True),
               g_bytes[row], {"bf16": g_flops[row]}) for row in FLASH_MOE),
            *((row, "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
               if row in FLASH_NEW_ROWS
               else "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:78",
               lambda r=row: fa.flash_attention_bhsd(*nx[r],
                                                     causal=n_causal[r]),
               lambda r=row: fa.flash_attention_plain(*nx[r],
                                                      causal=n_causal[r]),
               lambda r=row: sdpa(*nlib[r], is_causal=n_causal[r],
                                  enable_gqa=True),
               n_bytes[row], new_ops[row]) for row in n_flops),
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
        n_launches, per_path = row_launches(name)
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": n_launches,
            "launches_by_path": per_path,
            "max_abs_err": errs[name], "ms": time_ms(kern),
            "plain_ms": time_ms(plain, iters=5, repeats=3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if library is None else time_ms(library),
            "bound_parts_ms": parts})
        if name.startswith("ssca_update"):
            rows[-1]["variant"] = next(v for v, r in SSCA_ROW.items()
                                       if r == name)
            rows[-1]["launches_by_variant"] = {
                v: launches[f"ssca_update_{v}"] for v in su.VARIANTS}
        if name == "masked_sum":
            rows[-1]["launches_by_variant"] = {
                v: launches[f"masked_sum_{v}"]
                for v in sa.masked_sum_2d.launches_by_variant}
            rows[-1]["streams_needed"] = ms_streams
            rows[-1]["streams_run"] = CLIENTS * (CLIENTS - 1)
            rows[-1]["shard"] = shard_timing(
                torch, lambda q, k0, k1, **a: sa.masked_sum_2d(q, k0, k1,
                                                               **a, **kq),
                lambda q, k0, k1, **a: sa.masked_sum_plain(q, k0, k1, **a,
                                                           **kq),
                msgs[5:8].contiguous(), CLIENTS, 5, OPS_PER_ROW)
            log("masked_sum at a shard of 3 of 10 clients at offset 5:",
                json.dumps(rows[-1]["shard"]))
            # a (1, 2) group mesh's level-1 tile: 2 of a group's 4
            # members at offset 2
            rows[-1]["group_shard"] = shard_timing(
                torch, lambda q, k0, k1, **a: sa.masked_sum_2d(q, k0, k1,
                                                               **a, **kq),
                lambda q, k0, k1, **a: sa.masked_sum_plain(q, k0, k1, **a,
                                                           **kq),
                msgs[5:7].contiguous(), 4, 2, OPS_PER_ROW)
            log("masked_sum at a group mesh's tile, 2 of 4 members at "
                "offset 2:", json.dumps(rows[-1]["group_shard"]))
        if name.startswith("flash_attention"):
            rows[-1]["shape"] = list(
                {"flash_attention": FLASH_PATH,
                 "flash_attention_tf32x3": FLASH_SMALL,
                 "flash_attention_hd256": FLASH_HYBRID,
                 "flash_attention_hd256_band": FLASH_HYBRID,
                 "flash_attention_tf32x3_band": f32_band_shape,
                 **FLASH_MOE,
                 **{r: shape for r, (shape, _) in [
                     *FLASH_NEW_ROWS.items(), *FLASH_NEW_F32_ROWS.items()]}
                 }.get(name, FLASH_F32_WIDE))
            if name in n_causal:
                rows[-1]["shape_order"] = "B, Sq, Sk, H, Hkv, Dh"
                rows[-1]["causal"] = n_causal[name]
            rows[-1]["window"] = {"flash_attention_hd256": HYBRID_WINDOW,
                                  "flash_attention_hd256_band": FLASH_BAND,
                                  "flash_attention_tf32x3_band": f32_band
                                  }.get(name, 0)
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
        if name == "flash_attention_hd256":
            rows[-1]["bf16_check"] = band_stats[HYBRID_WINDOW]
        if name == "flash_attention_hd256_band":
            rows[-1]["bf16_check"] = band_stats[FLASH_BAND]
        if name in FLASH_MOE or name in FLASH_NEW_ROWS:
            rows[-1]["bf16_check"] = band_stats[name]
        if name == "rwkv6_wkv":
            rows[-1]["shape"] = list(WKV_PATH)
            rows[-1]["launches_by_variant"] = {
                v: launches[f"rwkv6_wkv_{v}"]
                for v in rw.rwkv6_wkv_bh.launches_by_variant}
        log(f"{name}: {time_ms(kern, graph=False):.4f} ms a call when "
            "launched eagerly from Python (wrapper overhead included)")
    floor = launch_floor_ms(torch)
    small = ("ssca_update", "ssca_update_lambda0", "masked_sum",
             "sketch_encode", "flash_attention_tf32x3",
             "flash_attention_tf32x3_band", "flash_attention_tf32x3_noncausal")
    for row in rows:
        if row["name"] in small:
            row["launch_floor_ms"] = floor
    log(f"launch floor: {floor * 1e3:.4f} us a launch of an empty kernel "
        "(graph replay), beside", ", ".join(
            f"{r['name']} {r['ms'] * 1e3:.4f} us" for r in rows
            if r["name"] in small[:4]), "at the MLP shape")
    log(f"rwkv6_wkv bound at (N, S, H, D) = {WKV_PATH}: "
        f"{w_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes ({w_bytes} B), "
        f"{w_ops['tf32'] / TF32_FLOPS_PER_S * 1e3:.4f} ms by products "
        f"({w_ops['tf32']} FLOP at the TF32 rate), "
        f"{w_ops['f32'] / FP32_FLOPS_PER_S * 1e3:.4f} ms by elementwise "
        f"terms ({w_ops['f32']} f32 FLOP), the chunked form at chunk "
        f"{w_chunk}, the causal pairs only")
    return rows


# the ring mode's operations per element of one group row: the running
# sum times alive, one multiply-add (no quantize)
OPS_PER_RING_ROW = 1


def streams_needed(i_loc, offset, num_clients, alive=None):
    """Directed mask streams an element that the masked sum's output
    needs, in either mode: each live local row's streams to the live rows
    outside [offset, offset + i_loc).  A stream between two live local
    rows cancels its partner's in the sum mod 2^32 (and one to or from a
    dropped row is never added), so at offset 0 with every row local the
    output is the plain sum of the rows and needs no stream: a function
    that skips those streams gives the same bits."""
    live = [1] * num_clients if alive is None else [int(a) for a in alive]
    local = range(offset, offset + i_loc)
    outside = sum(live[j] for j in range(num_clients) if j not in local)
    return sum(live[i] for i in local) * outside


def mask_work(rows, n, streams, per_row):
    """The masked sum's bound's parts in ms, either mode, over ``rows``
    local rows of n elements whose output needs ``streams`` directed
    streams an element (:func:`streams_needed`).  Bytes: each row read
    once, the sum written once, (rows + 1)·4·n.  Operations: each stream
    at OPS_PER_STREAM (ALU_OPS_PER_STREAM of them on the ALU pipe) and
    ``per_row`` a row (OPS_PER_ROW quantizing, OPS_PER_RING_ROW in the
    ring mode)."""
    ops = {"int32": n * (streams * OPS_PER_STREAM + rows * per_row),
           "int32_alu": n * streams * ALU_OPS_PER_STREAM}
    parts = {"bytes": (rows + 1) * 4 * n / HBM_BYTES_PER_S * 1e3}
    parts.update({k: v / RATES[k] * 1e3 for k, v in ops.items()})
    return parts


def bound_of(parts):
    """(bound_ms, bound_by) of a bound's parts."""
    ops_ms = max(v for k, v in parts.items() if k != "bytes")
    return max(parts["bytes"], ops_ms), \
        "bytes" if parts["bytes"] >= ops_ms else "operations"


def shard_timing(torch, kernel, plain, q, num_clients, offset, per_row):
    """One mode of the masked sum at a shard, where its streams are real:
    the rows ``q`` (I_loc, R, 128) are rows [offset, offset + I_loc) of
    ``num_clients``, so their streams to the other rows do not cancel.
    Held bit for bit against the plain version, then timed (graph
    replay) beside the bound of the streams its output needs."""
    kw = dict(num_clients=num_clients, client_offset=offset)
    if not torch.equal(kernel(q, 1, 2, **kw), plain(q, 1, 2, **kw)):
        raise AssertionError(f"masked sum at a shard {tuple(q.shape)} of "
                             f"{num_clients} at offset {offset} != plain")
    i_loc, r = q.shape[:2]
    needed = streams_needed(i_loc, offset, num_clients)
    parts = mask_work(i_loc, r * 128, needed, per_row)
    bound, by = bound_of(parts)
    return {"shape": list(q.shape), "num_clients": num_clients,
            "offset": offset, "streams_needed": needed,
            "streams_run": i_loc * (num_clients - 1),
            "ms": time_ms(lambda: kernel(q, 1, 2, **kw)), "bound_ms": bound,
            "bound_by": by, "bound_parts_ms": parts}


def ring_full_width(torch, sa):
    """The ring mode timed directly at llama3-8b's full-width row count
    with G = 2 group partials: the median of 5 eager launches after 2
    warm-ups, from CUDA events; the output checked against the plain
    int32 sum (entries in ±2^30, so the sum does not wrap).  Buffers:
    7.7 GB in, 3.8 GB out."""
    rows = -(-LM_PARAMS // 128)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randint(-2 ** 30, 2 ** 30, (2, rows, 128), device="cuda",
                      generator=gen, dtype=torch.int32)
    ms = eager_ms(lambda: sa.masked_ring_sum_2d(q, 1, 2, num_clients=2))
    got = sa.masked_ring_sum_2d(q, 1, 2, num_clients=2)
    if not torch.equal(got, q[0] + q[1]):
        raise AssertionError("masked_ring_sum at llama3-8b's width != the "
                             "plain int32 sum")
    del q, got
    torch.cuda.empty_cache()
    parts = mask_work(2, rows * 128, streams_needed(2, 0, 2),
                      OPS_PER_RING_ROW)
    bound, by = bound_of(parts)
    out = {"rows": rows, "groups": 2, "direct_ms": ms, "bound_ms": bound,
           "bound_by": by, "bound_parts_ms": parts}
    log("masked_ring_sum at llama3-8b's full-width rows, G = 2, direct "
        "launches, checked against the int32 sum:", json.dumps(out))
    return out


def ring_row(torch, sa, launches, by_path, err, full_width):
    """The ``{"kernels": [...]}`` row of the masked sum's ring mode,
    timed at the S = 512 tree's level 2, (G, R, 128) = (16, 794, 128)
    int32, every group local at offset 0 (so its bound is its bytes:
    :func:`streams_needed`), with its time at llama3-8b's width and at a
    shard of 3 of the 16 groups at offset 5 beside it."""
    g = torch.Generator().manual_seed(6)
    shape = (HIER_GROUPS, 794, 128)
    q = torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                      dtype=torch.int64).to(torch.int32).cuda()
    needed = streams_needed(shape[0], 0, shape[0])
    parts = mask_work(shape[0], shape[1] * shape[2], needed,
                      OPS_PER_RING_ROW)
    bound, by = bound_of(parts)
    shard = shard_timing(torch, sa.masked_ring_sum_2d,
                         sa.masked_ring_sum_plain, q[5:8].contiguous(),
                         shape[0], 5, OPS_PER_RING_ROW)
    # a (2, 1) group mesh's level 2: 2 of 4 groups at offset 2
    group_shard = shard_timing(torch, sa.masked_ring_sum_2d,
                               sa.masked_ring_sum_plain, q[2:4].contiguous(),
                               4, 2, OPS_PER_RING_ROW)
    row = {"name": "masked_ring_sum", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/secure_agg.cu",
           "replaces": "src/repro/kernels/secure_agg.py:233",
           "launches": launches["masked_ring_sum"],
           "launches_by_path": {p: v.get("masked_ring_sum", 0)
                                for p, v in by_path.items()},
           "launches_by_variant": {
               v: launches[f"masked_ring_sum_{v}"]
               for v in sa.masked_ring_sum_2d.launches_by_variant},
           "max_abs_err": err,
           "ms": time_ms(lambda: sa.masked_ring_sum_2d(
               q, 1, 2, num_clients=shape[0])),
           "plain_ms": time_ms(lambda: sa.masked_ring_sum_plain(
               q, 1, 2, num_clients=shape[0]), iters=5, repeats=3),
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "bound_parts_ms": parts, "shape": list(shape),
           "streams_needed": needed,
           "streams_run": shape[0] * (shape[0] - 1), "shard": shard,
           "group_shard": group_shard,
           "full_width": {"llama3-8b": full_width}}
    log(f"masked_ring_sum: {row['ms'] * 1e3:.4f} us at {shape} against a "
        f"{bound * 1e3:.4f} us bound ({by}); at a shard of 3 of 16 groups "
        f"at offset 5: {shard['ms'] * 1e3:.4f} us against "
        f"{shard['bound_ms'] * 1e3:.4f} us ({shard['bound_by']}); at a "
        f"group mesh's 2 of 4 groups at offset 2: "
        f"{group_shard['ms'] * 1e3:.4f} us against "
        f"{group_shard['bound_ms'] * 1e3:.4f} us ({group_shard['bound_by']})")
    return row


def ssca_bytes_of(variant, n):
    """The bytes an ``ssca_update`` variant must move over n elements:
    each input read once, each output written once, and the 4 scalars
    (beta: w, lin, g, β in and w', lin', β' out; lambda0: w, lin, g in and
    w', lin' out)."""
    return ((7 if variant == "beta" else 5) * n + 4) * 4


def full_width_rows(rows, by_path, profiled, direct):
    """The server-side kernels at the full-width LM paths' shapes: the
    ``masked_sum`` and both ``ssca_update`` rows gain, for each path, the
    launches, the device time of the profiled round's one launch (the
    λ = 0 paths launch only ``lambda0``, so the ``beta`` row has none),
    the time of :func:`server_kernels_full_width`'s direct launches, and
    the bound at that path's padded parameter count (I = 4 clients)."""
    for row in rows:
        if row["name"] not in ("masked_sum", *SSCA_ROW.values()):
            continue
        row["full_width"] = {}
        for path, n in FULL_WIDTH.items():
            n = -(-n // 128) * 128
            if row["name"] == "masked_sum":
                parts = mask_work(LM_CLIENTS, n, streams_needed(
                    LM_CLIENTS, 0, LM_CLIENTS), OPS_PER_ROW)
                nbytes = (LM_CLIENTS * n + n) * 4
                ops_ms = max(v for k, v in parts.items() if k != "bytes")
                launches = by_path[path]["masked_sum"]
                kind = "masked_sum"
            else:
                nbytes = ssca_bytes_of(row["variant"], n)
                ops_ms = FLOPS_SSCA[row["variant"]] * n / FP32_FLOPS_PER_S \
                    * 1e3
                launches = by_path[path][f"ssca_update_{row['variant']}"]
                kind = "ssca_update"
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row["full_width"][path] = {
                "elements": n,
                "launches": launches,
                "ms": profiled[path][kind] / 1e3 if launches else None,
                "direct_ms": direct[path][f"{row['name']}_ms"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_parts_ms": {"bytes": bytes_ms, "operations": ops_ms}}
        log(f"{row['name']} at the full-width LM paths (ms: the profiled "
            "round's launch; direct_ms: the median of 5 eager launches):",
            json.dumps(row["full_width"]))


# the client-sharded rounds (phase_client_mesh), at the paths' PERF.md §4
# configurations, 20 rounds: (name, runtime entry, population, arguments,
# arena, psum calls a round on one rank, masked sums with alive a round).
# The psums: the combine (two on the sketch's two phases), the
# home-sharded weight gather, for top-k and the sketch the residual rows'
# gather (home-sharded only) and their replication, and in async and
# pipelined rounds the packed snapshot ring's rebuild (home-sharded only)
def mesh_paths():
    from repro_torch.fed import aggregation, compression, sketch
    from repro_torch.fed.staleness import ConstantDiscount, StalenessConfig
    alg1 = dict(batch_size=100, fused=True)
    fedavg = dict(local_steps=2, lr_a=2.0, lr_alpha=0.3, batch_size=50)
    topk8 = compression.topk(0.1, bits=8)
    sk = sketch.sketch(4, 1024, 0.02, keep=256)
    k2 = StalenessConfig(max_staleness=2, delay_probs=ASYNC_PROBS)
    k0 = StalenessConfig(max_staleness=0, delay_probs=ASYNC_PROBS)
    tau1 = dict(staleness=StalenessConfig(max_staleness=1,
                                          schedule=ConstantDiscount()),
                staleness_trace=[[1] * CLIENTS] * ROUNDS)
    return [
        ("secure_dense", "run_alg1", "main", dict(alg1, secure=True),
         "sharded", 2, 0),
        ("topk8_secure", "run_alg1", "main",
         dict(alg1, secure=True, compressor=topk8), "sharded", 4, 0),
        ("topk8_secure_replicated", "run_alg1", "main",
         dict(alg1, secure=True, compressor=topk8), "replicated", 2, 0),
        ("sketch_secure", "run_alg1", "main",
         dict(alg1, secure=True, compressor=sk), "sharded", 5, 0),
        ("fedavg_topk8_secure", "run_fedavg", "main",
         dict(fedavg, aggregation=aggregation.secure(), compressor=topk8),
         "sharded", 4, 0),
        ("sampled_secure", "run_alg1", "i100",
         dict(alg1, aggregation=aggregation.secure(num_sampled=10)),
         "sharded", 2, 0),
        ("secure3", "run_alg1", "main",
         dict(alg1, aggregation=aggregation.secure(num_sampled=3)),
         "sharded", 2, 0),
        ("async_secure", "run_alg1", "main",
         dict(alg1, secure=True, staleness=k2), "sharded", 3, 1),
        ("drop_secure", "run_alg1", "main",
         dict(alg1, secure=True, staleness=k0), "sharded", 3, 1),
        ("async_plain", "run_alg1", "main", dict(alg1, staleness=k2),
         "sharded", 3, 0),
        ("async_fedavg_topk8_secure", "run_fedavg", "main",
         dict(fedavg, aggregation=aggregation.secure(), compressor=topk8,
              staleness=k2), "sharded", 5, 1),
        ("async_sketch_secure", "run_alg1", "main",
         dict(alg1, secure=True, compressor=sk, staleness=k2), "sharded", 6,
         2),
        ("pipeline_secure", "run_alg1", "main",
         dict(alg1, secure=True, pipeline=True), "sharded", 3, 0),
        ("tau1_secure", "run_alg1", "main", dict(alg1, secure=True, **tau1),
         "sharded", 3, 1),
    ]


# the async and pipelined paths, each also run with arena="replicated"
# on the one-rank mesh (its psums a round then: the combines and the
# residual rows' replication)
RING_PATHS = {"async_secure": 1, "drop_secure": 1, "async_plain": 1,
              "async_fedavg_topk8_secure": 2, "async_sketch_secure": 3,
              "pipeline_secure": 1, "tau1_secure": 1}
# the paths the two gloo ranks on one card run
GLOO_PATHS = ("secure_dense", "secure3", "sketch_secure",
              "fedavg_topk8_secure", "async_secure", "pipeline_secure",
              "tau1_secure", "async_fedavg_topk8_secure")
MESH_TIMEOUT_S = 600


def gloo_collectives(name, per_round):
    """(psums, chunked-ring calls) a round on two ranks: pipelined rounds
    reduce the masked partial through the ring instead of a psum."""
    return (per_round - 1, 1) if name.startswith("pipeline") \
        else (per_round, 0)


def path_bits(torch, params):
    """The final weights as int32 bits on the CPU, leaf order."""
    from repro_torch import tree
    return [v.detach().cpu().contiguous().view(torch.int32)
            for v in tree.leaves(params)]


def profiled_busy(torch, run):
    """The device's busy share of one more run under ``torch.profiler``
    (kernels by kind, host-to-device staging left out)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, h = run()
    us, _ = device_us_by_kind(torch, prof)
    return sum(v for k, v in us.items() if k != "staging_htod") \
        / (h.wall_seconds * 1e6)


def ring_tree(torch, rank):
    """A rank's share of the reference's mixed tree on ``cuda:0``
    (``tests/pipeline_engine_check.py::check_ring_psum``): int32 of
    length 37·13 + 3 over the full range, f32, a small int32 leaf."""
    g = torch.Generator().manual_seed(300 + rank)
    return {"a": torch.randint(-2 ** 31, 2 ** 31, (37, 13), generator=g,
                               dtype=torch.int64).to(torch.int32).cuda(),
            "b": torch.randn(5, generator=g).cuda(),
            "d": torch.randint(-100, 100, (3,), generator=g,
                               dtype=torch.int64).to(torch.int32).cuda()}


def ring_check(torch, mesh):
    """``ring_psum_chunked`` against ``psum`` on the mixed tree on the
    card, at 4, 3 and 7 pieces (484 int32 elements: even over 4, uneven
    over 3 and 7): bits equal, and the ring's counts."""
    x = ring_tree(torch, mesh.rank)
    want = mesh.psum(x)
    out = {}
    for chunks in (4, 3, 7):
        mesh.psum_calls = mesh.ring_calls = mesh.ring_bytes = 0
        mesh.ring_staged_bytes = 0
        got = mesh.ring_psum_chunked(x, chunks=chunks)
        out[chunks] = {
            "same_bits": all(torch.equal(got[k].view(torch.int32),
                                         want[k].view(torch.int32))
                             for k in x),
            "counts": [mesh.ring_calls, mesh.psum_calls, mesh.ring_bytes,
                       mesh.ring_staged_bytes]}
    return out


def mesh_rank_paths(names):
    """One rank of the two-rank gloo world on ``cuda:0``: the chunked
    ring against the psum, then each path of ``names`` on the client
    mesh, 20 rounds, with the masked sum's launch shapes, offsets and
    dropped slots recorded; returns what the parent checks."""
    import torch
    from repro_torch.fed import runtime
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.launch import make_client_mesh
    data, parts, params, kernels = rank_inputs()
    mesh = make_client_mesh()
    paths = {p[0]: p for p in mesh_paths()}
    launch = sa._launch
    seen = []

    def recording(fn, name, rows, scale_args, key0, key1, num_clients,
                  client_offset, alive, out):
        # the masked sum's kernel launches, as the wrapper makes them
        if name == "masked_sum":
            seen.append((list(rows.shape), int(client_offset),
                         int(num_clients),
                         None if alive is None else alive.clone()))
        return launch(fn, name, rows, scale_args, key0, key1, num_clients,
                      client_offset, alive, out)

    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), "wraps": mesh.int32_wraps,
           "ring": ring_check(torch, mesh), "paths": {}}
    sa._launch = recording
    try:
        for name in names:
            _, entry, pkey, extra, arena, _, _ = paths[name]

            def run(entry=entry, pkey=pkey, extra=extra, arena=arena):
                return getattr(runtime, entry)(
                    data, parts[pkey], rounds=ROUNDS, eval_every=10,
                    seed=0, params=params, mesh=mesh, arena=arena, **extra)
            run()                                   # warm-up
            reset_counts(kernels)
            seen.clear()
            mesh.psum_calls = mesh.all_reduces = mesh.psum_bytes = 0
            mesh.ring_calls = mesh.ring_bytes = mesh.ring_staged_bytes = 0
            torch.cuda.reset_peak_memory_stats()
            p, h = run()
            d = h.as_dict()
            wall = d.pop("wall_seconds")
            out["paths"][name] = {
                "bits": [b.numpy() for b in path_bits(torch, p)],
                "hist": d, "launches": {
                    **{k: f.launches for k, f in kernels.items()},
                    **variant_counts(kernels)},
                "alive_launches": sa.masked_sum_2d.launches_by_variant[
                    "alive"],
                "masked": [(s, o, n, None if a is None
                            else int((a == 0).sum()))
                           for s, o, n, a in seen],
                "psum_calls": mesh.psum_calls,
                "psum_bytes": mesh.psum_bytes, "ring_calls": mesh.ring_calls,
                "ring_bytes": mesh.ring_bytes,
                "ring_staged_bytes": mesh.ring_staged_bytes,
                "round_ms": wall / ROUNDS * 1e3,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "busy": profiled_busy(torch, run)}
            del p
    finally:
        sa._launch = launch
    return out


def upload_batch_witness(torch, data, params):
    """The per-slot uploads of the main path's first round under one vmap
    over all 10 slots against two vmaps over 5 (a rank's share on two
    ranks), on the card: the largest difference and the share of entries
    that differ.  Where they differ, the two-rank secure paths quantize
    other last bits than ``mesh=None`` (ROADMAP queue 3)."""
    from torch.func import vmap
    from repro_torch.core import protocol, ssca
    from repro_torch.core.schedules import paper_schedules
    from repro_torch.fed.engine import build_schedule
    from repro_torch.fed.tasks.base import SumLoss
    from repro_torch.fed.tasks.mlp import MLPTask
    from repro_torch.data import partition
    rho, gamma = paper_schedules(100)
    alg = protocol.SSCAUnconstrained(
        loss_fn=SumLoss(MLPTask(k=784, hidden=128, l=10)),
        hp=ssca.SSCAHyperParams(tau=0.1, lam=1e-5, rho=rho, gamma=gamma))
    p = {k: v.cuda() for k, v in params.items()}
    state = alg.init_state(p)
    _, idx = build_schedule(partition.iid(60000, CLIENTS, seed=0), 100, 1,
                            1, 0)
    idx = torch.as_tensor(idx[0], device="cuda")
    x = torch.as_tensor(data.x_train, device="cuda")[idx]
    y = torch.as_tensor(data.y_train, device="cuda")[idx]
    w = torch.full(idx.shape, 0.1, device="cuda")

    def upload(lo, hi):
        return vmap(lambda b: alg.client_upload(p, state, b))(
            (x[lo:hi], y[lo:hi], w[lo:hi]))

    whole, halves = upload(0, CLIENTS), (upload(0, 5), upload(5, CLIENTS))
    gap, differ, total = 0.0, 0, 0
    for k in whole:
        part = torch.cat([h[k] for h in halves])
        gap = max(gap, float((part - whole[k]).abs().max()))
        differ += int((part != whole[k]).sum())
        total += part.numel()
    log(f"vmapped upload on the card, 2 x 5 slots against 10: max |diff| "
        f"{gap:.3e}, {differ} of {total} entries differ")
    if not gap <= 1e-5:
        raise AssertionError(f"upload batch witness: {gap}")
    return {"max_abs": gap, "entries_differing": differ, "entries": total}


def shard_alive_parity(torch, sa):
    """``masked_sum`` at the two-rank async path's shard: (5, 794, 128)
    at ``client_offset`` 5 of 10, with the dropouts of the rounds of the
    paths' trace that drop a slot on that rank and of one that drops
    slots only on the other, against its plain version bit for bit."""
    from repro_torch.data import partition
    trace = partition.sample_staleness(CLIENTS, range(1, ROUNDS + 1), 0,
                                       ASYNC_PROBS)
    alive = trace <= 2
    here = [t for t in range(ROUNDS) if not alive[t, 5:].all()][:2]
    there = [t for t in range(ROUNDS)
             if alive[t, 5:].all() and not alive[t].all()][:1]
    if len(here) < 2 or not there:
        raise AssertionError(f"trace: no rounds to hold the shard at: "
                             f"{trace.tolist()}")
    g = torch.Generator().manual_seed(7)
    msgs = (torch.randn(5, 794, 128, generator=g) * 1e-3).cuda()
    out = {}
    for t in here + there:
        a = torch.as_tensor(alive[t].astype("int32"), device="cuda")
        got = sa.masked_sum_2d(msgs, 0x8BADF00D, 0x1234567,
                               scale_bits=SCALE_BITS, num_clients=CLIENTS,
                               client_offset=5, alive=a)
        want = sa.masked_sum_plain(msgs, 0x8BADF00D, 0x1234567,
                                   scale_bits=SCALE_BITS,
                                   num_clients=CLIENTS, client_offset=5,
                                   alive=a)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"masked_sum at the shard, round {t + 1}'s "
                                 "dropouts: kernel != plain")
        out[t + 1] = [int(i) for i in (~alive[t]).nonzero()[0]]
    log("masked_sum: kernel == plain bit for bit at (5, 794, 128), "
        f"client_offset 5 of 10, dropped slots by round {json.dumps(out)}")
    return out


def phase_client_mesh(torch, kernels, data, parts, params, runtime, card):
    """The client-sharded rounds on the card: the masked sum's ``alive``
    path held at a rank's shard; a one-rank NCCL group, each path bit for
    bit its ``mesh=None`` run with the same launches (the ``alive`` ones
    as predicted) and the predicted psums, the async and pipelined paths
    also bit for bit under ``arena="replicated"``; then two gloo ranks on
    ``cuda:0``: the chunked ring bit for bit the psum, the ranks bit for
    bit each other and within 5e-5 of ``mesh=None``, the masked sum
    launched at each rank's shard (with ``alive`` on the async paths),
    pipelined rounds bit for bit the async τ ≡ 1 run.  Then the
    hierarchical tree on the (groups, clients) mesh: on a (1, 1) mesh of
    the NCCL rank (:func:`phase_group_mesh_nccl`), and on gloo ranks at
    (2, 1), (1, 2) and (2, 2) (:func:`phase_group_mesh_gloo`)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.launch import LocalWorld, make_client_mesh
    torch.cuda.empty_cache()
    results = {"shard_alive_parity": shard_alive_parity(torch, sa)}
    paths = {p[0]: p for p in mesh_paths()}
    single = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_client_mesh()
        if (mesh.backend, mesh.size, mesh.device.type) != ("nccl", 1,
                                                            "cuda"):
            raise AssertionError(f"client mesh: {mesh}")
        # the int32 partials' exact round trip (one rank sums nothing: a
        # sum across ranks wrapping needs two cards); on one rank the
        # chunked ring is the psum
        ring = torch.tensor([2 ** 31 - 1, -2 ** 31, -1, 12345],
                            dtype=torch.int32, device=mesh.device)
        if not torch.equal(mesh.psum({"q": ring})["q"], ring) \
                or not torch.equal(mesh.ring_psum_chunked({"q": ring})["q"],
                                   ring) or mesh.ring_calls:
            raise AssertionError("nccl psum of int32 partials is not exact")
        for name, entry, pkey, extra, arena, per_round, alive in \
                mesh_paths():
            def run(**kw):
                return getattr(runtime, entry)(
                    data, parts[pkey], rounds=ROUNDS, eval_every=10, seed=0,
                    params=params, **extra, **kw)

            def counted(**kw):
                """A mesh run with its launches and collectives counted."""
                reset_counts(kernels)
                mesh.psum_calls = mesh.all_reduces = mesh.psum_bytes = 0
                mesh.ring_calls = 0
                out = run(mesh=mesh, **kw)
                got = {k: fn.launches for k, fn in kernels.items()}
                got.update(variant_counts(kernels))
                return out, got, mesh.psum_calls, mesh.psum_bytes

            reset_counts(kernels)
            p_n, h_n = run(device="cuda")
            want = {k: fn.launches for k, fn in kernels.items()}
            want.update(variant_counts(kernels))
            single[name] = (path_bits(torch, p_n), h_n)
            torch.cuda.reset_peak_memory_stats()
            (p_m, h_m), got, calls, nbytes = counted(arena=arena)
            peak = torch.cuda.max_memory_allocated()
            if got != want or not got["masked_sum"] \
                    and "plain" not in name:
                raise AssertionError(f"mesh {name}: launches {got}, "
                                     f"mesh=None {want}")
            if got["masked_sum_alive"] != alive * ROUNDS:
                raise AssertionError(f"mesh {name}: {got['masked_sum_alive']}"
                                     f" launches with alive, want {alive} a "
                                     "round")
            if calls != per_round * ROUNDS or mesh.ring_calls:
                raise AssertionError(f"mesh {name}: {calls} psums, want "
                                     f"{per_round} a round")
            if not same_mesh_run(torch, p_m, h_m, single[name]):
                raise AssertionError(f"mesh {name}: the one-rank nccl run is "
                                     "not mesh=None bit for bit")
            entry_out = {
                "launches": got, "psums_per_round": per_round,
                "psum_bytes_per_round": nbytes // ROUNDS,
                "round_ms": h_m.wall_seconds / ROUNDS * 1e3,
                "round_ms_mesh_none": h_n.wall_seconds / ROUNDS * 1e3,
                "device_busy_share": profiled_busy(
                    torch, lambda: run(mesh=mesh, arena=arena)),
                "peak_bytes": peak}
            if name in RING_PATHS:
                # the packed snapshot ring against the list of snapshots
                (p_r, h_r), got_r, calls_r, bytes_r = counted(
                    arena="replicated")
                if got_r != want or calls_r != RING_PATHS[name] * ROUNDS \
                        or not same_mesh_run(torch, p_r, h_r,
                                             (path_bits(torch, p_m), h_m)):
                    raise AssertionError(
                        f"mesh {name}: arena replicated ({calls_r} psums, "
                        f"launches {got_r}) is not sharded bit for bit")
                entry_out.update(
                    replicated_psums_per_round=RING_PATHS[name],
                    replicated_psum_bytes_per_round=bytes_r // ROUNDS,
                    replicated_round_ms=h_r.wall_seconds / ROUNDS * 1e3)
                del p_r
            results[f"nccl1_{name}"] = entry_out
            also = " and arena replicated" if name in RING_PATHS else ""
            log(f"client mesh, one nccl rank, {name} (arena {arena}): bit "
                f"for bit mesh=None{also}, {per_round} psums a round:",
                json.dumps(entry_out), f"on {card}")
            del p_n, p_m
        t0 = time.perf_counter()
        single_group, got = phase_group_mesh_nccl(
            torch, kernels, data, parts["main"], params, runtime, card)
        results.update(got)
        log(f"group mesh, one nccl rank: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)

    results["upload_batch_witness"] = upload_batch_witness(torch, data,
                                                           params)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = LocalWorld(mesh_rank_paths, 2, backend="gloo",
                       args=(GLOO_PATHS,), timeout_s=MESH_TIMEOUT_S).join()
    log("client mesh, two gloo ranks on cuda:0: "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    for r in ranks:
        if (r["backend"], r["size"], r["device"], r["wraps"]) \
                != ("gloo", 2, "cuda:0", True):
            raise AssertionError(f"gloo rank {r['rank']}: {r['backend']}, "
                                 f"{r['size']} ranks on {r['device']}, "
                                 f"int32 wraps {r['wraps']}")
        # one ring call a check, the f32 leaf through a psum; each piece
        # staged through host memory both ways on a CUDA device
        for chunks, chk in r["ring"].items():
            if chk != {"same_bits": True,
                       "counts": [1, 1, 4 * 484, 2 * 4 * 484]}:
                raise AssertionError(f"gloo rank {r['rank']}: chunked ring "
                                     f"at {chunks} pieces: {chk}")
    log("chunked ring on two gloo ranks on cuda:0: bit for bit the psum on "
        "the mixed tree at 4, 3 and 7 pieces:", json.dumps(ranks[0]["ring"]))
    results["gloo2_ring"] = ranks[0]["ring"]
    p0, p1 = (r["paths"] for r in ranks)
    for name in GLOO_PATHS:
        _, entry, pkey, extra, _, per_round, alive = paths[name]
        a, b = p0[name], p1[name]
        if not all((x == y).all() for x, y in zip(a["bits"], b["bits"])) \
                or a["hist"] != b["hist"]:
            raise AssertionError(f"gloo {name}: the ranks differ")
        if name not in single:
            raise AssertionError(f"gloo {name}: no mesh=None run")
        bits_n, h_n = single[name]
        gap = max(abs(x - y) for x, y in zip(a["hist"]["train_cost"],
                                              h_n.train_cost))
        acc = max(abs(x - y) for x, y in zip(a["hist"]["test_accuracy"],
                                              h_n.test_accuracy))
        w_gap = max(float((torch.from_numpy(x).view(torch.float32)
                           - y.view(torch.float32)).abs().max())
                    for x, y in zip(a["bits"], bits_n))
        if not gap < 5e-5 or not acc < 2e-3 \
                or a["hist"]["comm"] != h_n.comm:
            raise AssertionError(f"gloo {name}: cost gap {gap}, accuracy "
                                 f"gap {acc} from mesh=None")
        s = CLIENTS if extra.get("aggregation") is None \
            else extra["aggregation"].cohort_size(CLIENTS)
        s_pad = -(-s // 2) * 2
        psums, rings = gloo_collectives(name, per_round)
        dropped = (h_n.comm.get("async") or {}).get("dropped_total", 0)
        for r, res in ((0, a), (1, b)):
            per = 2 if name == "sketch_secure" else 1
            if len(res["masked"]) != per * ROUNDS \
                    or res["launches"]["masked_sum"] != per * ROUNDS \
                    or res["alive_launches"] != alive * ROUNDS:
                raise AssertionError(f"gloo {name} rank {r}: masked sums "
                                     f"{res['launches']}, with alive "
                                     f"{res['alive_launches']}")
            for shape, off, nc, drops in res["masked"]:
                rows_ok = name == "sketch_secure" or shape[1:] == [794, 128]
                if shape[0] != s_pad // 2 or off != r * s_pad // 2 \
                        or nc != s_pad or not rows_ok \
                        or (drops is None) != (alive == 0):
                    raise AssertionError(
                        f"gloo {name} rank {r}: masked sum at {shape}, "
                        f"offset {off}, {nc} clients, dropped {drops}")
            if sum(m[3] or 0 for m in res["masked"]) != dropped:
                raise AssertionError(f"gloo {name} rank {r}: the launches "
                                     f"dropped other than {dropped} slots")
            if (res["psum_calls"], res["ring_calls"]) \
                    != (psums * ROUNDS, rings * ROUNDS):
                raise AssertionError(f"gloo {name} rank {r}: "
                                     f"{res['psum_calls']} psums, "
                                     f"{res['ring_calls']} ring calls")
        results[f"gloo2_{name}"] = {
            "cost_gap": gap, "accuracy_gap": acc, "weights_gap": w_gap,
            "bitwise_mesh_none": all((x == y.numpy()).all() for x, y in
                                     zip(a["bits"], bits_n)),
            "masked_sum_rank0": a["masked"][0], "masked_sum_rank1":
                b["masked"][0], "launches": a["launches"],
            "alive_launches": a["alive_launches"],
            "psums_per_round": psums, "ring_calls_per_round": rings,
            "psum_bytes_per_round": a["psum_bytes"] // ROUNDS,
            "ring_bytes_per_round": a["ring_bytes"] // ROUNDS,
            "ring_staged_bytes_per_round": a["ring_staged_bytes"] // ROUNDS,
            "round_ms": [a["round_ms"], b["round_ms"]],
            "device_busy_share": [a["busy"], b["busy"]],
            "peak_bytes": [a["peak_bytes"], b["peak_bytes"]]}
        log(f"client mesh, two gloo ranks on cuda:0, {name}: ranks bit for "
            "bit,", json.dumps(results[f"gloo2_{name}"]), f"on {card}")
    # pipelined rounds are the async run at τ ≡ 1 on the mesh, bit for bit
    pipe, tau1 = p0["pipeline_secure"], p0["tau1_secure"]
    if not all((x == y).all() for x, y in zip(pipe["bits"], tau1["bits"])) \
            or pipe["hist"]["metrics"] != tau1["hist"]["metrics"]:
        raise AssertionError("gloo: pipeline_secure is not tau1_secure bit "
                             "for bit")
    log("client mesh, two gloo ranks: pipeline_secure == tau1_secure bit "
        "for bit (weights, every metric)")
    results.update(phase_group_mesh_gloo(torch, single_group, card))
    return results

# ---------------------------------------------------------------------------
# the hierarchical tree on the (groups, clients) mesh
# ---------------------------------------------------------------------------

def group_mesh_paths():
    """name -> (entry point, keyword arguments) of the tree's paths on
    the group mesh: the MLP on the main path's 10 clients."""
    from repro_torch.fed import aggregation, compression
    from repro_torch.fed.staleness import StalenessConfig
    alg1 = dict(batch_size=100, fused=True)

    def hier(groups):
        return aggregation.hierarchical(aggregation.secure(), groups)
    k2 = StalenessConfig(max_staleness=2, delay_probs=ASYNC_PROBS)
    return {
        "hier2_secure": ("run_alg1", dict(alg1, aggregation=hier(2))),
        "hier2_topk8_secure": ("run_alg1", dict(
            alg1, aggregation=hier(2),
            compressor=compression.topk(0.1, bits=8))),
        "async_hier2_secure": ("run_alg1", dict(alg1, aggregation=hier(2),
                                                staleness=k2)),
        "pipeline_hier2_secure": ("run_alg1", dict(
            alg1, aggregation=hier(2), pipeline=True)),
        # G = 4 does not divide S = 10: the mesh uploads G·M_pad = 12
        # slots where mesh=None uploads 10
        "hier4_secure": ("run_alg1", dict(alg1, aggregation=hier(4))),
    }


# the one NCCL rank's (1, 1) paths, and those also run under arena
# "replicated"; the gloo worlds' (layout, paths)
NCCL_GROUP_PATHS = ("hier2_secure", "hier2_topk8_secure",
                    "async_hier2_secure", "pipeline_hier2_secure",
                    "hier4_secure")
NCCL_GROUP_REPLICATED = ("async_hier2_secure",)
GLOO_GROUP_PATHS = {2: [((2, 1), ("hier4_secure", "async_hier2_secure",
                                  "pipeline_hier2_secure")),
                        ((1, 2), ("hier4_secure", "async_hier2_secure",
                                  "pipeline_hier2_secure"))],
                    4: [((2, 2), ("hier4_secure",))]}
AXES = ("whole", "groups", "clients")


def group_collectives(name, layout, arena="sharded"):
    """``PERF.md`` §4's (psum calls, chunked-ring calls) a round on each
    axis of a (g, c) group mesh: on the whole mesh the weight gather
    (sharded), a stateful compressor's residual gather (sharded) and
    replication, and the snapshot ring's rebuild (async and pipelined,
    sharded); on the groups and clients axes the combine's root and
    level-1 reductions, through the chunked ring in pipelined rounds
    where the axis has two or more ranks."""
    sharded = arena == "sharded"
    stateful = "topk" in name
    rounds_async = "async" in name or "pipeline" in name
    out = {"whole": (sharded + stateful * (1 + sharded)
                     + (sharded and rounds_async), 0)}
    for axis, size in zip(AXES[1:], layout):
        ring = name.startswith("pipeline") and size > 1
        out[axis] = (0, 1) if ring else (1, 0)
    return out


def axis_counts(mesh):
    """Each axis's counters of a group mesh."""
    return {name: {k: getattr(axis, k) for k in
                   ("psum_calls", "psum_bytes", "ring_calls", "ring_bytes",
                    "ring_staged_bytes")}
            for name, axis in zip(AXES, mesh.axes())}


def per_round(counts):
    """(psum calls, ring calls) a round on each axis, or None where a
    count is not a whole number of rounds."""
    out = {}
    for axis, c in counts.items():
        if c["psum_calls"] % ROUNDS or c["ring_calls"] % ROUNDS:
            return None
        out[axis] = (c["psum_calls"] // ROUNDS, c["ring_calls"] // ROUNDS)
    return out


def tree_tile(name, layout):
    """(G, G_loc, M_loc, M_pad) of a path's tile on a (g, c) mesh."""
    groups = group_mesh_paths()[name][1]["aggregation"].groups
    m = -(-CLIENTS // groups)
    m_pad = -(-m // layout[1]) * layout[1]
    return groups, groups // layout[0], m_pad // layout[1], m_pad


def phase_group_mesh_nccl(torch, kernels, data, part, params, runtime,
                          card):
    """The tree on a (1, 1) group mesh of the one NCCL rank (the default
    group is up): each path of :data:`NCCL_GROUP_PATHS` against its
    ``mesh=None`` run, bit for bit with the same launches where the mesh
    uploads as many slots (G | S), within 5e-5 in cost where it uploads
    G·M_pad > S (bits reported), with the predicted collectives on each
    axis; returns the ``mesh=None`` runs (bits, History)."""
    from repro_torch.launch import make_group_mesh
    mesh = make_group_mesh()
    if (mesh.shape, mesh.backend, mesh.device.type) \
            != ((1, 1), "nccl", "cuda"):
        raise AssertionError(f"group mesh: {mesh}")
    # NCCL makes a group's communicator at its first collective: one psum
    # on each axis keeps that out of the first path's timed rounds
    for axis in mesh.axes():
        axis.psum(torch.zeros(1, device=mesh.device))
    paths = group_mesh_paths()
    single, results = {}, {}
    for name in NCCL_GROUP_PATHS:
        entry, extra = paths[name]

        def run(**kw):
            return getattr(runtime, entry)(data, part, rounds=ROUNDS,
                                           eval_every=10, seed=0,
                                           params=params, **extra, **kw)

        def counted(**kw):
            reset_counts(kernels)
            mesh.reset_counts()
            out = run(mesh=mesh, **kw)
            got = {k: fn.launches for k, fn in kernels.items()}
            got.update(variant_counts(kernels))
            return out, got, axis_counts(mesh)

        reset_counts(kernels)
        p_n, h_n = run(device="cuda")
        want = {k: fn.launches for k, fn in kernels.items()}
        want.update(variant_counts(kernels))
        single[name] = (path_bits(torch, p_n), h_n)
        torch.cuda.reset_peak_memory_stats()
        (p_m, h_m), got, counts = counted()
        peak = torch.cuda.max_memory_allocated()
        groups = tree_tile(name, (1, 1))[0]
        alive = groups if name.startswith("async") else 0
        if got != want or got["masked_sum"] != groups * ROUNDS \
                or got["masked_ring_sum"] != ROUNDS \
                or got["masked_sum_alive"] != alive * ROUNDS:
            raise AssertionError(f"group mesh (1, 1) {name}: launches {got},"
                                 f" mesh=None {want}")
        rounds = per_round(counts)
        if rounds != group_collectives(name, (1, 1)):
            raise AssertionError(f"group mesh (1, 1) {name}: collectives "
                                 f"{counts}, want a round "
                                 f"{group_collectives(name, (1, 1))}")
        bitwise = same_mesh_run(torch, p_m, h_m, single[name])
        gap = max(abs(x - y) for x, y in zip(h_m.train_cost, h_n.train_cost))
        w_gap = max(float((a.view(torch.float32) - b.view(torch.float32))
                          .abs().max())
                    for a, b in zip(path_bits(torch, p_m), single[name][0]))
        if name == "hier4_secure":
            if not gap < 5e-5 or h_m.comm != h_n.comm:
                raise AssertionError(f"group mesh (1, 1) {name}: cost gap "
                                     f"{gap} from mesh=None")
        elif not bitwise:
            raise AssertionError(f"group mesh (1, 1) {name}: not mesh=None "
                                 "bit for bit")
        entry_out = {
            "launches": got, "collectives_per_round": rounds,
            "psum_bytes_per_round": {a: c["psum_bytes"] // ROUNDS
                                     for a, c in counts.items()},
            "bitwise_mesh_none": bitwise, "cost_gap": gap,
            "weights_gap": w_gap,
            "round_ms": h_m.wall_seconds / ROUNDS * 1e3,
            "round_ms_mesh_none": h_n.wall_seconds / ROUNDS * 1e3,
            "device_busy_share": profiled_busy(torch, lambda: run(mesh=mesh)),
            "peak_bytes": peak}
        if name in NCCL_GROUP_REPLICATED:
            (p_r, h_r), got_r, counts_r = counted(arena="replicated")
            if got_r != want or per_round(counts_r) != group_collectives(
                    name, (1, 1), "replicated") or not same_mesh_run(
                    torch, p_r, h_r, (path_bits(torch, p_m), h_m)):
                raise AssertionError(
                    f"group mesh (1, 1) {name}: arena replicated "
                    f"({counts_r}, launches {got_r}) is not sharded bit for "
                    "bit")
            entry_out.update(
                replicated_collectives_per_round=per_round(counts_r),
                replicated_round_ms=h_r.wall_seconds / ROUNDS * 1e3)
            del p_r
        results[f"group11_{name}"] = entry_out
        log(f"group mesh (1, 1), one nccl rank, {name}:",
            json.dumps(entry_out), f"on {card}")
        del p_n, p_m
    return single, results


def group_mesh_rank_paths(plan):
    """One rank of a gloo world on ``cuda:0``: for each (layout, names)
    of ``plan`` a group mesh (every rank making each, in the same
    order), then each path on it, 20 rounds, with the masked sum's and
    the ring mode's launches (rows, offset, rows in all, dropped slots)
    recorded; returns what the parent checks."""
    import torch
    from repro_torch.fed import runtime
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.launch import make_group_mesh
    data, parts, params, kernels = rank_inputs()
    kernels["masked_ring_sum"] = sa.masked_ring_sum_2d
    meshes = [make_group_mesh(*layout) for layout, _ in plan]
    paths = group_mesh_paths()
    launch = sa._launch
    seen = []

    def recording(fn, name, rows, scale_args, key0, key1, num_clients,
                  client_offset, alive, out):
        seen.append((name, list(rows.shape), int(client_offset),
                     int(num_clients),
                     None if alive is None else int((alive == 0).sum())))
        return launch(fn, name, rows, scale_args, key0, key1, num_clients,
                      client_offset, alive, out)

    out = {"rank": meshes[0].rank, "device": str(meshes[0].device),
           "meshes": {}, "paths": {}}
    sa._launch = recording
    try:
        for (layout, names), mesh in zip(plan, meshes):
            out["meshes"][layout] = {
                "coords": mesh.coords, "backend": mesh.backend,
                "axes": [(a.rank, a.size, a.int32_wraps)
                         for a in mesh.axes()]}
            for name in names:
                entry, extra = paths[name]

                def run(entry=entry, extra=extra, mesh=mesh):
                    return getattr(runtime, entry)(
                        data, parts["main"], rounds=ROUNDS, eval_every=10,
                        seed=0, params=params, mesh=mesh, **extra)
                run()                                   # warm-up
                reset_counts(kernels)
                mesh.reset_counts()
                seen.clear()
                torch.cuda.reset_peak_memory_stats()
                p, h = run()
                d = h.as_dict()
                wall = d.pop("wall_seconds")
                launches = {k: f.launches for k, f in kernels.items()}
                launches.update(variant_counts(kernels))
                out["paths"][(layout, name)] = {
                    "bits": [b.numpy() for b in path_bits(torch, p)],
                    "hist": d, "launches": launches, "calls": list(seen),
                    "counts": axis_counts(mesh),
                    "round_ms": wall / ROUNDS * 1e3,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "busy": profiled_busy(torch, run)}
                del p
    finally:
        sa._launch = launch
    return out


def check_group_rank(name, layout, rank, res):
    """One gloo rank's launches and collectives on a path: the masked sum
    G_loc times a round at its tile's member offset of M_pad (with
    ``alive`` on the async path), the ring mode once at its group
    offset of G, and the predicted collectives on each axis."""
    groups, g_loc, m_loc, m_pad = tree_tile(name, layout)
    gi, ci = divmod(rank, layout[1])
    masked = [c for c in res["calls"] if c[0] == "masked_sum"]
    rings = [c for c in res["calls"] if c[0] == "masked_ring_sum"]
    drops = name.startswith("async")
    for _, shape, off, n, dropped in masked:
        if (shape[0], shape[1:], off, n) != (m_loc, [794, 128], ci * m_loc,
                                             m_pad) \
                or (dropped is not None) != drops:
            raise AssertionError(f"gloo {layout} {name} rank {rank}: masked "
                                 f"sum at {shape}, offset {off} of {n}, "
                                 f"dropped {dropped}")
    for _, shape, off, n, dropped in rings:
        if (shape[0], off, n, dropped) != (g_loc, gi * g_loc, groups, None):
            raise AssertionError(f"gloo {layout} {name} rank {rank}: ring "
                                 f"mode at {shape}, offset {off} of {n}")
    lc = res["launches"]
    if (len(masked), len(rings), lc["masked_sum"], lc["masked_ring_sum"],
            lc["masked_sum_alive"]) != (g_loc * ROUNDS, ROUNDS,
                                        g_loc * ROUNDS, ROUNDS,
                                        g_loc * ROUNDS * drops):
        raise AssertionError(f"gloo {layout} {name} rank {rank}: launches "
                             f"{lc}, {len(masked)} masked sums and "
                             f"{len(rings)} ring launches recorded")
    if per_round(res["counts"]) != group_collectives(name, layout):
        raise AssertionError(f"gloo {layout} {name} rank {rank}: "
                             f"collectives {res['counts']}, want a round "
                             f"{group_collectives(name, layout)}")
    return masked[0], rings[0]


def phase_group_mesh_gloo(torch, single, card):
    """The tree on two gloo ranks at (2, 1) and (1, 2) and four at (2, 2),
    all on ``cuda:0``: the ranks bit for bit each other, within 5e-5 in
    cost and 1e-5 in weights of ``mesh=None``, the masked sum and the
    ring mode launched at each rank's tile, the predicted collectives;
    pipelined rounds (no ``alive``) beside the async ones."""
    from repro_torch.launch import LocalWorld
    results = {}
    for size, plan in GLOO_GROUP_PATHS.items():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = LocalWorld(group_mesh_rank_paths, size, backend="gloo",
                           args=(plan,), timeout_s=MESH_TIMEOUT_S).join()
        log(f"group mesh, {size} gloo ranks on cuda:0: "
            f"{time.perf_counter() - t0:.1f} s with start-up")
        for layout, names in plan:
            for r, res in enumerate(ranks):
                m = res["meshes"][layout]
                want = [(r, size, True), (r // layout[1], layout[0], True),
                        (r % layout[1], layout[1], True)]
                if res["device"] != "cuda:0" or m["backend"] != "gloo" \
                        or [tuple(a) for a in m["axes"]] != want:
                    raise AssertionError(f"gloo {layout} rank {r}: {m}, on "
                                         f"{res['device']}")
            for name in names:
                key = (layout, name)
                a = ranks[0]["paths"][key]
                for r, res in enumerate(ranks):
                    b = res["paths"][key]
                    if not all((x == y).all() for x, y in
                               zip(a["bits"], b["bits"])) \
                            or a["hist"] != b["hist"]:
                        raise AssertionError(f"gloo {layout} {name}: rank "
                                             f"{r} differs from rank 0")
                shards = [check_group_rank(name, layout, r, res["paths"][key])
                          for r, res in enumerate(ranks)]
                bits_n, h_n = single[name]
                gap = max(abs(x - y) for x, y in
                          zip(a["hist"]["train_cost"], h_n.train_cost))
                acc = max(abs(x - y) for x, y in
                          zip(a["hist"]["test_accuracy"], h_n.test_accuracy))
                w_gap = max(float((torch.from_numpy(x).view(torch.float32)
                                   - y.view(torch.float32)).abs().max())
                            for x, y in zip(a["bits"], bits_n))
                if not gap < 5e-5 or not w_gap < 1e-5 or not acc < 2e-3 \
                        or a["hist"]["comm"] != h_n.comm:
                    raise AssertionError(
                        f"gloo {layout} {name}: cost gap {gap}, weights gap "
                        f"{w_gap}, accuracy gap {acc} from mesh=None")
                entry = {
                    "cost_gap": gap, "accuracy_gap": acc,
                    "weights_gap": w_gap,
                    "bitwise_mesh_none": all(
                        (x == y.numpy()).all()
                        for x, y in zip(a["bits"], bits_n)),
                    "launches_rank0": a["launches"],
                    "tiles": {r: {"masked_sum": list(m[1:]),
                                  "ring": list(g[1:])}
                              for r, (m, g) in enumerate(shards)},
                    "collectives_per_round": per_round(a["counts"]),
                    "psum_bytes_per_round": {
                        ax: c["psum_bytes"] // ROUNDS
                        for ax, c in a["counts"].items()},
                    "ring_bytes_per_round": {
                        ax: c["ring_bytes"] // ROUNDS
                        for ax, c in a["counts"].items()},
                    "ring_staged_bytes_per_round": {
                        ax: c["ring_staged_bytes"] // ROUNDS
                        for ax, c in a["counts"].items()},
                    "round_ms": [res["paths"][key]["round_ms"]
                                 for res in ranks],
                    "device_busy_share": [res["paths"][key]["busy"]
                                          for res in ranks],
                    "peak_bytes": [res["paths"][key]["peak_bytes"]
                                   for res in ranks]}
                results[f"gloo{layout[0]}x{layout[1]}_{name}"] = entry
                log(f"group mesh {layout}, {size} gloo ranks on cuda:0, "
                    f"{name}: ranks bit for bit,", json.dumps(entry),
                    f"on {card}")
    return results


# ---------------------------------------------------------------------------
# the production (data, model) mesh
# ---------------------------------------------------------------------------

PM_STEPS = 3
PM_TAU = 2.0
PM_LAYOUT = (2, 2)
PM_AXES = ("data", "model")
# the four gloo ranks' cases: reduced dense train steps (granite-34b has
# one kv head: k and v gathered over ``model``), and the reduced moe
# forward in both weight modes
PM_DENSE = (("llama3-8b", "model"), ("llama3-8b", None),
            ("granite-34b", "model"))
PM_MODES = ("fsdp", "stationary")
# the families' train and prefill steps at full width on the one-rank
# mesh, against mesh=None: (arch, short name, the layers' cut, batch, seq),
# launch/train.py's B = 8 and S = 128, the vlm at train_vlm_full's shape
PM_FAMILIES = (("llama3-8b", "llama", None, TRAIN_BATCH, TRAIN_SEQ),
               ("rwkv6-7b", "rwkv", None, TRAIN_BATCH, TRAIN_SEQ),
               (HYBRID_ARCH, "hybrid", HYBRID_LAYERS, TRAIN_BATCH, TRAIN_SEQ),
               (VLM_ARCH, "vlm", None, *VLM_TRAIN),
               (AUDIO_ARCH, "audio", LM_LAYERS, *AUDIO_TRAIN))
# the four gloo ranks' family cases: the reduced moe train steps and the
# four families' (tests/torch_production_mesh_family_cases.py's)
PM_FAMILY_CASES = (MOE_ARCH, MOE_INTERLEAVED_ARCH, "rwkv6-7b", HYBRID_ARCH,
                   VLM_ARCH, AUDIO_ARCH)
# the reduced cases' bounds against the one-process run (the CPU tests'):
# every leaf within 1e-5 of its largest |entry|, loss and ‖g‖ within 1e-5
# relative, the moe logits within 1e-5 of the largest |logit|; the full
# moe forward on one rank is held bit for bit
PM_LEAF = 1e-5


def pm_cases():
    """``tests/torch_production_mesh_cases.py`` and ``tests/
    torch_production_mesh_family_cases.py``: the reduced cases' setups
    and the collective formulas (``family_calls``, ``moe_forward_calls``)
    that ``PERF.md`` §6 states and the CPU tests hold."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_production_mesh_cases as cases
    import torch_production_mesh_family_cases as family
    return cases, family


def pm_sync(torch, dev):
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def pm_free(torch, dev):
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()


def pm_peak(torch, dev, reset=False):
    """The device's peak allocation since the last reset (None off the
    card); resets it with ``reset``."""
    if not str(dev).startswith("cuda"):
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def pm_held(torch, dev):
    """The bytes allocated on the device now (None off the card): what a
    run's peak stands on (the weights, and an earlier run's outputs kept
    for the comparison)."""
    return torch.cuda.memory_allocated() if str(dev).startswith("cuda") \
        else None


def pm_reduced(torch, case, dev):
    """A reduced case's (config, weights, batch), drawn on the CPU by its
    setup in ``pm_cases()``, on ``dev``."""
    from repro_torch.models.transformer import params_from_numpy, \
        params_to_numpy
    cfg, params, batch = case
    return cfg, params_from_numpy(params_to_numpy(params), dev), {
        k: v.to(dev) for k, v in batch.items()}


def pm_train(torch, model, params, batches, dev, mesh=None):
    """``make_train_step`` over ``batches`` (τ = PM_TAU): the last
    parameters and ``lin``, (loss, ‖g‖) a step, each step's seconds and,
    on a mesh, its collectives by axes."""
    from repro_torch.core import ssca
    from repro_torch.core.schedules import PowerLaw
    from repro_torch.launch import steps
    hp = ssca.SSCAHyperParams(tau=PM_TAU, rho=PowerLaw(0.9, 0.3),
                              gamma=PowerLaw(0.9, 0.35))
    step = steps.make_train_step(model, hp)
    state = ssca.init(params, with_beta=False)
    metrics, secs, calls = [], [], []
    for b in batches:
        if mesh is not None:
            mesh.reset_counts()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        pm_sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["kkt_residual"])))
        if mesh is not None:
            calls.append(dict(mesh.calls))
    return params, state.lin, metrics, secs, calls


def pm_numpy(tree_):
    from repro_torch import tree
    return {k: v.detach().float().cpu().numpy()
            for k, v in tree.named_leaves(tree_)}


def pm_remat_launches(launches):
    """A train step's launches on a mesh from its launches without one:
    each layer runs again in the backward (``models.sharded.remat``), so
    the layer kernels' forwards (flash, WKV; their backwards are plain)
    twice a layer; the rest once."""
    return {k: 2 * n if k.startswith(("flash_attention", "rwkv6_wkv"))
            else n for k, n in launches.items()}


def pm_prefill(torch, model, params, batch, dev):
    """``make_prefill_step`` once: the (B, V) logits, its seconds."""
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    logits = steps.make_prefill_step(model)(params, batch)
    pm_sync(torch, dev)
    return logits, time.perf_counter() - t0


def pm_forward(torch, model, params, batch, dev, mesh=None):
    """One forward without autograd: logits, each MoE layer's dropped
    share, its seconds, its collectives."""
    dropped = []
    if mesh is not None:
        mesh.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.forward_with_aux(params, batch, dropped)[0]
    pm_sync(torch, dev)
    return (logits, [float(d) for d in dropped], time.perf_counter() - t0,
            dict(mesh.calls) if mesh is not None else {})


def pm_host_family(torch, kernels, card, mesh, dev, arch, short, layers,
                   batch, seq):
    """``arch`` at full width, 2 of its layers (``layers``: the hybrid's 3,
    one unit; whisper's encoder cut to 2 as well), ``launch/train.py``'s
    batches at (``batch``, ``seq``), PM_STEPS train steps at τ = PM_TAU and
    one prefill step from the first weights, without a mesh and on the
    one-rank ``make_host_mesh()``: parameters, ``lin``, the losses and the
    prefill logits bit for bit, ‖g‖ within 1e-6 relative, the same kernel
    launches but the layer kernels' forwards, twice a layer in the mesh's
    train step (:func:`pm_remat_launches`), the predicted collectives.
    The twin runs one after the other, its outputs copied to the host
    before the next starts (recurrentgemma's step alone peaks at 54.63
    GB)."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding, train
    from repro_torch.models import build_model
    cut = {"num_layers": layers or LM_LAYERS}
    if arch == AUDIO_ARCH:
        cut["encoder_layers"] = LM_LAYERS
    cfg = dataclasses.replace(get_config(arch), **cut)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    stream = train.batch_stream(cfg, batch, seq, device=dev)
    batches = [next(stream) for _ in range(PM_STEPS)]
    out, runs = {}, {}
    for name, model in (("none", build_model(cfg)),
                        ("mesh", build_model(
                            cfg, mesh=mesh,
                            layer_pspec_fn=sharding.layer_pspec_fn(mesh)))):
        on_mesh = mesh if name == "mesh" else None
        p0 = params if name == "none" else sharding.shard_params(params,
                                                                 mesh)
        reset_counts(kernels)
        held = pm_held(torch, dev)
        pm_peak(torch, dev, reset=True)
        p, lin, metrics, secs, calls = pm_train(torch, model, p0, batches,
                                                dev, on_mesh)
        launches = counts(kernels)
        peak = pm_peak(torch, dev)
        reset_counts(kernels)
        if on_mesh is not None:
            mesh.reset_counts()
        logits, prefill_s = pm_prefill(torch, model, p0, batches[0], dev)
        runs[name] = ([t.cpu() for t in tree.leaves(p) + tree.leaves(lin)],
                      metrics, logits.cpu())
        out[name] = {"metrics": metrics, "step_s": secs,
                     "prefill_s": prefill_s, "peak_device_bytes": peak,
                     "held_bytes": held, "launches": launches,
                     "prefill_launches": counts(kernels), "calls": calls,
                     "prefill_calls": dict(mesh.calls) if on_mesh else {}}
        del p, lin, logits, p0
        pm_free(torch, dev)
    (wa, ma, la), (wb, mb, lb) = runs["none"], runs["mesh"]
    same = all(torch.equal(a, b) for a, b in zip(wa, wb))
    same_loss = [u[0] for u in ma] == [v[0] for v in mb]
    same_logits = bool(torch.equal(la, lb))
    worst = max(abs(u[1] - v[1]) / abs(u[1]) for u, v in zip(ma, mb))
    cases = pm_cases()[1]
    want = cases.family_calls(cfg, 1, "model", train=True)
    want_prefill = cases.family_calls(cfg, 1, "model", train=False)
    log(f"production mesh, one {mesh.backend} rank, {arch} "
        f"({cfg.num_layers} layers, B = {batch}, S = {seq}, tau {PM_TAU}), "
        "make_host_mesh() against mesh=None:",
        json.dumps({"bit_for_bit": same, "losses_bit_for_bit": same_loss,
                    "prefill_bit_for_bit": same_logits,
                    "kkt_rel_gap": worst, "parameters": sum(
                        t.numel() for t in tree.leaves(params)),
                    "calls_per_step": want, "prefill_calls": want_prefill,
                    **out}), f"on {card}")
    if not (same and same_loss and same_logits and worst <= 1e-6):
        raise AssertionError(f"host mesh {arch}: bit for bit {same}, losses "
                             f"{same_loss}, prefill {same_logits}, ‖g‖ "
                             f"{worst} from mesh=None")
    mesh_l, none_l = out["mesh"], out["none"]
    if mesh_l["launches"] != pm_remat_launches(none_l["launches"]) \
            or mesh_l["prefill_launches"] != none_l["prefill_launches"] \
            or mesh_l["launches"]["ssca_update_lambda0"] != PM_STEPS \
            or not any(mesh_l["prefill_launches"][k] for k in
                       ("flash_attention", "rwkv6_wkv")):
        raise AssertionError(f"host mesh {arch}: launches {mesh_l}, "
                             f"mesh=None {none_l}")
    if mesh_l["calls"] != [want] * PM_STEPS \
            or mesh_l["prefill_calls"] != want_prefill:
        raise AssertionError(f"host mesh {arch}: collectives "
                             f"{mesh_l['calls']}, prefill "
                             f"{mesh_l['prefill_calls']}, want {want} a step "
                             f"and {want_prefill}")
    del params, runs, wa, wb
    pm_free(torch, dev)
    both = {k: {n: run["launches"].get(n, 0) + run["prefill_launches"][n]
                for n in run["prefill_launches"]}
            for k, run in out.items()}
    return ({f"mesh_host_{short}_full{s}": both[k]
             for k, s in (("mesh", ""), ("none", "_none"))},
            {f"{short}_full": out})


def pm_host_moe(torch, kernels, card, mesh, dev):
    """qwen3-moe at full width (LM_LAYERS of 94 layers, bf16 as published)
    at serve_moe_full's forward shape (SERVE_BATCH × SERVE_PROMPT +
    SERVE_NEW): the expert-parallel forward on the one-rank mesh in both
    weight modes against ``moe_ffn``'s: each layer's dropped share equal,
    the logits bit for bit (one rank runs ``moe_ffn``'s helpers on all
    experts, and its collectives move nothing), the predicted
    collectives, the layer kernel once a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=LM_LAYERS)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW),
                           generator=torch.Generator(device=dev).manual_seed(
                               3), device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    reset_counts(kernels)
    pm_peak(torch, dev, reset=True)
    ref, dropped, secs, _ = pm_forward(torch, build_model(cfg), params,
                                       batch, dev)
    by_path = {"mesh_moe_full_single": counts(kernels)}
    top = float(ref.abs().max())
    out = {"single": {"dropped": dropped, "forward_s": secs,
                      "peak_device_bytes": pm_peak(torch, dev)}}
    for mode in PM_MODES:
        place = dict(moe_fsdp_dim="f" if mode == "stationary" else "d")
        model = build_model(cfg, mesh=mesh, moe_weight_mode=mode,
                            layer_pspec_fn=sharding.layer_pspec_fn(mesh,
                                                                   **place))
        p = sharding.shard_params(params, mesh, **place)
        reset_counts(kernels)
        pm_peak(torch, dev, reset=True)
        logits, drops, secs, calls = pm_forward(torch, model, p, batch, dev,
                                                mesh)
        gap = float((logits - ref).abs().max()) / top
        want = pm_cases()[0].moe_forward_calls(cfg, "model", mode)
        launches = by_path[f"mesh_moe_full_{mode}"] = counts(kernels)
        same = bool(torch.equal(logits, ref))
        out[mode] = {"dropped": drops, "logits_gap": gap,
                     "bit_for_bit": same, "forward_s": secs, "calls": calls,
                     "peak_device_bytes": pm_peak(torch, dev)}
        if drops != dropped or not same or calls != want \
                or launches != by_path["mesh_moe_full_single"]:
            raise AssertionError(f"host mesh qwen3-moe {mode}: dropped "
                                 f"{drops} against {dropped}, bit for bit "
                                 f"{same} (gap {gap}), "
                                 f"collectives {calls} (want {want}), "
                                 f"launches {launches}")
        del logits
    log(f"production mesh, one {mesh.backend} rank, qwen3-moe "
        f"({LM_LAYERS} of 94 layers, bf16, batch ({SERVE_BATCH}, "
        f"{SERVE_PROMPT + SERVE_NEW})), expert-parallel against moe_ffn:",
        json.dumps(out), f"on {card}")
    del params, ref
    pm_free(torch, dev)
    return by_path, {"moe_full": out}


def pm_family_train(torch, kernels, model, params, batch, dev, mesh=None):
    """A reduced family case: PM_STEPS train steps and one prefill step
    from the first weights, each part's launches (and, on a mesh, its
    collectives) counted apart."""
    reset_counts(kernels)
    pm_peak(torch, dev, reset=True)
    p, lin, metrics, secs, calls = pm_train(torch, model, params,
                                            [batch] * PM_STEPS, dev, mesh)
    launches = counts(kernels)
    reset_counts(kernels)
    if mesh is not None:
        mesh.reset_counts()
    logits, _ = pm_prefill(torch, model, params, batch, dev)
    return {"p": p, "lin": lin, "logits": logits, "metrics": metrics,
            "step_s": secs, "calls": calls, "launches": launches,
            "prefill_launches": counts(kernels),
            "prefill_calls": dict(mesh.calls) if mesh is not None else {},
            "peak_device_bytes": pm_peak(torch, dev)}


def pm_single_reduced(torch, kernels, dev):
    """The gloo ranks' cases in one process on ``dev``: each dense case's
    steps, the moe forward and each family case's steps and prefill
    without a mesh; their launches."""
    from repro_torch.models import build_model
    cases, family_cases = pm_cases()
    dense, family = {}, {}
    reset_counts(kernels)
    for arch in sorted({a for a, _ in PM_DENSE}):
        cfg, params, batch = pm_reduced(torch, cases.dense_setup(arch), dev)
        p, lin, metrics, _, _ = pm_train(torch, build_model(cfg), params,
                                         [batch] * PM_STEPS, dev)
        dense[arch] = {"params": pm_numpy(p), "lin": pm_numpy(lin),
                       "metrics": metrics}
    cfg, params, batch = pm_reduced(torch, cases.moe_setup(MOE_ARCH), dev)
    logits, dropped, _, _ = pm_forward(torch, build_model(cfg), params,
                                       batch, dev)
    forward = (logits.cpu().numpy(), dropped)
    total = counts(kernels)
    for case in PM_FAMILY_CASES:
        cfg, params, batch = pm_reduced(torch, family_cases.setup(case), dev)
        run = pm_family_train(torch, kernels, build_model(cfg), params,
                              batch, dev)
        family[case] = {"params": pm_numpy(run["p"]),
                        "lin": pm_numpy(run["lin"]),
                        "prefill": run["logits"].cpu().numpy(),
                        "metrics": run["metrics"],
                        "launches": run["launches"],
                        "prefill_launches": run["prefill_launches"]}
        for part in ("launches", "prefill_launches"):
            total = {k: total[k] + run[part][k] for k in total}
    return dense, forward, family, total


def production_mesh_rank(dev="cuda"):
    """One rank of the four-rank gloo world on ``cuda:0`` at PM_LAYOUT:
    every PM_DENSE train case and the reduced moe forward in both modes,
    the full parameters (``gather_params``) and logits back as numpy,
    with the metrics, collectives, launches, step seconds and peaks."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssca_update as su
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"flash_attention": fa.flash_attention_bhsd,
               "ssca_update": su.ssca_update_2d,
               "rwkv6_wkv": rw.rwkv6_wkv_bh}
    mesh = make_mesh(PM_LAYOUT, PM_AXES, device=dev)
    cases, family_cases = pm_cases()
    out = {"coords": mesh.coords, "backend": mesh.backend,
           "device": str(mesh.device), "dense": {}, "moe": {}, "family": {}}
    for arch, act in PM_DENSE:
        cfg, params, batch = pm_reduced(torch, cases.dense_setup(arch),
                                        mesh.device)
        model = build_model(cfg, mesh=mesh, act_tp=act,
                            layer_pspec_fn=sharding.layer_pspec_fn(mesh))
        reset_counts(kernels)
        pm_peak(torch, mesh.device, reset=True)
        p, lin, metrics, secs, calls = pm_train(
            torch, model, sharding.shard_params(params, mesh),
            [sharding.local_batch(batch, mesh)] * PM_STEPS, mesh.device,
            mesh)
        out["dense"][(arch, act)] = {
            "params": pm_numpy(sharding.gather_params(p, mesh)),
            "lin": pm_numpy(sharding.gather_params(lin, mesh)),
            "metrics": metrics, "calls": calls, "step_s": secs,
            "launches": counts(kernels),
            "peak_device_bytes": pm_peak(torch, mesh.device)}
    cfg, params, batch = pm_reduced(torch, cases.moe_setup(MOE_ARCH),
                                    mesh.device)
    for mode in PM_MODES:
        place = dict(moe_fsdp_dim="f" if mode == "stationary" else "d")
        model = build_model(cfg, mesh=mesh, moe_weight_mode=mode,
                            layer_pspec_fn=sharding.layer_pspec_fn(mesh,
                                                                   **place))
        p = sharding.shard_params(params, mesh, **place)
        reset_counts(kernels)
        logits, dropped, secs, calls = pm_forward(
            torch, model, p, sharding.local_batch(batch, mesh), mesh.device,
            mesh)
        full = mesh.all_gather(mesh.all_gather(logits, "model", -1), "data",
                               0)
        out["moe"][mode] = {"logits": full.cpu().numpy(), "dropped": dropped,
                            "calls": calls, "forward_s": secs,
                            "launches": counts(kernels)}
    for case in PM_FAMILY_CASES:
        cfg, params, batch = pm_reduced(torch, family_cases.setup(case),
                                        mesh.device)
        model = build_model(cfg, mesh=mesh,
                            layer_pspec_fn=sharding.layer_pspec_fn(mesh))
        run = pm_family_train(torch, kernels, model,
                              sharding.shard_params(params, mesh),
                              sharding.local_batch(batch, mesh), mesh.device,
                              mesh)
        out["family"][case] = {
            "params": pm_numpy(sharding.gather_params(run.pop("p"), mesh)),
            "lin": pm_numpy(sharding.gather_params(run.pop("lin"), mesh)),
            "prefill": mesh.all_gather(run.pop("logits"), "data",
                                       0).cpu().numpy(), **run}
    return out


def pm_ranks_check(torch, ranks, single, card, dev="cuda",
                   backend="gloo"):
    """The four ranks: each on its card (rank modulo the cards: all on
    ``cuda:0`` with one card), on ``backend``, row-major coordinates, bit
    for bit each other, within the CPU tests' bounds of the one-process
    run, the predicted collectives, the layer kernel and ``lambda0``
    launched."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    dense, (logits, dropped), family = single
    cases, family_cases = pm_cases()
    m = PM_LAYOUT[1]
    summary = {}
    for r, res in enumerate(ranks):
        want_dev = f"cuda:{r % torch.cuda.device_count()}" \
            if dev == "cuda" else dev
        if (res["device"], res["backend"], tuple(res["coords"])) \
                != (want_dev, backend, divmod(r, m)):
            raise AssertionError(f"gloo rank {r}: {res['device']}, "
                                 f"{res['backend']}, {res['coords']}")
    for arch, act in PM_DENSE:
        cfg = reduced(get_config(arch))
        want_calls = family_cases.family_calls(cfg, m, act, train=True)
        runs = [res["dense"][(arch, act)] for res in ranks]
        worst = 0.0
        for r, run in enumerate(runs):
            for k in ("params", "lin"):
                for name, w in dense[arch][k].items():
                    if not np.array_equal(run[k][name], runs[0][k][name]):
                        raise AssertionError(f"gloo {arch} {act}: rank {r}'s "
                                             f"{k} {name} differs from 0's")
                    top = float(np.abs(w).max())
                    worst = max(worst, float(np.abs(run[k][name] - w).max())
                                / top)
            gap = max(abs(x - y) / abs(y) for u, v in zip(
                run["metrics"], dense[arch]["metrics"]) for x, y in zip(u, v))
            launches = run["launches"]
            if run["calls"] != [want_calls] * PM_STEPS or gap > PM_LEAF \
                    or launches["ssca_update_lambda0"] != PM_STEPS \
                    or launches["ssca_update"] != PM_STEPS \
                    or launches["flash_attention_tf32x3"] \
                    != 2 * PM_STEPS * cfg.num_layers:
                raise AssertionError(f"gloo {arch} {act} rank {r}: "
                                     f"collectives {run['calls']} (want "
                                     f"{want_calls}), metrics gap {gap}, "
                                     f"launches {launches}")
        if worst > PM_LEAF:
            raise AssertionError(f"gloo {arch} {act}: {worst} of the largest "
                                 "|leaf| from the one-process run")
        summary[f"{arch} act_tp={act}"] = {
            "leaf_gap": worst, "metrics": runs[0]["metrics"],
            "step_s": [run["step_s"] for run in runs],
            "peak_device_bytes": [run["peak_device_bytes"] for run in runs],
            "calls_per_step": want_calls}
    cfg = reduced(get_config(MOE_ARCH))
    top = float(np.abs(logits).max())
    for mode in PM_MODES:
        want_calls = cases.moe_forward_calls(cfg, "model", mode)
        runs = [res["moe"][mode] for res in ranks]
        gap = float(np.abs(runs[0]["logits"] - logits).max()) / top
        for r, run in enumerate(runs):
            if not np.array_equal(run["logits"], runs[0]["logits"]) \
                    or run["dropped"] != dropped or gap > PM_LEAF \
                    or run["calls"] != want_calls \
                    or run["launches"]["flash_attention_tf32x3"] \
                    != cfg.num_layers:
                raise AssertionError(f"gloo moe {mode} rank {r}: dropped "
                                     f"{run['dropped']} ({dropped}), gap "
                                     f"{gap}, collectives {run['calls']} "
                                     f"(want {want_calls}), launches "
                                     f"{run['launches']}")
        summary[f"moe {mode}"] = {
            "logits_gap": gap, "dropped": dropped,
            "forward_s": [run["forward_s"] for run in runs],
            "calls": want_calls}
    for case in PM_FAMILY_CASES:
        summary[f"{case} train"] = pm_family_check(
            torch, case, [res["family"][case] for res in ranks], family[case])
    log(f"production mesh, four {backend} ranks at {PM_LAYOUT} on "
        f"{sorted({res['device'] for res in ranks})}: ranks bit for bit, "
        "within the CPU tests' bounds of one process:", json.dumps(summary),
        f"on {card}")
    return summary


def moe_full_train_rank(layout, dev="cuda"):
    """One NCCL rank of a ``layout`` (data, model) mesh, one card each:
    qwen3-moe at full width, LM_LAYERS of its 94 layers in bf16 as
    published, ``launch/train.py``'s batches (B = TRAIN_BATCH, S =
    TRAIN_SEQ), each MoE layer's dropped share and expert ids at the
    first weights, then PM_STEPS train steps at τ = PM_TAU; the weights
    drawn on every card from one seed and sharded.  Returns the metrics,
    the collectives, step seconds, peak and launches
    (``tools/production_mesh_cards.py``: it does not fit one card)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssca_update as su
    from repro_torch.launch import sharding, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"flash_attention": fa.flash_attention_bhsd,
               "ssca_update": su.ssca_update_2d}
    mesh = make_mesh(layout, PM_AXES, device=dev)
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=LM_LAYERS)
    full = build_model(cfg).init(
        torch.Generator(device=mesh.device).manual_seed(0),
        device=mesh.device)
    params = sharding.shard_params(full, mesh)
    del full
    torch.cuda.empty_cache()
    model = build_model(cfg, mesh=mesh,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh))
    stream = train.batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                device=mesh.device)
    batches = [sharding.local_batch(next(stream), mesh)
               for _ in range(PM_STEPS)]
    with moe_routes(torch) as routes:
        _, dropped, _, _ = pm_forward(torch, model, params, batches[0],
                                      mesh.device, mesh)
    reset_counts(kernels)
    held = pm_held(torch, mesh.device)
    pm_peak(torch, mesh.device, reset=True)
    _, _, metrics, secs, calls = pm_train(torch, model, params, batches,
                                          mesh.device, mesh)
    return {"coords": mesh.coords, "device": str(mesh.device),
            "dropped": dropped, "metrics": metrics, "step_s": secs,
            "routes": [idx.cpu().numpy() for idx, _ in routes],
            "calls": calls, "launches": counts(kernels),
            "held_bytes": held,
            "peak_device_bytes": pm_peak(torch, mesh.device)}


def pm_family_check(torch, case, runs, want):
    """The four ranks' runs of a reduced family case: bit for bit each
    other (parameters, ``lin``, prefill logits), within PM_LEAF of the
    one-process run (the CPU tests' bounds), the predicted collectives,
    the one-process launches with the layer kernels' forwards twice (the
    remat's rerun), ``lambda0`` once a step."""
    import numpy as np
    cases = pm_cases()[1]
    cfg = cases.setup(case)[0]
    train = cases.family_calls(cfg, PM_LAYOUT[1], "model", train=True)
    prefill = cases.family_calls(cfg, PM_LAYOUT[1], "model", train=False)
    # the ranks count their three kernels, the one process every kernel
    launches = {k: n for k, n in pm_remat_launches(want["launches"]).items()
                if k in runs[0]["launches"]}
    prefill_launches = {k: want["prefill_launches"][k]
                        for k in runs[0]["prefill_launches"]}
    worst = 0.0
    for r, run in enumerate(runs):
        for k in ("params", "lin"):
            for name, w in want[k].items():
                if not np.array_equal(run[k][name], runs[0][k][name]):
                    raise AssertionError(f"gloo {case}: rank {r}'s {k} "
                                         f"{name} differs from 0's")
                worst = max(worst, float(np.abs(run[k][name] - w).max())
                            / float(np.abs(w).max()))
        gap = max(abs(x - y) / abs(y) for u, v in zip(
            run["metrics"], want["metrics"]) for x, y in zip(u, v))
        pre = float(np.abs(run["prefill"] - want["prefill"]).max()) \
            / float(np.abs(want["prefill"]).max())
        if run["calls"] != [train] * PM_STEPS \
                or run["prefill_calls"] != prefill or gap > PM_LEAF \
                or pre > PM_LEAF \
                or not np.array_equal(run["prefill"], runs[0]["prefill"]) \
                or run["launches"] != launches \
                or run["prefill_launches"] != prefill_launches \
                or run["launches"]["ssca_update_lambda0"] != PM_STEPS:
            raise AssertionError(
                f"gloo {case} rank {r}: collectives {run['calls']} (want "
                f"{train}), prefill {run['prefill_calls']} (want {prefill}), "
                f"metrics gap {gap}, prefill gap {pre}, launches "
                f"{run['launches']} / {run['prefill_launches']} (want "
                f"{launches} / {prefill_launches})")
    if worst > PM_LEAF:
        raise AssertionError(f"gloo {case}: {worst} of the largest |leaf| "
                             "from the one-process run")
    return {"leaf_gap": worst, "metrics": runs[0]["metrics"],
            "step_s": [run["step_s"] for run in runs],
            "peak_device_bytes": [run["peak_device_bytes"] for run in runs],
            "calls_per_step": train, "prefill_calls": prefill,
            "launches": runs[0]["launches"],
            "prefill_launches": runs[0]["prefill_launches"]}


def phase_production_mesh(torch, kernels, card, dev="cuda",
                          backend="nccl"):
    """The production mesh (``launch/mesh.py::make_mesh``, ``models/
    sharded.py``): on a one-rank ``backend`` group in this process
    (``init_process_group`` on a FileStore), qwen3-moe's expert-parallel
    forward in both weight modes against ``moe_ffn``, and each of
    PM_FAMILIES' train and prefill steps on ``make_host_mesh()`` bit for
    bit ``mesh=None``; then four gloo ranks on ``cuda:0`` at PM_LAYOUT
    against the same cases in one process.  Returns each path's
    launches."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import LocalWorld
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    by_path = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pm_")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_host_mesh(device=dev)
        if (mesh.backend, mesh.size, mesh.device.type) \
                != (backend, 1, torch.device(dev).type):
            raise AssertionError(f"host mesh: {mesh}")
        by_path.update(pm_host_moe(torch, kernels, card, mesh, dev)[0])
        for family in PM_FAMILIES:
            t1 = time.perf_counter()
            paths, _ = pm_host_family(torch, kernels, card, mesh, dev,
                                      *family)
            by_path.update(paths)
            log(f"production mesh, one {backend} rank, {family[0]}: "
                f"{time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"production mesh, one {backend} rank: "
        f"{time.perf_counter() - t0:.1f} s")
    single = pm_single_reduced(torch, kernels, dev)
    by_path["mesh_gloo_single"] = single[3]
    t1 = time.perf_counter()
    ranks = LocalWorld(production_mesh_rank, 4, backend="gloo",
                       args=(dev,), timeout_s=MESH_TIMEOUT_S).join()
    log(f"production mesh, four gloo ranks: {time.perf_counter() - t1:.1f} "
        "s with start-up")
    pm_ranks_check(torch, ranks, single[:3], card, dev)
    total = {}
    for res in ranks:
        for case in [*res["dense"].values(), *res["moe"].values(),
                     *res["family"].values()]:
            for part in ("launches", "prefill_launches"):
                for k, v in case.get(part, {}).items():
                    total[k] = total.get(k, 0) + v
    by_path["mesh_gloo2x2"] = total
    log(f"production mesh phase: {time.perf_counter() - t0:.1f} s; "
        "launches by path:", json.dumps(by_path))
    return by_path


def rank_inputs():
    """A spawned rank's data, partitions, initial weights and the four MLP
    kernels' wrappers: the main path's."""
    import torch
    from repro_torch.data import partition, synthetic
    from repro_torch.kernels import compress as kc
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.kernels import sketch as ks
    from repro_torch.kernels import ssca_update as su
    from repro_torch.mlpapp import model
    torch.backends.cuda.matmul.allow_tf32 = False
    data = synthetic.classification_dataset(60000, 10000, seed=0)
    parts = {"main": partition.iid(60000, CLIENTS, seed=0),
             "i100": partition.iid(60000, 100, seed=0)}
    params = model.init_params(torch.Generator().manual_seed(0), 784, 128,
                               10)
    kernels = {"ssca_update": su.ssca_update_2d,
               "masked_sum": sa.masked_sum_2d, "compress": kc.compress_2d,
               "sketch_encode": ks.sketch_encode}
    return data, parts, params, kernels


# the paths at λ = 0, whose server update launches the β-less variant;
# every other Algorithm-1 path runs λ = 1e-5 and launches ``beta``
LAMBDA0_PATHS = ("lm_small", "lm_full_width", "rwkv_small",
                 "rwkv_full_width", "train_small_llama", "train_small_rwkv",
                 "train_llama_full", "hybrid_small", "hybrid_small_tail",
                 "hybrid_full_width", "train_small_hybrid",
                 "train_small_hybrid_tail", "train_hybrid_full",
                 *(f"{p}{s}" for p in ("moe_small", "train_small_moe")
                   for s in ("", "_interleaved")),
                 *(f"train_small_{m}_{s}" for m in ("moe", "moe_interleaved")
                   for s in ("resume", "bf16")),
                 "train_small_vlm", "train_small_audio", "train_vlm_full",
                 "train_audio_full", "mesh_gloo_single",
                 "mesh_gloo2x2",
                 *(f"mesh_host_{f[1]}_full{s}" for f in PM_FAMILIES
                   for s in ("", "_none")))


def check_ssca_variants(by_path):
    """Each path's ``ssca_update`` launches all on its variant: ``lambda0``
    on the λ = 0 LM paths, ``beta`` elsewhere."""
    for name, got in by_path.items():
        want = "lambda0" if name in LAMBDA0_PATHS else "beta"
        other = "beta" if want == "lambda0" else "lambda0"
        if got.get(f"ssca_update_{want}") != got["ssca_update"] \
                or got.get(f"ssca_update_{other}") != 0:
            raise AssertionError(f"{name}: ssca_update launches {got}, want "
                                 f"all {got['ssca_update']} on {want}")
    log(f"ssca_update launches on their variant on {len(by_path)} paths "
        f"(lambda0: {[k for k in by_path if k in LAMBDA0_PATHS]})")


def same_mesh_run(torch, p_m, h_m, single):
    """A mesh run's weights and history equal ``single``'s (bits, History)
    bit for bit."""
    bits, h_n = single
    same = all(torch.equal(a, b) for a, b in zip(path_bits(torch, p_m),
                                                   bits))
    for k in ("rounds", "metrics", "slack", "cum_uplink_bytes",
              "uplink_bytes_per_round", "downlink_bytes_per_round", "comm"):
        same = same and getattr(h_m, k) == getattr(h_n, k)
    return same


def main() -> int:
    global CARD
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
    CARD = card
    log(card)
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    log("flash_attention (registers a thread, spill bytes a thread, shared "
        "bytes a block) by head dim and mask (causal, band, none):",
        json.dumps({f"{dh} {mask}": fa.kernel_attributes(dh, mask)
                    for dh in sorted({d for dims in fa.HEAD_DIMS.values()
                                      for d in dims})
                    for mask in fa.MASKS}))
    log("rwkv6_wkv (registers a thread, spill bytes a thread, shared bytes "
        "a block) by instance:", json.dumps(rw.kernel_attributes()))
    log("masked_sum (registers a thread, spill bytes a thread, shared bytes "
        "a block) by instance:", json.dumps(sa.kernel_attributes()))
    stream_loop_mix()

    errs = phase_kernel_parity(torch, su, sa)
    errs["flash_attention"], f32_err, flash_stats = phase_flash_parity(torch)
    errs["flash_attention_tf32x3"] = f32_err[FLASH_SMALL]
    errs["flash_attention_f32_wide"] = f32_err[FLASH_F32_WIDE]
    band_errs, band_stats = phase_flash_band_parity(torch, card)
    errs.update(band_errs)
    moe_errs, moe_stats = phase_flash_moe_parity(torch)
    errs.update(moe_errs)
    band_stats.update(moe_stats)
    t0 = time.perf_counter()
    new_errs, new_stats = phase_flash_new_parity(torch, card)
    errs.update(new_errs)
    band_stats.update(new_stats)
    log(f"flash parity of the vlm and audio instances: "
        f"{time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    parts = {"main": part,
             "i100": partition.iid(60000, 100, seed=0),
             "i10k": partition.iid(60000, POP_CLIENTS, seed=0)}
    by_path.update(phase_participation(torch, kernels, data, parts, params,
                                       runtime, card))
    log(f"participation phase: {time.perf_counter() - t0:.1f} s")
    # the ring mode's wrapper counts its launches apart from masked_sum's
    kernels = dict(kernels, masked_ring_sum=sa.masked_ring_sum_2d)
    t0 = time.perf_counter()
    errs["masked_ring_sum"] = phase_ring_parity(torch, sa)
    by_path.update(phase_engine_modes(torch, kernels, data, parts, params,
                                      runtime, card))
    log(f"engine modes phase: {time.perf_counter() - t0:.1f} s")
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
    # the hybrid: one attention layer a forward, the f32 band at small
    # width, the wgmma kernel's head-dim-256 instance at full width
    t0 = time.perf_counter()
    for name, layers in (("hybrid_small", 3), ("hybrid_small_tail", 5)):
        by_path[name] = phase_lm_small(
            torch, kernels, runtime, name,
            transformer_task(HYBRID_ARCH, layers=layers), "flash_attention",
            "flash_attention_tf32x3")
    by_path["hybrid_full_width"], profiled["hybrid_full_width"] = \
        phase_lm_full(torch, kernels, runtime, card, "hybrid_full",
                      HYBRID_ARCH, HYBRID_PARAMS, "flash_attention",
                      "flash_attention_wgmma", layers=HYBRID_LAYERS,
                      clients=HYBRID_CLIENTS, tau=HYBRID_TAU, eval_every=1,
                      profile_copies=False)
    log(f"hybrid phase: {time.perf_counter() - t0:.1f} s")
    # the moe family at small width: every layer MoE (top-2) and the
    # interleaved super-block (top-1 and the shared expert), f32, the
    # tf32x3 kernel once a layer a forward
    t0 = time.perf_counter()
    for name, arch in (("moe_small", MOE_ARCH),
                       ("moe_small_interleaved", MOE_INTERLEAVED_ARCH)):
        by_path[name] = phase_lm_small(
            torch, kernels, runtime, name, transformer_task(arch),
            "flash_attention", "flash_attention_tf32x3")
    log(f"moe small phase: {time.perf_counter() - t0:.1f} s")
    by_path.update(phase_launch(torch, kernels, card))
    by_path.update(phase_production_mesh(torch, kernels, card))
    check_ssca_variants(by_path)
    total = {k: sum(p.get(k, 0) for p in by_path.values())
             for k in [*kernels, *variant_counts(kernels)]}
    log(f"launches over all paths: {total}")

    direct = server_kernels_full_width(torch, su, sa)
    log("masked_sum and ssca_update (beta, lambda0) at the full-width LM "
        "paths' widths, direct launches, checked against Σ quantize(m_i) "
        "and the plain update:", json.dumps(direct))
    ring_direct = ring_full_width(torch, sa)
    phase_profile(torch, data, part, params, runtime)
    rows = phase_timing(torch, su, sa, kc, ks, fa, rw, total, by_path, errs,
                        flash_stats, band_stats)
    rows.append(ring_row(torch, sa, total, by_path,
                         errs["masked_ring_sum"], ring_direct))
    full_width_rows(rows, by_path, profiled, direct)
    t0 = time.perf_counter()
    mesh_results = phase_client_mesh(torch, kernels, data, parts, params,
                                     runtime, card)
    log(f"client mesh phase: {time.perf_counter() - t0:.1f} s")
    check_ssca_variants({k: v.get("launches") or v["launches_rank0"]
                         for k, v in mesh_results.items()
                         if v.get("launches") or v.get("launches_rank0")})
    # the two modes' launches on each group-mesh path (rank 0 of a gloo
    # world), beside the rows' totals over the one-device paths
    for row in rows:
        if row["name"] in ("masked_sum", "masked_ring_sum"):
            row["group_mesh_launches"] = {
                k: (v.get("launches") or v["launches_rank0"])[row["name"]]
                for k, v in mesh_results.items()
                if k.startswith(("group11_", "gloo2x1_", "gloo1x2_",
                                 "gloo2x2_"))}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
