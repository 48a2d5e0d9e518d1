#!/usr/bin/env python3
"""The production mesh's four-rank cases on four cards, one NCCL rank a
card, against the same cases in one process on ``cuda:0``; then
qwen3-moe's train step at full width on a (1, 4) mesh.

    python3 tools/production_mesh_cards.py

``chip_smoke.py`` runs these cases on four gloo ranks sharing one card
(NCCL refuses two ranks on one card); here each rank of a (2, 2) (data,
model) mesh has a card of its own and the collectives run on NCCL
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``):
the reduced llama3-8b (both ``act_tp``) and granite-34b train steps, the
reduced qwen3-moe forward in both weight modes, and the reduced moe and
family train and prefill steps, every reduced decode case of
``tests/torch_production_mesh_decode_cases.py`` and a checkpoint saved on
the mesh in each moe weight mode (``chip_smoke.production_mesh_rank``),
held by ``chip_smoke.pm_ranks_check``: the ranks bit for bit each
other, within the CPU tests' bounds of the one-process run (1e-5 in
f32), the predicted collectives; the checkpoints read back whole on one
device (``chip_smoke.pm_ckpt_check``).  Then three reduced decode cases
(qwen3-moe expert-parallel in f32 and in bf16, llama3-8b in bf16) on a
(1, 4) mesh of NCCL ranks (``chip_smoke.pm_decode_rank``), held the same
way.

Then qwen3-moe at full width (2 of 94 layers, bf16; one card holds
neither its train step nor its fused update's f32 buffers) on four NCCL
ranks at (1, 4), 3 train steps at ``launch/train.py``'s B = 8, S = 128
(``chip_smoke.moe_full_train_rank``), against one card's loss, ‖g‖,
drops and routes at the same weights and batch (its gradient fits one
card, its update does not): the ranks' metrics equal; the first loss
within LOSS_GAP and the first ‖g‖ within GRAD_GAP relative of one
card's (bf16 partial sums add in another order); the first MoE
layer's expert choices equal but at near-ties (a token routed apart has
a relative top-k margin within ``chip_smoke.ROUTE_TIE`` on the one card;
a later layer's input differs by more, as a token routed apart
perturbs every later one through attention); each layer's dropped share
within the count of tokens routed apart over B · S of one card's (a
token routed apart moves at most k assignments, and each changes the
kept count by at most one); the predicted collectives, the flash kernel
twice a layer a step and ``lambda0`` once.
Needs four cards; exits 2 with fewer.  Prints the cards' names and power
limits, then one JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if torch.cuda.device_count() < 4:
        print("production_mesh_cards: needs four cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssca_update as su
    from repro_torch.launch import LocalWorld
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], check=True,
                           capture_output=True, text=True).stdout.strip()
    print(cards)
    card = cards.splitlines()[0]
    cs.CARD = card
    build.load()
    kernels = {"flash_attention": fa.flash_attention_bhsd,
               "ssca_update": su.ssca_update_2d,
               "rwkv6_wkv": rw.rwkv6_wkv_bh}
    dense, forward, family, _, decode = cs.pm_single_reduced(
        torch, kernels, "cuda")
    tmp = tempfile.mkdtemp(prefix="production_mesh_cards_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    ranks = LocalWorld(cs.production_mesh_rank, 4, backend="nccl",
                       args=("cuda", ckpt_dir),
                       timeout_s=cs.MESH_TIMEOUT_S).join()
    seconds = time.perf_counter() - t0
    summary = cs.pm_ranks_check(torch, ranks, (dense, forward, family,
                                               decode),
                                card, backend="nccl")
    summary["ckpt"] = cs.pm_ckpt_check(ckpt_dir)
    shutil.rmtree(tmp, ignore_errors=True)
    layout, names = (1, 4), DECODE_1X4
    t0 = time.perf_counter()
    ranks = LocalWorld(cs.pm_decode_rank, 4, backend="nccl",
                       args=(layout, names),
                       timeout_s=cs.MESH_TIMEOUT_S).join()
    decode_1x4 = {"world_seconds": time.perf_counter() - t0,
                  **cs.pm_decode_check(ranks, {n: decode[n] for n in names},
                                       layout)}
    moe_full = moe_full_width(torch, card)
    print(json.dumps({"nccl_ranks": 4, "world_seconds": seconds,
                      "cases": summary, "decode_1x4": decode_1x4,
                      "moe_full_width": moe_full}))
    return 0


# the reduced decode cases the (1, 4) NCCL mesh runs: expert-parallel in
# f32 and in bf16, and the dense bf16 one (the split-K combine's f32
# partials)
DECODE_1X4 = ("qwen3-moe", "qwen3-moe bf16", "llama3-8b bf16")


# the first step on (1, 4) against one card, relative, as measured on
# H100 80GB HBM3 cards at 700 W: the loss 4.0e-5 (25× room), ‖g‖ 6.5e-4
# (15× room)
LOSS_GAP = 1e-3
GRAD_GAP = 1e-2


def moe_full_width(torch, card):
    """qwen3-moe's full-width train step on (1, 4) NCCL ranks against the
    one-card loss, ‖g‖, drops and routes at the same weights."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import autodiff, ssca
    from repro_torch.launch import LocalWorld, train
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(cs.MOE_ARCH),
                              num_layers=cs.LM_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = next(train.batch_stream(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                    device="cuda"))
    dropped = []
    with torch.no_grad(), cs.moe_routes(torch) as own:
        model.forward_with_aux(params, batch, dropped)
    dropped = [float(d) for d in dropped]
    loss, grads = autodiff.value_and_grad(model.loss, params, batch)
    loss, norm = float(loss), float(ssca.kkt_residual(grads))
    del params, batch, grads
    torch.cuda.empty_cache()
    layout = (1, 4)
    t0 = time.perf_counter()
    ranks = LocalWorld(cs.moe_full_train_rank, 4, backend="nccl",
                       args=(layout,), timeout_s=cs.MESH_TIMEOUT_S).join()
    seconds = time.perf_counter() - t0
    sys.path.insert(0, str(cs.ROOT / "tests"))
    import torch_production_mesh_family_cases as cases
    want = cases.family_calls(cfg, layout[1], "model", train=True)
    first, first_norm = ranks[0]["metrics"][0]
    k, tokens = cfg.experts_per_token, cs.TRAIN_BATCH * cs.TRAIN_SEQ
    ties = [cs.route_ties([o], [torch.as_tensor(r).cuda()], k)
            for o, r in zip(own, ranks[0]["routes"])]
    apart = [flips[0] for flips, _ in ties]
    worst = [margin for _, margin in ties]
    near = [int(((top[..., k - 1] - top[..., k]) / top[..., k - 1]
                 <= cs.ROUTE_TIE).sum()) for _, top in own]
    ln_v = math.log(cfg.vocab_size)
    out = {"layout": layout, "world_seconds": seconds,
           "one_card_loss": loss, "one_card_grad_norm": norm,
           "one_card_dropped": dropped,
           "loss_rel_gap": abs(first - loss) / loss,
           "grad_norm_rel_gap": abs(first_norm - norm) / norm,
           "tokens_routed_apart_by_layer": apart,
           "largest_margin_routed_apart_by_layer": worst,
           "tokens_within_route_tie_by_layer": near,
           "tokens_a_layer": tokens, "calls_per_step": want,
           "ranks": {r: {key: v for key, v in res.items()
                         if key != "routes"} for r, res in enumerate(ranks)}}
    print(f"qwen3-moe full width ({cs.LM_LAYERS} of 94 layers, bf16, "
          f"B = {cs.TRAIN_BATCH}, S = {cs.TRAIN_SEQ}) on {layout} NCCL "
          f"ranks, one card a rank: {json.dumps(out)} on {card}")
    for r, res in enumerate(ranks):
        launches = res["launches"]
        if res["metrics"] != ranks[0]["metrics"] \
                or res["calls"] != [want] * cs.PM_STEPS \
                or launches["ssca_update_lambda0"] != cs.PM_STEPS \
                or launches["flash_attention_wgmma"] \
                != 2 * cs.PM_STEPS * cfg.num_layers \
                or tuple(res["coords"]) != (0, r) \
                or not all(np.array_equal(a, b) for a, b in zip(
                    res["routes"], ranks[0]["routes"])):
            raise AssertionError(f"qwen3-moe full width rank {r}: "
                                 f"{out['ranks'][r]}")
    drops = [abs(a - b) * tokens <= n for a, b, n in zip(
        ranks[0]["dropped"], dropped, apart)]
    if not (all(math.isfinite(x) for u in ranks[0]["metrics"] for x in u)
            and ln_v - 1 <= first <= ln_v + 3
            and out["loss_rel_gap"] <= LOSS_GAP
            and out["grad_norm_rel_gap"] <= GRAD_GAP
            and worst[0] <= cs.ROUTE_TIE and all(drops)
            and len(apart) == cfg.num_layers):
        raise AssertionError(
            f"qwen3-moe full width: metrics {ranks[0]['metrics']}, one card "
            f"{loss}, ‖g‖ {norm}; dropped {ranks[0]['dropped']} against "
            f"{dropped}, routed apart {apart} (largest margins {worst})")
    return {k: v for k, v in out.items() if k != "ranks"} | {
        "metrics": ranks[0]["metrics"],
        "dropped": ranks[0]["dropped"],
        "step_s": [res["step_s"] for res in ranks],
        "peak_device_bytes": [res["peak_device_bytes"] for res in ranks],
        "held_bytes": [res["held_bytes"] for res in ranks]}


if __name__ == "__main__":
    sys.exit(main())
