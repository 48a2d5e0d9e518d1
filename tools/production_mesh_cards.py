#!/usr/bin/env python3
"""The production mesh's four-rank cases on four cards, one NCCL rank a
card, against the same cases in one process on ``cuda:0``.

    python3 tools/production_mesh_cards.py

``chip_smoke.py`` runs these cases on four gloo ranks sharing one card
(NCCL refuses two ranks on one card); here each rank of a (2, 2) (data,
model) mesh has a card of its own and the collectives run on NCCL
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``):
the reduced llama3-8b (both ``act_tp``) and granite-34b train steps and
the reduced qwen3-moe forward in both weight modes
(``chip_smoke.production_mesh_rank``), held by
``chip_smoke.pm_ranks_check``: the ranks bit for bit each other, within
1e-5 of the one-process run, the predicted collectives.  Needs four
cards; exits 2 with fewer.  Prints the cards' names and power limits,
then one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
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
               "ssca_update": su.ssca_update_2d}
    dense, forward, _ = cs.pm_single_reduced(torch, kernels, "cuda")
    t0 = time.perf_counter()
    ranks = LocalWorld(cs.production_mesh_rank, 4, backend="nccl",
                       args=("cuda",), timeout_s=cs.MESH_TIMEOUT_S).join()
    seconds = time.perf_counter() - t0
    summary = cs.pm_ranks_check(torch, ranks, (dense, forward), card,
                                backend="nccl")
    print(json.dumps({"nccl_ranks": 4, "world_seconds": seconds,
                      "cases": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
