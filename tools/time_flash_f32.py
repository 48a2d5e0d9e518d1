#!/usr/bin/env python3
"""Time a checkout's f32 flash-attention kernel on one GPU, with
``chip_smoke.py``'s inputs and timer.

    python3 tools/time_flash_f32.py CHECKOUT

CHECKOUT is the root of a checkout of this repository (``.``, or the
parent commit unpacked with ``git archive`` into a gitignored
directory); its kernels are built from its own sources.  The kernel is
timed at the small LM's shape and at llama3-8b's attention in f32
(``chip_smoke.FLASH_SMALL`` and ``FLASH_F32_WIDE``) by
``chip_smoke.time_ms``, the same inputs and timer as ``chip_smoke.py``'s
rows, which time only their own checkout's kernel.  Prints the card's
name and power limit, then one JSON line of milliseconds a call.  Run it
for two checkouts in turns in one call to compare them.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    out = {"checkout": str(root)}
    for name, shape in (("small", cs.FLASH_SMALL),
                        ("wide", cs.FLASH_F32_WIDE)):
        x = cs.flash_inputs(torch, *shape, torch.float32, seed=2)
        out[f"{name}_ms"] = cs.time_ms(lambda: fa.flash_attention_bhsd(*x))
        del x
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
