#!/usr/bin/env python3
"""A/B of an LM path's round at full width between checkouts, on one GPU.

    python3 tools/ab_lm_round.py OLD NEW [--arch rwkv6-7b]

OLD and NEW are checkouts of this repository (for example the parent
commit unpacked with ``git archive`` into a gitignored directory, and
``.``).  They run in turns, OLD NEW NEW OLD, each in a fresh process
that imports that checkout's ``chip_smoke.py`` and ``repro_torch`` and
runs ``chip_smoke.phase_lm_full`` for ``--arch`` (``rwkv6-7b`` or
``llama3-8b``, 2 of their layers): a warm-up round, 4 timed rounds with
counted launches, then one round under ``torch.profiler``.  Each run
prints its round time, peak device memory and device time by kind; the
card's name and power limit come first.  Host time varies from run to
run on a shared host, so compare within one call only.
"""
from __future__ import annotations

import inspect
import os
import subprocess
import sys


def one(root: str, arch: str) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    from repro_torch.fed import runtime
    from repro_torch.kernels import build, compress, flash_attention
    from repro_torch.kernels import rwkv6_scan, secure_agg, sketch
    from repro_torch.kernels import ssca_update
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    kernels = {"ssca_update": ssca_update.ssca_update_2d,
               "masked_sum": secure_agg.masked_sum_2d,
               "compress": compress.compress_2d,
               "sketch_encode": sketch.sketch_encode,
               "flash_attention": flash_attention.flash_attention_bhsd,
               "rwkv6_wkv": rwkv6_scan.rwkv6_wkv_bh}
    if arch == "rwkv6-7b":
        args = ["rwkv6-7b", cs.RWKV_PARAMS, "rwkv6_wkv"]
        variant = "rwkv6_wkv_mma"
    else:
        args = ["llama3-8b", cs.LM_PARAMS, "flash_attention"]
        variant = "flash_attention_wgmma"
    # older checkouts take no variant for the WKV scan
    if "variant" in inspect.signature(cs.phase_lm_full).parameters:
        args.append(variant)
    elif arch != "rwkv6-7b":
        args.append(variant)
    print(f"checkout {root}", flush=True)
    cs.phase_lm_full(torch, kernels, runtime, "this card", arch, *args)


def main() -> int:
    if sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        return 0
    roots = [a for a in sys.argv[1:] if not a.startswith("--")]
    arch = "rwkv6-7b"
    if "--arch" in sys.argv:
        arch = sys.argv[sys.argv.index("--arch") + 1]
        roots.remove(arch)
    old, new = roots
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root in (old, new, new, old):
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               arch])
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
