"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by
:mod:`repro_torch.kernels.build`), each beside its plain PyTorch version:

* ``ssca_update`` — the fused Algorithm-1 server update.
* ``secure_agg``  — streaming secure aggregation: quantize + counter-mode
                    pair masks + Z_{2^32} sum in one pass.
* ``compress``    — threshold, stochastic lattice rounding and residual
                    of the qsgd / top-k uploads.
* ``sketch``      — the count-sketch encode of the sketched uploads.
* ``flash_attention`` — causal GQA attention of the LM's training forward,
                    with a plain backward and a vmap rule.
* ``rwkv6_scan``  — the WKV scan of the RWKV-6 time mix, with a plain
                    backward and a vmap rule.

``ops`` holds the wrappers for parameter and message dicts and the
differentiable model ops ``ops.flash_attention`` and ``ops.rwkv6_wkv``
(exported here; the name ``flash_attention`` stays the submodule's).  No
module here builds or loads a kernel at import: the build runs on a
wrapper's first launch.
"""
from repro_torch.kernels.ops import rwkv6_wkv  # noqa: F401
