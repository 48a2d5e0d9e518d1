"""Fused SSCA server update: the kernel wrapper and its plain version.

The port of ``repro/kernels/ssca_update.py::ssca_update_2d``.  One
elementwise pass fuses the four update equations of Algorithm 1 with the
canonical surrogate (6), with scalars [ρ, γ, τ, λ]:

    lin'  = (1−ρ)·lin + ρ·(g − 2τ·ω)          # (14)/(15)
    β'    = (1−ρ)·β  + ρ·ω                     # (13)
    ω̄     = −(lin' + 2λβ') / (2τ)              # (16)/(17)
    ω'    = (1−γ)·ω + γ·ω̄                      # (4)

Two variants of one kernel: ``beta`` runs the four equations, and
``lambda0``, for λ = 0, drops β: it reads ω, lin and g, writes ω' and
lin', and takes ω̄ = −lin'/(2τ), the reference's λ = 0 closed form.
On a CUDA tensor :func:`ssca_update_2d` launches the hand-written kernel
``csrc/ssca_update.cu``; on a CPU tensor it runs :func:`ssca_update_plain`.
Both round every operation separately in f32, in the same order, so they
agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import Device, on_cuda
from repro_torch.kernels import build

LANES = 128
VARIANTS = ("beta", "lambda0")


def ssca_update_plain(w, lin, g, beta, scalars):
    """The plain PyTorch version: (w', lin', β') from (R, 128) f32 inputs
    and the (4,) f32 scalars [ρ, γ, τ, λ].

    With ``beta=None`` (the ``lambda0`` variant) it returns
    (w', lin', None) with ω̄ = −lin'/(2τ), λ unread: bit for bit
    ``core.ssca.server_update(fused=False)`` at λ = 0.  Against the
    ``beta`` variant at λ = 0, lin' is the same bits and w' differs at
    most in the sign of a zero: there ω̄ = −(lin' + 0·β')/(2τ), and
    lin' + 0·β' turns a −0 lin' into +0.
    """
    rho, gamma, tau, lam = scalars.unbind()
    two_tau = 2.0 * tau
    lin_new = (1.0 - rho) * lin + rho * (g - two_tau * w)
    if beta is None:
        beta_new = None
        omega_bar = -lin_new / two_tau
    else:
        beta_new = (1.0 - rho) * beta + rho * w
        omega_bar = -(lin_new + (2.0 * lam) * beta_new) / two_tau
    w_new = (1.0 - gamma) * w + gamma * omega_bar
    return w_new, lin_new, beta_new


def ssca_update_2d(w, lin, g, beta, scalars, *, device: Device = None):
    """w/lin/g/beta: (R, 128) f32; scalars: (4,) f32 [ρ, γ, τ, λ], all on
    one device.  Returns (w', lin', β'), each in a fresh buffer; with
    ``beta=None`` the ``lambda0`` variant, (w', lin', None).

    A CPU tensor goes to :func:`ssca_update_plain` (only with
    ``device="cpu"``); a CUDA tensor launches the kernel's variant and
    adds one to ``ssca_update_2d.launches`` and to that variant's count in
    ``ssca_update_2d.launches_by_variant``.  Use :func:`repro_torch.
    kernels.ops.ssca_update` for parameter dicts (it flattens, pads and
    reshapes).
    """
    variant = "lambda0" if beta is None else "beta"
    tensors = (w, lin, g) if beta is None else (w, lin, g, beta)
    if not on_cuda(w, device):
        return ssca_update_plain(w, lin, g, beta, scalars)
    for x in tensors:
        if x.dtype != torch.float32 or x.shape != w.shape \
                or x.device != w.device or not x.is_contiguous():
            raise ValueError("ssca_update_2d takes contiguous f32 tensors "
                             "of one shape on one device")
    if w.dim() != 2 or w.shape[1] != LANES:
        raise ValueError(f"ssca_update_2d takes (R, {LANES}), got "
                         f"{tuple(w.shape)}")
    if scalars.dtype != torch.float32 or scalars.shape != (4,) \
            or scalars.device != w.device:
        raise ValueError("scalars must be a (4,) f32 tensor beside w")
    lib = build.load()
    outs = [torch.empty_like(w) for _ in tensors[1:]]
    ptr = [x.data_ptr() for x in tensors]
    out_ptr = [o.data_ptr() for o in outs]
    if beta is None:
        ptr.append(None)
        out_ptr.append(None)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    status = lib.ssca_update_launch(
        *ptr, scalars.contiguous().data_ptr(), *out_ptr, w.numel(), stream)
    build.check(status, "ssca_update")
    ssca_update_2d.launches += 1
    ssca_update_2d.launches_by_variant[variant] += 1
    return (*outs, None) if beta is None else tuple(outs)


ssca_update_2d.launches = 0
# the launches of each variant: ``beta`` (β read and advanced) and
# ``lambda0`` (λ = 0, no β)
ssca_update_2d.launches_by_variant = dict.fromkeys(VARIANTS, 0)
