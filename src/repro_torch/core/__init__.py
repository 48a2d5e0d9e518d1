"""Core of the port: mini-batch SSCA.

* :mod:`repro_torch.core.schedules` — the stepsize laws and the paper's
  Section-VI tunings.
* :mod:`repro_torch.core.ssca` — Algorithm 1 (unconstrained).
* :mod:`repro_torch.core.protocol` — the algorithm interface the engine
  consumes.
"""
