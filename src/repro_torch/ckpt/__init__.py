"""Checkpoints of parameter and optimizer trees (:mod:`repro_torch.ckpt.io`)."""
