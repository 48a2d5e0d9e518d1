"""The model zoo of the port: the reference's API over the ``dense``,
``moe``, ``ssm`` and ``hybrid`` families so far (:mod:`repro_torch.models.
transformer`, :mod:`repro_torch.models.moe`, :mod:`repro_torch.models.
rwkv6`, :mod:`repro_torch.models.rglru`)."""
from repro_torch.models.transformer import Model, build_model  # noqa: F401
