"""The model zoo of the port: the reference's API over the ``dense`` and
``ssm`` families so far (:mod:`repro_torch.models.transformer`,
:mod:`repro_torch.models.rwkv6`)."""
from repro_torch.models.transformer import Model, build_model  # noqa: F401
