"""The model zoo of the port: the reference's API over the ``dense``
family so far (:mod:`repro_torch.models.transformer`)."""
from repro_torch.models.transformer import Model, build_model  # noqa: F401
