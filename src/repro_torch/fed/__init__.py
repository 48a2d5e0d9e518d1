"""Federated runtime of the port: the engine (one device, or the cohort
sharded over a client mesh of ranks, with the home-sharded arena), the
task contract, aggregation strategies (full or cohort participation, the
hierarchical tree), the staleness helpers of async rounds, the byte
ledger, the round keys and the :mod:`repro_torch.fed.runtime` entry
points."""
from repro_torch.fed.aggregation import (  # noqa: F401
    HierarchicalAggregation, hierarchical)
