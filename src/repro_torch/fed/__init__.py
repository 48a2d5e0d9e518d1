"""Federated runtime of the port: the single-device engine, the task
contract, aggregation strategies (full or cohort participation), the
staleness helpers of async rounds, the byte ledger, the round keys and
the :mod:`repro_torch.fed.runtime` entry points."""
