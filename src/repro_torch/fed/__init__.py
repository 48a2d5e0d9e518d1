"""Federated runtime of the port: the single-device engine, the task
contract, aggregation strategies, the byte ledger, the round keys and
the :func:`repro_torch.fed.runtime.run_alg1` entry point."""
