"""The per-round communication ledger.

The port of ``repro/fed/compression.py``'s ``RoundBytes``,
``round_bytes`` and the identity compressor's ``payload_bytes``: exact
uplink/downlink bytes of one round for an algorithm × aggregation pair.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class IdentityCompressor:
    """Dense float32 uploads — the only wire of this port so far."""

    name = "identity"

    def payload_bytes(self, elements, leaves, elem_bytes):
        del leaves
        return elements * elem_bytes


def identity() -> IdentityCompressor:
    return IdentityCompressor()


@dataclasses.dataclass
class RoundBytes:
    """Exact per-round wire traffic of one engine configuration."""
    uplink_per_client: int
    uplink_total: int
    downlink_per_client: int
    downlink_total: int
    participants: int
    breakdown: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _param_bytes(params) -> int:
    return sum(w.numel() * w.element_size() for w in params.values())


def round_bytes(algorithm, aggregation, params,
                num_clients: int) -> RoundBytes:
    """The ledger: exact uplink/downlink bytes for one round.

    * uplink — per participating client: the payload under a float wire
      (plain aggregation), or the dense Z_{2^32} ring representation plus
      the per-peer seed overhead under secure aggregation
      (:meth:`SecureAggregation.uplink_wire_bytes`).
    * downlink — the server's model broadcast, one dense copy of
      ``params`` per participating client.
    """
    comp = identity()
    elements, leaves, elem_bytes = algorithm.upload_spec(params)
    payload = comp.payload_bytes(elements, leaves, elem_bytes)
    per_client = aggregation.uplink_wire_bytes(payload, elements,
                                               num_clients)
    participants = aggregation.participants(num_clients)
    down = _param_bytes(params)
    return RoundBytes(
        uplink_per_client=per_client,
        uplink_total=per_client * participants,
        downlink_per_client=down,
        downlink_total=down * participants,
        participants=participants,
        breakdown={
            "compressor": comp.name,
            "payload_bytes": payload,
            "upload_elements": elements,
            "wire_elements": elements,
            "upload_leaves": leaves,
            "upload_elem_bytes": elem_bytes,
            "wire_overhead_bytes": per_client - payload,
            "group_uplink_bytes": 0,
        })
