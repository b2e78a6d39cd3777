"""Bounded parser for untrusted transfer-proof JSON documents (the port's
copy; host-only, it imports `json` and `dataclasses`).

Port of reference `common/src/circuit.rs:20-370` (`TransferProofJson`): a
client-supplied document carrying a chain storage proof. Every bound exists
to cap attacker-controlled allocation:

  * the RAW document length is checked against an 8 MiB cap BEFORE any
    parsing — per-field bounds alone cannot stop an escape-inflated string
    from being decoded into scratch storage first;
  * per-field caps (state_root hex length, storage-proof node count / node
    length / aggregate length, Merkle index count) are enforced on the parsed
    values as defense in depth;
  * `from_json_str` is the ONLY parse path — the type deliberately has no
    generic `from_dict`/deserialize hook (`tests/test_torch_tools.py` holds
    the attribute set, the outcomes and the messages to the JAX package's).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

MAX_STORAGE_PROOF_NODES = 1024
MAX_STORAGE_PROOF_NODE_HEX_LEN = 1 << 20
MAX_STORAGE_PROOF_HEX_BYTES = 1 << 20
MAX_MERKLE_INDICES = 1024
MAX_STATE_ROOT_HEX_LEN = 64
MAX_TRANSFER_PROOF_JSON_BYTES = 8 * 1024 * 1024


class TransferProofError(ValueError):
    pass


@dataclass
class TransferProofJson:
    transfer_count: int
    state_root: str  # hex (no 0x)
    storage_proof: list  # hex-encoded nodes
    indices: list  # Merkle indices

    @classmethod
    def from_json_str(cls, doc: str | bytes) -> "TransferProofJson":
        """Parse untrusted transfer-proof JSON, bounding allocation up front.

        The raw document length is checked BEFORE parsing (reference
        `circuit.rs:118-131`): `json.loads` would otherwise decode
        arbitrarily large escaped strings into scratch storage before any
        per-field bound could observe them."""
        raw_len = len(doc)
        if raw_len > MAX_TRANSFER_PROOF_JSON_BYTES:
            raise TransferProofError(
                f"transfer proof JSON exceeds {MAX_TRANSFER_PROOF_JSON_BYTES} bytes "
                f"({raw_len} bytes); refusing to parse it"
            )
        try:
            obj = json.loads(doc)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise TransferProofError(f"failed to parse transfer proof JSON: {e}") from e
        if not isinstance(obj, dict):
            raise TransferProofError("transfer proof JSON must be an object")

        missing = {"transfer_count", "state_root", "storage_proof", "indices"} - obj.keys()
        if missing:
            raise TransferProofError(f"missing fields: {sorted(missing)}")

        tc = obj["transfer_count"]
        # JSON has no u64; enforce the reference's u64 range + integrality
        if isinstance(tc, bool) or not isinstance(tc, int) or not 0 <= tc < (1 << 64):
            raise TransferProofError("transfer_count must be a u64")

        sr = obj["state_root"]
        if not isinstance(sr, str):
            raise TransferProofError("state_root must be a string")
        if len(sr) > MAX_STATE_ROOT_HEX_LEN:
            raise TransferProofError(f"state_root exceeds {MAX_STATE_ROOT_HEX_LEN} bytes")

        sp = obj["storage_proof"]
        if not isinstance(sp, list):
            raise TransferProofError("storage_proof must be an array")
        if len(sp) > MAX_STORAGE_PROOF_NODES:
            raise TransferProofError(f"storage_proof exceeds {MAX_STORAGE_PROOF_NODES} nodes")
        total = 0
        for index, node in enumerate(sp):
            if not isinstance(node, str):
                raise TransferProofError(f"storage_proof node {index} must be a string")
            if len(node) > MAX_STORAGE_PROOF_NODE_HEX_LEN:
                raise TransferProofError(
                    f"storage_proof node {index} exceeds {MAX_STORAGE_PROOF_NODE_HEX_LEN} bytes"
                )
            total += len(node)
            if total > MAX_STORAGE_PROOF_HEX_BYTES:
                raise TransferProofError(
                    f"storage_proof exceeds {MAX_STORAGE_PROOF_HEX_BYTES} total bytes"
                )

        idx = obj["indices"]
        if not isinstance(idx, list):
            raise TransferProofError("indices must be an array")
        if len(idx) > MAX_MERKLE_INDICES:
            raise TransferProofError(f"indices exceeds {MAX_MERKLE_INDICES} entries")
        for i, v in enumerate(idx):
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise TransferProofError(f"indices[{i}] must be a non-negative integer")

        out = cls(transfer_count=tc, state_root=sr, storage_proof=list(sp), indices=list(idx))
        out.validate()
        return out

    def validate(self) -> None:
        """Re-check the decoded bounds (for callers constructing directly —
        reference `circuit.rs:133-171`)."""
        if len(self.state_root) > MAX_STATE_ROOT_HEX_LEN:
            raise TransferProofError(f"state_root exceeds {MAX_STATE_ROOT_HEX_LEN} bytes")
        if len(self.storage_proof) > MAX_STORAGE_PROOF_NODES:
            raise TransferProofError(f"storage_proof exceeds {MAX_STORAGE_PROOF_NODES} nodes")
        total = 0
        for index, node in enumerate(self.storage_proof):
            if len(node) > MAX_STORAGE_PROOF_NODE_HEX_LEN:
                raise TransferProofError(
                    f"storage_proof node {index} exceeds {MAX_STORAGE_PROOF_NODE_HEX_LEN} bytes"
                )
            total += len(node)
            if total > MAX_STORAGE_PROOF_HEX_BYTES:
                raise TransferProofError(
                    f"storage_proof exceeds {MAX_STORAGE_PROOF_HEX_BYTES} total bytes"
                )
        if len(self.indices) > MAX_MERKLE_INDICES:
            raise TransferProofError(f"indices exceeds {MAX_MERKLE_INDICES} entries")
