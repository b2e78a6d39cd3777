"""Leaf verifier artifacts: names, size-capped reads, keccak pins.

The leaf part of the JAX package's `wormhole/artifacts.py` (the pinning
policy of reference `wormhole/verifier/src/lib.rs:101-127` and
`aggregator/src/common/utils.rs:27-158`):

  * the artifact names and the 1 MiB (leaf) / 64 MiB (aggregation) size
    caps; loads enforce them BEFORE allocation;
  * **never** serialize prover data (exfiltration rationale);
  * canonical pinning: artifacts are compared raw-byte against a rebuild
    from source (never deserialize untrusted common data), and keccak256
    pins (`canonical_pins.py`) guard the leaf verifier artifacts.

`write_leaf_verifier_artifacts` writes the verifier.bin / common.bin pair
only: the dummy proof of `generate_leaf_circuit_binaries`, the aggregation
artifacts and atomic publication come with the aggregation layers.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..hash.keccak import keccak256
from ..plonk.serialization import VerifierCircuitData

MAX_VERIFIER_ARTIFACT_BYTES = 1 << 20  # 1 MiB (leaf artifacts)
MAX_AGG_ARTIFACT_BYTES = 64 << 20  # 64 MiB (aggregation artifacts)

LEAF_COMMON_BIN = "common.bin"
LEAF_VERIFIER_BIN = "verifier.bin"
DUMMY_PROOF_BIN = "dummy_proof.bin"
PRIVATE_BATCH_COMMON_BIN = "private_batch_common.bin"
PRIVATE_BATCH_VERIFIER_BIN = "private_batch_verifier.bin"
DUMMY_PRIVATE_BATCH_PROOF_BIN = "dummy_private_batch_proof.bin"
PUBLIC_BATCH_COMMON_BIN = "public_batch_common.bin"
PUBLIC_BATCH_VERIFIER_BIN = "public_batch_verifier.bin"
CONFIG_JSON = "config.json"


class ArtifactError(ValueError):
    pass


def read_artifact_file(path: Path, max_bytes: int) -> bytes:
    """Size-capped read: stat BEFORE reading so oversized files cannot force
    allocation (reference `verifier/src/lib.rs:143-159`)."""
    size = os.path.getsize(path)
    if size > max_bytes:
        raise ArtifactError(f"artifact {path} exceeds size cap ({size} > {max_bytes})")
    return Path(path).read_bytes()


def artifact_keccak(data: bytes) -> str:
    return keccak256(data).hex()


def leaf_verifier_artifacts(data) -> dict:
    """{common.bin: bytes, verifier.bin: bytes} of a leaf `CircuitData` (its
    constants cap and circuit digest read on the host) or of its
    `VerifierCircuitData`."""
    vdata = data if isinstance(data, VerifierCircuitData) else VerifierCircuitData.from_circuit_data(data)
    return {
        LEAF_COMMON_BIN: vdata.to_common_bytes(),  # config + gates + layout + PI count
        LEAF_VERIFIER_BIN: vdata.to_verifier_only_bytes(),  # constants cap + digest
    }


def write_leaf_verifier_artifacts(out_dir: Path, data) -> dict:
    """Write common.bin and verifier.bin of a leaf `CircuitData` (or its
    `VerifierCircuitData`) into
    `out_dir` (the same bytes as the JAX package's
    `generate_leaf_circuit_binaries` writes); returns {name: keccak_hex}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    blobs = leaf_verifier_artifacts(data)
    for name, blob in blobs.items():
        (out_dir / name).write_bytes(blob)
    return {name: artifact_keccak(blob) for name, blob in blobs.items()}


def load_canonical_leaf_verifier_data(bins_dir: Path, rebuild=None,
                                      device=None) -> VerifierCircuitData:
    """Load verifier.bin + common.bin and pin BOTH by RAW-BYTE equality
    against a from-source rebuild — untrusted common data is never
    deserialized before the pin (poisoned-length rationale, reference
    `utils.rs:126-158`). Without `rebuild`, the leaf circuit is built and
    its preprocessing oracle committed on `device` (CUDA unless named)."""
    from .leaf_circuit import WormholeCircuit

    bins_dir = Path(bins_dir)
    loaded_v = read_artifact_file(bins_dir / LEAF_VERIFIER_BIN, MAX_VERIFIER_ARTIFACT_BYTES)
    loaded_c = read_artifact_file(bins_dir / LEAF_COMMON_BIN, MAX_VERIFIER_ARTIFACT_BYTES)
    if rebuild is None:
        rebuild = VerifierCircuitData.from_circuit_data(WormholeCircuit().build(device=device))
    if loaded_v != rebuild.to_verifier_only_bytes():
        raise ArtifactError("verifier.bin does not match canonical from-source rebuild")
    if loaded_c != rebuild.to_common_bytes():
        raise ArtifactError("common.bin does not match canonical from-source rebuild")
    return rebuild
