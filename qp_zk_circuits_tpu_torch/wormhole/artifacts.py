"""Circuit artifact generation, pinning and atomic publication (the JAX
package's `wormhole/artifacts.py`).

Port of reference `wormhole/circuit-builder/src/lib.rs` + the pinning policy
of `wormhole/verifier/src/lib.rs:101-127` and
`aggregator/src/common/utils.rs:27-158`:

  * artifact set per build: `common.bin`, `verifier.bin`, `dummy_proof.bin`,
    the private- and public-batch pairs, `dummy_private_batch_proof.bin`
    and `config.json`;
  * the 1 MiB (leaf) / 64 MiB (aggregation) size caps; loads enforce them
    BEFORE allocation;
  * **never** serialize prover data (exfiltration rationale);
  * canonical pinning: artifacts are compared raw-byte against a rebuild
    from source (never deserialize untrusted common data), and keccak256
    pins (`canonical_pins.py`) guard the leaf verifier artifacts;
  * publication is ATOMIC: write into a same-filesystem staging directory,
    then rename-swap with move-aside + rollback.

Every builder here commits its circuit's preprocessing oracle on `device`
(CUDA unless the caller names one) and proves there.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
from dataclasses import dataclass
from pathlib import Path

from ..hash.keccak import keccak256
from ..plonk.serialization import VerifierCircuitData, proof_to_bytes
from . import inputs as wi

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

#: the full 9-file artifact set a complete `--include-aggregation` build
#: publishes (reference `wormhole/README.md:221-222` lists the same set)
FULL_ARTIFACT_SET = (
    LEAF_COMMON_BIN,
    LEAF_VERIFIER_BIN,
    DUMMY_PROOF_BIN,
    PRIVATE_BATCH_COMMON_BIN,
    PRIVATE_BATCH_VERIFIER_BIN,
    DUMMY_PRIVATE_BATCH_PROOF_BIN,
    PUBLIC_BATCH_COMMON_BIN,
    PUBLIC_BATCH_VERIFIER_BIN,
    CONFIG_JSON,
)



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


@dataclass(frozen=True)
class CircuitBinsConfig:
    """config.json schema binding artifact sets to their (L, N) shape
    (reference `aggregator/src/config.rs`)."""

    num_leaf_proofs: int
    num_private_batch_proofs: int

    def validate(self) -> None:
        wi.validate_proof_count(self.num_leaf_proofs, "num_leaf_proofs")
        wi.validate_proof_count(self.num_private_batch_proofs, "num_private_batch_proofs")

    def save(self, path: Path) -> None:
        self.validate()
        Path(path).write_text(
            json.dumps(
                {
                    "num_leaf_proofs": self.num_leaf_proofs,
                    "num_private_batch_proofs": self.num_private_batch_proofs,
                },
                indent=2,
            )
        )

    @classmethod
    def load(cls, path: Path) -> "CircuitBinsConfig":
        raw = json.loads(read_artifact_file(Path(path), 1 << 16))
        # legacy-key alias (reference config.rs:19-88)
        n_leaf = raw.get("num_leaf_proofs", raw.get("num_proofs"))
        n_pb = raw.get("num_private_batch_proofs", raw.get("num_agg_proofs"))
        if n_leaf is None or n_pb is None:
            raise ArtifactError("config.json missing proof-count keys")
        cfg = cls(num_leaf_proofs=int(n_leaf), num_private_batch_proofs=int(n_pb))
        cfg.validate()
        return cfg


def leaf_verifier_artifacts(data) -> dict:
    """{common.bin: bytes, verifier.bin: bytes} of a leaf `CircuitData` (its
    constants cap and circuit digest read on the host) or of its
    `VerifierCircuitData`."""
    vdata = data if isinstance(data, VerifierCircuitData) else VerifierCircuitData.from_circuit_data(data)
    return {
        LEAF_COMMON_BIN: vdata.to_common_bytes(),  # config + gates + layout + PI count
        LEAF_VERIFIER_BIN: vdata.to_verifier_only_bytes(),  # constants cap + digest
    }


def generate_leaf_circuit_binaries(out_dir: Path, prover=None, seed: int = 0,
                                   device=None) -> dict:
    """Build the leaf circuit from source (on `device` unless `prover` is
    given) and write common.bin / verifier.bin / dummy_proof.bin into
    `out_dir`. Returns {name: keccak_hex}."""
    from .dummy_proof import generate_dummy_proof
    from .prover import WormholeProver

    prover = prover or WormholeProver(device=device)
    hashes = write_leaf_verifier_artifacts(out_dir, prover.data)
    dummy_bytes = proof_to_bytes(generate_dummy_proof(prover, seed=seed))
    (Path(out_dir) / DUMMY_PROOF_BIN).write_bytes(dummy_bytes)
    hashes[DUMMY_PROOF_BIN] = artifact_keccak(dummy_bytes)
    return hashes


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


def generate_private_batch_circuit_binaries(
    out_dir: Path,
    num_leaf_proofs: int,
    leaf_prover=None,
    config=None,
    enforce_security_floor: bool = True,
    seed: int = 0,
    device=None,
):
    """Build the private-batch aggregation circuit over the leaf bins already
    present in `out_dir` and write private_batch_{common,verifier}.bin plus
    dummy_private_batch_proof.bin (the padding template for the public layer).

    Mirrors reference `aggregator/src/private_batch/circuit/build.rs:32-116`:
    the dummy leaf template is validated BEFORE the (expensive) aggregation
    circuit build, and the all-dummy private batch is proven with the freshly
    built circuit. Without `leaf_prover` the leaf and the batch are built on
    `device` (CUDA unless named); with it, on the leaf prover's device.
    Returns (PrivateBatchCircuit, {name: keccak_hex})."""
    from ..plonk.serialization import proof_from_bytes
    from .private_batch import (
        PrivateBatchCircuit,
        generate_dummy_private_batch_proof,
        verify_dummy_leaf_template,
    )
    from .prover import WormholeProver
    from .verifier import WormholeVerifier

    out_dir = Path(out_dir)
    if leaf_prover is None:
        leaf_prover = WormholeProver(device=device)
    leaf_vdata = VerifierCircuitData.from_circuit_data(leaf_prover.data)
    # pin the staged leaf artifacts against the in-memory build before use
    load_canonical_leaf_verifier_data(out_dir, rebuild=leaf_vdata)
    dummy_leaf = proof_from_bytes(
        read_artifact_file(out_dir / DUMMY_PROOF_BIN, MAX_AGG_ARTIFACT_BYTES)
    )
    leaf_verifier = WormholeVerifier(
        leaf_vdata, enforce_security_floor=enforce_security_floor
    )
    # validate the padding template BEFORE the expensive aggregation build
    verify_dummy_leaf_template(leaf_verifier, dummy_leaf)

    circuit = PrivateBatchCircuit(
        leaf_vdata,
        num_leaf_proofs,
        config=config,
        enforce_security_floor=enforce_security_floor,
        device=leaf_prover.data.device,
    )
    vdata = VerifierCircuitData.from_circuit_data(circuit.data)
    common_bytes = vdata.to_common_bytes()
    verifier_bytes = vdata.to_verifier_only_bytes()
    dummy_pb = generate_dummy_private_batch_proof(circuit, dummy_leaf, seed=seed)
    dummy_pb_bytes = proof_to_bytes(dummy_pb)

    (out_dir / PRIVATE_BATCH_COMMON_BIN).write_bytes(common_bytes)
    (out_dir / PRIVATE_BATCH_VERIFIER_BIN).write_bytes(verifier_bytes)
    (out_dir / DUMMY_PRIVATE_BATCH_PROOF_BIN).write_bytes(dummy_pb_bytes)
    return circuit, {
        PRIVATE_BATCH_COMMON_BIN: artifact_keccak(common_bytes),
        PRIVATE_BATCH_VERIFIER_BIN: artifact_keccak(verifier_bytes),
        DUMMY_PRIVATE_BATCH_PROOF_BIN: artifact_keccak(dummy_pb_bytes),
    }


def generate_public_batch_circuit_binaries(
    out_dir: Path,
    num_private_batch_proofs: int,
    num_leaf_proofs: int,
    private_batch_vdata: VerifierCircuitData,
    config=None,
    device=None,
):
    """Build the public-batch circuit over the private-batch verifier data and
    write public_batch_{common,verifier}.bin (reference
    `aggregator/src/public_batch/circuit/build.rs:35-116`).
    Returns (PublicBatchCircuit, {name: keccak_hex})."""
    from .public_batch import PublicBatchCircuit

    out_dir = Path(out_dir)
    circuit = PublicBatchCircuit(
        private_batch_vdata, num_private_batch_proofs, num_leaf_proofs, config=config,
        device=device,
    )
    vdata = VerifierCircuitData.from_circuit_data(circuit.data)
    common_bytes = vdata.to_common_bytes()
    verifier_bytes = vdata.to_verifier_only_bytes()
    (out_dir / PUBLIC_BATCH_COMMON_BIN).write_bytes(common_bytes)
    (out_dir / PUBLIC_BATCH_VERIFIER_BIN).write_bytes(verifier_bytes)
    return circuit, {
        PUBLIC_BATCH_COMMON_BIN: artifact_keccak(common_bytes),
        PUBLIC_BATCH_VERIFIER_BIN: artifact_keccak(verifier_bytes),
    }


def _load_pinned_agg_verifier_data(
    bins_dir: Path, verifier_name: str, common_name: str,
    rebuild: VerifierCircuitData,
) -> VerifierCircuitData:
    """Raw-byte pin of an aggregation-layer artifact pair against a
    from-source rebuild (reference `utils.rs:126-158`): the untrusted bytes
    are never deserialized — load fails unless both files equal the
    canonical serializations."""
    bins_dir = Path(bins_dir)
    loaded_v = read_artifact_file(bins_dir / verifier_name, MAX_AGG_ARTIFACT_BYTES)
    if loaded_v != rebuild.to_verifier_only_bytes():
        raise ArtifactError(f"{verifier_name} does not match canonical from-source rebuild")
    loaded_c = read_artifact_file(bins_dir / common_name, MAX_AGG_ARTIFACT_BYTES)
    if loaded_c != rebuild.to_common_bytes():
        raise ArtifactError(f"{common_name} does not match canonical from-source rebuild")
    return rebuild


def load_canonical_private_batch_verifier_data(
    bins_dir: Path, rebuild=None, leaf_rebuild=None, config=None,
    enforce_security_floor: bool = True, device=None,
):
    """Pin + load private_batch_verifier.bin. When `rebuild` is not supplied,
    the canonical circuit is rebuilt from source on `device`: leaf verifier
    data (itself pinned) + the (L) shape from config.json (reference
    `utils.rs:265-297`)."""
    from .private_batch import PrivateBatchCircuit

    bins_dir = Path(bins_dir)
    if rebuild is None:
        cfg = CircuitBinsConfig.load(bins_dir / CONFIG_JSON)
        leaf_vdata = load_canonical_leaf_verifier_data(
            bins_dir, rebuild=leaf_rebuild, device=device)
        circuit = PrivateBatchCircuit(
            leaf_vdata,
            cfg.num_leaf_proofs,
            config=config,
            enforce_security_floor=enforce_security_floor,
            device=device,
        )
        rebuild = VerifierCircuitData.from_circuit_data(circuit.data)
    return _load_pinned_agg_verifier_data(
        bins_dir, PRIVATE_BATCH_VERIFIER_BIN, PRIVATE_BATCH_COMMON_BIN, rebuild
    )


def load_canonical_public_batch_verifier_data(
    bins_dir: Path, rebuild=None, private_batch_rebuild=None, leaf_rebuild=None,
    config=None, enforce_security_floor: bool = True, device=None,
):
    """Pin + load public_batch_verifier.bin (rebuild chain: leaf → private
    batch → public batch, each layer pinned, rebuilt on `device`)."""
    from .public_batch import PublicBatchCircuit

    bins_dir = Path(bins_dir)
    if rebuild is None:
        cfg = CircuitBinsConfig.load(bins_dir / CONFIG_JSON)
        pb_vdata = load_canonical_private_batch_verifier_data(
            bins_dir, rebuild=private_batch_rebuild, leaf_rebuild=leaf_rebuild,
            enforce_security_floor=enforce_security_floor, device=device,
        )
        circuit = PublicBatchCircuit(
            pb_vdata, cfg.num_private_batch_proofs, cfg.num_leaf_proofs, config=config,
            device=device,
        )
        rebuild = VerifierCircuitData.from_circuit_data(circuit.data)
    return _load_pinned_agg_verifier_data(
        bins_dir, PUBLIC_BATCH_VERIFIER_BIN, PUBLIC_BATCH_COMMON_BIN, rebuild
    )


def load_dummy_private_batch_proof(bins_dir: Path):
    """Read + deserialize dummy_private_batch_proof.bin (template validation —
    sentinel + cryptographic verify — happens in the consumers)."""
    from ..plonk.serialization import proof_from_bytes

    return proof_from_bytes(
        read_artifact_file(
            Path(bins_dir) / DUMMY_PRIVATE_BATCH_PROOF_BIN, MAX_AGG_ARTIFACT_BYTES
        )
    )


# ---------------------------------------------------------------------------
# atomic staged publication (reference circuit-builder/src/lib.rs:115-310)


def create_staging_dir(target: Path) -> Path:
    """Same-filesystem sibling with a random name (rename-swap capable)."""
    target = Path(target)
    parent = target.parent if target.parent != Path("") else Path(".")
    parent.mkdir(parents=True, exist_ok=True)
    staging = parent / f".staging-{target.name}-{secrets.token_hex(6)}"
    staging.mkdir()
    return staging


def commit_staging_dir(staging: Path, target: Path, rename=os.rename) -> None:
    """Atomic swap: move aside any existing target, rename staging in, clean
    up; on a failed swap-in, roll the old directory back; on double failure
    both copies are preserved. `rename` is injectable for fault tests
    (reference `circuit-builder/src/lib.rs:217-310, 458-587`)."""
    staging, target = Path(staging), Path(target)
    moved_aside = None
    if target.exists():
        moved_aside = target.parent / f".old-{target.name}-{secrets.token_hex(6)}"
        rename(str(target), str(moved_aside))
    try:
        rename(str(staging), str(target))
    except OSError:
        if moved_aside is not None:
            try:
                rename(str(moved_aside), str(target))
            except OSError as rollback_err:
                raise ArtifactError(
                    f"swap-in failed AND rollback failed; data preserved at "
                    f"{staging} and {moved_aside}"
                ) from rollback_err
        raise ArtifactError(f"failed to swap staging dir into {target}; rolled back")
    if moved_aside is not None:
        shutil.rmtree(moved_aside, ignore_errors=True)


def generate_all_circuit_binaries(
    output: Path,
    num_leaf_proofs: int = 8,
    num_private_batch_proofs: int | None = None,
    include_aggregation: bool = False,
    seed: int = 0,
    leaf_config=None,
    private_batch_config=None,
    public_batch_config=None,
    enforce_security_floor: bool = True,
    rename=os.rename,
    device=None,
) -> None:
    """Full artifact-set generation with atomic publish (reference
    `circuit-builder/src/lib.rs:115-310`).

    Leaf artifacts always; with `include_aggregation` the complete
    FULL_ARTIFACT_SET (private + public batch bins and the dummy private-batch
    proof) is generated into the same staging directory. config.json is
    written LAST inside staging (completion marker) before the atomic swap.
    The non-canonical config knobs exist for tests only; production artifact
    sets use the canonical profiles. Every circuit is built and every proof
    made on `device` (CUDA unless named)."""
    from .prover import WormholeProver

    cfg = CircuitBinsConfig(
        num_leaf_proofs=num_leaf_proofs,
        num_private_batch_proofs=num_private_batch_proofs or num_leaf_proofs,
    )
    cfg.validate()  # before any writes
    output = Path(output)
    staging = create_staging_dir(output)
    try:
        leaf_prover = WormholeProver(leaf_config, device=device)
        generate_leaf_circuit_binaries(staging, prover=leaf_prover, seed=seed)
        if include_aggregation:
            pb_circuit, _ = generate_private_batch_circuit_binaries(
                staging,
                cfg.num_leaf_proofs,
                leaf_prover=leaf_prover,
                config=private_batch_config,
                enforce_security_floor=enforce_security_floor,
                seed=seed,
            )
            generate_public_batch_circuit_binaries(
                staging,
                cfg.num_private_batch_proofs,
                cfg.num_leaf_proofs,
                VerifierCircuitData.from_circuit_data(pb_circuit.data),
                config=public_batch_config,
                device=leaf_prover.data.device,
            )
        cfg.save(staging / CONFIG_JSON)  # completion marker, written last
        commit_staging_dir(staging, output, rename=rename)
    except Exception:
        shutil.rmtree(staging, ignore_errors=True)
        raise
