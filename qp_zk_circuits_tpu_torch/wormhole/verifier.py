"""Leaf verifier: canonical-profile checks + proof verification.

The reference ships a standalone no-std verifier that loads keccak-pinned
artifacts (`wormhole/verifier/src/lib.rs`): size caps, canonical pins,
config + PI-shape re-checks, then cryptographic verification. Artifact
byte-serialization and pinning live in `wormhole/artifacts.py`; this module
is the verification entry point. All of it runs on the host (numpy and
Python ints); `WormholeVerifier(prover.data)` takes the port's `CircuitData`
as built on the card, whose constants cap and circuit digest are host
arrays. The JAX package's verifier, error for error."""

from __future__ import annotations

from ..hash.keccak import keccak256
from ..plonk.verifier import VerificationError, verify as plonk_verify
from . import canonical_pins as pins
from . import inputs as wi


def ensure_loaded_matches_canonical_leaf_profile(vdata) -> None:
    """Config + PI-shape re-check after deserialization (reference
    `verifier/src/lib.rs:215-246`): the loaded artifact must describe exactly
    the canonical leaf profile — config equality, 21 public inputs, and the
    100-bit security floor — even though the keccak pin already passed."""
    from ..utils.config_policy import wormhole_leaf_circuit_config

    if vdata.config != wormhole_leaf_circuit_config():
        raise VerificationError("loaded verifier data config is not the canonical leaf profile")
    if vdata.num_public_inputs != wi.PUBLIC_INPUTS_FELTS_LEN:
        raise VerificationError(
            f"loaded verifier data exposes {vdata.num_public_inputs} public inputs, "
            f"expected {wi.PUBLIC_INPUTS_FELTS_LEN}"
        )
    if vdata.config.total_security_bits() < wi.MIN_LEAF_SECURITY_BITS:
        raise VerificationError("loaded verifier data below the canonical security floor")


class WormholeVerifier:
    def __init__(self, data, enforce_security_floor: bool = True):
        """`data` is the leaf CircuitData (or a compatible verifier view)."""
        self.data = data
        self._enforce_floor = enforce_security_floor
        self._check_profile()

    def _check_profile(self):
        cfg = self.data.config
        if self._enforce_floor and cfg.total_security_bits() < wi.MIN_LEAF_SECURITY_BITS:
            raise VerificationError(
                f"leaf config security {cfg.total_security_bits()} below floor "
                f"{wi.MIN_LEAF_SECURITY_BITS}"
            )

    @classmethod
    def new_from_bytes(
        cls, verifier_bytes: bytes, common_bytes: bytes,
        enforce_pins: bool = True,
    ) -> "WormholeVerifier":
        """Load from the (verifier.bin, common.bin) artifact pair with the
        reference's pinning ladder (`verifier/src/lib.rs:170-246`): size caps
        → keccak256 pins against the compiled-in canonical digests →
        deserialize (the recomputed circuit digest binds the two views) →
        config/PI-shape re-check. ONLY the canonical pair loads when pins
        are on."""
        from ..plonk.serialization import VerifierCircuitData
        from .artifacts import MAX_VERIFIER_ARTIFACT_BYTES

        for name, blob, pin in (
            ("verifier.bin", verifier_bytes, pins.CANONICAL_LEAF_VERIFIER_KECCAK256),
            ("common.bin", common_bytes, pins.CANONICAL_LEAF_COMMON_KECCAK256),
        ):
            if len(blob) > MAX_VERIFIER_ARTIFACT_BYTES:
                raise VerificationError(f"{name} exceeds the artifact size cap")
            if enforce_pins:
                if pin is None:
                    raise VerificationError("canonical keccak pins are unset in this build")
                if keccak256(blob).hex() != pin:
                    raise VerificationError(f"{name} keccak256 does not match the canonical pin")
        vdata = VerifierCircuitData.from_artifact_bytes(
            verifier_bytes, common_bytes, max_len=MAX_VERIFIER_ARTIFACT_BYTES
        )
        ensure_loaded_matches_canonical_leaf_profile(vdata)
        return cls(vdata)

    @classmethod
    def new_from_files(
        cls, verifier_path, common_path, enforce_pins: bool = True
    ) -> "WormholeVerifier":
        """File-loading variant: size-capped reads BEFORE allocation
        (reference `verifier/src/lib.rs:143-159, 255-268`)."""
        from .artifacts import MAX_VERIFIER_ARTIFACT_BYTES, read_artifact_file

        verifier_bytes = read_artifact_file(verifier_path, MAX_VERIFIER_ARTIFACT_BYTES)
        common_bytes = read_artifact_file(common_path, MAX_VERIFIER_ARTIFACT_BYTES)
        return cls.new_from_bytes(verifier_bytes, common_bytes, enforce_pins=enforce_pins)

    def verify(self, proof) -> wi.PublicCircuitInputs:
        """Verify and return the parsed public inputs."""
        if proof.public_inputs.shape != (wi.PUBLIC_INPUTS_FELTS_LEN,):
            raise VerificationError(
                f"expected {wi.PUBLIC_INPUTS_FELTS_LEN} public inputs, got "
                f"{proof.public_inputs.shape}"
            )
        plonk_verify(self.data, proof)
        return wi.PublicCircuitInputs.from_felts(proof.public_inputs)
