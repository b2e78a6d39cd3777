"""Keccak256 pins of the canonical leaf verifier artifacts.

The reference hard-codes keccak256 digests of the canonical verifier.bin /
common.bin as compile-time constants and refuses to load any artifact whose
bytes do not match (`wormhole/verifier/src/lib.rs:101-112`). These are the
JAX package's two digests, copied: the port's artifacts are byte-identical
to the JAX package's (`plonk/serialization.py`), so one pin holds both, and
a port that computes the constants cap on the card (kernel 3's LDE, kernel
2's tree) is held to it. Changing either is a consensus-critical change,
made in both packages together.

Serialization is deterministic (little-endian u64 arrays, no maps), so the
digests are stable across hosts.
"""

# keccak256(verifier.bin) for the canonical leaf profile
# (wormhole_leaf_circuit_config: 135 wires, 80 routed, 28 queries, 16 PoW).
# verifier.bin is the VerifierOnly view (constants cap + circuit digest).
CANONICAL_LEAF_VERIFIER_KECCAK256: str | None = (
    "bdc1178a27ac011b4803650badb24029e065b9ae5e6a0bd8422272dd734e20ca"
)

# keccak256(common.bin): the Common view (config + degree + gate set +
# column layout + PI count) — a distinct artifact, as in the reference
# (`wormhole/verifier/src/lib.rs:199-204`).
CANONICAL_LEAF_COMMON_KECCAK256: str | None = (
    "e466c584896dd26bdee74ee8a3152ccfd1b0130be6f8a91862d7bf75aa8d1b01"
)
