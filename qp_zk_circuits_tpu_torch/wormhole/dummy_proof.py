"""Dummy-proof factory: sentinel padding proofs for aggregation batches.

Port of reference `aggregator/src/dummy_proof.rs`: a dummy proof has
block_hash = 0 AND outputs = 0 (the in-circuit sentinel that disables the
nullifier/header/root bindings), zero exit accounts, zero nullifier PI, and a
structurally valid witness. Dummy nullifiers are later replaced in the
private-batch circuit with H(H(random preimage)) so padding cannot be
deduplicated (`dummy_proof.rs:178-187`)."""

from __future__ import annotations

import numpy as np

from ..utils import serialization as sz
from . import inputs as wi
from .circuit_inputs import CircuitInputs, PrivateCircuitInputs
from .sensitive import Secret
from .circuit_inputs import unspendable_account_from_secret

DUMMY_BLOCK_HASH = b"\x00" * 32
DUMMY_EXIT_ACCOUNT = b"\x00" * 32

_DEFAULT_SECRET = "4c8587bd422e01d961acdc75e7d66f6761b7af7c9b1864a492f369c9d6724f05"
_DEFAULT_TRANSFER_COUNT = 4
_DEFAULT_INPUT_AMOUNT = 100
_DEFAULT_OUTPUT_AMOUNT = 0
_DEFAULT_VOLUME_FEE_BPS = 10
_DEFAULT_ROOT_HASH = "ae6e4ff0dca1ef5ede9dccc84365cecfab4e431c6f3086216bc3b819cdf0a893"
_DEFAULT_DIGEST = bytes(
    [8, 6, 112, 111, 119, 95, 128, 233, 182, 183, 107, 158, 1, 115, 19, 219, 126, 253]
) + bytes(92)


def build_dummy_circuit_inputs() -> CircuitInputs:
    """Fixed witness set for a dummy leaf (validation bypassed by sentinel)."""
    secret = Secret.from_hex(_DEFAULT_SECRET)
    account = sz.digest_to_bytes(unspendable_account_from_secret(secret))
    public = wi.PublicCircuitInputs(
        asset_id=0,
        output_amount_1=_DEFAULT_OUTPUT_AMOUNT,
        output_amount_2=0,
        volume_fee_bps=_DEFAULT_VOLUME_FEE_BPS,
        nullifier=wi.BytesDigest.zero(),
        exit_account_1=wi.BytesDigest(DUMMY_EXIT_ACCOUNT),
        exit_account_2=wi.BytesDigest.zero(),
        block_hash=wi.BytesDigest(DUMMY_BLOCK_HASH),
        block_number=0,
    )
    state_root = bytes.fromhex(_DEFAULT_ROOT_HASH)
    private = PrivateCircuitInputs(
        secret=secret,
        transfer_count=_DEFAULT_TRANSFER_COUNT,
        unspendable_account=account,
        parent_hash=b"\x00" * 32,
        state_root=state_root,
        extrinsics_root=b"\x00" * 32,
        digest=_DEFAULT_DIGEST,
        input_amount=_DEFAULT_INPUT_AMOUNT,
        zk_tree_root=b"\x00" * 32,
        siblings=[],
        positions=[],
    )
    return CircuitInputs(public=public, private=private)


def generate_dummy_proof(prover, seed: int | None = None):
    """Prove the dummy witness with the supplied leaf prover."""
    return prover.prove_inputs(build_dummy_circuit_inputs(), seed=seed)


def generate_random_nullifier_preimage(rng: np.random.Generator) -> bytes:
    """Rejection-sample a canonical 32-byte digest (all limbs < p)."""
    while True:
        cand = rng.bytes(32)
        try:
            return bytes(wi.BytesDigest(cand))
        except wi.InputsError:
            continue


def is_dummy_proof_pis(pis: np.ndarray) -> bool:
    parsed = wi.PublicCircuitInputs.from_felts(pis)
    return parsed.is_dummy
