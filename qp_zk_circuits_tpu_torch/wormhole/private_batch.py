"""Private-batch aggregation: recursively verify N leaf proofs + wrapper.

Port of reference `aggregator/src/private_batch/` (circuit_logic.rs 171-479,
prover/lib.rs, witness.rs): the ZK layer of the aggregation tree.

Wrapper constraints (position-independent by design — the prover uniformly
shuffles real and dummy slots):
  * dummy sentinel at this level: leaf block_hash == 0;
  * prefix-scan reference selection (block/fee from the FIRST non-dummy slot);
  * per-slot block/asset/fee consistency x (1 - dummy);
  * exit-account grouping/dedup with dummy slots masked to zero at ingress
    (full group sums, first-occurrence-wins, duplicates zeroed, 32-bit sums);
  * real-nullifier pairwise distinctness (anti replay-inflation);
  * dummy nullifiers replaced by H(H(random preimage)) and the whole region
    emitted canonically SORTED (decorrelates nullifiers from exit slots).

Output PI layout: [2N, asset, fee, block_hash(4), block_number,
(sum, exit(4)) x 2N, nullifier(4) x N, zero padding] — total 21N + 8.

The circuit is built on the host by the port's builder and proven on the
device of its preprocessing oracle (CUDA unless the caller names one) by
`plonk/prover.py::prove`: a ZK proof, host-rng (byte-equal to the JAX
package's for the same commit rng and seed) or device-rng (kernel G).
"""

from __future__ import annotations

import numpy as np

from ..plonk.builder import CircuitBuilder, PartialWitness
from ..plonk.prover import prove as plonk_prove, warmup
from ..plonk.serialization import VerifierCircuitData
from ..recursion.verifier_gadget import (
    add_virtual_proof_with_pis,
    fill_proof_targets,
    verify_proof_circuit,
)
from ..utils import gadgets as gd
from ..utils.config_policy import (
    validate_circuit_config,
    wormhole_private_batch_circuit_config,
)
from . import inputs as wi
from .dummy_proof import generate_random_nullifier_preimage

LEAF_PI_LEN = wi.PUBLIC_INPUTS_FELTS_LEN


def pi_len(n_leaf: int) -> int:
    return LEAF_PI_LEN * n_leaf + 8


def _hash_dummy_nullifier_preimage(b: CircuitBuilder, preimage: list) -> list:
    """H(H(preimage)) — value-indistinguishable from a real nullifier."""
    inner = b.hash_n_to_hash_no_pad(list(preimage))
    return b.hash_n_to_hash_no_pad(inner)


def build_private_batch_constraints(
    b: CircuitBuilder, leaf_pis: list, dummy_preimages: list, n_leaf: int
) -> None:
    """leaf_pis: per proof, the 21 PI targets; dummy_preimages: per proof, 4
    targets of the random dummy-nullifier preimage."""
    zero = b.zero()
    one = b.one()

    def limbs4(i, off):
        return list(leaf_pis[i][off : off + 4])

    def limb1(i, off):
        return leaf_pis[i][off]

    # dummy flags: block_hash == 0
    dummy_sentinel = [zero] * 4
    is_dummy = []
    block_hashes = []
    for i in range(n_leaf):
        bh = limbs4(i, wi.BLOCK_HASH_START_INDEX)
        is_dummy.append(gd.bytes_digest_eq(b, bh, dummy_sentinel))
        block_hashes.append(bh)

    # prefix-scan reference selection from the first non-dummy slot
    found_real = b._false()
    block_ref = [zero] * 4
    block_number_ref = zero
    fee_ref = zero
    for i in range(n_leaf):
        is_real = b.not_(is_dummy[i])
        take = b.and_(is_real, b.not_(found_real))
        for j in range(4):
            block_ref[j] = b.select(take, block_hashes[i][j], block_ref[j])
        block_number_ref = b.select(take, limb1(i, wi.BLOCK_NUMBER_INDEX), block_number_ref)
        fee_ref = b.select(take, limb1(i, wi.VOLUME_FEE_BPS_INDEX), fee_ref)
        found_real = b.or_(found_real, is_real)

    # `asset_id` must match across every slot INCLUDING dummies — the
    # reference binds slot 0's asset unconditionally (circuit_logic.rs:202,
    # :274), keeping the historical rule that dummy padding is only
    # compatible with native-asset (asset_id = 0) batches; the prover
    # preflight enforces that before padding.
    asset_ref = limb1(0, wi.ASSET_ID_INDEX)
    num_exit_slots_t = b.constant(2 * n_leaf)
    output_pis = [num_exit_slots_t, asset_ref, fee_ref]

    # block / asset / fee consistency
    for i in range(n_leaf):
        matches = gd.bytes_digest_eq(b, block_hashes[i], block_ref)
        b.connect(b.or_(is_dummy[i], matches), one)
        b.connect(limb1(i, wi.ASSET_ID_INDEX), asset_ref)
        fee_matches = b.is_equal(limb1(i, wi.VOLUME_FEE_BPS_INDEX), fee_ref)
        b.connect(b.or_(is_dummy[i], fee_matches), one)
    output_pis.extend(block_ref)
    output_pis.append(block_number_ref)

    # exit-account grouping / dedup (dummy slots masked to zero at ingress)
    num_slots = 2 * n_leaf
    slot_exits, slot_amounts = [], []
    for slot in range(num_slots):
        i = slot // 2
        if slot % 2 == 0:
            exit_raw = limbs4(i, wi.EXIT_ACCOUNT_1_START_INDEX)
            amount_raw = limb1(i, wi.OUTPUT_AMOUNT_1_INDEX)
        else:
            exit_raw = limbs4(i, wi.EXIT_ACCOUNT_2_START_INDEX)
            amount_raw = limb1(i, wi.OUTPUT_AMOUNT_2_INDEX)
        slot_exits.append([b.select(is_dummy[i], zero, e) for e in exit_raw])
        slot_amounts.append(b.select(is_dummy[i], zero, amount_raw))

    for slot in range(num_slots):
        exit_slot = slot_exits[slot]
        is_duplicate = b._false()
        for earlier in slot_exits[:slot]:
            is_duplicate = b.or_(is_duplicate, gd.bytes_digest_eq(b, earlier, exit_slot))
        acc = zero
        for exit_j, amount_j in zip(slot_exits, slot_amounts):
            matches = gd.bytes_digest_eq(b, exit_j, exit_slot)
            acc = b.add(acc, b.select(matches, amount_j, zero))
        final_sum = b.select(is_duplicate, zero, acc)
        final_exit = [b.select(is_duplicate, zero, e) for e in exit_slot]
        b.range_check(final_sum, 32)
        output_pis.append(final_sum)
        output_pis.extend(final_exit)

    # real-nullifier pairwise distinctness
    nullifiers = [limbs4(i, wi.NULLIFIER_START_INDEX) for i in range(n_leaf)]
    for i in range(n_leaf):
        is_real_i = b.not_(is_dummy[i])
        for j in range(i + 1, n_leaf):
            both_real = b.and_(is_real_i, b.not_(is_dummy[j]))
            equal = gd.bytes_digest_eq(b, nullifiers[i], nullifiers[j])
            b.assert_zero(b.and_(both_real, equal))

    # nullifier selection + canonical sort
    selected = []
    for i in range(n_leaf):
        dummy_null = _hash_dummy_nullifier_preimage(b, dummy_preimages[i])
        selected.append(
            [b.select(is_dummy[i], dummy_null[j], nullifiers[i][j]) for j in range(4)]
        )
    for digest in gd.sort_digests4(b, selected):
        output_pis.extend(digest)

    expected = pi_len(n_leaf)
    assert len(output_pis) <= expected
    while len(output_pis) < expected:
        output_pis.append(zero)
    b.register_public_inputs(output_pis)


class PrivateBatchCircuit:
    """Verify N leaf proofs recursively + the wrapper constraints."""

    def __init__(
        self,
        leaf_common: VerifierCircuitData,
        n_leaf: int,
        config=None,
        enforce_security_floor: bool = True,
        shape_only: bool = False,
        device=None,
    ):
        config = config or wormhole_private_batch_circuit_config()
        validate_circuit_config(config)
        wi.validate_proof_count(n_leaf, "num_leaf_proofs")
        if leaf_common.num_public_inputs != LEAF_PI_LEN:
            raise ValueError(
                f"leaf proofs must expose {LEAF_PI_LEN} public inputs, got "
                f"{leaf_common.num_public_inputs}"
            )
        if (
            enforce_security_floor
            and leaf_common.config.total_security_bits() < wi.MIN_LEAF_SECURITY_BITS
        ):
            raise ValueError("leaf security below the canonical floor")
        self.n_leaf = n_leaf
        self.leaf_common = leaf_common
        b = CircuitBuilder(config)
        self.proof_targets = [
            add_virtual_proof_with_pis(b, leaf_common) for _ in range(n_leaf)
        ]
        for pt in self.proof_targets:
            verify_proof_circuit(b, pt, leaf_common)
        self.dummy_preimages = [b.add_virtual_hash() for _ in range(n_leaf)]
        build_private_batch_constraints(
            b, [pt.public_inputs for pt in self.proof_targets], self.dummy_preimages, n_leaf
        )
        self.builder = b
        self.data = b.build(shape_only=shape_only, device=device)


class BatchCompatibilityError(ValueError):
    pass


def ensure_leaf_batch_compatible(parsed: list) -> None:
    """Fail-fast admission (reference `private_batch/prover/lib.rs:372-460`):
    real proofs share block/fee, nullifiers distinct, not all dummy."""
    real = [p for p in parsed if not p.is_dummy]
    if not real:
        raise BatchCompatibilityError("batch must contain at least one real proof")
    ref = real[0]
    seen = set()
    for p in real:
        if p.block_hash != ref.block_hash or p.block_number != ref.block_number:
            raise BatchCompatibilityError("all real proofs must share one block")
        if p.volume_fee_bps != ref.volume_fee_bps:
            raise BatchCompatibilityError("all real proofs must share one fee rate")
        if p.asset_id != ref.asset_id:
            raise BatchCompatibilityError("all real proofs must share one asset")
        if bytes(p.nullifier) in seen:
            raise BatchCompatibilityError("duplicate nullifier in batch")
        seen.add(bytes(p.nullifier))


def verify_dummy_leaf_template(leaf_verifier, template_proof) -> None:
    """Strong sentinel: zero block/outputs/asset/exits + cryptographic verify
    (reference `prover/lib.rs:478-531`)."""
    pis = leaf_verifier.verify(template_proof)
    if not pis.is_dummy:
        raise BatchCompatibilityError("dummy template is not a dummy proof")
    if pis.asset_id != 0:
        raise BatchCompatibilityError("dummy template must use asset 0")
    if int.from_bytes(bytes(pis.exit_account_1), "little") != 0 or int.from_bytes(
        bytes(pis.exit_account_2), "little"
    ) != 0:
        raise BatchCompatibilityError("dummy template must have zero exit accounts")


class PrivateBatchProver:
    """commit/prove with fail-fast admission, dummy padding + uniform shuffle."""

    def __init__(
        self,
        circuit: PrivateBatchCircuit,
        leaf_verifier,
        dummy_template,
        warm_start: bool = False,
    ):
        self.circuit = circuit
        self.leaf_verifier = leaf_verifier
        verify_dummy_leaf_template(leaf_verifier, dummy_template)
        self.dummy_template = dummy_template
        self._slots = None
        if warm_start:
            # kernel tables, the witness program and its C tape, one
            # throw-away all-dummy proof, and "auto" -> device rng: the
            # FIRST real aggregate is already steady-state (the reference
            # service likewise builds circuits at startup)
            warmup(circuit.data,
                   _dummy_witness(circuit, dummy_template, np.random.default_rng(0)))

    @classmethod
    def new_from_binaries_dir(
        cls,
        bins_dir,
        config=None,
        leaf_rebuild=None,
        enforce_security_floor: bool = True,
        device=None,
    ) -> "PrivateBatchProver":
        """Artifact-loading constructor (reference `prover/lib.rs:213`):
        config.json gives the (L) shape, the leaf verifier data is pinned
        raw-byte against a from-source rebuild, the aggregation circuit is
        rebuilt from source and pinned against private_batch_verifier.bin,
        and the dummy leaf template is sentinel- + crypto-verified."""
        from pathlib import Path

        from ..plonk.serialization import proof_from_bytes
        from . import artifacts as art
        from .verifier import WormholeVerifier

        bins_dir = Path(bins_dir)
        cfg = art.CircuitBinsConfig.load(bins_dir / art.CONFIG_JSON)
        leaf_vdata = art.load_canonical_leaf_verifier_data(
            bins_dir, rebuild=leaf_rebuild, device=device)
        dummy = proof_from_bytes(
            art.read_artifact_file(
                bins_dir / art.DUMMY_PROOF_BIN, art.MAX_AGG_ARTIFACT_BYTES
            )
        )
        circuit = PrivateBatchCircuit(
            leaf_vdata,
            cfg.num_leaf_proofs,
            config=config,
            enforce_security_floor=enforce_security_floor,
            device=device,
        )
        art.load_canonical_private_batch_verifier_data(
            bins_dir, rebuild=VerifierCircuitData.from_circuit_data(circuit.data)
        )
        leaf_verifier = WormholeVerifier(
            leaf_vdata, enforce_security_floor=enforce_security_floor
        )
        return cls(circuit, leaf_verifier, dummy)

    def commit(self, proofs: list, rng: np.random.Generator | None = None):
        n = self.circuit.n_leaf
        if not 1 <= len(proofs) <= n:
            raise BatchCompatibilityError(f"batch size must be in 1..={n}")
        rng = rng or np.random.default_rng()
        parsed = []
        for p in proofs:
            # per-leaf PI shape + cryptographic verification at admission
            parsed.append(self.leaf_verifier.verify(p))
        ensure_leaf_batch_compatible(parsed)
        if len(proofs) < n and any(p.asset_id != 0 for p in parsed):
            raise BatchCompatibilityError(
                "padding with dummies requires native asset (asset_id = 0)"
            )
        slots = list(proofs) + [self.dummy_template] * (n - len(proofs))
        rng.shuffle(slots)  # uniform shuffle: real/dummy positions indistinguishable
        self._slots = slots
        self._rng = rng
        return self

    def prove(self, seed: int | None = None, rng_mode: str = "auto", mesh=None):
        """Prove the committed slots; the dummy preimages are drawn from the
        commit's rng after its shuffle. `rng_mode` and `mesh` as in
        `plonk/prover.py::prove`."""
        assert self._slots is not None, "commit() before prove()"
        pw = _batch_witness(self.circuit, self._slots, self._rng)
        proof = plonk_prove(self.circuit.data, pw, seed=seed, rng_mode=rng_mode, mesh=mesh)
        self._slots = None
        return proof

    def aggregate(self, proofs: list, seed: int | None = None, rng=None,
                  rng_mode: str = "auto", mesh=None):
        return self.commit(proofs, rng=rng).prove(seed=seed, rng_mode=rng_mode, mesh=mesh)


def _batch_witness(circuit: PrivateBatchCircuit, slots: list, rng) -> PartialWitness:
    """The batch's witness seeds: each slot's proof targets, then a dummy
    nullifier preimage a slot drawn from `rng`."""
    pw = PartialWitness()
    for pt, proof in zip(circuit.proof_targets, slots):
        fill_proof_targets(pw, pt, proof)
    for pre_t in circuit.dummy_preimages:
        pre = generate_random_nullifier_preimage(rng)
        pw.set_many(pre_t, np.frombuffer(pre, dtype="<u8").astype(np.uint64))
    return pw


def _dummy_witness(circuit: PrivateBatchCircuit, dummy_leaf_template, rng) -> PartialWitness:
    return _batch_witness(circuit, [dummy_leaf_template] * circuit.n_leaf, rng)


def generate_dummy_private_batch_proof(
    circuit: PrivateBatchCircuit, dummy_leaf_template, rng=None, seed: int | None = None
):
    """Trusted-builder path: prove the ALL-DUMMY private batch (the padding
    template for the public layer — reference `private_batch/circuit/build.rs`:
    proves all-dummy batch -> dummy_private_batch_proof.bin). Bypasses the
    not-all-dummy admission rule deliberately."""
    rng = rng or np.random.default_rng(seed)
    pw = _dummy_witness(circuit, dummy_leaf_template, rng)
    return plonk_prove(circuit.data, pw, seed=seed)
