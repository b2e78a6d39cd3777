"""Public-batch aggregation: verify M private-batch proofs + forwarding.

Port of reference `aggregator/src/public_batch/` (circuit_logic.rs 167-317,
prover/lib.rs): the non-ZK outer layer. Unlike the private batch there is NO
shuffle and NO grouping — exit slots and nullifiers are forwarded in order
(per-segment on-chain attribution), with dummy inner batches' slots zeroed.
The witnessed aggregator address (4 felts) is prepended to the output.

Output layout (reference `public_batch/circuit/constants.rs:59-121`):
  [addr(4), asset, fee, block_hash(4), block_number, total_slots,
   (sum, exit(4)) x (M * 2L), nullifier(4) x (M * L)]

Built on the host by the port's builder, proven (non-ZK) on the device of
its preprocessing oracle by `plonk/prover.py::prove`.
"""

from __future__ import annotations

import numpy as np

from ..plonk.builder import CircuitBuilder, PartialWitness
from ..plonk.prover import prove as plonk_prove, warmup
from ..plonk.serialization import VerifierCircuitData
from ..plonk.verifier import verify as plonk_verify
from ..recursion.verifier_gadget import (
    add_virtual_proof_with_pis,
    fill_proof_targets,
    verify_proof_circuit,
)
from ..utils import gadgets as gd
from ..utils.config_policy import (
    validate_circuit_config,
    wormhole_public_batch_circuit_config,
)
from . import inputs as wi
from .private_batch import BatchCompatibilityError, pi_len as private_pi_len

# private-batch PI header offsets
PB_NUM_SLOTS = 0
PB_ASSET = 1
PB_FEE = 2
PB_BLOCK_HASH = 3
PB_BLOCK_NUMBER = 7
PB_SLOTS_START = 8


def build_public_batch_constraints(
    b: CircuitBuilder, inner_pis: list, addr_targets: list, m: int, n_leaf: int
) -> None:
    zero = b.zero()
    one = b.one()
    slots_per_inner = 2 * n_leaf

    def limbs4(i, off):
        return list(inner_pis[i][off : off + 4])

    # dummy flags: inner block_hash == 0
    sentinel = [zero] * 4
    is_dummy = []
    block_hashes = []
    for i in range(m):
        bh = limbs4(i, PB_BLOCK_HASH)
        is_dummy.append(gd.bytes_digest_eq(b, bh, sentinel))
        block_hashes.append(bh)

    # prefix-scan references
    found_real = b._false()
    block_ref = [zero] * 4
    bn_ref = zero
    fee_ref = zero
    for i in range(m):
        is_real = b.not_(is_dummy[i])
        take = b.and_(is_real, b.not_(found_real))
        for j in range(4):
            block_ref[j] = b.select(take, block_hashes[i][j], block_ref[j])
        bn_ref = b.select(take, inner_pis[i][PB_BLOCK_NUMBER], bn_ref)
        fee_ref = b.select(take, inner_pis[i][PB_FEE], fee_ref)
        found_real = b.or_(found_real, is_real)

    asset_ref = inner_pis[0][PB_ASSET]
    for i in range(m):
        matches = gd.bytes_digest_eq(b, block_hashes[i], block_ref)
        b.connect(b.or_(is_dummy[i], matches), one)
        b.connect(inner_pis[i][PB_ASSET], asset_ref)
        fee_ok = b.is_equal(inner_pis[i][PB_FEE], fee_ref)
        b.connect(b.or_(is_dummy[i], fee_ok), one)
        # structural: every inner batch carries 2L slots
        b.connect(inner_pis[i][PB_NUM_SLOTS], b.constant(slots_per_inner))

    output = list(addr_targets)
    output.append(asset_ref)
    output.append(fee_ref)
    output.extend(block_ref)
    output.append(bn_ref)
    output.append(b.constant(m * slots_per_inner))

    # order-preserving forwarding of exit slots (dummy inners zeroed)
    for i in range(m):
        base = PB_SLOTS_START
        for s in range(slots_per_inner):
            off = base + 5 * s
            amount = b.select(is_dummy[i], zero, inner_pis[i][off])
            exit_acc = [
                b.select(is_dummy[i], zero, inner_pis[i][off + 1 + j]) for j in range(4)
            ]
            output.append(amount)
            output.extend(exit_acc)
    # order-preserving forwarding of nullifiers (dummy inners zeroed)
    for i in range(m):
        base = PB_SLOTS_START + 5 * slots_per_inner
        for k in range(n_leaf):
            off = base + 4 * k
            output.extend(
                b.select(is_dummy[i], zero, inner_pis[i][off + j]) for j in range(4)
            )
    assert len(output) == wi.public_batch_pi.pi_len(m, n_leaf)
    b.register_public_inputs(output)


class PublicBatchCircuit:
    def __init__(
        self, private_common: VerifierCircuitData, m: int, n_leaf: int, config=None,
        device=None,
    ):
        config = config or wormhole_public_batch_circuit_config()
        validate_circuit_config(config)
        wi.validate_proof_count(m, "num_private_batch_proofs")
        wi.validate_proof_count(n_leaf, "num_leaf_proofs")
        if private_common.num_public_inputs != private_pi_len(n_leaf):
            raise ValueError("inner proofs do not carry the private-batch PI layout")
        self.m = m
        self.n_leaf = n_leaf
        b = CircuitBuilder(config)
        self.proof_targets = [
            add_virtual_proof_with_pis(b, private_common) for _ in range(m)
        ]
        for pt in self.proof_targets:
            verify_proof_circuit(b, pt, private_common)
        self.aggregator_address = b.add_virtual_hash()
        build_public_batch_constraints(
            b,
            [pt.public_inputs for pt in self.proof_targets],
            self.aggregator_address,
            m,
            n_leaf,
        )
        self.data = b.build(device=device)


def parse_private_batch_pis(proof) -> wi.PrivateBatchPublicInputs:
    return wi.PrivateBatchPublicInputs.from_felts(proof.public_inputs)


def ensure_private_batch_compatible(parsed: list) -> None:
    """reference `public_batch/prover/lib.rs:368-444`."""
    real = [p for p in parsed if int.from_bytes(bytes(p.block_data.block_hash), "little") != 0]
    if not real:
        raise BatchCompatibilityError("public batch must contain at least one real inner batch")
    ref = real[0]
    for p in real:
        if p.block_data != ref.block_data:
            raise BatchCompatibilityError("all real inner batches must share one block")
        if p.volume_fee_bps != ref.volume_fee_bps:
            raise BatchCompatibilityError("all real inner batches must share one fee")
        if p.asset_id != ref.asset_id:
            raise BatchCompatibilityError("all real inner batches must share one asset")


def verify_dummy_private_batch_template(verifier_fn, template, n_leaf: int) -> None:
    """Sentinel + crypto verify for the padding template
    (reference `public_batch/prover/lib.rs:455-509`)."""
    verifier_fn(template)
    parsed = parse_private_batch_pis(template)
    if int.from_bytes(bytes(parsed.block_data.block_hash), "little") != 0:
        raise BatchCompatibilityError("dummy private-batch template has nonzero block hash")
    if any(a.summed_output_amount != 0 for a in parsed.account_data):
        raise BatchCompatibilityError("dummy private-batch template has nonzero amounts")


class PublicBatchProver:
    """Preflight -> pad with the dummy template (NO shuffle) -> prove."""

    def __init__(
        self,
        circuit: PublicBatchCircuit,
        inner_verify_fn,
        dummy_template,
        warm_start: bool = False,
    ):
        self.circuit = circuit
        self.inner_verify = inner_verify_fn
        verify_dummy_private_batch_template(inner_verify_fn, dummy_template, circuit.n_leaf)
        self.dummy_template = dummy_template
        self._slots = None
        self._address = None
        if warm_start:
            # kernel tables, the witness program and its C tape, and one
            # throw-away proof of the all-dummy batch
            warmup(circuit.data, self._witness([dummy_template] * circuit.m,
                                               wi.BytesDigest.zero()))

    @classmethod
    def new_from_binaries_dir(
        cls,
        bins_dir,
        config=None,
        private_batch_rebuild=None,
        leaf_rebuild=None,
        enforce_security_floor: bool = True,
        device=None,
    ) -> "PublicBatchProver":
        """Artifact-loading constructor (reference `public_batch/prover/lib.rs`):
        the private-batch verifier data is pinned (rebuild chain from source),
        the public-batch circuit is rebuilt + pinned against
        public_batch_verifier.bin, and the dummy private-batch template is
        sentinel- + crypto-verified before any batch is accepted."""
        from pathlib import Path

        from . import artifacts as art

        bins_dir = Path(bins_dir)
        cfg = art.CircuitBinsConfig.load(bins_dir / art.CONFIG_JSON)
        pb_vdata = art.load_canonical_private_batch_verifier_data(
            bins_dir,
            rebuild=private_batch_rebuild,
            leaf_rebuild=leaf_rebuild,
            enforce_security_floor=enforce_security_floor,
            device=device,
        )
        dummy = art.load_dummy_private_batch_proof(bins_dir)

        def inner_verify(proof):
            plonk_verify(pb_vdata, proof)  # includes the full shape preflight

        circuit = PublicBatchCircuit(
            pb_vdata, cfg.num_private_batch_proofs, cfg.num_leaf_proofs, config=config,
            device=device,
        )
        art.load_canonical_public_batch_verifier_data(
            bins_dir,
            rebuild=VerifierCircuitData.from_circuit_data(circuit.data),
        )
        return cls(circuit, inner_verify, dummy)

    def preflight(self, proofs: list) -> list:
        if not 1 <= len(proofs) <= self.circuit.m:
            raise BatchCompatibilityError(f"batch size must be in 1..={self.circuit.m}")
        parsed = []
        for p in proofs:
            self.inner_verify(p)  # cryptographic verify BEFORE circuit work
            parsed.append(parse_private_batch_pis(p))
        ensure_private_batch_compatible(parsed)
        return parsed

    def commit(self, proofs: list, aggregator_address: wi.BytesDigest):
        self.preflight(proofs)
        self._slots = list(proofs) + [self.dummy_template] * (self.circuit.m - len(proofs))
        self._address = aggregator_address
        return self

    def _witness(self, slots: list, address) -> PartialWitness:
        pw = PartialWitness()
        for pt, proof in zip(self.circuit.proof_targets, slots):
            fill_proof_targets(pw, pt, proof)
        pw.set_many(
            self.circuit.aggregator_address,
            np.frombuffer(bytes(address), dtype="<u8").astype(np.uint64),
        )
        return pw

    def prove(self, seed: int | None = None):
        assert self._slots is not None
        proof = plonk_prove(self.circuit.data, self._witness(self._slots, self._address),
                            seed=seed)
        self._slots = None
        return proof
