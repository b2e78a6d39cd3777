"""Fake leaf circuit: same 21-felt PI layout, none of the real constraints.

Port of reference `tests/test-helpers/src/fake_leaf.rs:20-57`: lets every
aggregation-layer test run without the slow real leaf prover, and doubles as
the MALICIOUS circuit in VK-substitution tests (a fake-leaf proof must be
rejected by provers/pools pinned to the canonical leaf VK). Explicitly NOT a
verification target (reference `formal/SPEC.md:240-241`)."""

from __future__ import annotations

import numpy as np

from ..plonk.builder import CircuitBuilder, PartialWitness
from ..plonk.prover import prove as plonk_prove
from ..utils.config_policy import wormhole_leaf_circuit_config
from . import inputs as wi


class FakeLeafCircuit:
    """21 public inputs, a few 32-bit range checks, nothing else."""

    def __init__(self, config=None, device=None):
        """Build it and commit its preprocessing oracle on `device` (CUDA
        unless the caller names one)."""
        config = config or wormhole_leaf_circuit_config()
        b = CircuitBuilder(config)
        self.pi_targets = b.add_virtual_targets(wi.PUBLIC_INPUTS_FELTS_LEN)
        b.register_public_inputs(self.pi_targets)
        # token constraints so the circuit is nonempty (like the reference's)
        for idx in [wi.ASSET_ID_INDEX, wi.OUTPUT_AMOUNT_1_INDEX, wi.OUTPUT_AMOUNT_2_INDEX]:
            b.range_check(self.pi_targets[idx], 32)
        self.builder = b
        self.data = b.build(device=device)

    def prove_pis(self, pis, seed: int | None = None):
        """Prove ARBITRARY public inputs (no real constraints!)."""
        pis = np.asarray(pis, dtype=np.uint64)
        assert pis.shape == (wi.PUBLIC_INPUTS_FELTS_LEN,)
        pw = PartialWitness()
        pw.set_many(self.pi_targets, pis)
        return plonk_prove(self.data, pw, seed=seed)
