"""Leaf prover: WormholeProver{new, commit, prove} (reference
`wormhole/prover/src/lib.rs`).

Always rebuilds the circuit from source — prover data is never deserialized
from disk (poisoned-artifact exfiltration rationale, reference
`prover/src/lib.rs:12-17`). `prove_inputs_batch` proves many leaves
together and `prove_inputs_stream` pipelines chunks of them
(plonk/prover.py::prove_batch, prove_stream)."""

from __future__ import annotations

from ..plonk import prover as plonk_prover
from ..plonk.builder import PartialWitness
from .circuit_inputs import CircuitInputs, MAX_DEPTH
from .leaf_circuit import WormholeCircuit, fill_witness


def build_fresh(config=None, device=None) -> "WormholeProver":
    return WormholeProver(config, device)


class WormholeProver:
    def __init__(self, config=None, device=None):
        """Build the leaf circuit and commit its preprocessing oracle on
        `device`: CUDA unless the caller names one (no quiet CPU fallback)."""
        circuit = WormholeCircuit(config)
        self.targets = circuit.targets
        self.data = circuit.build(device=device)
        self._pw: PartialWitness | None = None

    def _partial_witness(self, inputs: CircuitInputs) -> PartialWitness:
        """The leaf's witness seeds (fail-fast: depth preflight, digest
        validation)."""
        if len(inputs.private.siblings) > MAX_DEPTH:
            raise ValueError("proof depth exceeds MAX_DEPTH")
        pw = PartialWitness()
        fill_witness(pw, inputs, self.targets)
        return pw

    def commit(self, inputs: CircuitInputs) -> "WormholeProver":
        """Fill the witness (fail-fast: depth preflight, digest validation)."""
        self._pw = self._partial_witness(inputs)
        return self

    def prove(self, seed: int | None = None, mesh=None):
        """Prove the committed witness; with a `mesh` (parallel/mesh.py) the
        oracle commits run tensor-parallel over it, the same bytes."""
        assert self._pw is not None, "commit() must be called before prove()"
        proof = plonk_prover.prove(self.data, self._pw, seed=seed, mesh=mesh)
        self._pw = None
        return proof

    def prove_inputs(self, inputs: CircuitInputs, seed: int | None = None, mesh=None):
        return self.commit(inputs).prove(seed=seed, mesh=mesh)

    def prove_inputs_batch(self, inputs_list, seed: int | None = None) -> list:
        """Prove many leaves together (plonk/prover.py::prove_batch: the
        fused batch, one upload and one download, unless
        QZKT_STAGED_PROVER is set): each stage runs once for the batch,
        with its kernels' proof axis. Each proof equals `prove_inputs` of
        the same inputs; input order."""
        pws = [self._partial_witness(inputs) for inputs in inputs_list]
        return plonk_prover.prove_batch(self.data, pws, seed=seed)

    def prove_inputs_stream(self, inputs_list, batch: int = 16, seed: int | None = None):
        """Sustained proving (the deployment shape for miner-side leaf
        proving): `batch`-sized chunks, chunk i+1's witness fills and tapes
        running on the host while chunk i is proven (plonk/prover.py::
        prove_stream: the fused stream, as the JAX package's always is,
        unless QZKT_STAGED_PROVER is set). `inputs_list` is a list or any
        iterable of inputs; its length must tile `batch`."""
        total = len(inputs_list) if hasattr(inputs_list, "__len__") else None
        pws = (self._partial_witness(inputs) for inputs in inputs_list)
        return plonk_prover.prove_stream(self.data, pws, batch, seed=seed, total=total)
