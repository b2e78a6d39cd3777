"""The miner's public-batch aggregation service.

The port of the JAX package's `wormhole/aggregator_service.py` (itself the
reference `aggregator/src/aggregator.rs`): pins all artifacts at
construction (never re-reads the bins dir), wraps the proof pool, and hands
proving workers an OWNED `ProvingContext` clone so proving runs lock-free
(short-lock snapshot / no-lock prove — `aggregator.rs:23-63`). Verification
of produced public-batch proofs binds the configured aggregator address
(`aggregator.rs:224-254`). The public batch is proven on the device of its
circuit's preprocessing oracle (`plonk/prover.py::prove`).

What the JAX package's `plonk/aot_cache.py` keeps between runs (compiled
XLA executables) has no counterpart here: the port's compiled state is the
kernel library that `_cuda.py` builds by nvcc into `_build/`, keyed by its
sources' hash, the host library of `native/`, built alike, and the tables
and witness tape that `plonk/prover.py::warmup` builds in memory. The first
two are reused by every later process of the checkout; the last is what
`warm_start=True` builds at construction. Nothing is read from, or written
into, the bins directory but its pinned artifacts, so an `aot/`
subdirectory shipped inside one stays inert.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import inputs as wi
from .pool import BatchKey, PoolLimits, ProofPool
from .public_batch import (
    BatchCompatibilityError,
    PublicBatchCircuit,
    PublicBatchProver,
)


@dataclass
class ProvingContext:
    """Owned, lock-free proving state for a worker thread."""

    prover: PublicBatchProver
    aggregator_address: wi.BytesDigest

    def prove_batch(self, proofs: list, seed: int | None = None):
        return self.prover.commit(proofs, self.aggregator_address).prove(seed=seed)


class PublicBatchAggregator:
    def __init__(
        self,
        public_circuit: PublicBatchCircuit,
        inner_verify_fn,
        outer_verify_fn,
        dummy_private_batch_template,
        aggregator_address: wi.BytesDigest,
        limits: PoolLimits | None = None,
        warm_start: bool = False,
    ):
        """All verification/proving material pinned here, once; the pool and
        workers never re-read artifact sources. `warm_start=True` warms the
        public batch circuit at construction (`PublicBatchProver`'s warm
        start: the kernel tables, the witness program and its C tape, and one
        throw-away proof of the all-dummy batch), so every prove_batch is
        warm steady-state."""
        self.circuit = public_circuit
        self.inner_verify = inner_verify_fn
        self.outer_verify = outer_verify_fn
        self.aggregator_address = aggregator_address
        self.dummy_template = dummy_private_batch_template
        self.pool = ProofPool(
            verifier_fn=inner_verify_fn,
            n_leaf=public_circuit.n_leaf,
            batch_size=public_circuit.m,
            limits=limits,
        )
        if warm_start:
            PublicBatchProver(public_circuit, inner_verify_fn, dummy_private_batch_template,
                              warm_start=True)

    @classmethod
    def with_limits(cls, *args, limits: PoolLimits, **kwargs):
        return cls(*args, limits=limits, **kwargs)

    @classmethod
    def from_binaries_dir(
        cls,
        bins_dir,
        aggregator_address: wi.BytesDigest,
        limits: PoolLimits | None = None,
        config=None,
        private_batch_rebuild=None,
        leaf_rebuild=None,
        enforce_security_floor: bool = True,
        warm_start: bool = False,
        device=None,
    ) -> "PublicBatchAggregator":
        """Construct the miner service from a published artifact set
        (reference `aggregator.rs:262-316`): every artifact is read + pinned
        HERE, once — the pool and proving workers never re-read bins_dir, so
        post-construction mutation of the directory cannot affect behavior.
        The circuits are rebuilt from source on `device` (CUDA unless named)
        where no rebuild is given; `warm_start=True` warms the public batch
        circuit at construction. Nothing else in bins_dir is read: an `aot/`
        subdirectory shipped inside one stays inert."""
        from functools import partial
        from pathlib import Path

        from ..plonk.serialization import VerifierCircuitData
        from ..plonk.verifier import verify as plonk_verify
        from . import artifacts as art
        from .public_batch import PublicBatchCircuit, verify_dummy_private_batch_template

        cfg = art.CircuitBinsConfig.load(Path(bins_dir) / art.CONFIG_JSON)
        pb_vdata = art.load_canonical_private_batch_verifier_data(
            bins_dir,
            rebuild=private_batch_rebuild,
            leaf_rebuild=leaf_rebuild,
            enforce_security_floor=enforce_security_floor,
            device=device,
        )
        dummy = art.load_dummy_private_batch_proof(bins_dir)
        inner_verify = partial(plonk_verify, pb_vdata)
        circuit = PublicBatchCircuit(
            pb_vdata, cfg.num_private_batch_proofs, cfg.num_leaf_proofs, config=config,
            device=device,
        )
        outer_vdata = art.load_canonical_public_batch_verifier_data(
            bins_dir, rebuild=VerifierCircuitData.from_circuit_data(circuit.data)
        )
        outer_verify = partial(plonk_verify, outer_vdata)
        verify_dummy_private_batch_template(inner_verify, dummy, cfg.num_leaf_proofs)
        return cls(
            circuit,
            inner_verify,
            outer_verify,
            dummy,
            aggregator_address,
            limits=limits,
            warm_start=warm_start,
        )

    # -- pool facade ---------------------------------------------------------
    def push_proof(self, proof) -> BatchKey:
        return self.pool.push(proof)

    def snapshot_batch(self, key: BatchKey) -> list:
        return self.pool.snapshot_batch(key)

    def evict_settled(self, nullifiers) -> int:
        return self.pool.evict_settled(nullifiers)

    def evict_older_than(self, max_age_secs: float) -> int:
        return self.pool.evict_older_than(max_age_secs)

    def bucket_stats(self):
        return self.pool.bucket_stats()

    # -- proving -------------------------------------------------------------
    def proving_context(self) -> ProvingContext:
        """Owned clone for a lock-free proving worker."""
        prover = PublicBatchProver(self.circuit, self.inner_verify, self.dummy_template)
        return ProvingContext(prover=prover, aggregator_address=self.aggregator_address)

    def aggregate(self, key: BatchKey, seed: int | None = None):
        """Short-lock snapshot, then prove without holding any pool lock."""
        proofs = self.snapshot_batch(key)
        if not proofs:
            raise BatchCompatibilityError("no proofs pooled under this batch key")
        ctx = self.proving_context()
        return ctx.prove_batch(proofs, seed=seed)

    def verify(self, proof) -> wi.PublicBatchPublicInputs:
        """Verify a produced public-batch proof AND bind its aggregator
        address to the configured one."""
        self.outer_verify(proof)
        parsed = wi.PublicBatchPublicInputs.from_felts(
            proof.public_inputs, self.circuit.m, self.circuit.n_leaf
        )
        if parsed.aggregator_address != self.aggregator_address:
            raise BatchCompatibilityError(
                "proof is bound to a different aggregator address"
            )
        return parsed
