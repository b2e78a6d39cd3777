"""Flagship pipelines (the package's "models"): the provers.

The framework's deployable units are proving pipelines rather than neural
networks; this package re-exports them under one roof:

  * `WormholeProver` / `WormholeVerifier` — the leaf proof pipeline;
  * `PrivateBatchCircuit` / `PrivateBatchProver` — the ZK aggregation layer;
  * `PublicBatchCircuit` / `PublicBatchProver` — the public aggregation layer.

The JAX package's `batch_commit_step` (its sharded multi-chip commitment
core) comes with the port's multi-GPU layer.
"""

from ..wormhole.private_batch import PrivateBatchCircuit, PrivateBatchProver  # noqa: F401
from ..wormhole.prover import WormholeProver  # noqa: F401
from ..wormhole.public_batch import PublicBatchCircuit, PublicBatchProver  # noqa: F401
from ..wormhole.verifier import WormholeVerifier  # noqa: F401
