"""Flagship pipelines (the package's "models"): the provers.

The framework's deployable units are proving pipelines rather than neural
networks; this package re-exports them under one roof:

  * `WormholeProver` / `WormholeVerifier` — the leaf proof pipeline;
  * `PrivateBatchCircuit` / `PrivateBatchProver` — the ZK aggregation layer;
  * `PublicBatchCircuit` / `PublicBatchProver` — the public aggregation layer;
  * `batch_commit_step` — the sharded multi-device commitment core, with
    `make_prover_mesh` and `sharded_batch_commit` (parallel/mesh.py).
"""

from ..parallel.mesh import batch_commit_step, make_prover_mesh, sharded_batch_commit  # noqa: F401
from ..wormhole.private_batch import PrivateBatchCircuit, PrivateBatchProver  # noqa: F401
from ..wormhole.prover import WormholeProver  # noqa: F401
from ..wormhole.public_batch import PublicBatchCircuit, PublicBatchProver  # noqa: F401
from ..wormhole.verifier import WormholeVerifier  # noqa: F401
