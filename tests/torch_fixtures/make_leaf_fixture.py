"""Write the reference proofs that the PyTorch port's tests compare against.

Run from the repository root (CPU is enough; the staged prover avoids the
long single-graph compile, and for non-ZK circuits it is pinned
byte-identical to the fused prover in tests/test_plonk.py):

    QZKT_STAGED_PROVER=1 JAX_PLATFORMS=cpu python tests/torch_fixtures/make_leaf_fixture.py

Outputs, next to this file:
  * leaf_proof_inputs0.bin — proof_to_bytes of
    WormholeProver().prove_inputs(test_inputs_0(), seed=0);
  * leaf_proof_real0.bin, leaf_proof_real1.bin — the same for each leaf of
    two_real_leaves_same_block() (the batch and stream tests' leaves);
  * small_circuit_proof.bin — proof_to_bytes of prove_staged on the small
    real circuit below (witness x=11, y=13, seed=0);
  * fixtures.json — length and SHA-256 of every file, and each circuit's
    constants cap and circuit digest.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SMALL_WITNESS = (11, 13)
#: the proofs of two_real_leaves_same_block()'s two leaves, in order
REAL_LEAF_FIXTURES = ("leaf_proof_real0.bin", "leaf_proof_real1.bin")


def small_real_circuit(pkg: str):
    """The small but real circuit of `__graft_entry__._small_real_circuit`
    (arithmetic, range check, copy constraints, in-circuit hash, public
    inputs), built with package `pkg`'s builder. Returns (builder, x, y)
    unbuilt, so each package builds it its own way."""
    fri = importlib.import_module(f"{pkg}.fri.config")
    plonk_builder = importlib.import_module(f"{pkg}.plonk.builder")
    plonk_config = importlib.import_module(f"{pkg}.plonk.config")
    cfg = plonk_config.CircuitConfig(
        fri_config=fri.FriConfig(
            rate_bits=3,
            cap_height=4,
            proof_of_work_bits=1,
            num_query_rounds=2,
            reduction_strategy=fri.FriReductionStrategy(4, 5),
        ),
    )
    b = plonk_builder.CircuitBuilder(cfg)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    s = b.add(b.mul(x, y), b.mul_const(3, x))
    b.range_check(s, 32)
    h = b.hash_n_to_hash_no_pad([x, y, s])
    b.register_public_inputs([s] + list(h))
    return b, x, y


def _entry(blob: bytes, data) -> dict:
    return {
        "len": len(blob),
        "sha256": hashlib.sha256(blob).hexdigest(),
        "constants_cap": [[int(v) for v in row] for row in data.constants_oracle.cap],
        "circuit_digest": [int(v) for v in data.circuit_digest],
    }


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from qp_zk_circuits_tpu.plonk.builder import PartialWitness
    from qp_zk_circuits_tpu.plonk.prover import prove_staged
    from qp_zk_circuits_tpu.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu.wormhole.test_helpers import test_inputs_0, two_real_leaves_same_block

    b, x, y = small_real_circuit("qp_zk_circuits_tpu")
    small = b.build()
    pw = PartialWitness()
    pw.set_target(x, SMALL_WITNESS[0])
    pw.set_target(y, SMALL_WITNESS[1])
    small_blob = proof_to_bytes(prove_staged(small, pw, seed=0))

    prover = WormholeProver()
    leaf_blob = proof_to_bytes(prover.prove_inputs(test_inputs_0(), seed=0))
    real_blobs = [proof_to_bytes(prover.prove_inputs(inputs, seed=0))
                  for inputs in two_real_leaves_same_block()]

    blobs = {"small_circuit_proof.bin": (small_blob, small),
             "leaf_proof_inputs0.bin": (leaf_blob, prover.data)}
    for i, blob in enumerate(real_blobs):
        blobs[REAL_LEAF_FIXTURES[i]] = (blob, prover.data)
    meta = {}
    for name, (blob, data) in blobs.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(blob)
        meta[name] = _entry(blob, data)
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    for name, m in meta.items():
        print(name, m["len"], m["sha256"])


if __name__ == "__main__":
    main()
