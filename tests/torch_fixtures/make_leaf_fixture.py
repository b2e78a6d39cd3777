"""Write the reference proofs that the PyTorch port's tests compare against.

Run from the repository root (CPU is enough; the staged prover avoids the
long single-graph compile, and for non-ZK circuits it is pinned
byte-identical to the fused prover in tests/test_plonk.py):

    QZKT_STAGED_PROVER=1 JAX_PLATFORMS=cpu python tests/torch_fixtures/make_leaf_fixture.py

It takes about 17 minutes on a CPU, most of them the JAX package's staged
proof of the ZK leaf (building that circuit takes about a minute and its
proof over three): run it once, in the background. The non-ZK outputs come
out byte-identical from run to run.

Outputs, next to this file:
  * leaf_proof_inputs0.bin — proof_to_bytes of
    WormholeProver().prove_inputs(test_inputs_0(), seed=0);
  * leaf_proof_real0.bin, leaf_proof_real1.bin — the same for each leaf of
    two_real_leaves_same_block() (the batch and stream tests' leaves);
  * small_circuit_proof.bin — proof_to_bytes of prove_staged on the small
    real circuit below (witness x=11, y=13, seed=0);
  * small_zk_proof.bin — the same circuit under a zero-knowledge config
    (`small_real_circuit(pkg, zk=True)`), prove_staged with seed ZK_SEED:
    a host-rng ZK proof (blinding rows, then the wires, zs_pp and quotient
    salt seeds, all from one default_rng(seed));
  * small_zk_batch0.bin .. small_zk_batch2.bin — the proofs of the JAX
    package's default prove_batch of ZK_BATCH_WITNESSES with seed ZK_SEED:
    its fused path (prover_fused.py::prove_fused_batch) draws every proof
    from one default_rng(seed) in turn (_batch_flat_inputs: the blinding
    rows, then the three salt seeds), and its host-rng proofs are pinned
    bit-identical to the staged prover's. The vmapped fused graph's XLA
    compile did not finish on a CPU in two hours, so the batch is made
    here by prove_staged drawing from that one generator, passed as the
    seed (default_rng returns a Generator unaltered): the same draws, in
    the same order. (The QZKT_STAGED_PROVER fallback of prove_batch seeds
    each proof anew; it is not the default and not this.)
  * leaf_zk_proof_inputs0.bin — WormholeProver(
    wormhole_private_batch_circuit_config()).prove_inputs(test_inputs_0(),
    seed=LEAF_ZK_SEED) by the staged prover;
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
#: the ZK small circuit's single proof and batch: seed and witnesses (the
#: first is the single proof's, so proof 0 of the batch equals it)
ZK_SEED = 3
ZK_BATCH_WITNESSES = (SMALL_WITNESS, (12, 17), (5, 40))
ZK_SMALL_FIXTURE = "small_zk_proof.bin"
ZK_BATCH_FIXTURES = tuple(f"small_zk_batch{i}.bin" for i in range(len(ZK_BATCH_WITNESSES)))
#: the ZK leaf (private batch config, test_inputs_0())
LEAF_ZK_SEED = 7
LEAF_ZK_FIXTURE = "leaf_zk_proof_inputs0.bin"


def small_real_circuit(pkg: str, zk: bool = False):
    """The small but real circuit of `__graft_entry__._small_real_circuit`
    (arithmetic, range check, copy constraints, in-circuit hash, public
    inputs), built with package `pkg`'s builder; `zk` turns on
    zero-knowledge (row blinding and salted oracles). Returns (builder, x,
    y) unbuilt, so each package builds it its own way."""
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
        zero_knowledge=zk,
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
    import numpy as np

    from qp_zk_circuits_tpu.plonk.prover import prove_staged
    from qp_zk_circuits_tpu.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu.utils.config_policy import wormhole_private_batch_circuit_config
    from qp_zk_circuits_tpu.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu.wormhole.test_helpers import test_inputs_0, two_real_leaves_same_block

    b, x, y = small_real_circuit("qp_zk_circuits_tpu")
    small = b.build()
    pw = PartialWitness()
    pw.set_target(x, SMALL_WITNESS[0])
    pw.set_target(y, SMALL_WITNESS[1])
    small_blob = proof_to_bytes(prove_staged(small, pw, seed=0))

    b, x, y = small_real_circuit("qp_zk_circuits_tpu", zk=True)
    small_zk = b.build()
    pws = []
    for wx, wy in ZK_BATCH_WITNESSES:
        zpw = PartialWitness()
        zpw.set_target(x, wx)
        zpw.set_target(y, wy)
        pws.append(zpw)
    small_zk_blob = proof_to_bytes(prove_staged(small_zk, pws[0], seed=ZK_SEED))
    rng = np.random.default_rng(ZK_SEED)  # the default batch's one generator
    zk_batch_blobs = [proof_to_bytes(prove_staged(small_zk, pw, seed=rng)) for pw in pws]

    prover = WormholeProver()
    leaf_blob = proof_to_bytes(prover.prove_inputs(test_inputs_0(), seed=0))
    real_blobs = [proof_to_bytes(prover.prove_inputs(inputs, seed=0))
                  for inputs in two_real_leaves_same_block()]


    zk_prover = WormholeProver(wormhole_private_batch_circuit_config())
    leaf_zk_blob = proof_to_bytes(zk_prover.prove_inputs(test_inputs_0(), seed=LEAF_ZK_SEED))

    blobs = {"small_circuit_proof.bin": (small_blob, small),
             "leaf_proof_inputs0.bin": (leaf_blob, prover.data)}
    for i, blob in enumerate(real_blobs):
        blobs[REAL_LEAF_FIXTURES[i]] = (blob, prover.data)
    blobs[ZK_SMALL_FIXTURE] = (small_zk_blob, small_zk)
    for name, blob in zip(ZK_BATCH_FIXTURES, zk_batch_blobs, strict=True):
        blobs[name] = (blob, small_zk)
    blobs[LEAF_ZK_FIXTURE] = (leaf_zk_blob, zk_prover.data)
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
