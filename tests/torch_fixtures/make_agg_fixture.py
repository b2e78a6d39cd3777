"""Write the recursion and aggregation proofs that the port's tests and
`chip_smoke.py` compare against.

Run from the repository root, on the CPU, one part a process (the parts are
independent and can run side by side):

    QZKT_STAGED_PROVER=1 JAX_PLATFORMS=cpu python tests/torch_fixtures/make_agg_fixture.py recursion
    QZKT_STAGED_PROVER=1 JAX_PLATFORMS=cpu python tests/torch_fixtures/make_agg_fixture.py test_profile
    QZKT_STAGED_PROVER=1 JAX_PLATFORMS=cpu python tests/torch_fixtures/make_agg_fixture.py canonical

Every proof is the JAX package's staged proof (pinned byte-identical to its
fused prover for non-ZK circuits and for ZK circuits in host-rng mode). Each
part prints its seconds and adds its files to `fixtures.json` (length,
SHA-256, the circuit's constants cap and digest, and the seeds).

Parts and outputs, next to this file:

  * recursion (tests/test_recursion.py's setup): the inner circuit z = x * y
    (x = 6, y = 7) and the outer circuit that verifies its proof and
    re-exposes z; `recursion_inner_proof.bin` (seed 1),
    `recursion_outer_proof.bin` (seed 2, with the SHA-256 of the outer
    witness trace's used rows), the outer `VerifierCircuitData`
    as `recursion_outer_common.bin` and `recursion_outer_verifier.bin`;
  * test_profile (tests/test_aggregation.py's profile, N_LEAF = 2): the two
    real leaves of `two_real_leaves_same_block()` (`agg_leaf0.bin`,
    `agg_leaf1.bin`, seeds 10 and 11), the dummy leaf (`agg_dummy_leaf.bin`,
    seed 12), the private batch `PrivateBatchProver.commit([leaf0, leaf1],
    rng=default_rng(PB_RNG)).prove(seed=PB_SEED)` (`agg_private_batch.bin`)
    with its verifier data (`agg_private_batch_common.bin`,
    `agg_private_batch_verifier.bin`) and the SHA-256 of its witness trace's
    used rows (the same commit on a fresh default_rng(PB_RNG), the prover's
    witness built the prover's way), the all-dummy private batch
    (`agg_dummy_private_batch.bin`, rng default_rng(DUMMY_PB_RNG), seed
    DUMMY_PB_SEED), and the public batch over [private batch, dummy private
    batch] for aggregator address PUB_ADDRESS (`agg_public_batch.bin`, seed
    PUB_SEED, a commit of the private batch alone, padded by the dummy) with
    its verifier data (`agg_public_batch_common.bin`,
    `agg_public_batch_verifier.bin`);
  * canonical (the canonical configs): the dummy leaf of the canonical leaf
    circuit (`canonical_dummy_leaf.bin`, seed 12) and the N = 2 private
    batch over `leaf_proof_real0.bin` and `leaf_proof_real1.bin`
    (`canonical_private_batch.bin`, the same rng and seed as the test
    profile's) with its verifier data (`canonical_private_batch_common.bin`,
    `canonical_private_batch_verifier.bin`).
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_LEAF = 2
LEAF_SEEDS = (10, 11)
DUMMY_LEAF_SEED = 12
PB_RNG, PB_SEED = 7, 20
DUMMY_PB_RNG, DUMMY_PB_SEED = 9, 23
PUB_ADDRESS = bytes([9] * 8) + bytes(24)
PUB_SEED = 24
INNER_WITNESS, INNER_SEED, OUTER_SEED = (6, 7), 1, 2


def test_fri(pkg):
    """tests/test_recursion.py's and tests/test_aggregation.py's FRI config
    in package `pkg`."""
    fc = pkg.fri.config
    return fc.FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=6,
                        num_query_rounds=10, reduction_strategy=fc.FriReductionStrategy(4, 5))


def test_configs(pkg):
    """(leaf, private batch, public batch) configs of the aggregation test
    profile, which is also the recursion test's (inner and outer = leaf)."""
    cc = pkg.plonk.config.CircuitConfig
    fri = test_fri(pkg)
    leaf = cc(num_wires=135, num_routed_wires=80, num_challenges=2, fri_config=fri)
    pb = cc(num_wires=135, num_routed_wires=80, num_challenges=2, zero_knowledge=True,
            fri_config=fri)
    pub = cc(num_wires=135, num_routed_wires=80, num_challenges=2, fri_config=fri)
    return leaf, pb, pub


def recursion_circuits(pkg, build):
    """The recursion test's inner and outer circuits in package `pkg`
    (`build(builder)` builds each): (inner data, x, y, common, outer data,
    proof targets)."""
    leaf_cfg = test_configs(pkg)[0]
    cb = pkg.plonk.builder.CircuitBuilder
    vg = pkg.recursion.verifier_gadget
    bi = cb(leaf_cfg)
    x = bi.add_virtual_target()
    y = bi.add_virtual_target()
    bi.register_public_input(bi.mul(x, y))
    inner = build(bi)
    common = pkg.plonk.serialization.VerifierCircuitData.from_circuit_data(inner)
    bo = cb(leaf_cfg)
    pt = vg.add_virtual_proof_with_pis(bo, common)
    vg.verify_proof_circuit(bo, pt, common)
    bo.register_public_inputs(pt.public_inputs)
    return inner, x, y, common, build(bo), pt


def trace_sha256(trace, rows_used: int) -> str:
    """SHA-256 of a witness trace's used rows (num_wires, rows_used) as
    little-endian u64."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(trace, dtype="<u8")[:, :rows_used]).tobytes()).hexdigest()


def batch_witness(pkg, circuit, slots, rng):
    """The private batch prover's witness (`PrivateBatchProver.prove`): the
    slots' proof targets, then a dummy preimage a slot drawn from `rng`."""
    import numpy as np

    pw = pkg.plonk.builder.PartialWitness()
    for pt, proof in zip(circuit.proof_targets, slots):
        pkg.recursion.verifier_gadget.fill_proof_targets(pw, pt, proof)
    for pre_t in circuit.dummy_preimages:
        pre = pkg.wormhole.dummy_proof.generate_random_nullifier_preimage(rng)
        pw.set_many(pre_t, np.frombuffer(pre, dtype="<u8").astype(np.uint64))
    return pw


def _entry(blob: bytes, data, **extra) -> dict:
    out = {"len": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}
    if data is not None:
        out["constants_cap"] = [[int(v) for v in row] for row in data.constants_oracle.cap]
        out["circuit_digest"] = [int(v) for v in data.circuit_digest]
    out.update(extra)
    return out


def _publish(files: dict, seconds: float, part: str) -> None:
    """Write `files` ({name: (blob, data, extra)}) and merge their entries
    into fixtures.json under a lock (the parts may run side by side)."""
    meta = {}
    for name, (blob, data, extra) in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(blob)
        meta[name] = _entry(blob, data, **extra)
    path = os.path.join(HERE, "fixtures.json")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        with open(path) as f:
            allm = json.load(f)
        allm.update(meta)
        with open(path, "w") as f:
            json.dump(allm, f, indent=1)
            f.write("\n")
    os.remove(path + ".lock")
    for name, m in meta.items():
        print(name, m["len"], m["sha256"])
    print(f"[{part}] {seconds:.1f} s", flush=True)


def _pkg():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import importlib

    pkg = importlib.import_module("qp_zk_circuits_tpu")
    for mod in ("fri.config", "plonk.builder", "plonk.config", "plonk.serialization",
                "recursion.verifier_gadget", "wormhole.dummy_proof"):
        importlib.import_module(f"qp_zk_circuits_tpu.{mod}")
    return pkg


def part_recursion() -> None:
    pkg = _pkg()
    from qp_zk_circuits_tpu.plonk.builder import PartialWitness, generate_witness
    from qp_zk_circuits_tpu.plonk.prover import prove_staged
    from qp_zk_circuits_tpu.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu.plonk.verifier import verify
    from qp_zk_circuits_tpu.recursion.verifier_gadget import fill_proof_targets

    t0 = time.perf_counter()
    inner, x, y, common, outer, pt = recursion_circuits(pkg, lambda b: b.build())
    print(f"[recursion] built, outer degree_bits {outer.degree_bits}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pw = PartialWitness()
    pw.set_target(x, INNER_WITNESS[0])
    pw.set_target(y, INNER_WITNESS[1])
    inner_proof = prove_staged(inner, pw, seed=INNER_SEED)
    verify(inner, inner_proof)
    opw = PartialWitness()
    fill_proof_targets(opw, pt, inner_proof)
    outer_proof = prove_staged(outer, opw, seed=OUTER_SEED)
    verify(outer, outer_proof)
    trace, _ = generate_witness(outer, opw)
    ovd = pkg.plonk.serialization.VerifierCircuitData.from_circuit_data(outer)
    _publish({
        "recursion_inner_proof.bin": (proof_to_bytes(inner_proof), inner, {"seed": INNER_SEED}),
        "recursion_outer_proof.bin": (proof_to_bytes(outer_proof), outer,
                                      {"seed": OUTER_SEED, "degree_bits": outer.degree_bits,
                                       "trace_sha256": trace_sha256(trace, outer.num_rows_used)}),
        "recursion_outer_common.bin": (ovd.to_common_bytes(), None, {}),
        "recursion_outer_verifier.bin": (ovd.to_verifier_only_bytes(), None, {}),
    }, time.perf_counter() - t0, "recursion")


def _private_batch_files(pkg, prefix, leaf_data, leaves, dummy_leaf, cfg, floor, t0):
    """Build the private batch over `leaf_data`, prove it over `leaves` and
    return (circuit, proof, files)."""
    import numpy as np

    from qp_zk_circuits_tpu.plonk.builder import generate_witness
    from qp_zk_circuits_tpu.plonk.serialization import VerifierCircuitData, proof_to_bytes
    from qp_zk_circuits_tpu.plonk.verifier import verify
    from qp_zk_circuits_tpu.wormhole.private_batch import PrivateBatchCircuit, PrivateBatchProver
    from qp_zk_circuits_tpu.wormhole.verifier import WormholeVerifier

    leaf_common = VerifierCircuitData.from_circuit_data(leaf_data)
    tb = time.perf_counter()
    circuit = PrivateBatchCircuit(leaf_common, N_LEAF, config=cfg, enforce_security_floor=floor)
    build_s = time.perf_counter() - tb
    print(f"[{prefix}] private batch built in {build_s:.1f} s, degree_bits "
          f"{circuit.data.degree_bits}, {time.perf_counter() - t0:.1f} s", flush=True)
    leaf_verifier = WormholeVerifier(leaf_data, enforce_security_floor=floor)
    prover = PrivateBatchProver(circuit, leaf_verifier, dummy_leaf)
    tp = time.perf_counter()
    proof = prover.commit(list(leaves), rng=np.random.default_rng(PB_RNG)).prove(seed=PB_SEED)
    prove_s = time.perf_counter() - tp
    verify(circuit.data, proof)
    print(f"[{prefix}] private batch proved in {prove_s:.1f} s, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the same commit on a fresh generator gives the prover's witness
    prover.commit(list(leaves), rng=np.random.default_rng(PB_RNG))
    pw = batch_witness(pkg, circuit, prover._slots, prover._rng)
    prover._slots = None
    trace, pis = generate_witness(circuit.data, pw, np.random.default_rng(0))
    assert np.array_equal(np.asarray(pis, np.uint64), np.asarray(proof.public_inputs, np.uint64))
    vd = VerifierCircuitData.from_circuit_data(circuit.data)
    files = {
        f"{prefix}_private_batch.bin": (proof_to_bytes(proof), circuit.data, {
            "rng": PB_RNG, "seed": PB_SEED, "degree_bits": circuit.data.degree_bits,
            "trace_sha256": trace_sha256(trace, circuit.data.num_rows_used),
            "rows_used": circuit.data.num_rows_used, "build_s": round(build_s, 1),
            "prove_s": round(prove_s, 1)}),
        f"{prefix}_private_batch_common.bin": (vd.to_common_bytes(), None, {}),
        f"{prefix}_private_batch_verifier.bin": (vd.to_verifier_only_bytes(), None, {}),
    }
    return circuit, proof, files


def part_test_profile() -> None:
    pkg = _pkg()
    import numpy as np

    from qp_zk_circuits_tpu.plonk.serialization import VerifierCircuitData, proof_to_bytes
    from qp_zk_circuits_tpu.plonk.verifier import verify
    from qp_zk_circuits_tpu.wormhole import inputs as wi
    from qp_zk_circuits_tpu.wormhole import test_helpers as th
    from qp_zk_circuits_tpu.wormhole.dummy_proof import generate_dummy_proof
    from qp_zk_circuits_tpu.wormhole.private_batch import generate_dummy_private_batch_proof
    from qp_zk_circuits_tpu.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu.wormhole.public_batch import PublicBatchCircuit, PublicBatchProver

    t0 = time.perf_counter()
    leaf_cfg, pb_cfg, pub_cfg = test_configs(pkg)
    leaf_prover = WormholeProver(leaf_cfg)
    leaves = [leaf_prover.prove_inputs(i, seed=s)
              for i, s in zip(th.two_real_leaves_same_block(), LEAF_SEEDS)]
    dummy_leaf = generate_dummy_proof(leaf_prover, seed=DUMMY_LEAF_SEED)
    print(f"[test_profile] leaves proved, {time.perf_counter() - t0:.1f} s", flush=True)
    circuit, agg, files = _private_batch_files(
        pkg, "agg", leaf_prover.data, leaves, dummy_leaf, pb_cfg, False, t0)
    dummy_pb = generate_dummy_private_batch_proof(
        circuit, dummy_leaf, rng=np.random.default_rng(DUMMY_PB_RNG), seed=DUMMY_PB_SEED)
    pb_common = VerifierCircuitData.from_circuit_data(circuit.data)
    pub_circuit = PublicBatchCircuit(pb_common, m=2, n_leaf=N_LEAF, config=pub_cfg)
    print(f"[test_profile] public batch built, degree_bits {pub_circuit.data.degree_bits}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pub_prover = PublicBatchProver(pub_circuit, lambda p: verify(circuit.data, p), dummy_pb)
    pub = pub_prover.commit([agg], wi.BytesDigest(PUB_ADDRESS)).prove(seed=PUB_SEED)
    verify(pub_circuit.data, pub)
    pvd = VerifierCircuitData.from_circuit_data(pub_circuit.data)
    for i, (p, s) in enumerate(zip(leaves, LEAF_SEEDS)):
        files[f"agg_leaf{i}.bin"] = (proof_to_bytes(p), leaf_prover.data, {"seed": s})
    files["agg_dummy_leaf.bin"] = (proof_to_bytes(dummy_leaf), leaf_prover.data,
                                   {"seed": DUMMY_LEAF_SEED})
    files["agg_dummy_private_batch.bin"] = (proof_to_bytes(dummy_pb), circuit.data, {
        "rng": DUMMY_PB_RNG, "seed": DUMMY_PB_SEED})
    files["agg_public_batch.bin"] = (proof_to_bytes(pub), pub_circuit.data, {
        "seed": PUB_SEED, "address": PUB_ADDRESS.hex(),
        "degree_bits": pub_circuit.data.degree_bits})
    files["agg_public_batch_common.bin"] = (pvd.to_common_bytes(), None, {})
    files["agg_public_batch_verifier.bin"] = (pvd.to_verifier_only_bytes(), None, {})
    _publish(files, time.perf_counter() - t0, "test_profile")


def part_canonical() -> None:
    pkg = _pkg()
    from qp_zk_circuits_tpu.plonk.serialization import proof_from_bytes, proof_to_bytes
    from qp_zk_circuits_tpu.wormhole.dummy_proof import generate_dummy_proof
    from qp_zk_circuits_tpu.wormhole.prover import WormholeProver

    t0 = time.perf_counter()
    leaf_prover = WormholeProver()
    leaves = []
    for name in ("leaf_proof_real0.bin", "leaf_proof_real1.bin"):
        with open(os.path.join(HERE, name), "rb") as f:
            leaves.append(proof_from_bytes(f.read()))
    dummy_leaf = generate_dummy_proof(leaf_prover, seed=DUMMY_LEAF_SEED)
    print(f"[canonical] dummy leaf proved, {time.perf_counter() - t0:.1f} s", flush=True)
    _, _, files = _private_batch_files(
        pkg, "canonical", leaf_prover.data, leaves, dummy_leaf, None, True, t0)
    files["canonical_dummy_leaf.bin"] = (proof_to_bytes(dummy_leaf), leaf_prover.data,
                                         {"seed": DUMMY_LEAF_SEED})
    _publish(files, time.perf_counter() - t0, "canonical")


PARTS = {"recursion": part_recursion, "test_profile": part_test_profile,
         "canonical": part_canonical}


if __name__ == "__main__":
    for part in sys.argv[1:] or list(PARTS):
        PARTS[part]()
