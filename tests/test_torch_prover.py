"""The port's PLONK prover on a small real circuit against the JAX package.

The circuit is `__graft_entry__._small_real_circuit`'s (arithmetic, range
check, copy constraints, in-circuit hash, public inputs), built by each
package's own builder. The reference proof is the JAX package's
`prove_staged` output, committed by tests/torch_fixtures/make_leaf_fixture.py
(proving it here would compile the JAX prover graphs for over a minute).
Everything is bit-exact, and each package's verifier accepts the port's
proof.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from qp_zk_circuits_tpu.field import extension as jext
from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.plonk import builder as jbuilder
from qp_zk_circuits_tpu.plonk import gates as jgates
from qp_zk_circuits_tpu.plonk import prover as jprover
from qp_zk_circuits_tpu.plonk.serialization import VerifierCircuitData
from qp_zk_circuits_tpu.plonk.serialization import proof_from_bytes as j_proof_from_bytes
from qp_zk_circuits_tpu.plonk.verifier import verify as j_verify
from qp_zk_circuits_tpu_torch import interop
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.fri import oracle as toracle
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import gates as tgates
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk.config import CircuitConfig
from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes as t_proof_from_bytes
from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
from qp_zk_circuits_tpu_torch.plonk.verifier import verify as t_verify

FIXTURES = Path(__file__).parent / "torch_fixtures"


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_leaf_fixture", FIXTURES / "make_leaf_fixture.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _fixture_module()
META = json.loads((FIXTURES / "fixtures.json").read_text())["small_circuit_proof.bin"]
REF_PROOF = (FIXTURES / "small_circuit_proof.bin").read_bytes()


def _witness(pkg_builder, x, y):
    pw = pkg_builder.PartialWitness()
    pw.set_target(x, MK.SMALL_WITNESS[0])
    pw.set_target(y, MK.SMALL_WITNESS[1])
    return pw


@pytest.fixture(scope="module")
def small():
    """(reference shape-only data, its witness, port data, its witness)."""
    jb, jx, jy = MK.small_real_circuit("qp_zk_circuits_tpu")
    jdata = jb.build(shape_only=True)
    tb, tx, ty = MK.small_real_circuit("qp_zk_circuits_tpu_torch")
    tdata = tb.build(device="cpu")
    return jdata, _witness(jbuilder, jx, jy), tdata, _witness(tbuilder, tx, ty)


@pytest.fixture(scope="module")
def port_proof(small):
    _, _, tdata, tpw = small
    return proof_to_bytes(tprover.prove(tdata, tpw, seed=0))


def test_circuit_data_equals_reference(small):
    jdata, _, tdata, _ = small
    mine, ref = interop.arrays_of(tdata), interop.arrays_of(jdata)
    for key in ("const_cols", "sel_cols", "sigma_vals", "id_coords", "gate_keys",
                "public_input_targets", "num_rows_used"):
        assert np.array_equal(mine[key], ref[key]), key
    assert tdata.degree_bits == jdata.degree_bits
    assert tdata.constants_oracle.cap.tolist() == META["constants_cap"]
    assert tdata.circuit_digest.tolist() == META["circuit_digest"]


def test_circuit_data_from_arrays(small):
    jdata, _, tdata, _ = small
    arrays = dict(interop.arrays_of(jdata), circuit_digest=np.array(META["circuit_digest"], dtype=np.uint64))
    data = interop.circuit_data_from_arrays(arrays, jdata.config, device="cpu")
    assert np.array_equal(data.constants_oracle.cap, tdata.constants_oracle.cap)
    assert np.array_equal(data.circuit_digest, tdata.circuit_digest)
    bad = dict(arrays, circuit_digest=np.zeros(4, dtype=np.uint64))
    with pytest.raises(ValueError):
        interop.circuit_data_from_arrays(bad, jdata.config, device="cpu")


def test_proof_bytes_equal_reference(port_proof):
    assert port_proof == REF_PROOF


def test_prove_from_reference_trace(small):
    """The reference builder's trace proven on arrays-only data: isolates the
    prover from the port's builder."""
    jdata, jpw, _, _ = small
    trace, pis = jbuilder.generate_witness(jdata, jpw)
    arrays = dict(interop.arrays_of(jdata), circuit_digest=np.array(META["circuit_digest"], dtype=np.uint64))
    data = interop.circuit_data_from_arrays(arrays, jdata.config, device="cpu")
    assert proof_to_bytes(tprover.prove_from_trace(data, trace, pis)) == REF_PROOF
    with pytest.raises(tbuilder.WitnessError):
        tbuilder.run_generators(data, tbuilder.PartialWitness())


def test_reference_verifier_accepts_port_proof(small, port_proof):
    jdata, _, tdata, _ = small
    vdata = VerifierCircuitData(
        jdata.config, jdata.degree_bits, jdata.gate_types, jdata.num_selectors,
        jdata.const_cols.shape[0], tdata.constants_oracle.cap, tdata.circuit_digest,
        len(jdata.public_input_targets),
    )
    j_verify(vdata, j_proof_from_bytes(port_proof))


def test_port_verifier_accepts_port_proof(small, port_proof):
    """The port's own verifier, on the port's circuit data (its constants
    cap and digest as committed by the port), accepts the port's proof."""
    _, _, tdata, _ = small
    t_verify(tdata, t_proof_from_bytes(port_proof))


def test_permutation_polys_match_reference(small):
    jdata, jpw, tdata, _ = small
    trace, _ = jbuilder.generate_witness(jdata, jpw)
    rng = np.random.default_rng(1)
    betas, gammas = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    want = jprover.compute_permutation_polys(jdata, trace, betas, gammas)
    rec = tprover.host_records("cpu", 1, 2, betas=betas, gammas=gammas)[0]
    got = tprover.compute_permutation_polys(tdata, gl.from_u64(trace, "cpu"), rec)
    assert np.array_equal(gl.to_u64(got), want)


def _gate_cases():
    return [
        ("arith", lambda g: g.ArithmeticGate(3)),
        ("const", lambda g: g.ConstantGate(2)),
        ("public_input", lambda g: g.PublicInputGate()),
        ("poseidon2", lambda g: g.Poseidon2Gate()),
        ("reduce_ext", lambda g: g.ReducingGate(3, True, 20)),
        ("reduce_base", lambda g: g.ReducingGate(4, False, 20)),
        ("base_sum", lambda g: g.BaseSumGate(9)),
    ]


@pytest.mark.parametrize("name, make", _gate_cases())
def test_gate_eval_batched_matches_reference_eval(name, make):
    """Port eval_batched over m points == the reference's scalar eval at each
    point (host extension algebra, base values embedded as (v, 0))."""
    rng = np.random.default_rng(len(name))
    m = 4
    wires = JF.rand_felts((135, m), rng)
    consts = JF.rand_felts((2, m), rng)
    pi = JF.rand_felts(4, rng)
    ctx = tgates.DeviceBatchCtx(
        gl.from_u64(wires, "cpu"), [gl.from_u64(c, "cpu") for c in consts], gl.from_u64(pi, "cpu")
    )
    got = gl.to_u64(make(tgates).eval_batched(ctx))
    ref_gate = make(jgates)
    for j in range(m):
        hctx = jgates.HostExtCtx(
            [(int(w), 0) for w in wires[:, j]], [(int(c), 0) for c in consts[:, j]],
            [(int(v), 0) for v in pi],
        )
        want = [int(jext.pair(v)[0]) for v in ref_gate.eval(hctx)]
        assert got[:, j].tolist() == want


def test_eval_openings_match_horner():
    rng = np.random.default_rng(2)
    coeffs = JF.rand_felts((3, 16), rng)
    z, zn = jext.rand((), rng), jext.rand((), rng)
    o = toracle.commit(coeffs, 1, 0, "cpu")
    values = toracle.eval_openings([o], toracle.point_records("cpu", [z], [zn])[0],
                                   next_oracle=0, next_count=2)
    (at_z,), at_next = toracle.split_openings(gl.to_u64(values), [o], 2)
    for point, got, cols in ((z, at_z, 3), (zn, at_next, 2)):
        for c in range(cols):
            acc = (0, 0)
            for i in range(15, -1, -1):
                acc = jext.add(jext.mul(acc, jext.pair(point)), (int(coeffs[c, i]), 0))
            assert jext.pair(got[c]) == acc


def test_zero_knowledge_is_refused(small):
    """A ZK proof is refused without its draws (the host salts or a device
    key, exactly one), and a non-ZK proof is refused with them: the
    blinding rows and salts are never made up behind the caller's back."""
    _, _, tdata, _ = small
    zk = dataclasses.replace(tdata, config=CircuitConfig(zero_knowledge=True))
    trace = np.zeros((135, tdata.n), dtype=np.uint64)
    salts = np.zeros((3, tdata.n << 3, 4), dtype=np.uint64)
    pis = np.zeros(0, dtype=np.uint64)
    for kwargs in ({}, {"salts": salts, "device_key": 5}):
        with pytest.raises(ValueError, match="host salts or a device key"):
            tprover.prove_from_trace(zk, trace, pis, **kwargs)
    for kwargs in ({"salts": salts}, {"device_key": 5}):
        with pytest.raises(ValueError, match="non-ZK"):
            tprover.prove_from_trace(tdata, trace, pis, **kwargs)
