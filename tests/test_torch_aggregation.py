"""The port's aggregation layers (`wormhole/private_batch.py`,
`public_batch.py`, `dummy_proof.py`) against the JAX package's, on the CPU.

No proof is made here and no JAX graph is built. The JAX proofs are the
committed fixtures of tests/torch_fixtures/make_agg_fixture.py, at
tests/test_aggregation.py's profile (N_LEAF = 2, reduced FRI) and at the
canonical configs. The circuits are shape-only builds: the preprocessing
commit on the CPU's plain versions makes a degree-13 build about seven
times slower (21 s against 3 s with eight threads), and the module
builds three such circuits, so the constants cap comes from the fixture
here and `chip_smoke.py` builds the full verifier data on the card and
compares its bytes. The checks:

  * the private and public batch circuits have the JAX package's shape
    (degree, gate set, selector and constant columns, sigmas, routing) and
    common bytes, and the fixture's verifier-only bytes bind to them;
  * the private batch's witness for the JAX commit (the same leaves, the
    same shuffle and dummy preimages from default_rng(PB_RNG)) equals the
    JAX package's (the trace's SHA-256), runs on the compiled witness tape
    from its second run on, and its public inputs are the fixture proof's;
    the same for the public batch over [private batch, dummy];
  * the port's verifier accepts every fixture proof (leaves, dummies,
    private batches, public batch) and rejects tampered copies with the
    JAX verifier's class and message;
  * admission (`commit`, `preflight`, the dummy templates) rejects what the
    JAX package rejects, with its class and message.
"""

import copy
import importlib
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest

import qp_zk_circuits_tpu as jpkg
from qp_zk_circuits_tpu.plonk import serialization as jser
from qp_zk_circuits_tpu.plonk import verifier as jverifier
from qp_zk_circuits_tpu.wormhole import inputs as jwi
from qp_zk_circuits_tpu.wormhole import private_batch as jpb
from qp_zk_circuits_tpu.wormhole import public_batch as jpub
from qp_zk_circuits_tpu.wormhole import verifier as jwverifier
from qp_zk_circuits_tpu.wormhole.leaf_circuit import WormholeCircuit as JWormholeCircuit
import qp_zk_circuits_tpu_torch as tpkg
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import verifier as tverifier
from qp_zk_circuits_tpu_torch.plonk import witness_tape as twt
from qp_zk_circuits_tpu_torch.wormhole import dummy_proof as tdummy
from qp_zk_circuits_tpu_torch.wormhole import inputs as twi
from qp_zk_circuits_tpu_torch.wormhole import private_batch as tpb
from qp_zk_circuits_tpu_torch.wormhole import public_batch as tpub
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as tth
from qp_zk_circuits_tpu_torch.wormhole import verifier as twverifier
from qp_zk_circuits_tpu_torch.wormhole.leaf_circuit import WormholeCircuit as TWormholeCircuit

P = 0xFFFFFFFF00000001
FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())

for _name in ("qp_zk_circuits_tpu", "qp_zk_circuits_tpu_torch"):
    for _mod in ("fri.config", "plonk.config"):
        importlib.import_module(f"{_name}.{_mod}")


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_agg_fixture", FIXTURES / "make_agg_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _fixture_module()
N_LEAF = MK.N_LEAF


def _blob(name):
    return (FIXTURES / name).read_bytes()


def _proof(name, ser=tser):
    return ser.proof_from_bytes(_blob(name))


def _leaf_vdata(ser, data, name):
    """A package's leaf VerifierCircuitData: its shape-only circuit with the
    fixture's constants cap and circuit digest."""
    meta = META[name]
    return ser.VerifierCircuitData(
        data.config, data.degree_bits, list(data.gate_types), data.num_selectors,
        data.const_cols.shape[0], np.array(meta["constants_cap"], dtype=np.uint64),
        np.array(meta["circuit_digest"], dtype=np.uint64), len(data.public_input_targets),
    )


def _pair_vdata(ser, prefix):
    """A package's VerifierCircuitData from a fixture's artifact pair."""
    return ser.VerifierCircuitData.from_artifact_bytes(
        _blob(f"{prefix}_verifier.bin"), _blob(f"{prefix}_common.bin"), max_len=64 << 20)


@pytest.fixture(scope="module")
def vdata():
    """{kind: (JAX, port) VerifierCircuitData} of every fixture circuit."""
    tleaf_cfg = MK.test_configs(tpkg)[0]
    jleaf_cfg = MK.test_configs(jpkg)[0]
    return {
        "leaf": (_leaf_vdata(jser, JWormholeCircuit(jleaf_cfg).build(shape_only=True), "agg_leaf0.bin"),
                 _leaf_vdata(tser, TWormholeCircuit(tleaf_cfg).build(shape_only=True),
                             "agg_leaf0.bin")),
        "canonical_leaf": (
            _leaf_vdata(jser, JWormholeCircuit().build(shape_only=True), "leaf_proof_real0.bin"),
            _leaf_vdata(tser, TWormholeCircuit().build(shape_only=True), "leaf_proof_real0.bin")),
        "private_batch": (_pair_vdata(jser, "agg_private_batch"),
                          _pair_vdata(tser, "agg_private_batch")),
        "public_batch": (_pair_vdata(jser, "agg_public_batch"),
                         _pair_vdata(tser, "agg_public_batch")),
        "canonical_private_batch": (_pair_vdata(jser, "canonical_private_batch"),
                                    _pair_vdata(tser, "canonical_private_batch")),
    }


@pytest.fixture(scope="module")
def circuits(vdata):
    """(JAX, port) shape-only private batch circuits at the test profile,
    and the port's shape-only public batch over the fixture's private batch."""
    jcfg, tcfg = MK.test_configs(jpkg)[1], MK.test_configs(tpkg)[1]
    (jleaf, tleaf), (_, tpbv) = vdata["leaf"], vdata["private_batch"]
    jc = jpb.PrivateBatchCircuit(jleaf, N_LEAF, config=jcfg, enforce_security_floor=False,
                                 shape_only=True)
    tc = tpb.PrivateBatchCircuit(tleaf, N_LEAF, config=tcfg, enforce_security_floor=False,
                                 shape_only=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpub, "CircuitBuilder", _ShapeOnlyBuilder)
        pub = tpub.PublicBatchCircuit(tpbv, 2, N_LEAF, config=MK.test_configs(tpkg)[2])
    return jc, tc, pub


class _ShapeOnlyBuilder(tbuilder.CircuitBuilder):
    """A builder that skips the constants' commitment, for the public batch,
    whose class (like the JAX package's) always commits: the commitment on
    the CPU's plain Poseidon2 would dominate the module's time."""

    def build(self, shape_only: bool = False, device=None):
        return super().build(shape_only=True, device=device)


def test_private_batch_shape_equals_reference(circuits, vdata):
    jc, tc, _ = circuits
    jd, td = jc.data, tc.data
    assert td.degree_bits == jd.degree_bits == META["agg_private_batch.bin"]["degree_bits"]
    assert td.num_rows_used == jd.num_rows_used
    assert [g.key() for g in td.gate_types] == [g.key() for g in jd.gate_types]
    for name in ("const_cols", "sel_cols", "sigma_vals", "id_coords"):
        assert np.array_equal(np.asarray(getattr(td, name)), np.asarray(getattr(jd, name))), name
    assert td.target_root == jd.target_root
    mine = _leaf_vdata(tser, td, "agg_private_batch.bin")
    assert mine.to_common_bytes() == _blob("agg_private_batch_common.bin")
    assert mine.to_verifier_only_bytes() == _blob("agg_private_batch_verifier.bin")


@pytest.fixture(scope="module")
def canonical(vdata):
    """The port's shape-only canonical private batch (N = 2)."""
    return tpb.PrivateBatchCircuit(vdata["canonical_leaf"][1], N_LEAF, shape_only=True)


def test_canonical_private_batch_shape_and_witness_equal_reference(canonical, vdata):
    """The canonical N = 2 batch over the leaf fixtures: its common bytes,
    and its witness for the JAX commit (the trace's SHA-256), equal the JAX
    package's."""
    meta = META["canonical_private_batch.bin"]
    assert canonical.data.degree_bits == meta["degree_bits"]
    mine = _leaf_vdata(tser, canonical.data, "canonical_private_batch.bin")
    assert mine.to_common_bytes() == _blob("canonical_private_batch_common.bin")
    assert mine.to_verifier_only_bytes() == _blob("canonical_private_batch_verifier.bin")
    leaf_verifier = twverifier.WormholeVerifier(vdata["canonical_leaf"][1])
    prover = tpb.PrivateBatchProver(canonical, leaf_verifier, _proof("canonical_dummy_leaf.bin"))
    prover.commit([_proof("leaf_proof_real0.bin"), _proof("leaf_proof_real1.bin")],
                  rng=np.random.default_rng(MK.PB_RNG))
    trace, pis = tbuilder.witness_trace(canonical.data,
                                        tpb._batch_witness(canonical, prover._slots, prover._rng))
    assert MK.trace_sha256(trace, canonical.data.num_rows_used) == meta["trace_sha256"]
    assert np.array_equal(pis, _proof("canonical_private_batch.bin").public_inputs)


def test_public_batch_common_bytes_equal_reference(circuits):
    _, _, pub = circuits
    mine = _leaf_vdata(tser, pub.data, "agg_public_batch.bin")
    assert pub.data.degree_bits == META["agg_public_batch.bin"]["degree_bits"]
    assert mine.to_common_bytes() == _blob("agg_public_batch_common.bin")
    assert mine.to_verifier_only_bytes() == _blob("agg_public_batch_verifier.bin")


def _leaves():
    return [_proof("agg_leaf0.bin"), _proof("agg_leaf1.bin")]


def _private_prover(circuit, vdata, template="agg_dummy_leaf.bin"):
    verifier = twverifier.WormholeVerifier(vdata["leaf"][1], enforce_security_floor=False)
    return tpb.PrivateBatchProver(circuit, verifier, _proof(template))


def test_private_batch_witness_equals_reference_and_runs_on_the_tape(circuits, vdata):
    _, tc, _ = circuits
    prover = _private_prover(tc, vdata)
    meta = META["agg_private_batch.bin"]
    want_pis = _proof("agg_private_batch.bin").public_inputs
    for run in range(2):
        prover.commit(_leaves(), rng=np.random.default_rng(MK.PB_RNG))
        pw = tpb._batch_witness(tc, prover._slots, prover._rng)
        if run:
            assert twt.run_tape(tc.data, pw) is not None
        trace, pis = tbuilder.witness_trace(tc.data, pw)
        assert MK.trace_sha256(trace, tc.data.num_rows_used) == meta["trace_sha256"]
        assert np.array_equal(pis, want_pis)


def test_private_batch_public_inputs():
    """tests/test_aggregation.py's checks of the grouping, the dedup and the
    sorted nullifier region, on the fixture's public inputs."""
    parsed = twi.PrivateBatchPublicInputs.from_felts(_proof("agg_private_batch.bin").public_inputs)
    assert parsed.num_exit_slots == 2 * N_LEAF
    assert parsed.block_data.block_number == tth.DEFAULT_BLOCK_NUMBER
    sums = sorted(a.summed_output_amount for a in parsed.account_data)
    assert sums == [0, 0, 0, sum(tth.DEFAULT_OUTPUT_AMOUNTS)]
    i0, i1 = tth.two_real_leaves_same_block()
    assert {bytes(n) for n in parsed.nullifiers} == {bytes(i0.public.nullifier),
                                                      bytes(i1.public.nullifier)}
    key = lambda nf: tuple(int(v) for v in np.frombuffer(nf, dtype="<u8"))  # noqa: E731
    assert sorted(parsed.nullifiers, key=key) == list(parsed.nullifiers)


def test_public_batch_witness_equals_reference(circuits, vdata):
    _, _, pub = circuits
    pb_vd = vdata["private_batch"][1]
    prover = tpub.PublicBatchProver(pub, lambda p: tverifier.verify(pb_vd, p),
                                    _proof("agg_dummy_private_batch.bin"))
    prover.commit([_proof("agg_private_batch.bin")], twi.BytesDigest(MK.PUB_ADDRESS))
    _, pis = tbuilder.witness_trace(pub.data, prover._witness(prover._slots, prover._address))
    assert np.array_equal(pis, _proof("agg_public_batch.bin").public_inputs)
    parsed = twi.PublicBatchPublicInputs.from_felts(pis, 2, N_LEAF)
    assert parsed.aggregator_address == twi.BytesDigest(MK.PUB_ADDRESS)
    sums = [a.summed_output_amount for a in parsed.account_data]
    assert sum(sums) == sum(tth.DEFAULT_OUTPUT_AMOUNTS)
    assert all(s == 0 for s in sums[2 * N_LEAF:])


# ---------------------------------------------------------------------------
# verification


def _error(e: Exception) -> tuple[str, str]:
    """(error class as the JAX package names it, message)."""
    module = type(e).__module__.replace("qp_zk_circuits_tpu_torch", "qp_zk_circuits_tpu")
    return f"{module}.{type(e).__name__}", str(e)


def _outcome(fn):
    """`_error` of what fn() raised, or ("accepted", the repr of what it
    returned, None for None: a verifier's public inputs)."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the class itself is compared
        return _error(e)
    return ("accepted", None if out is None else repr(out))


#: each fixture proof and the verifier data that verifies it
VERIFIED = {
    "agg_leaf0.bin": "leaf", "agg_leaf1.bin": "leaf", "agg_dummy_leaf.bin": "leaf",
    "agg_private_batch.bin": "private_batch", "agg_dummy_private_batch.bin": "private_batch",
    "agg_public_batch.bin": "public_batch",
    "canonical_private_batch.bin": "canonical_private_batch",
    "canonical_dummy_leaf.bin": "canonical_leaf",
}


def _verify_fns(vdata, kind):
    """(JAX, port) verify functions: the Wormhole verifier for leaves (it
    returns the parsed public inputs), the PLONK verifier for batches."""
    jv, tv = vdata[kind]
    if kind.endswith("leaf"):
        floor = kind == "canonical_leaf"
        return (jwverifier.WormholeVerifier(jv, enforce_security_floor=floor).verify,
                twverifier.WormholeVerifier(tv, enforce_security_floor=floor).verify)
    return (lambda p: jverifier.verify(jv, p)), (lambda p: tverifier.verify(tv, p))


@pytest.mark.parametrize("name", list(VERIFIED))
def test_port_verifier_accepts_reference_fixture(vdata, name):
    jfn, tfn = _verify_fns(vdata, VERIFIED[name])
    want = _outcome(lambda: jfn(_proof(name, jser)))
    assert want[0] == "accepted"
    assert _outcome(lambda: tfn(_proof(name))) == want


def _bump(a, at):
    a = np.array(a, dtype=np.uint64)
    a[at] = (int(a[at]) + 1) % P
    return a


def _round(p, fn, i=0):
    fn(p.fri_proof.query_rounds[i])


TAMPERS = {
    "public_input": lambda p: setattr(p, "public_inputs", _bump(p.public_inputs, 3)),
    "opening": lambda p: setattr(p.openings, "quotient", _bump(p.openings.quotient, (2, 1))),
    # the zs_pp oracle's opened row (a salt felt of a ZK proof's row)
    "salted_row": lambda p: _round(
        p, lambda r: r.initial_rows.__setitem__(2, _bump(r.initial_rows[2], -1))),
    "last_round_leaf": lambda p: _round(
        p, lambda r: setattr(r.steps[-1], "leaf_values", _bump(r.steps[-1].leaf_values, (1, 1))),
        i=-1),
    "final_poly": lambda p: setattr(p.fri_proof, "final_poly", _bump(p.fri_proof.final_poly, (3, 0))),
    "pow_witness": lambda p: setattr(p.fri_proof, "pow_witness",
                                     np.uint64(int(p.fri_proof.pow_witness) ^ 1)),
}


@pytest.mark.parametrize("tamper", list(TAMPERS))
@pytest.mark.parametrize("name", ["agg_private_batch.bin", "agg_public_batch.bin",
                                  "canonical_private_batch.bin"])
def test_tampered_batch_proof_rejected_like_reference(vdata, name, tamper):
    jfn, tfn = _verify_fns(vdata, VERIFIED[name])
    jproof, tproof = _proof(name, jser), _proof(name)
    TAMPERS[tamper](jproof)
    TAMPERS[tamper](tproof)
    want = _outcome(lambda: jfn(jproof))
    assert want[0] != "accepted"
    assert _outcome(lambda: tfn(tproof)) == want


# ---------------------------------------------------------------------------
# admission


class _ParseOnly:
    """A leaf verifier that parses the public inputs and checks nothing else:
    it lets admission see leaves the real verifier would refuse."""

    def __init__(self, wi):
        self.wi = wi

    def verify(self, proof):
        return self.wi.PublicCircuitInputs.from_felts(proof.public_inputs)


def _set_pi(index, value, at=0):
    """A copy of leaf `at` with public input `index` set to `value`."""
    def make(ser):
        p = copy.deepcopy(_proof(f"agg_leaf{at}.bin", ser))
        p.public_inputs = np.array(p.public_inputs, dtype=np.uint64)
        p.public_inputs[index] = value
        return p
    return make


def _leaf(at):
    return lambda ser: _proof(f"agg_leaf{at}.bin", ser)


_DUMMY = lambda ser: _proof("agg_dummy_leaf.bin", ser)  # noqa: E731

#: name -> (real verifier?, slot makers); each maker takes a serialization
#: module and returns a proof
ADMISSION = {
    "duplicate_nullifier": (True, [_leaf(0), _leaf(0)]),
    "all_dummy": (True, [_DUMMY, _DUMMY]),
    "batch_size_over": (True, [_leaf(0), _leaf(1), _leaf(0)]),
    "batch_size_empty": (True, []),
    "tampered_leaf": (True, [_set_pi(jwi.OUTPUT_AMOUNT_1_INDEX, 5), _leaf(1)]),
    "non_native_asset_padding": (False, [_set_pi(jwi.ASSET_ID_INDEX, 1)]),
    "non_native_asset_full": (False, [_set_pi(jwi.ASSET_ID_INDEX, 1),
                                      _set_pi(jwi.ASSET_ID_INDEX, 1, at=1)]),
    "asset_mismatch": (False, [_set_pi(jwi.ASSET_ID_INDEX, 1), _leaf(1)]),
    "block_mismatch": (False, [_leaf(0), _set_pi(jwi.BLOCK_NUMBER_INDEX, 99, at=1)]),
    "fee_mismatch": (False, [_leaf(0), _set_pi(jwi.VOLUME_FEE_BPS_INDEX, 11, at=1)]),
}


@pytest.mark.parametrize("name", list(ADMISSION))
def test_private_batch_admission_like_reference(vdata, name):
    """`PrivateBatchProver.commit` of both packages on the same slots (the
    circuit is not reached: a stand-in with N = 2)."""
    real, makers = ADMISSION[name]
    stand_in = types.SimpleNamespace(n_leaf=N_LEAF)
    out = []
    for pb, ser, wi, wv, vd in ((jpb, jser, jwi, jwverifier, vdata["leaf"][0]),
                                (tpb, tser, twi, twverifier, vdata["leaf"][1])):
        verifier = wv.WormholeVerifier(vd, enforce_security_floor=False) if real else _ParseOnly(wi)
        prover = pb.PrivateBatchProver(stand_in, verifier, _DUMMY(ser))
        out.append(_outcome(lambda: prover.commit([m(ser) for m in makers],
                                                  rng=np.random.default_rng(0)) and None))
    assert out[0][0] != "accepted" or name == "non_native_asset_full"
    assert out[1] == out[0]


@pytest.mark.parametrize("template", ["agg_leaf0.bin", "agg_private_batch.bin"])
def test_dummy_templates_checked_like_reference(vdata, template):
    """A real leaf is refused as the leaf layer's dummy template, a real
    private batch as the public layer's."""
    stand_in = types.SimpleNamespace(n_leaf=N_LEAF, m=2)
    out = []
    for pb, pub, ser, wv, kind in ((jpb, jpub, jser, jwverifier, 0), (tpb, tpub, tser,
                                                                       twverifier, 1)):
        proof = _proof(template, ser)
        if template.startswith("agg_leaf"):
            verifier = wv.WormholeVerifier(vdata["leaf"][kind], enforce_security_floor=False)
            out.append(_outcome(lambda: pb.PrivateBatchProver(stand_in, verifier, proof)))
        else:
            fn = _verify_fns(vdata, "private_batch")[kind]
            out.append(_outcome(lambda: pub.PublicBatchProver(stand_in, fn, proof)))
    assert out[0][0] != "accepted"
    assert out[1] == out[0]


@pytest.mark.parametrize("slots", [["agg_dummy_private_batch.bin"],
                                   ["agg_private_batch.bin"] * 3])
def test_public_batch_preflight_like_reference(vdata, slots):
    stand_in = types.SimpleNamespace(n_leaf=N_LEAF, m=2)
    out = []
    for pub, ser, kind in ((jpub, jser, 0), (tpub, tser, 1)):
        fn = _verify_fns(vdata, "private_batch")[kind]
        prover = pub.PublicBatchProver(stand_in, fn, _proof("agg_dummy_private_batch.bin", ser))
        out.append(_outcome(lambda: prover.preflight([_proof(s, ser) for s in slots])))
    assert out[0][0] != "accepted"
    assert out[1] == out[0]


def test_dummy_leaf_inputs_and_preimages_match_reference():
    """The dummy leaf's witness inputs and the rejection-sampled dummy
    nullifier preimages equal the JAX package's."""
    from qp_zk_circuits_tpu.wormhole import dummy_proof as jdummy

    jin, tin = jdummy.build_dummy_circuit_inputs(), tdummy.build_dummy_circuit_inputs()
    assert np.array_equal(tin.public.to_felts(), jin.public.to_felts())
    assert repr(tin.private) == repr(jin.private)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(64):
        assert tdummy.generate_random_nullifier_preimage(tr) == \
            jdummy.generate_random_nullifier_preimage(jr)
    felts = _proof("agg_dummy_leaf.bin").public_inputs
    assert tdummy.is_dummy_proof_pis(felts) and jdummy.is_dummy_proof_pis(felts)
    assert not tdummy.is_dummy_proof_pis(_proof("agg_leaf0.bin").public_inputs)


# ---------------------------------------------------------------------------
# the warm start


def _small_zk_circuit():
    """make_leaf_fixture.py's small ZK circuit, committed on the CPU, and a
    witness for it."""
    spec = importlib.util.spec_from_file_location(
        "make_leaf_fixture", FIXTURES / "make_leaf_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    b, x, y = mod.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cpu")
    pw = tbuilder.PartialWitness()
    pw.set_target(x, 11)
    pw.set_target(y, 13)
    return data, pw


def test_warmup_builds_the_tables_and_tape_and_flips_auto(monkeypatch):
    """`warmup` builds kernels A's and B's tables, records the witness
    program and lowers its tape, makes one throw-away proof in the mode it
    warms for, and from then on `prove(..., rng_mode="auto")` takes that
    mode; before it, "auto" is "host". The proofs themselves (the fused
    prover's, which `prove` takes for this small circuit) are replaced by a
    recorder (the proving path is the ZK tests')."""
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused

    data, pw = _small_zk_circuit()
    modes = []
    monkeypatch.setattr(tfused, "prove_fused", lambda d, pw, seed, mode: modes.append(mode))
    tprover.prove(data, pw, seed=1)
    assert modes == ["host"] and "_torch_tables" not in data.__dict__
    tprover.warmup(data, pw)
    assert modes == ["host", "device"]
    assert {"_torch_tables", "_torch_routing", "_witness_program"} <= set(data.__dict__)
    assert data.__dict__["_witness_tape"][1] is not None
    tprover.prove(data, pw, seed=1)
    tprover.prove(data, pw, seed=1, rng_mode="host")
    assert modes == ["host", "device", "device", "host"]
    tprover.warmup(data, pw, rng_mode="host")
    tprover.prove(data, pw, seed=1)
    assert modes[-2:] == ["host", "host"]
    with pytest.raises(ValueError, match="warm up for"):
        tprover.warmup(data, pw, rng_mode="auto")


def test_warm_start_warms_the_batch_circuits(circuits, vdata, monkeypatch):
    """PrivateBatchProver and PublicBatchProver(warm_start=True) warm their
    circuit with an all-dummy witness."""
    _, tc, pub = circuits
    calls = []
    monkeypatch.setattr(tpb, "warmup", lambda data, pw: calls.append((data, pw)))
    monkeypatch.setattr(tpub, "warmup", lambda data, pw: calls.append((data, pw)))
    tpb.PrivateBatchProver(
        tc, twverifier.WormholeVerifier(vdata["leaf"][1], enforce_security_floor=False),
        _proof("agg_dummy_leaf.bin"), warm_start=True)
    pb_vd = vdata["private_batch"][1]
    tpub.PublicBatchProver(pub, lambda p: tverifier.verify(pb_vd, p),
                           _proof("agg_dummy_private_batch.bin"), warm_start=True)
    assert [c[0] for c in calls] == [tc.data, pub.data]
    dummy = _proof("agg_dummy_leaf.bin")
    pw = calls[0][1]
    want = tbuilder.PartialWitness()
    for pt in tc.proof_targets:
        tpb.fill_proof_targets(want, pt, dummy)
    seeded = dict(pw.all_items())
    assert all(seeded[t] == v for t, v in want.all_items())
    assert set(seeded) == set(dict(want.all_items())) | {
        t for pre in tc.dummy_preimages for t in pre}


# ---------------------------------------------------------------------------
# artifacts: staging, config.json, the pinned aggregation loaders


def _two_packages_outcome(fn):
    """fn(artifacts module of a package) in the JAX package and the port,
    the JAX package's first: ("accepted", its value), or the error's class
    as the JAX package names it and its message."""
    from qp_zk_circuits_tpu.wormhole import artifacts as jart
    from qp_zk_circuits_tpu_torch.wormhole import artifacts as tart

    out = []
    for art in (jart, tart):
        try:
            out.append(("accepted", fn(art)))
        except Exception as e:  # noqa: BLE001 - the class itself is compared
            out.append(_error(e))
    return out


@pytest.mark.parametrize("fail_at", [None, 2, "after_move_aside"])
def test_staging_commit_like_reference(tmp_path, fail_at):
    """The atomic swap: success replaces and cleans up, a failed swap-in
    rolls the old directory back, a failed rollback keeps both copies, in
    both packages (tests/test_artifacts.py's cases); the error's class and
    message (its paths masked) and the files left are the same."""
    import os
    import re

    def run(art):
        root = tmp_path / art.__name__.split(".")[0]
        target = root / "bins"
        target.mkdir(parents=True)
        (target / "old.bin").write_bytes(b"old")
        staging = art.create_staging_dir(target)
        (staging / "new.bin").write_bytes(b"new")
        calls = []

        def rename(src, dst):
            calls.append(src)
            if fail_at == len(calls) or (fail_at == "after_move_aside" and len(calls) > 1):
                raise OSError("injected")
            return os.rename(src, dst)

        try:
            art.commit_staging_dir(staging, target, rename=rename)
            error = None
        except art.ArtifactError as e:
            error = (type(e).__name__, re.sub(r"\S*" + re.escape(str(root)) + r"\S*", "<path>",
                                              str(e)))
        files = sorted((p.parent.name.split("-")[0], p.name, p.read_bytes())
                       for p in root.glob("*/*.bin"))
        return error, files, len(calls)

    jout, tout = _two_packages_outcome(run)
    assert tout == jout
    error, files, _ = tout[1]
    want = {None: (None, [("bins", "new.bin", b"new")]),
            2: ("rolled back", [("bins", "old.bin", b"old"), (".staging", "new.bin", b"new")]),
            "after_move_aside": ("preserved", [(".old", "old.bin", b"old"),
                                               (".staging", "new.bin", b"new")])}[fail_at]
    assert (error is None) == (want[0] is None)
    assert error is None or want[0] in error[1]
    assert sorted(files) == sorted(want[1])


@pytest.mark.parametrize("text", ['{"num_leaf_proofs": 8, "num_private_batch_proofs": 4}',
                                  '{"num_proofs": 3, "num_agg_proofs": 5}',
                                  '{"num_leaf_proofs": 0, "num_private_batch_proofs": 4}',
                                  '{"num_leaf_proofs": 65, "num_private_batch_proofs": 4}',
                                  '{"num_leaf_proofs": 2}'])
def test_bins_config_like_reference(tmp_path, text):
    def load(art):
        path = tmp_path / f"{art.__name__.split('.')[0]}.json"
        path.write_text(text)
        cfg = art.CircuitBinsConfig.load(path)
        cfg.save(path)
        return (cfg.num_leaf_proofs, cfg.num_private_batch_proofs, path.read_text())

    jout, tout = _two_packages_outcome(load)
    assert tout == jout


def _bins_dir(root: Path, flip: str | None = None) -> Path:
    """An aggregation artifact set of the test profile's fixtures (its
    config.json, the private and public batch pairs and the dummy private
    batch), with one byte of `flip` changed."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text('{"num_leaf_proofs": 2, "num_private_batch_proofs": 2}')
    for kind in ("private_batch", "public_batch"):
        for part in ("common", "verifier"):
            (root / f"{kind}_{part}.bin").write_bytes(_blob(f"agg_{kind}_{part}.bin"))
    (root / "dummy_private_batch_proof.bin").write_bytes(_blob("agg_dummy_private_batch.bin"))
    if flip:
        blob = bytearray((root / flip).read_bytes())
        blob[-3] ^= 1
        (root / flip).write_bytes(bytes(blob))
    return root


@pytest.mark.parametrize("flip", [None, "private_batch_verifier.bin", "private_batch_common.bin",
                                  "public_batch_verifier.bin", "public_batch_common.bin"])
def test_pinned_aggregation_loaders_like_reference(tmp_path, flip, vdata):
    """Both layers' loaders pin the artifact pair byte for byte against a
    rebuild (here: the fixture's verifier data) and refuse a flipped byte
    with the JAX package's class and message."""
    def load(art):
        root = _bins_dir(tmp_path / art.__name__.split(".")[0], flip)
        ser = jser if art.__name__.startswith("qp_zk_circuits_tpu.") else tser
        pb = art.load_canonical_private_batch_verifier_data(
            root, rebuild=_pair_vdata(ser, "agg_private_batch"))
        pub = art.load_canonical_public_batch_verifier_data(
            root, rebuild=_pair_vdata(ser, "agg_public_batch"))
        dummy = art.load_dummy_private_batch_proof(root)
        return pb.to_bytes().hex(), pub.to_bytes().hex(), ser.proof_to_bytes(dummy).hex()

    jout, tout = _two_packages_outcome(load)
    assert tout == jout
    assert (jout[0] == "accepted") == (flip is None)


def test_public_batch_loader_verifies_its_dummy(tmp_path, circuits, monkeypatch):
    """`PublicBatchProver.new_from_binaries_dir` pins the private and the
    public batch's verifier data, loads the dummy private batch and verifies
    it with the loaded data before it accepts anything. The JAX package's
    loader raises NameError there (`plonk_verify` is not imported in its
    wormhole/public_batch.py); the port's verifies. The public circuit's
    build is stood in by the shape-only circuit with the fixture's
    constants cap and digest."""
    from qp_zk_circuits_tpu.wormhole import artifacts as jart

    _, _, pub = circuits
    meta = META["agg_public_batch.bin"]
    data = copy.copy(pub.data)
    data.constants_oracle = types.SimpleNamespace(cap=np.array(meta["constants_cap"],
                                                               dtype=np.uint64))
    data.circuit_digest = np.array(meta["circuit_digest"], dtype=np.uint64)
    stand_in = types.SimpleNamespace(data=data, m=pub.m, n_leaf=pub.n_leaf)
    root = _bins_dir(tmp_path / "bins")
    monkeypatch.setattr(tpub, "PublicBatchCircuit", lambda *args, **kw: stand_in)
    prover = tpub.PublicBatchProver.new_from_binaries_dir(
        root, private_batch_rebuild=_pair_vdata(tser, "agg_private_batch"))
    assert tser.proof_to_bytes(prover.dummy_template) == _blob("agg_dummy_private_batch.bin")
    prover.preflight([_proof("agg_private_batch.bin")])
    monkeypatch.setattr(jpub, "PublicBatchCircuit", lambda *args, **kw: stand_in)
    monkeypatch.setattr(jart, "load_canonical_public_batch_verifier_data", lambda *a, **kw: None)
    with pytest.raises(NameError, match="plonk_verify"):
        jpub.PublicBatchProver.new_from_binaries_dir(
            root, private_batch_rebuild=_pair_vdata(jser, "agg_private_batch"))
