"""The port's leaf verifier stack against the JAX package's, on the host.

No JAX graph is built: the proofs are the committed reference fixtures
(tests/torch_fixtures/), and the verifier data is each package's
`VerifierCircuitData` from a shape-only build of the circuit with the
fixture's constants cap and circuit digest. The checks:

  * the port verifies the small-circuit and the leaf fixture through its
    compiled host paths (the constraint tape and the C query rounds), and
    its `WormholeVerifier` returns the reference's public inputs;
  * on each tampered proof both verifiers reject with the same error class
    and message: the port's compiled paths against the reference's native
    library, and the port's pure paths (the Python query loop and vanishing
    walk) against the reference with its native library off;
  * the port's and the reference's C libraries, loaded in one process, each
    compute with their own constants, and a compiler that does not exist
    makes the port's build raise;
  * `keccak256` against the empty-input vector and the reference on seeded
    inputs of 0-300 bytes, the 135- and 136-byte rate edges included;
  * the verifier data's bytes (full, common, verifier-only) equal the
    reference's and hash to the canonical pins;
  * the artifact loaders reject a swapped pair, an oversized blob, a flipped
    byte and a non-canonical profile as the reference does, and
    `new_from_files` rejects an oversized file before reading it.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from qp_zk_circuits_tpu import native as jnat
from qp_zk_circuits_tpu.hash import keccak as jkeccak
from qp_zk_circuits_tpu.hash import merkle as jmerkle
from qp_zk_circuits_tpu.hash import poseidon2 as jps
from qp_zk_circuits_tpu.plonk import serialization as jser
from qp_zk_circuits_tpu.wormhole import artifacts as jartifacts
from qp_zk_circuits_tpu.wormhole import canonical_pins as jpins
from qp_zk_circuits_tpu.wormhole import verifier as jwverifier
from qp_zk_circuits_tpu.wormhole.leaf_circuit import WormholeCircuit as JWormholeCircuit
from qp_zk_circuits_tpu_torch import native as tnat
from qp_zk_circuits_tpu_torch.fri import verifier as tfverifier
from qp_zk_circuits_tpu_torch.hash import keccak as tkeccak
from qp_zk_circuits_tpu_torch.hash import merkle as tmerkle
from qp_zk_circuits_tpu_torch.hash import poseidon2 as tps
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import verifier as tverifier
from qp_zk_circuits_tpu_torch.wormhole import artifacts as tartifacts
from qp_zk_circuits_tpu_torch.wormhole import canonical_pins as tpins
from qp_zk_circuits_tpu_torch.wormhole import verifier as twverifier
from qp_zk_circuits_tpu_torch.wormhole.leaf_circuit import WormholeCircuit as TWormholeCircuit

P = 0xFFFFFFFF00000001
FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())
LEAF = "leaf_proof_inputs0.bin"
SMALL = "small_circuit_proof.bin"


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_leaf_fixture", FIXTURES / "make_leaf_fixture.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vdata(ser, data, name):
    """A package's VerifierCircuitData of shape-only circuit data, with the
    fixture's constants cap and circuit digest."""
    meta = META[name]
    return ser.VerifierCircuitData(
        data.config, data.degree_bits, list(data.gate_types), data.num_selectors,
        data.const_cols.shape[0], np.array(meta["constants_cap"], dtype=np.uint64),
        np.array(meta["circuit_digest"], dtype=np.uint64), len(data.public_input_targets),
    )


@pytest.fixture(scope="module")
def leaf():
    """(reference, port) verifier data of the canonical leaf."""
    return (_vdata(jser, JWormholeCircuit().build(shape_only=True), LEAF),
            _vdata(tser, TWormholeCircuit().build(shape_only=True), LEAF))


@pytest.fixture(scope="module")
def small():
    mk = _fixture_module()
    return tuple(_vdata(ser, mk.small_real_circuit(pkg)[0].build(shape_only=True), SMALL)
                 for ser, pkg in ((jser, "qp_zk_circuits_tpu"), (tser, "qp_zk_circuits_tpu_torch")))


@pytest.fixture
def reference_pure(monkeypatch):
    """The reference verifier on its pure path: no compiled library."""
    monkeypatch.setattr(jps, "_NATIVE", None)


@pytest.fixture
def port_pure(monkeypatch):
    """The port's verifier on its pure paths: the Python query loop and the
    Python walk of the vanishing check, reached by their own names."""
    monkeypatch.setattr(tfverifier, "_query_rounds", tfverifier._query_rounds_pure)
    monkeypatch.setattr(tverifier, "verify_vanishing_at_zeta", tprover._verify_vanishing_pure)


def _compiled_calls():
    return tnat.counts["fri_verify_queries"], tnat.counts["eval_tape"]


def _outcome(fn):
    """(error class as the reference names it, message), or "accepted"."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class itself is compared
        module = type(e).__module__.replace("qp_zk_circuits_tpu_torch", "qp_zk_circuits_tpu")
        return f"{module}.{type(e).__name__}", str(e)
    return "accepted"


# ---------------------------------------------------------------------------
# keccak256


def test_keccak_empty_vector():
    assert tkeccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )


def test_keccak_matches_reference():
    rng = np.random.default_rng(8)
    lengths = [0, 1, 7, 8, 64, 134, 135, 136, 137, 271, 272, 273, 300]
    lengths += [int(n) for n in rng.integers(0, 301, 24)]
    for n in lengths:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tkeccak.keccak256(data) == jkeccak.keccak256(data), n


# ---------------------------------------------------------------------------
# verifier data and pins


def test_verifier_data_bytes_equal_reference(leaf, small):
    for ref, mine in (leaf, small):
        assert mine.to_bytes() == ref.to_bytes()
        assert mine.to_common_bytes() == ref.to_common_bytes()
        assert mine.to_verifier_only_bytes() == ref.to_verifier_only_bytes()
        back = tser.VerifierCircuitData.from_bytes(mine.to_bytes())
        assert back.to_bytes() == mine.to_bytes()


def test_canonical_leaf_artifacts_hash_to_the_pins(leaf):
    _, mine = leaf
    assert tpins.CANONICAL_LEAF_VERIFIER_KECCAK256 == jpins.CANONICAL_LEAF_VERIFIER_KECCAK256
    assert tpins.CANONICAL_LEAF_COMMON_KECCAK256 == jpins.CANONICAL_LEAF_COMMON_KECCAK256
    blobs = tartifacts.leaf_verifier_artifacts(mine)
    assert tartifacts.artifact_keccak(blobs["verifier.bin"]) == tpins.CANONICAL_LEAF_VERIFIER_KECCAK256
    assert tartifacts.artifact_keccak(blobs["common.bin"]) == tpins.CANONICAL_LEAF_COMMON_KECCAK256


def test_merkle_walk_matches_reference():
    rng = np.random.default_rng(9)
    leaf_digest = rng.integers(0, P, 4, dtype=np.uint64)
    siblings = rng.integers(0, P, (5, 4), dtype=np.uint64)
    for index in (0, 1, 22, 31):
        want = jmerkle.merkle_root_from_proof(leaf_digest, index, siblings)
        assert np.array_equal(tmerkle.merkle_root_from_proof(leaf_digest, index, siblings), want)
    row = rng.integers(0, P, 9, dtype=np.uint64)
    cap = rng.integers(0, P, (4, 4), dtype=np.uint64)
    cap[100 >> 5] = jmerkle.merkle_root_from_proof(jps.hash_or_noop(row), 100, siblings)
    for r in (row, row[:3]):
        got = tmerkle.verify_merkle_proof(r, 100, siblings, cap)
        assert got == jmerkle.verify_merkle_proof(r, 100, siblings, cap)
    assert tmerkle.verify_merkle_proof(row, 100, siblings, cap)


# ---------------------------------------------------------------------------
# verification


def test_port_verifies_small_circuit_fixture(small):
    _, mine = small
    tverifier.verify(mine, tser.proof_from_bytes((FIXTURES / SMALL).read_bytes()))


@pytest.mark.parametrize("name", [SMALL, LEAF])
def test_compiled_paths_verify_fixture(leaf, small, name):
    """Each fixture's verify runs one C query verify and one tape, and the
    pure paths accept it too."""
    _, mine = small if name == SMALL else leaf
    fri0, tape0 = _compiled_calls()
    tverifier.verify(mine, tser.proof_from_bytes((FIXTURES / name).read_bytes()))
    assert _compiled_calls() == (fri0 + 1, tape0 + 1)
    mp = pytest.MonkeyPatch()
    mp.setattr(tfverifier, "_query_rounds", tfverifier._query_rounds_pure)
    mp.setattr(tverifier, "verify_vanishing_at_zeta", tprover._verify_vanishing_pure)
    try:
        tverifier.verify(mine, tser.proof_from_bytes((FIXTURES / name).read_bytes()))
    finally:
        mp.undo()
    assert _compiled_calls() == (fri0 + 1, tape0 + 1)


def test_port_verifies_leaf_fixture_from_pinned_artifacts(leaf):
    ref, mine = leaf
    blob = (FIXTURES / LEAF).read_bytes()
    blobs = tartifacts.leaf_verifier_artifacts(mine)
    verifier = twverifier.WormholeVerifier.new_from_bytes(
        blobs["verifier.bin"], blobs["common.bin"], enforce_pins=True)
    got = verifier.verify(tser.proof_from_bytes(blob))
    want = jwverifier.WormholeVerifier(ref).verify(jser.proof_from_bytes(blob))
    assert np.array_equal(got.to_felts(), want.to_felts())
    assert repr(got) == repr(want)


def _bump(a, at):
    a = np.array(a, dtype=np.uint64)
    a[at] = (int(a[at]) + 1) % P
    return a


def _tamper_round(p, fn):
    fn(p.fri_proof.query_rounds[0])


TAMPERS = {
    "public_input": lambda p: setattr(p, "public_inputs", _bump(p.public_inputs, 0)),
    "opening": lambda p: setattr(p.openings, "wires", _bump(p.openings.wires, (3, 0))),
    "quotient_cap": lambda p: setattr(p, "quotient_cap", _bump(p.quotient_cap, (0, 0))),
    "pow_witness": lambda p: setattr(p.fri_proof, "pow_witness",
                                     np.uint64(int(p.fri_proof.pow_witness) + 1)),
    "final_poly": lambda p: setattr(p.fri_proof, "final_poly", _bump(p.fri_proof.final_poly, (0, 1))),
    "initial_row": lambda p: _tamper_round(
        p, lambda r: r.initial_rows.__setitem__(1, _bump(r.initial_rows[1], 5))),
    "merkle_sibling": lambda p: _tamper_round(
        p, lambda r: r.initial_siblings.__setitem__(2, _bump(r.initial_siblings[2], (1, 0)))),
    "fold_leaf": lambda p: _tamper_round(
        p, lambda r: setattr(r.steps[0], "leaf_values", _bump(r.steps[0].leaf_values, (0, 0)))),
    "missing_query_round": lambda p: p.fri_proof.query_rounds.pop(),
    "commit_cap_shape": lambda p: p.fri_proof.commit_caps.__setitem__(
        0, np.asarray(p.fri_proof.commit_caps[0])[:-1]),
}


@pytest.mark.parametrize("name", list(TAMPERS))
def test_tampered_leaf_proof_rejected_like_reference(leaf, reference_pure, port_pure, name):
    ref, mine = leaf
    blob = (FIXTURES / LEAF).read_bytes()
    jproof, tproof = jser.proof_from_bytes(blob), tser.proof_from_bytes(blob)
    TAMPERS[name](jproof)
    TAMPERS[name](tproof)
    want = _outcome(lambda: jwverifier.WormholeVerifier(ref).verify(jproof))
    got = _outcome(lambda: twverifier.WormholeVerifier(mine).verify(tproof))
    assert want != "accepted"
    assert got == want


@pytest.mark.parametrize("name", list(TAMPERS))
def test_tampered_leaf_proof_rejected_like_reference_compiled(leaf, name):
    """The port's compiled paths against the reference's native library:
    the same class and message, query round included."""
    assert jps._native() is not None
    ref, mine = leaf
    blob = (FIXTURES / LEAF).read_bytes()
    jproof, tproof = jser.proof_from_bytes(blob), tser.proof_from_bytes(blob)
    TAMPERS[name](jproof)
    TAMPERS[name](tproof)
    want = _outcome(lambda: jwverifier.WormholeVerifier(ref).verify(jproof))
    got = _outcome(lambda: twverifier.WormholeVerifier(mine).verify(tproof))
    assert want != "accepted"
    assert got == want


# ---------------------------------------------------------------------------
# the host library


def test_both_libraries_in_one_process():
    """Each package's library answers with its own constants: the port's,
    given other tables, changes its permutations and no others; restored,
    it agrees with the reference's again."""
    assert jnat.available()
    states = np.random.default_rng(10).integers(0, P, (3, 12), dtype=np.uint64)
    want = tps._permute_np_pure(states)
    assert tnat.library_path().parent != jnat._SO.parent
    assert np.array_equal(tnat.permute_batch(states), want)
    assert np.array_equal(jnat.permute_batch(states), want)
    int_rcs = tps._constants()[1].copy()
    int_rcs[0] ^= np.uint64(1)
    try:
        tnat.set_constants(tnat.lib(), int_rcs=int_rcs)
        swapped = tnat.permute_batch(states)
        assert not np.array_equal(swapped, want)
        assert np.array_equal(jnat.permute_batch(states), want)
        fold = np.random.default_rng(11).integers(0, P, (3, 4), dtype=np.uint64)
        assert np.array_equal(jnat.merkle_walk(fold[0], 5, fold[1:]),
                              tmerkle._merkle_root_from_proof_pure(fold[0], 5, fold[1:]))
    finally:
        tnat.set_constants(tnat.lib())
    assert np.array_equal(tnat.permute_batch(states), want)


def test_failed_build_raises(tmp_path):
    """A compiler that does not exist: the build raises with its error and
    publishes no library."""
    missing = str(tmp_path / "no-such-cc")
    with pytest.raises(RuntimeError, match="did not build") as err:
        tnat.build(cc=missing)
    assert "no-such-cc" in str(err.value)
    assert not tnat.library_path(missing).exists()


# ---------------------------------------------------------------------------
# artifact loading


def _artifact_cases(ref, mine, small_ref, small_mine):
    """name -> (reference (verifier.bin, common.bin), port pair)."""
    def pair(v):
        return v.to_verifier_only_bytes(), v.to_common_bytes()

    def flip(b, at):
        b = bytearray(b)
        b[at] ^= 1
        return bytes(b)

    huge = b"\x00" * ((1 << 20) + 1)
    cases = {}
    for name, (rv, mv) in (("canonical", (ref, mine)), ("small", (small_ref, small_mine))):
        cases[name] = (pair(rv), pair(mv))
    (rv, rc), (mv, mc) = cases["canonical"]
    cases["swapped"] = ((rc, rv), (mc, mv))
    cases["oversized"] = ((huge, rc), (huge, mc))
    cases["flipped_cap"] = ((flip(rv, 20), rc), (flip(mv, 20), mc))
    cases["flipped_common"] = ((rv, flip(rc, len(rc) - 1)), (mv, flip(mc, len(mc) - 1)))
    cases["truncated"] = ((rv[:-1], rc), (mv[:-1], mc))
    return cases


@pytest.mark.parametrize("name", ["canonical", "small", "swapped", "oversized", "flipped_cap",
                                  "flipped_common", "truncated"])
def test_artifact_pair_loading_matches_reference(leaf, small, name):
    """`from_artifact_bytes`, and `new_from_bytes` with and without the pins:
    the same acceptance, or the same error class and message, at the same
    check (the small circuit's pair is a valid artifact of a profile that
    is not the canonical leaf's)."""
    (rv, rc), (mv, mc) = _artifact_cases(*leaf, *small)[name]
    calls = [
        (lambda v, c: jser.VerifierCircuitData.from_artifact_bytes(v, c),
         lambda v, c: tser.VerifierCircuitData.from_artifact_bytes(v, c)),
        (lambda v, c: jwverifier.WormholeVerifier.new_from_bytes(v, c, enforce_pins=True),
         lambda v, c: twverifier.WormholeVerifier.new_from_bytes(v, c, enforce_pins=True)),
        (lambda v, c: jwverifier.WormholeVerifier.new_from_bytes(v, c, enforce_pins=False),
         lambda v, c: twverifier.WormholeVerifier.new_from_bytes(v, c, enforce_pins=False)),
    ]
    outcomes = []
    for jcall, tcall in calls:
        want = _outcome(lambda: jcall(rv, rc))
        assert _outcome(lambda: tcall(mv, mc)) == want
        outcomes.append(want)
    if name == "canonical":
        assert outcomes == ["accepted"] * 3
    else:
        assert "accepted" not in outcomes[1:]


def test_new_from_files_and_canonical_load(leaf, tmp_path, monkeypatch):
    ref, mine = leaf
    keccaks = tartifacts.write_leaf_verifier_artifacts(tmp_path, mine)
    assert keccaks == {"verifier.bin": tpins.CANONICAL_LEAF_VERIFIER_KECCAK256,
                       "common.bin": tpins.CANONICAL_LEAF_COMMON_KECCAK256}
    v, c = tmp_path / "verifier.bin", tmp_path / "common.bin"
    loaded = twverifier.WormholeVerifier.new_from_files(v, c)
    assert loaded.data.to_bytes() == ref.to_bytes()
    assert tartifacts.load_canonical_leaf_verifier_data(tmp_path, rebuild=mine).to_bytes() == ref.to_bytes()
    c.write_bytes(c.read_bytes()[:-1] + b"\x07")
    got = _outcome(lambda: tartifacts.load_canonical_leaf_verifier_data(tmp_path, rebuild=mine))
    want = _outcome(lambda: jartifacts.load_canonical_leaf_verifier_data(tmp_path, rebuild=ref))
    assert got == want == ("qp_zk_circuits_tpu.wormhole.artifacts.ArtifactError",
                           "common.bin does not match canonical from-source rebuild")
    # an oversized file is refused by its size, before a byte of it is read
    with v.open("wb") as f:
        f.truncate(tartifacts.MAX_VERIFIER_ARTIFACT_BYTES + 1)

    def no_read(self):
        raise AssertionError(f"{self} was read")

    monkeypatch.setattr(Path, "read_bytes", no_read)
    with pytest.raises(tartifacts.ArtifactError, match="exceeds size cap"):
        twverifier.WormholeVerifier.new_from_files(v, c)
