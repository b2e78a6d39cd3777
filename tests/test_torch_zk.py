"""Zero-knowledge proving in the port against the JAX package.

Kernel G's plain version (field/random.py) is held to numpy's independent
Philox4x64-10. The small real circuit of tests/torch_fixtures/
make_leaf_fixture.py under a ZK config, and the Wormhole leaf under the
private batch's config (`wormhole_private_batch_circuit_config`, degree 9),
are proven by the port on the CPU (the kernels' plain versions) and held to
the JAX package's proofs committed by make_leaf_fixture.py: the host-rng
single proof, the JAX package's default (fused) K = 3 batch and a stream of
the same witnesses, all from one rng in proof order. Device-rng proofs
(kernel G's draws) are valid, not byte-equal. Every proof is accepted by
both packages' verifiers, and a copy with one salt felt of an opened row
changed is rejected by both alike. No JAX prover runs here: the
reference's side is its verifier, its shape-only builds and the fixtures.
"""

import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.hash import poseidon2 as jps
from qp_zk_circuits_tpu.plonk import serialization as jser
from qp_zk_circuits_tpu.plonk.verifier import verify as j_verify
from qp_zk_circuits_tpu.utils.config_policy import (
    wormhole_private_batch_circuit_config as j_private_batch_config,
)
from qp_zk_circuits_tpu.wormhole.leaf_circuit import WormholeCircuit as JWormholeCircuit
from qp_zk_circuits_tpu_torch import interop
from qp_zk_circuits_tpu_torch import native as tnat
from qp_zk_circuits_tpu_torch.field import gf_np as TF
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.field import random as frandom
from qp_zk_circuits_tpu_torch.fri import verifier as tfverifier
from qp_zk_circuits_tpu_torch.fri.config import SALT_SIZE
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import verifier as tverifier
from qp_zk_circuits_tpu_torch.utils.config_policy import wormhole_private_batch_circuit_config
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers
from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

FIXTURES = Path(__file__).parent / "torch_fixtures"
P = (1 << 64) - (1 << 32) + 1


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_leaf_fixture", FIXTURES / "make_leaf_fixture.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _fixture_module()
META = json.loads((FIXTURES / "fixtures.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run torch's CPU ops on tensors of a few thousand
    rows: one intra-op thread each keeps them fast when the suite's workers
    share the host's cores (idle threads spinning on a busy host cost
    them up to a hundredfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture(name: str) -> bytes:
    blob = (FIXTURES / name).read_bytes()
    assert len(blob) == META[name]["len"]
    assert hashlib.sha256(blob).hexdigest() == META[name]["sha256"]
    return blob


def _vdata(ser, data, name):
    """A package's VerifierCircuitData of shape-only circuit data, with the
    fixture's constants cap and circuit digest."""
    meta = META[name]
    return ser.VerifierCircuitData(
        data.config, data.degree_bits, list(data.gate_types), data.num_selectors,
        data.const_cols.shape[0], np.array(meta["constants_cap"], dtype=np.uint64),
        np.array(meta["circuit_digest"], dtype=np.uint64), len(data.public_input_targets),
    )


def _j_accepts(vdata, blob: bytes) -> None:
    j_verify(vdata, jser.proof_from_bytes(blob))


# ---------------------------------------------------------------------------
# kernel G's function: Philox4x64-10 and the select rule

#: a key whose block 0 has its third word at or above p (0xffffffff738048d8,
#: stream 1), found by a search over keys: felt 1 takes the fourth word
SELECT_KEY, SELECT_STREAM = 257001637, 1
U64 = (1 << 64) - 1


def _numpy_block(key: int, stream: int, block: int) -> np.ndarray:
    """numpy's Philox block for counter `block`: numpy advances its counter
    before it draws, so it starts one below (all ones for block 0)."""
    counter = np.full(4, U64, dtype=np.uint64) if block == 0 else block - 1
    return np.random.Philox(key=key + (stream << 64), counter=counter).random_raw(4)


@pytest.mark.parametrize("key,stream", [(5, 9), (0, 0), ((1 << 63) - 1, 3), (1 << 62, 1 << 40),
                                        (SELECT_KEY, SELECT_STREAM)])
def test_philox_blocks_equal_numpy(key, stream):
    blocks = [0, 1, 2, 7, 1000, (1 << 33) + 5]
    got = frandom.philox_blocks_plain(key, stream, torch.tensor(blocks)).numpy().view(np.uint64)
    for b, words in zip(blocks, got):
        assert np.array_equal(words, _numpy_block(key, stream, b)), b


def test_rand_felts_take_the_second_word_above_p():
    """Felt 2b is w0 if w0 < p, else w1 reduced; felt 2b + 1 alike from w2,
    w3: the forced case takes w3, and every felt is canonical."""
    words = _numpy_block(SELECT_KEY, SELECT_STREAM, 0)
    assert words[0] < P <= words[2]
    out = torch.empty(2, dtype=torch.int64)
    felts = gl.to_u64(frandom.rand_felts(SELECT_KEY, SELECT_STREAM, out))
    assert felts.tolist() == [int(words[0]), int(words[3]) % P]
    many = gl.to_u64(frandom.rand_felts(3, 2, torch.empty(5001, dtype=torch.int64)))
    assert (many < np.uint64(P)).all()
    for i in (0, 1, 2, 3, 4999, 5000):
        w = _numpy_block(3, 2, i >> 1)[2 * (i & 1):][:2]
        assert int(many[i]) == (int(w[0]) if w[0] < P else int(w[1]) % P)


def test_rand_felts_fill_a_strided_view_in_row_major_order():
    """The blinding rows are filled in place through a strided view, felt i
    at the view's i-th element; the rest of the tensor is left alone."""
    trace = torch.zeros((7, 40), dtype=torch.int64)
    frandom.rand_felts(11, 0, trace[:, 29:])
    flat = frandom.rand_felts(11, 0, torch.empty(7 * 11, dtype=torch.int64))
    assert torch.equal(trace[:, 29:].reshape(-1), flat)
    assert not trace[:, :29].any()
    with pytest.raises(TypeError):
        frandom.rand_felts(1, 0, torch.empty(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        frandom.rand_felts(1 << 64, 0, torch.empty(4, dtype=torch.int64))


@pytest.mark.parametrize("view,plan", [
    # the blinding columns [:, 64:]: even start, even row length and stride
    (lambda t: t[:, 64:], (7, 136, 200, 1, True)),
    # an odd row length: blocks straddle rows, scalar stores
    (lambda t: t[:, 63:], (7, 137, 200, 1, False)),
    # an even row length that starts one felt past 16-byte alignment
    (lambda t: t[:, 1:3], (7, 2, 200, 1, False)),
    # a transposed view: column stride 200
    (lambda t: t.T, (200, 7, 1, 200, False)),
    # one column
    (lambda t: t[:, 5:6], (7, 1, 200, 1, False)),
    # a vector is one row, whatever its stride
    (lambda t: t.reshape(-1)[:1000], (1, 1000, 1000, 1, True)),
    (lambda t: t.reshape(-1)[:1001], (1, 1001, 1001, 1, False)),
    (lambda t: t.reshape(-1)[::2], (1, 700, 1400, 2, False)),
    # an odd row stride: only a single row keeps every pair aligned
    (lambda t: t.reshape(-1)[:21].view(3, 7)[:, :6], (3, 6, 7, 1, False)),
    (lambda t: t.reshape(-1)[:7].view(1, 7)[:, :6], (1, 6, 7, 1, True)),
])
def test_rand_felts_plan(view, plan):
    """Kernel G's launch plan: the (rows, cols) view and its strides, and
    16-byte stores only where no Philox block straddles a row and every
    block's pair is 16-byte aligned."""
    trace = torch.zeros((7, 200), dtype=torch.int64)
    assert trace.data_ptr() % 16 == 0
    assert tuple(frandom.rand_felts_plan(view(trace))) == plan


def test_rand_felts_plan_refuses_2_31_felts(monkeypatch):
    """The kernel's indices are 32-bit: a draw of 2^31 felts or more is
    refused before any launch, never sent down another path; the largest
    draw of the repo (the degree-16 blinding, 135 x 65,472) is far below.
    Meta tensors (no memory, address 0) take the wrapper's CUDA branch."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    assert frandom.rand_felts_plan(meta(frandom.MAX_FELTS)).cols == (1 << 31) - 1
    assert tuple(frandom.rand_felts_plan(meta(135, 65472))) == (135, 65472, 65472, 1, True)
    for shape in ((1 << 31,), (2, 1 << 30), (1 << 16, 1 << 15)):
        with pytest.raises(ValueError, match="fewer than 2\\^31 felts"):
            frandom.rand_felts_plan(meta(*shape))

    def no_launch():
        raise AssertionError("kernel G launched a draw it does not cover")

    monkeypatch.setattr(frandom._cuda, "require_cuda_int64", lambda *tensors: None)
    monkeypatch.setattr(frandom._cuda, "lib", no_launch)
    with pytest.raises(ValueError, match="fewer than 2\\^31 felts"):
        frandom.rand_felts(1, 0, meta(1 << 31))


@pytest.mark.gpu
def test_rand_felts_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for shape in ((135, 252), (3, 1001), (SALT_SIZE, 4096)):
        out = torch.empty(shape, dtype=torch.int64, device="cuda")
        before = frandom.rand_felts.launches
        frandom.rand_felts(7, 2, out)
        assert frandom.rand_felts.launches == before + 1
        want = frandom.rand_felts_plain(7, 2, torch.empty(shape, dtype=torch.int64))
        assert torch.equal(out.cpu(), want)


@pytest.mark.gpu
def test_rand_felts_views_on_card():
    """Kernel G's other paths against the plain version on the card: rows
    that split Philox blocks (an odd start and length), a transposed view,
    one column, a strided vector, and the degree-16 blinding view, larger
    than one grid's worth of blocks; nothing outside the view is written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [((135, 1 << 12), lambda t: t[:, 63:]), ((1 << 12, 135), lambda t: t.T),
             ((4097, 9), lambda t: t[:, 5:6]), ((20001,), lambda t: t[1::2]),
             ((135, 1 << 16), lambda t: t[:, 64:])]
    for shape, view in cases:
        base = torch.zeros(shape, dtype=torch.int64, device="cuda")
        out = view(base)
        before = frandom.rand_felts.launches
        frandom.rand_felts(7, 3, out)
        assert frandom.rand_felts.launches == before + 1
        want = frandom.rand_felts_plain(
            7, 3, torch.empty(tuple(out.shape), dtype=torch.int64, device="cuda"))
        assert torch.equal(out, want), shape
        out.zero_()
        assert not base.any(), shape


# ---------------------------------------------------------------------------
# the small real circuit under a ZK config


def _witnesses(pkg_builder, x, y, which):
    out = []
    for xv, yv in which:
        pw = pkg_builder.PartialWitness()
        pw.set_target(x, xv)
        pw.set_target(y, yv)
        out.append(pw)
    return out


@pytest.fixture(scope="module")
def small():
    """The port's ZK small circuit on the CPU, a maker of its witnesses, and
    the reference's verifier data for it."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cpu")
    jdata = MK.small_real_circuit("qp_zk_circuits_tpu", zk=True)[0].build(shape_only=True)
    return data, lambda which: _witnesses(tbuilder, x, y, which), _vdata(
        jser, jdata, MK.ZK_SMALL_FIXTURE)


@pytest.fixture(scope="module")
def small_proof(small):
    data, pws, _ = small
    return tser.proof_to_bytes(tprover.prove(data, pws(MK.ZK_BATCH_WITNESSES[:1])[0],
                                             seed=MK.ZK_SEED))


@pytest.fixture(scope="module")
def small_batch(small):
    data, pws, _ = small
    return [tser.proof_to_bytes(p) for p in
            tprover.prove_batch(data, pws(MK.ZK_BATCH_WITNESSES), seed=MK.ZK_SEED)]


@pytest.fixture(scope="module")
def device_proofs(small):
    """Two device-rng proofs of the same witness and seed."""
    data, pws, _ = small
    return [tser.proof_to_bytes(tprover.prove(data, pws(MK.ZK_BATCH_WITNESSES[:1])[0],
                                              seed=MK.ZK_SEED, rng_mode="device"))
            for _ in range(2)]


def test_small_zk_circuit_data_equals_reference(small):
    data, _, _ = small
    assert data.config.zero_knowledge and data.n - data.num_rows_used >= tbuilder.ZK_BLINDING_ROWS
    meta = META[MK.ZK_SMALL_FIXTURE]
    assert data.constants_oracle.cap.tolist() == meta["constants_cap"]
    assert data.circuit_digest.tolist() == meta["circuit_digest"]


def test_small_zk_proof_equals_fixture(small_proof):
    assert small_proof == _fixture(MK.ZK_SMALL_FIXTURE)


def test_small_zk_batch_equals_jax_default_batch(small_proof, small_batch):
    """The JAX package's default batch draws each proof in turn from one
    rng, so proof 0 is the single proof of the same seed."""
    assert small_batch == [_fixture(name) for name in MK.ZK_BATCH_FIXTURES]
    assert small_batch[0] == small_proof


def test_small_zk_stream_equals_batch(small, small_batch):
    """A stream of the first two witnesses in chunks of one: the rng runs on
    across the chunks (the K = 3 fixture does not tile chunks of two)."""
    data, pws, _ = small
    proofs = tprover.prove_stream(data, iter(pws(MK.ZK_BATCH_WITNESSES[:2])), 1,
                                  seed=MK.ZK_SEED)
    assert [tser.proof_to_bytes(p) for p in proofs] == small_batch[:2]


def test_zk_batch_witness_draws_in_proof_order(small):
    """`generate_witness_batch` draws each proof's blinding rows and salts
    in turn from one rng, as K `zk_draws` would."""
    data, pws, _ = small
    traces, _, salts = tbuilder.generate_witness_batch(
        data, pws(MK.ZK_BATCH_WITNESSES), np.random.default_rng(4))
    m = data.n << data.config.rate_bits
    assert salts.shape == (3, 3, m, SALT_SIZE)
    rng = np.random.default_rng(4)
    for trace, salt in zip(traces, salts):
        blind, want = tbuilder.zk_draws(data, rng)
        assert np.array_equal(trace[:, data.num_rows_used:], blind)
        assert np.array_equal(salt, want)


def test_generate_witness_blinds_with_the_first_draw(small):
    """`generate_witness` of a ZK circuit: the unblinded trace of
    `witness_trace`, its rows past `num_rows_used` the blinding rows that
    `zk_draws` draws first from the same rng."""
    data, pws, _ = small
    pw = pws(MK.ZK_BATCH_WITNESSES[:1])[0]
    trace, pis = tbuilder.generate_witness(data, pw, np.random.default_rng(5))
    plain, plain_pis = tbuilder.witness_trace(data, pw)
    used = data.num_rows_used
    assert np.array_equal(trace[:, :used], plain[:, :used]) and not plain[:, used:].any()
    assert np.array_equal(pis, plain_pis)
    assert np.array_equal(trace[:, used:], tbuilder.zk_draws(data, np.random.default_rng(5))[0])


def test_small_zk_proofs_verify_in_both_packages(small, small_proof, small_batch, device_proofs):
    data, _, jvdata = small
    for blob in [small_proof, *small_batch, *device_proofs]:
        tverifier.verify(data, tser.proof_from_bytes(blob))
        _j_accepts(jvdata, blob)


def test_device_rng_proofs_are_valid_fresh_and_repeatable(small_proof, device_proofs):
    """Device-rng blinding and salts (kernel G's plain version here) are
    another draw than the host's: not byte-equal to the host-rng proof, the
    same for the same seed."""
    assert device_proofs[0] == device_proofs[1]
    assert device_proofs[0] != small_proof
    assert len(device_proofs[0]) == len(small_proof)


def test_rng_mode_is_checked(small):
    data, pws, _ = small
    with pytest.raises(ValueError, match="rng_mode"):
        tprover.prove(data, pws(MK.ZK_BATCH_WITNESSES[:1])[0], seed=0, rng_mode="threefry")


# ---------------------------------------------------------------------------
# the ZK leaf: the private batch's config


@pytest.fixture(scope="module")
def zk_leaf():
    """(port prover on the CPU, its host-rng proof of test_inputs_0() with
    the fixture's seed, the reference's verifier data)."""
    prover = WormholeProver(wormhole_private_batch_circuit_config(), device="cpu")
    blob = tser.proof_to_bytes(prover.prove_inputs(thelpers.test_inputs_0(),
                                                   seed=MK.LEAF_ZK_SEED))
    jdata = JWormholeCircuit(j_private_batch_config()).build(shape_only=True)
    return prover, blob, jdata


def test_zk_leaf_circuit_data_equals_reference(zk_leaf):
    """The circuit carried across: the JAX package's shape-only arrays give
    the port's own build, and its constants cap, circuit digest and
    VerifierCircuitData bytes are the reference's."""
    prover, _, jdata = zk_leaf
    data = prover.data
    cfg = data.config
    assert (cfg.num_wires, cfg.num_routed_wires, cfg.zero_knowledge) == (135, 60, True)
    assert (data.degree_bits, data.num_rows_used) == (9, 260)
    ref = interop.arrays_of(jdata)
    mine = interop.arrays_of(data)
    for key in ref:
        assert np.array_equal(mine[key], ref[key]), key
    meta = META[MK.LEAF_ZK_FIXTURE]
    assert data.constants_oracle.cap.tolist() == meta["constants_cap"]
    assert data.circuit_digest.tolist() == meta["circuit_digest"]
    want = _vdata(jser, jdata, MK.LEAF_ZK_FIXTURE)
    got = tser.VerifierCircuitData(
        cfg, data.degree_bits, list(data.gate_types), data.num_selectors,
        data.const_cols.shape[0], data.constants_oracle.cap, data.circuit_digest,
        len(data.public_input_targets))
    assert got.to_bytes() == want.to_bytes()


def test_zk_leaf_proof_equals_fixture(zk_leaf):
    _, blob, _ = zk_leaf
    assert blob == _fixture(MK.LEAF_ZK_FIXTURE)


def test_zk_leaf_proof_verified_by_both(zk_leaf):
    prover, blob, jdata = zk_leaf
    fri0, tape0 = tnat.counts["fri_verify_queries"], tnat.counts["eval_tape"]
    WormholeVerifier(prover.data).verify(tser.proof_from_bytes(blob))
    assert (tnat.counts["fri_verify_queries"], tnat.counts["eval_tape"]) == (fri0 + 1, tape0 + 1)
    _j_accepts(_vdata(jser, jdata, MK.LEAF_ZK_FIXTURE), blob)


def _outcome(fn):
    """(error class as the reference names it, message), or "accepted"."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class itself is compared
        module = type(e).__module__.replace("qp_zk_circuits_tpu_torch", "qp_zk_circuits_tpu")
        return f"{module}.{type(e).__name__}", str(e)
    return "accepted"


@pytest.mark.parametrize("oracle", [1, 2, 3])
@pytest.mark.parametrize("path", ["compiled", "pure"])
def test_changed_salt_felt_rejected_like_reference(zk_leaf, monkeypatch, path, oracle):
    """One salt felt of a query's opened row (wires, zs_pp or quotient)
    changed: both verifiers reject it with the same class and message, the
    port's compiled paths against the reference's native library and its
    pure paths against the reference with `_NATIVE` off."""
    prover, blob, jdata = zk_leaf
    if path == "pure":
        monkeypatch.setattr(jps, "_NATIVE", None)
        monkeypatch.setattr(tfverifier, "_query_rounds", tfverifier._query_rounds_pure)
        monkeypatch.setattr(tverifier, "verify_vanishing_at_zeta",
                            tprover._verify_vanishing_pure)
    jproof, tproof = jser.proof_from_bytes(blob), tser.proof_from_bytes(blob)
    for proof in (jproof, tproof):
        rnd = proof.fri_proof.query_rounds[0]
        row = np.array(rnd.initial_rows[oracle], dtype=np.uint64)
        row[-SALT_SIZE] = np.uint64((int(row[-SALT_SIZE]) + 1) % P)
        rnd.initial_rows[oracle] = row
    want = _outcome(lambda: j_verify(_vdata(jser, jdata, MK.LEAF_ZK_FIXTURE), jproof))
    got = _outcome(lambda: WormholeVerifier(prover.data).verify(tproof))
    assert want != "accepted"
    assert got == want


def test_zk_draws_are_the_jax_packages(zk_leaf):
    """`zk_draws` draws in the JAX package's order (prove_staged,
    _flat_input): the blinding rows, then the wires, zs_pp and quotient
    salt seeds, each expanded by its own default_rng; and the committed
    proof's opened wires rows end with the wires salt's rows."""
    prover, blob, _ = zk_leaf
    data = prover.data
    m = data.n << data.config.rate_bits
    rng = np.random.default_rng(MK.LEAF_ZK_SEED)
    blind = TF.rand_felts((data.config.num_wires, data.n - data.num_rows_used), rng)
    salts = [TF.rand_felts((m, SALT_SIZE), np.random.default_rng(int(rng.integers(0, 2**63))))
             for _ in range(3)]
    got_blind, got_salts = tbuilder.zk_draws(data, np.random.default_rng(MK.LEAF_ZK_SEED))
    assert np.array_equal(got_blind, blind) and got_blind.shape == (135, 252)
    assert np.array_equal(got_salts, np.stack(salts))
    rounds = tser.proof_from_bytes(blob).fri_proof.query_rounds
    opened = {tuple(np.asarray(r.initial_rows[1][-SALT_SIZE:]).tolist()) for r in rounds}
    assert opened <= {tuple(row) for row in salts[0].tolist()}
