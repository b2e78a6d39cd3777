"""The port's fused prover (plonk/prover_fused.py) and its kernels I and J
(csrc/transcript.cu) against the JAX package, on the CPU.

The kernels' plain versions run here (a wrapper takes its plain version for
CPU tensors); no JAX prover graph is compiled (the JAX package's grind
compiles one small sweep kernel):

  * kernel I's plain version (`transcript.DeviceChallenger`) gives the JAX
    package's host `Challenger`'s challenges, extension challenges and query
    indices on a short schedule (scalar observes, a bulk absorb of more
    than two rate-chunks, an extension challenge, 11-bit indices) and on
    the leaf proof's whole schedule, from numpy inputs made from a seed;
  * kernel J's plain version (`transcript.grind_plain`) gives the JAX
    package's `grind_pow` lowest-index witness at 8 and 16 bits, also when
    the witness lies past the first sweep; a grind that finds no witness
    below its limit makes the fused prover raise;
  * `prove` dispatches as the JAX package's does: fused at degree_bits <=
    11, staged above until `warmup_fused`, the two overrides, and
    rng_mode "device" on the staged path refused;
  * fused and staged proofs equal the committed fixtures: the leaf (seed
    0), the ZK leaf (host rng, seed 7), and the recursion test's outer
    proof (degree 11: fused with no warm-up); a device-rng proof of the ZK
    small circuit equals the staged device-rng proof and is accepted;
  * a fused leaf proof makes one upload and one download, and no
    `gl.to_u64`, `.tolist()` or `.item()` in between (the plain grind's
    loop tests its done flag, as kernel J does on the card).
"""

import hashlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.plonk import transcript as jts
from qp_zk_circuits_tpu_torch.field import gf_np as TF
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import transcript as tts
from qp_zk_circuits_tpu_torch.plonk import verifier as tverifier
from qp_zk_circuits_tpu_torch.recursion import verifier_gadget as tvg
from qp_zk_circuits_tpu_torch.utils.config_policy import wormhole_private_batch_circuit_config
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers
from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

import qp_zk_circuits_tpu_torch as tpkg

FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())
LEAF = "leaf_proof_inputs0.bin"


def _module(name):
    spec = importlib.util.spec_from_file_location(name, FIXTURES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _module("make_leaf_fixture")
AGG = _module("make_agg_fixture")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions on one intra-op thread (the other port modules'
    rule: idle torch threads spinning on a busy host slowed them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture(name: str) -> bytes:
    blob = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(blob).hexdigest() == META[name]["sha256"]
    return blob


def _felts(rng, *shape):
    return JF.rand_felts(shape, rng)


def _cpu(a) -> torch.Tensor:
    return gl.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


# ---------------------------------------------------------------------------
# kernel I: the transcript


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_transcript_short_schedule_equals_reference(seed):
    """Scalar observes, a bulk absorb of 21 felts (more than two rate-chunks:
    the JAX DeviceChallenger's lax.scan path), an extension challenge,
    11-bit query indices, then a matrix source read through strides and a
    scaled extension pair: the same values as the JAX host Challenger."""
    rng = np.random.default_rng(seed)
    scalars, bulk, mat = _felts(rng, 3), _felts(rng, 21), _felts(rng, 2, 7)
    ref = jts.Challenger()
    for v in scalars:
        ref.observe(v)
    ref.observe_many(bulk)
    want_ext = ref.challenge_ext()
    want_idx = [ref.challenge_index(1 << 11) for _ in range(5)]
    ref.observe_many(mat.T)  # absorbed column by column of (2, 7): the (7, 2) rows
    want_tail = ref.challenge_ext()
    g = 0x1234567
    want_scaled = [int(JF.mul(np.uint64(v), np.uint64(g))) for v in want_tail]

    state = torch.zeros(tts.TS_WORDS, dtype=torch.int64)
    ch = tts.DeviceChallenger(state)
    out = torch.zeros(11, dtype=torch.int64)
    record = torch.zeros(21, dtype=torch.int64)
    ch.segment(observe=[(_cpu(scalars), None), (_cpu(bulk), record)],
               squeeze=[(out[0:2], 0), (out[2:7], 11)])
    ch.segment(observe=[(_cpu(mat).T, None)], squeeze=[(out[7:9], 0)], scale=(out[9:11], g))
    got = gl.to_u64(out).tolist()
    assert got[0:2] == [int(v) for v in want_ext]
    assert got[2:7] == want_idx
    assert got[7:9] == [int(v) for v in want_tail] and got[9:11] == want_scaled
    assert gl.to_u64(record).tolist() == bulk.tolist()
    assert np.array_equal(gl.to_u64(state[:12]), ref.state)
    assert (ch.in_len, ch.out_len) == (len(ref.input_buf), len(ref.output_buf))


def test_device_transcript_leaf_schedule_equals_reference():
    """The leaf proof's whole observe/squeeze schedule (the shapes of the
    committed leaf proof; seeded random values): every challenge, the query
    indices and the final state equal the JAX host Challenger's, segment by
    segment as the fused prover runs them."""
    proof = tser.proof_from_bytes(_fixture(LEAF))
    rng = np.random.default_rng(5)
    nc, lde_bits, g = 2, 11, int(TF.primitive_root_of_unity(8))
    caps = [_felts(rng, *np.asarray(c).shape) for c in (proof.wires_cap, proof.zs_pp_cap,
                                                          proof.quotient_cap)]
    zeta_rows = _felts(rng, proof.openings.batch_zeta().shape[0], 2)
    next_rows = _felts(rng, proof.openings.zs_next.shape[0], 2)
    fri_caps = [_felts(rng, *np.asarray(c).shape) for c in proof.fri_proof.commit_caps]
    final = _felts(rng, *proof.fri_proof.final_poly.shape)
    digest, pi, witness = _felts(rng, 4), _felts(rng, 4), _felts(rng, 1)
    nq = len(proof.fri_proof.query_rounds)

    ref = jts.Challenger()
    ref.observe_many(digest)
    ref.observe_many(pi)
    ref.observe_cap(caps[0])
    want = [ref.challenge_many(nc), ref.challenge_many(nc)]
    ref.observe_cap(caps[1])
    want.append(ref.challenge_many(nc))
    ref.observe_cap(caps[2])
    zeta = ref.challenge_ext()
    want += [zeta, [int(JF.mul(np.uint64(v), np.uint64(g))) for v in zeta]]
    ref.observe_many(zeta_rows)
    ref.observe_many(next_rows)
    want.append(ref.challenge_ext())
    for cap in fri_caps:
        ref.observe_cap(cap)
        want.append(ref.challenge_ext())
    ref.observe_many(final)
    ref.observe(witness[0])
    want += [[ref.challenge()], [ref.challenge_index(1 << lde_bits) for _ in range(nq)]]

    ch = tts.DeviceChallenger(torch.zeros(tts.TS_WORDS, dtype=torch.int64))
    slots = [torch.zeros(len(w), dtype=torch.int64) for w in want]
    openings = _cpu(np.concatenate([zeta_rows, next_rows]))
    # the final polynomial as the fused prover holds it: (2, m_f) rows, read transposed
    final_rows = _cpu(np.ascontiguousarray(final.T))
    ch.segment(observe=[(_cpu(digest), None), (_cpu(pi), None), (_cpu(caps[0]), None)],
               squeeze=[(slots[0], 0), (slots[1], 0)])
    ch.segment(observe=[(_cpu(caps[1]), None)], squeeze=[(slots[2], 0)])
    ch.segment(observe=[(_cpu(caps[2]), None)], squeeze=[(slots[3], 0)], scale=(slots[4], g))
    ch.segment(observe=[(openings, None)], squeeze=[(slots[5], 0)])
    for r, cap in enumerate(fri_caps):
        ch.segment(observe=[(_cpu(cap), None)], squeeze=[(slots[6 + r], 0)])
    ch.segment(observe=[(final_rows.T, None)])
    ch.segment(observe=[(_cpu(witness), None)],
               squeeze=[(slots[-2], 0), (slots[-1], lde_bits)])
    for got, w in zip(slots, want, strict=True):
        assert gl.to_u64(got).tolist() == [int(v) for v in w]
    assert np.array_equal(gl.to_u64(ch.state[:12]), ref.state)
    assert ch.permutations > 100


# ---------------------------------------------------------------------------
# kernel J: the grind


def _grind_pair(seed: int, felts: int):
    """A JAX host Challenger and a device transcript after the same
    observes."""
    vals = _felts(np.random.default_rng(seed), felts)
    ref = jts.Challenger()
    ref.observe_many(vals)
    ch = tts.DeviceChallenger(torch.zeros(tts.TS_WORDS, dtype=torch.int64))
    ch.segment(observe=[(_cpu(vals), None)])
    return ref, ch


@pytest.mark.parametrize("bits, seed", [(8, 0), (8, 1), (16, 2)])
def test_device_grind_equals_reference_lowest_witness(bits, seed):
    ref, ch = _grind_pair(seed, 13)
    want = jts.grind_pow(ref, bits, batch=1 << 12)
    words = torch.tensor([0, -1], dtype=torch.int64)
    ch.grind(bits, words)
    assert int(words[1]) == int(want)
    assert jts.check_pow(ref.fork(), want, bits)


def test_device_grind_past_the_first_sweep_keeps_the_lowest_witness():
    """A sweep of 16 candidates at 8 bits: the witness lies in a later sweep,
    and the plain grind still returns the JAX package's lowest one; with a
    limit at the witness's sweep it finds none (words[1] stays -1)."""
    ref, ch = _grind_pair(7, 5)
    want = int(jts.grind_pow(ref, 8, batch=1 << 12))
    assert want >= 16
    words = torch.tensor([0, -1], dtype=torch.int64)
    tts.grind_plain(ch.state, ch.in_len, 8, words, batch=16)
    assert int(words[1]) == want and int(words[0]) == (want // 16 + 1) * 16
    words = torch.tensor([0, -1], dtype=torch.int64)
    tts.grind_plain(ch.state, ch.in_len, 8, words, limit=want // 16 * 16, batch=16)
    assert int(words[1]) == -1


# ---------------------------------------------------------------------------
# dispatch


@pytest.fixture
def recorded(monkeypatch):
    """`prove_fused` and `prove_staged` replaced by a recorder of (path,
    mode); the QZKT overrides cleared."""
    calls = []
    monkeypatch.setattr(tfused, "prove_fused", lambda d, pw, seed, mode: calls.append(
        ("fused", mode)))
    monkeypatch.setattr(tprover, "prove_staged", lambda d, pw, seed, mode, mesh: calls.append(
        ("staged", mode)))
    for var in ("QZKT_STAGED_PROVER", "QZKT_FORCE_FUSED"):
        monkeypatch.delenv(var, raising=False)
    return calls


def _stand_in(degree_bits: int):
    return SimpleNamespace(degree_bits=degree_bits,
                           config=SimpleNamespace(rate_bits=3, max_quotient_degree_factor=8))


@pytest.mark.parametrize("degree_bits, path", [(8, "fused"), (9, "fused"), (11, "fused"),
                                               (12, "staged"), (16, "staged")])
def test_prove_dispatches_by_degree(recorded, degree_bits, path):
    tprover.prove(_stand_in(degree_bits), None, seed=0)
    assert recorded == [(path, "host" if path == "fused" else "auto")]


def test_warmup_flips_a_large_circuit_onto_the_fused_prover(recorded, monkeypatch):
    """Above degree 11 `prove` is staged (rng_mode "device" refused there)
    until `warmup_fused` builds the fused bundle; then fused in the mode it
    warmed for. QZKT_STAGED_PROVER=1 forces staged, QZKT_FORCE_FUSED=1
    fused."""
    data = _stand_in(14)
    monkeypatch.setattr(tbuilder, "witness_root_values", lambda d, pw: None)
    monkeypatch.setattr(tprover, "witness_root_values", lambda d, pw: None)
    monkeypatch.setattr(tfused, "fused_bundle",
                        lambda d: d.__dict__.setdefault("_torch_fused", object()))
    tprover.prove(data, None, seed=0)
    with pytest.raises(ValueError, match="requires the fused prover"):
        tprover.prove(data, None, seed=0, rng_mode="device")
    tprover.warmup_fused(data, None, rng_mode="host")
    tprover.prove(data, None, seed=0)
    tprover.prove(data, None, seed=0, rng_mode="device")
    assert recorded == [("staged", "auto"), ("fused", "host"), ("fused", "host"),
                        ("fused", "device")]
    monkeypatch.setenv("QZKT_STAGED_PROVER", "1")
    tprover.prove(data, None, seed=0)
    monkeypatch.delenv("QZKT_STAGED_PROVER")
    monkeypatch.setenv("QZKT_FORCE_FUSED", "1")
    tprover.prove(_stand_in(16), None, seed=0)
    assert recorded[-2:] == [("staged", "auto"), ("fused", "host")]


# ---------------------------------------------------------------------------
# the proofs


class _Spy:
    """Counts the fused path's two transfer helpers and any `gl.to_u64`,
    `Tensor.tolist` or `Tensor.item` call between them."""

    def __init__(self, monkeypatch):
        self.transfers, self.between, self.open = [], [], False
        up, down = tfused._upload, tfused._download

        def upload(*args):
            self.transfers.append("up")
            self.open = True
            return up(*args)

        def download(*args):
            self.transfers.append("down")
            self.open = False
            return down(*args)

        monkeypatch.setattr(tfused, "_upload", upload)
        monkeypatch.setattr(tfused, "_download", download)
        for owner, name in ((gl, "to_u64"), (torch.Tensor, "tolist"), (torch.Tensor, "item")):
            monkeypatch.setattr(owner, name, self._watch(name, getattr(owner, name)))

    def _watch(self, name, fn):
        def inner(*args, **kwargs):
            if self.open:
                self.between.append(name)
            return fn(*args, **kwargs)
        return inner


@pytest.fixture(scope="module")
def leaf():
    return WormholeProver(device="cpu")


@pytest.fixture(scope="module")
def leaf_fused(leaf):
    """The leaf's fused proof (seed 0), its transfers and reads recorded."""
    with pytest.MonkeyPatch.context() as mp:
        spy = _Spy(mp)
        assert tprover.uses_fused(leaf.data)
        blob = tser.proof_to_bytes(leaf.prove_inputs(thelpers.test_inputs_0(), seed=0))
    return blob, spy


def test_fused_leaf_proof_equals_fixture(leaf, leaf_fused):
    blob, _ = leaf_fused
    assert blob == _fixture(LEAF)
    timings = leaf.data.__dict__["_last_prove_timings"]
    assert {"witness_pack_s", "upload_s", "dispatch_s", "execute_fetch_s", "unpack_s",
            "flat_in_mb", "flat_out_mb"} <= set(timings) and timings["rng_mode"] == "host"


def test_fused_leaf_proof_makes_one_upload_and_one_download(leaf_fused):
    _, spy = leaf_fused
    assert spy.transfers == ["up", "down"]
    assert spy.between == []


def test_staged_leaf_proof_equals_fixture(leaf):
    pw = leaf._partial_witness(thelpers.test_inputs_0())
    assert tser.proof_to_bytes(tprover.prove_staged(leaf.data, pw, seed=0)) == _fixture(LEAF)


@pytest.fixture(scope="module")
def zk_leaf():
    return WormholeProver(wormhole_private_batch_circuit_config(), device="cpu")


@pytest.mark.parametrize("path", ["fused", "staged"])
def test_zk_leaf_proof_equals_fixture(zk_leaf, path):
    """The ZK leaf (degree 9) in host rng, seed 7: `prove_inputs` takes the
    fused prover; `prove_staged` the staged one; both the fixture."""
    assert zk_leaf.data.degree_bits == 9 and tprover.uses_fused(zk_leaf.data)
    inputs = thelpers.test_inputs_0()
    if path == "fused":
        proof = zk_leaf.prove_inputs(inputs, seed=MK.LEAF_ZK_SEED)
    else:
        proof = tprover.prove_staged(zk_leaf.data, zk_leaf._partial_witness(inputs),
                                     seed=MK.LEAF_ZK_SEED)
    assert tser.proof_to_bytes(proof) == _fixture(MK.LEAF_ZK_FIXTURE)


@pytest.fixture(scope="module")
def small_zk():
    """The ZK small circuit on the CPU and a witness of it."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cpu")
    pw = tbuilder.PartialWitness()
    pw.set_target(x, 11)
    pw.set_target(y, 13)
    return data, pw


def test_device_rng_fused_proof_is_accepted_and_equals_staged(small_zk):
    """A device-rng proof of the ZK small circuit through the fused prover:
    kernel G's streams of the seed's key, as the staged device-rng proof
    draws them, so the same bytes; accepted."""
    data, pw = small_zk
    assert tprover.uses_fused(data)
    fused = tprover.prove(data, pw, seed=MK.ZK_SEED, rng_mode="device")
    tverifier.verify(data, fused)
    blob = tser.proof_to_bytes(fused)
    staged = tprover.prove_staged(data, pw, seed=MK.ZK_SEED, rng_mode="device")
    assert blob == tser.proof_to_bytes(staged)
    assert data.__dict__["_last_prove_timings"]["rng_mode"] == "device"


def test_recursion_outer_proof_takes_the_fused_path_and_equals_fixture():
    """tests/test_recursion.py's outer circuit (degree 11) over the committed
    inner proof: `prove` takes the fused prover with no warm-up, and the
    bytes are the JAX package's outer proof."""
    _, _, _, _, outer, pt = AGG.recursion_circuits(tpkg, lambda b: b.build(device="cpu"))
    assert outer.degree_bits == 11 and tprover.uses_fused(outer)
    assert "_warm_rng_mode" not in outer.__dict__
    pw = tbuilder.PartialWitness()
    tvg.fill_proof_targets(pw, pt, tser.proof_from_bytes(_fixture("recursion_inner_proof.bin")))
    proof = tprover.prove(outer, pw, seed=META["recursion_outer_proof.bin"]["seed"])
    assert "_torch_fused" in outer.__dict__
    assert tser.proof_to_bytes(proof) == _fixture("recursion_outer_proof.bin")


def test_a_grind_without_a_witness_raises(small_zk, monkeypatch):
    """Kernel J's limit reached with no witness leaves 2^64 - 1 as its best:
    the fused prover raises at the download and returns no proof."""
    data, pw = small_zk
    assert data.config.fri_config.proof_of_work_bits
    real = tts.grind_device
    monkeypatch.setattr(tts, "grind_device", lambda state, in_len, bits, words, limit=None: real(
        state, in_len, bits, words, limit=1))
    # seed 1's witness is 2 at the circuit's 1 PoW bit: candidate 0 fails
    with pytest.raises(RuntimeError, match="no witness"):
        tprover.prove(data, pw, seed=1, rng_mode="host")
