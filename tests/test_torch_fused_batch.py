"""The port's fused batch and stream (plonk/prover_fused.py::
prove_fused_batch, prove_fused_stream) and kernels I and J with a proof
axis against the JAX package, on the CPU.

The kernels' plain versions run here; no vmapped JAX prover graph is
compiled (make_leaf_fixture.py records that one did not finish in two hours
on a CPU), only the JAX package's DeviceChallenger and its grind under
jax.vmap on a short schedule:

  * kernel I's batch form (`transcript.transcript_segment_batch_plain`) on
    K = 3 transcripts of one short schedule with random values equals three
    single `transcript_segment_plain` runs and the JAX DeviceChallenger
    under jax.vmap;
  * kernel J's (`grind_batch_plain`) equals K single `grind_plain`s and the
    JAX `_grind_j` under jax.vmap, each proof its lowest witness, some past
    the first sweep;
  * the fused batch equals the committed fixtures: the ZK small circuit's
    K = 3 host-rng batch (the JAX package's default `prove_batch`) and the
    leaf's two real spends; the fused stream equals the fused batch;
  * `prove_batch`, `prove_stream`, `prove_inputs_batch` and
    `prove_inputs_stream` take the fused forms by default and the staged
    ones under QZKT_STAGED_PROVER=1;
  * a batch makes one upload and one download and nothing read back in
    between, the stream's upload slots alternate;
  * through a stand-in kernel library, at K = 17 kernels A-F take a launch
    a group of 16 proofs with each proof's record a row of the upload
    apart, and kernels I and J one launch for all 17.
"""

import contextlib
import ctypes
import functools
import hashlib
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.field import goldilocks as jgl
from qp_zk_circuits_tpu.plonk import prover_fused as jfused
from qp_zk_circuits_tpu_torch import _cuda
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.fri import oracle as fo
from qp_zk_circuits_tpu_torch.fri import prover as tfri
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import transcript as tts
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers
from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())


def _module(name):
    spec = importlib.util.spec_from_file_location(name, FIXTURES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _module("make_leaf_fixture")
STAGED = "QZKT_STAGED_PROVER"


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


def _cpu(a) -> torch.Tensor:
    return gl.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


# ---------------------------------------------------------------------------
# kernel I over K transcripts


K3 = 3
G = 0x1234567


def _port_schedule(states, digest, scalars, bulk, mat_t, out, record):
    """The short schedule on a DeviceChallengerBatch: a shared digest (a
    stride-0 source), 3 scalars, a bulk absorb of 21 felts recorded, an
    extension challenge and five 11-bit indices; then a (7, 2) matrix read
    through strides, an extension challenge scaled by G."""
    ch = tts.DeviceChallengerBatch(states)
    ch.segment(observe=[(digest.expand(len(ch), -1), None), (scalars, None), (bulk, record)],
               squeeze=[(out[:, 0:2], 0), (out[:, 2:7], 11)])
    ch.segment(observe=[(mat_t.transpose(1, 2), None)], squeeze=[(out[:, 7:9], 0)],
               scale=(out[:, 9:11], G))
    return ch


@functools.cache
def _jax_schedule_vmapped():
    """The JAX schedule under jax.vmap (the digest shared), jitted once."""
    return jax.jit(jax.vmap(_jax_schedule, in_axes=(None, 0, 0, 0)))


def _jax_schedule(digest, scalars, bulk, mat):
    ch = jfused.DeviceChallenger()
    ch.observe_many(digest)
    for i in range(3):
        ch.observe(scalars[i])
    ch.observe_many(bulk)
    ext = ch.challenge_many(2)
    idx = jnp.stack([ch.challenge_index_bits(11) for _ in range(5)])
    ch.observe_many(mat)
    tail = ch.challenge_many(2)
    return ext, idx, tail, ch.state


@pytest.mark.parametrize("seed", [0, 1])
def test_transcript_batch_plain_equals_singles_and_jax_vmap(seed):
    rng = np.random.default_rng(seed)
    digest = JF.rand_felts((4,), rng)
    scalars, bulk = JF.rand_felts((K3, 3), rng), JF.rand_felts((K3, 21), rng)
    mat = JF.rand_felts((K3, 7, 2), rng)
    # the states rows of a wider buffer, the outputs a row a proof apart
    states = torch.zeros((K3, tts.TS_WORDS + 3), dtype=torch.int64)[:, : tts.TS_WORDS]
    rows = torch.zeros((K3, 11 + 21 + 2), dtype=torch.int64)
    out, record = rows[:, :11], rows[:, 11:32]
    ch = _port_schedule(states, _cpu(digest), _cpu(scalars), _cpu(bulk),
                        _cpu(np.ascontiguousarray(np.swapaxes(mat, 1, 2))), out, record)
    for i in range(K3):
        state = torch.zeros(tts.TS_WORDS, dtype=torch.int64)
        single = tts.DeviceChallenger(state)
        o, r = torch.zeros(11, dtype=torch.int64), torch.zeros(21, dtype=torch.int64)
        single.segment(observe=[(_cpu(digest), None), (_cpu(scalars[i]), None),
                                (_cpu(bulk[i]), r)], squeeze=[(o[0:2], 0), (o[2:7], 11)])
        single.segment(observe=[(_cpu(mat[i]), None)], squeeze=[(o[7:9], 0)], scale=(o[9:11], G))
        assert torch.equal(o, out[i]) and torch.equal(r, record[i]) and torch.equal(state, states[i])
        assert (single.in_len, single.out_len, single.permutations) == (
            ch.in_len, ch.out_len, ch.permutations)
    assert gl.to_u64(record).tolist() == bulk.tolist()

    ext, idx, tail, st = _jax_schedule_vmapped()(
        jgl.from_u64(digest), jgl.from_u64(scalars), jgl.from_u64(bulk), jgl.from_u64(mat))
    got = gl.to_u64(out)
    assert got[:, 0:2].tolist() == jgl.to_u64(ext).tolist()
    assert got[:, 2:7].tolist() == np.asarray(idx).tolist()
    tail = jgl.to_u64(tail)
    assert got[:, 7:9].tolist() == tail.tolist()
    assert got[:, 9:11].tolist() == JF.mul(tail, np.uint64(G)).tolist()
    assert np.array_equal(gl.to_u64(states[:, :12]), jgl.to_u64(st))


# ---------------------------------------------------------------------------
# kernel J over K grinds

#: seed 0's four transcripts (13 felts observed each): 8-bit witnesses 150,
#: 728, 94, 180 (728 past the JAX grind's first sweep of 256), 6-bit 6, 30,
#: 94, 180 (each but the first past a plain sweep of 16)
GRIND_SEED, K4 = 0, 4


@pytest.mark.parametrize("bits", [6, 8])
def test_grind_batch_plain_equals_singles_and_jax_vmap(bits):
    vals = JF.rand_felts((K4, 13), np.random.default_rng(GRIND_SEED))
    states = torch.zeros((K4, tts.TS_WORDS), dtype=torch.int64)
    ch = tts.DeviceChallengerBatch(states)
    ch.segment(observe=[(_cpu(vals), None)])
    words = torch.tensor([[0, -1]] * K4, dtype=torch.int64)
    tts.grind_batch_plain(states, ch.in_len, bits, words, batch=16)
    for i in range(K4):
        single = torch.tensor([0, -1], dtype=torch.int64)
        tts.grind_plain(states[i].clone(), ch.in_len, bits, single, batch=16)
        assert torch.equal(single, words[i])

    def jax_grind(v):
        c = jfused.DeviceChallenger()
        c.observe_many(v)
        return jfused._grind_j(c, bits, batch=256)

    want = jgl.to_u64(jax.jit(jax.vmap(jax_grind))(jgl.from_u64(vals)))
    assert words[:, 1].tolist() == want.tolist()
    assert max(want) >= 16 and (bits == 6 or max(want) >= 256)
    # the lowest: no candidate below a proof's witness passes
    for i, w in enumerate(want.tolist()):
        below = torch.tensor([0, -1], dtype=torch.int64)
        tts.grind_plain(states[i].clone(), ch.in_len, bits, below, limit=w, batch=16)
        assert int(below[1]) == -1


def test_batch_limits_refuse_what_the_kernels_do_not_take():
    """K = 0, overlapping proof rows, an operand of another element size (its
    proof stride not whole int64 felts), a squeeze of other rows."""
    good = torch.zeros((2, tts.TS_WORDS), dtype=torch.int64)
    dst = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="K >= 1"):
        tts.transcript_segment_batch(good[:0], 0, 0, squeeze=[(dst[:0], 0)])
    overlap = torch.zeros(40, dtype=torch.int64).as_strided((2, tts.TS_WORDS), (5, 1))
    with pytest.raises(ValueError, match="overlap"):
        tts.transcript_segment_batch(overlap, 0, 0, squeeze=[(dst, 0)])
    with pytest.raises(ValueError, match="overlap"):
        tts.transcript_segment_batch(good, 0, 0, squeeze=[(dst.as_strided((2, 4), (2, 1)), 0)])
    with pytest.raises(TypeError, match="int64"):
        tts.transcript_segment_batch(good, 0, 0, squeeze=[(dst.to(torch.int32), 0)])
    with pytest.raises(ValueError, match="of 3 proofs"):
        tts.transcript_segment_batch(good, 0, 0, observe=[(torch.zeros((3, 4), dtype=torch.int64),
                                                           None)])
    with pytest.raises(ValueError, match="contiguous"):
        tts.transcript_segment_batch(good, 0, 0, squeeze=[(dst.T.contiguous().T, 0)])
    with pytest.raises(ValueError, match="K >= 1"):
        tts.grind_device_batch(good[:0], 0, 8, torch.zeros((0, 2), dtype=torch.int64))
    with pytest.raises(TypeError, match="int64"):
        tts.grind_device_batch(good, 0, 8, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="overlap"):
        tts.grind_device_batch(good, 0, 8, torch.zeros(4, dtype=torch.int64).as_strided(
            (2, 2), (1, 1)))


# ---------------------------------------------------------------------------
# whole batches and streams


def _witnesses(pkg_builder, x, y, pairs):
    out = []
    for xv, yv in pairs:
        pw = pkg_builder.PartialWitness()
        pw.set_target(x, xv)
        pw.set_target(y, yv)
        out.append(pw)
    return out


@pytest.fixture(scope="module")
def small():
    """The small real circuit (non-ZK) on the CPU and its fused batch of
    three witnesses."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch")
    data = b.build(device="cpu")
    pws = lambda: _witnesses(tbuilder, x, y, [MK.SMALL_WITNESS, (12, 17), (5, 40)])  # noqa: E731
    return data, pws, [tser.proof_to_bytes(p) for p in tfused.prove_fused_batch(data, pws(),
                                                                                 seed=0)]


class _Transfers:
    """Records `_upload` (with its slot) and `_download`, and any
    `gl.to_u64`, `Tensor.tolist` or `Tensor.item` call while an upload
    waits for its download."""

    def __init__(self, monkeypatch):
        self.calls, self.between, self.open = [], [], False
        up, down = tfused._upload, tfused._download

        def upload(flat, b, slot=0):
            self.calls.append(("up", slot))
            self.open = True
            return up(flat, b, slot)

        def download(*args):
            self.calls.append(("down",))
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
def leaf_batch():
    """The leaf's fused batch of the two real spends, its transfers and
    reads recorded."""
    prover = WormholeProver(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(STAGED, raising=False)
        spy = _Transfers(mp)
        proofs = prover.prove_inputs_batch(list(thelpers.two_real_leaves_same_block()), seed=0)
    return prover, proofs, spy


def test_fused_leaf_batch_equals_fixtures(leaf_batch):
    prover, proofs, _ = leaf_batch
    verifier = WormholeVerifier(prover.data)
    for proof, name in zip(proofs, MK.REAL_LEAF_FIXTURES, strict=True):
        assert tser.proof_to_bytes(proof) == _fixture(name)
        verifier.verify(proof)
    timings = prover.data.__dict__["_last_prove_timings"]
    assert timings["proofs"] == 2 and timings["rng_mode"] == "host"
    assert {"witness_pack_s", "upload_s", "dispatch_s", "execute_fetch_s", "unpack_s",
            "flat_in_mb", "flat_out_mb", "device_roundtrip_s"} <= set(timings)


def test_fused_batch_makes_one_upload_and_one_download(leaf_batch):
    _, _, spy = leaf_batch
    assert spy.calls == [("up", 0), ("down",)]
    assert spy.between == []


def test_fused_zk_batch_equals_jax_default_batch():
    """The ZK small circuit, K = 3, host rng from one rng (ZK_SEED): the JAX
    package's default `prove_batch` (small_zk_batch0..2.bin)."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cpu")
    proofs = tfused.prove_fused_batch(data, _witnesses(tbuilder, x, y, MK.ZK_BATCH_WITNESSES),
                                      seed=MK.ZK_SEED)
    assert [tser.proof_to_bytes(p) for p in proofs] == [
        _fixture(name) for name in MK.ZK_BATCH_FIXTURES]


def test_fused_stream_equals_fused_batch(small, monkeypatch):
    """Six witnesses from a generator in chunks of three: each chunk the
    fused batch's proofs; two uploads into alternating slots, each chunk's
    download after the next chunk's upload."""
    data, pws, batch3 = small
    spy = _Transfers(monkeypatch)
    items = pws() + pws()
    got = tfused.prove_fused_stream(data, (pw for pw in items), 3, seed=0)
    assert [tser.proof_to_bytes(p) for p in got] == batch3 + batch3
    assert spy.calls == [("up", 0), ("up", 1), ("down",), ("down",)]
    assert data.__dict__["_last_prove_timings"]["chunks"] == 2


def test_fused_stream_length_and_source_errors(small):
    data, pws, _ = small
    with pytest.raises(AssertionError, match="tile"):
        tfused.prove_fused_stream(data, pws(), 2)  # a list of 3: checked first
    with pytest.raises(AssertionError, match="tile"):
        tfused.prove_fused_stream(data, (pw for pw in pws()), 4)  # the short chunk

    def broken():
        yield from pws()[:1]
        raise KeyError("witness source failed")

    with pytest.raises(KeyError, match="witness source failed"):
        tfused.prove_fused_stream(data, broken(), 2)


# ---------------------------------------------------------------------------
# the staged batch and stream, kept under QZKT_STAGED_PROVER=1


@pytest.fixture
def staged(monkeypatch):
    """QZKT_STAGED_PROVER set, and each `prove_from_traces` batch's size
    recorded (the staged forms prove a chunk through it)."""
    monkeypatch.setenv(STAGED, "1")
    sizes = []
    real = tprover.prove_from_traces

    def prove_from_traces(data, traces, *args, **kwargs):
        sizes.append(len(traces))
        return real(data, traces, *args, **kwargs)

    monkeypatch.setattr(tprover, "prove_from_traces", prove_from_traces)
    return sizes


def test_staged_batch_equals_fused_batch_and_jax_proof(small, staged):
    """The staged small batch's proofs are the fused batch's, the first the
    JAX package's committed proof of its witness."""
    data, pws, batch3 = small
    got = [tser.proof_to_bytes(p) for p in tprover.prove_batch(data, pws(), seed=0)]
    assert staged == [3]
    assert got == batch3
    assert got[0] == _fixture("small_circuit_proof.bin")


def test_staged_zk_batch_equals_jax_default_batch(staged):
    """The staged ZK batch draws host-rng as the fused batch does: the JAX
    package's default `prove_batch` (small_zk_batch0..2.bin)."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cpu")
    proofs = tprover.prove_batch(data, _witnesses(tbuilder, x, y, MK.ZK_BATCH_WITNESSES),
                                 seed=MK.ZK_SEED)
    assert staged == [3]
    assert [tser.proof_to_bytes(p) for p in proofs] == [
        _fixture(name) for name in MK.ZK_BATCH_FIXTURES]


def test_staged_stream_equals_fused_batch(small, staged):
    """Six witnesses from a generator in chunks of three through the staged
    stream's worker thread: each chunk the fused batch's proofs."""
    data, pws, batch3 = small
    got = tprover.prove_stream(data, (pw for pw in pws() + pws()), 3, seed=0)
    assert staged == [3, 3]
    assert [tser.proof_to_bytes(p) for p in got] == batch3 + batch3


def test_staged_stream_length_and_source_errors(small, staged):
    """The staged stream's tiling checks (the total first, else the short
    last chunk in its worker) and a witness source's exception reach the
    caller."""
    data, pws, _ = small
    with pytest.raises(AssertionError, match="tile"):
        tprover.prove_stream(data, pws(), 2, total=3)
    with pytest.raises(AssertionError, match="tile"):
        tprover.prove_stream(data, (pw for pw in pws()), 2)

    def broken():
        yield from pws()[:1]
        raise KeyError("witness source failed")

    with pytest.raises(KeyError, match="witness source failed"):
        tprover.prove_stream(data, broken(), 2)
    assert staged == [2]  # the first chunk of the short stream, before its short one


# ---------------------------------------------------------------------------
# dispatch


@pytest.fixture
def recorded(monkeypatch):
    """The fused and staged batch and stream forms replaced by a recorder."""
    calls = []
    monkeypatch.setattr(tfused, "prove_fused_batch",
                        lambda data, pws, seed: calls.append(("fused batch", len(pws))) or [])
    monkeypatch.setattr(tfused, "prove_fused_stream", lambda data, pws, batch, seed, total:
                        calls.append(("fused stream", len(list(pws)), total)) or [])
    monkeypatch.setattr(tprover, "generate_witness_batch",
                        lambda data, pws, rng: (None, None, len(pws)))
    monkeypatch.setattr(tprover, "prove_from_traces", lambda data, traces, pis, seed, salts:
                        calls.append(("staged", salts)) or [])
    monkeypatch.delenv(STAGED, raising=False)
    return calls


def test_batch_and_stream_dispatch_as_the_jax_package(recorded, monkeypatch):
    data = types.SimpleNamespace(config=types.SimpleNamespace(rate_bits=3,
                                                              max_quotient_degree_factor=8))
    leaf = types.SimpleNamespace(data=data, _partial_witness=lambda inputs: inputs)
    for staged in (False, True):
        if staged:
            monkeypatch.setenv(STAGED, "1")
        tprover.prove_batch(data, [1, 2, 3], seed=0)
        tprover.prove_stream(data, iter([1, 2, 3, 4]), 2, seed=0)
        WormholeProver.prove_inputs_batch(leaf, [1, 2], seed=0)
        WormholeProver.prove_inputs_stream(leaf, [1, 2], batch=1, seed=0)
    assert recorded == [("fused batch", 3), ("fused stream", 4, None), ("fused batch", 2),
                        ("fused stream", 2, 2),
                        ("staged", 3), ("staged", 2), ("staged", 2), ("staged", 2),
                        ("staged", 1), ("staged", 1)]
    assert tprover.prove_batch(data, [], seed=0) == []


# ---------------------------------------------------------------------------
# K = 17 through a stand-in kernel library


def _host(ptr: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_uint64 * count).from_address(ptr)).copy()


class _Library:
    """Records each entry's arguments (and the host words a transcript
    launch's plan holds while they are alive)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            host = _host(args[0], tts._SEGMENT_WORDS + tts._STRIDE_WORDS) if \
                entry == "qzk_transcript_batch" else None
            self.calls.append((entry, args, host))
            return 0
        return call


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "stream", lambda: 0)
    monkeypatch.setattr(_cuda, "require_cuda_int64", lambda *tensors: None)
    monkeypatch.setattr(tprover, "_kernel_lib", lambda index: lib)
    monkeypatch.setattr(tts, "_transcript_lib", lambda index: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    return lib


K17, WIDTH = 17, 300  # proofs, an upload row's words (a record REC_WORDS of them)


def _upload_rows(device="cpu"):
    """A batch upload (K17, WIDTH) and its records, a row apart."""
    up = torch.zeros((K17, WIDTH), dtype=torch.int64, device=device)
    return up, up[:, tfused.HEAD_REC : tfused.HEAD_REC + tts.REC_WORDS]


def test_k17_kernels_a_to_f_split_while_i_and_j_launch_once(small, library):
    """Kernels B, A, C, D and E read the fused batch's records in place,
    a row of the upload apart: two launches (16 proofs, then 1), each with
    its first proof's record pointer and the row stride; kernel F gathers
    into the part-major output from the device indices, a group's rows at
    its first proof; kernel I's batch form takes all 17 in one launch with
    the proof strides of its operands, kernel J's too."""
    data, _, _ = small
    cfg = data.config
    groups = _cuda.proof_groups(K17)
    assert groups == [(0, 16), (16, 17)]
    up, rec = _upload_rows()
    m = data.n << cfg.rate_bits
    traces = torch.zeros((K17, cfg.num_wires, data.n), dtype=torch.int64)
    tprover._permutation_rec_launches(data, traces, rec)
    wires = torch.zeros((K17, cfg.num_wires, m), dtype=torch.int64)
    nc = cfg.num_challenges
    zpp = torch.zeros((K17, nc + nc * (-(-cfg.num_routed_wires // 8) - 1), m), dtype=torch.int64)
    tprover._quotient_rec_launches(data, wires, zpp, rec, data.constants_oracle.lde)
    lde = torch.zeros((K17, 4, 64), dtype=torch.int64)
    oracles_k = [[types.SimpleNamespace(lde=x, coeffs=x[:, :8])] for x in lde]
    ys = torch.zeros((K17, 4, 2), dtype=torch.int64)
    tfri._composition_rec_launches(oracles_k, (((0, 0), (0, 1), (0, 2), (0, 3)),), ys, rec, 6, 1)
    fo._openings_rec_launches(oracles_k, rec, 0, 0)
    tfri._fold_rec_launches(torch.zeros((K17, 32, 4), dtype=torch.int64), rec, tts.REC_FRI_BETA,
                            1, 6, 0, 0)
    pos = {"qzk_permutation": (4, 5, 8), "qzk_quotient": (12, 13, 14),
           "qzk_fri_composition": (7, 8, 12), "qzk_eval_openings": (2, 3, 7),
           "qzk_fri_fold": (2, 3, 9)}
    seen = {}
    for entry, args, _ in library.calls:
        p, s, n = pos[entry]
        seen.setdefault(entry, []).append((args[p], args[s], args[n]))
    assert set(seen) == set(pos)
    for entry, got in seen.items():
        assert got == [(rec[g0].data_ptr(), WIDTH, g1 - g0) for g0, g1 in groups], entry

    # kernel F: the device indices and the (K, Q, width) part-major output
    library.calls.clear()
    sources = [[tfri.GatherSource(x.T, 63)] for x in lde]
    indices = torch.arange(K17 * 3, dtype=torch.int64).reshape(K17, 3) % 64
    rows = torch.zeros((K17, 3, 4), dtype=torch.int64)
    _, launches = tfri._gather_launches(sources, indices, _cuda.proof_groups(
        K17, tfri.gather_group(1)), out=rows)
    assert launches == 2
    for (entry, (plan, _), _), (g0, g1) in zip(library.calls, groups, strict=True):
        assert entry == "qzk_query_gather"
        assert int.from_bytes(plan[:8], "little") == rows[g0].data_ptr()
        memory = [lde, indices]
        want = torch.cat([tfri.query_gather_plain(s, i) for s, i in zip(sources[g0:g1],
                                                                         indices[g0:g1])])
        assert torch.equal(tfri.query_gather_packed_plain(plan, memory), want)

    # kernels I and J: one launch for all 17 (meta tensors take the CUDA branch)
    library.calls.clear()
    meta_up = torch.zeros((K17, WIDTH), dtype=torch.int64, device="meta")
    states = meta_up[:, tfused.HEAD_TS : tfused.HEAD_TS + tts.TS_WORDS]
    meta_rec = meta_up[:, tfused.HEAD_REC : tfused.HEAD_REC + tts.REC_WORDS]
    caps = torch.zeros((K17, 100, 4), dtype=torch.int64, device="meta")[:, 84:]
    part = torch.zeros((K17, 64), dtype=torch.int64, device="meta")
    before = tts.transcript_segment_batch.launches, tts.grind_device_batch.launches
    ch = tts.DeviceChallengerBatch(states)
    ch.segment(observe=[(torch.zeros(4, dtype=torch.int64, device="meta").expand(K17, -1), None),
                        (caps, part)],
               squeeze=[(meta_rec[:, tts.REC_BETA : tts.REC_BETA + 2], 0)])
    ch.grind(8, meta_up[:, tfused.HEAD_GRIND : tfused.HEAD_GRIND + 2])
    (e1, a1, words), (e2, a2, _) = library.calls
    assert e1 == "qzk_transcript_batch" and a1[1] == K17
    at = tts._SEGMENT_WORDS
    assert words[at] == WIDTH  # the states, a row of the upload apart
    assert words[at + 1 : at + 3].tolist() == [0, 400]  # the digest read by all, the caps
    assert words[at + 1 + tts.MAX_SOURCES + 1] == 64  # the caps' record, part-major
    assert words[at + 1 + 2 * tts.MAX_SOURCES] == WIDTH  # the betas into the records
    assert words[5 + 6 : 5 + 6 + 5].tolist() == [8 * 84 * 4, 16, 4, 4, 1]
    assert e2 == "qzk_grind_batch" and a2[1] == WIDTH and a2[5] == WIDTH and a2[6] == K17
    assert (tts.transcript_segment_batch.launches, tts.grind_device_batch.launches) == (
        before[0] + 1, before[1] + 1)
