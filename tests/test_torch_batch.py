"""Batch and stream proving in the port against the JAX package.

The small real circuit of tests/torch_fixtures/make_leaf_fixture.py is
proven in batches and streams by the port (on the CPU, the kernels' plain
versions) and by the JAX package's `prove_batch` through its staged path
(`QZKT_STAGED_PROVER=1`, so no fused graph is compiled); the leaf's two real
spends of `two_real_leaves_same_block()` are proven as one batch and held to
the JAX package's proofs committed by make_leaf_fixture.py. The batched
pieces underneath are held to K single calls: the host library's absorb,
duplex and witness tape over K states, the lockstep transcripts, the grind,
the forest and kernels A and B (their plain versions, and the arguments
their launches would get). The `gpu` cases hold the kernels to their plain
versions on the card.
"""

import contextlib
import ctypes
import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.plonk import builder as jbuilder
from qp_zk_circuits_tpu.plonk import prover as jprover
from qp_zk_circuits_tpu.plonk.serialization import proof_to_bytes as j_proof_to_bytes
from qp_zk_circuits_tpu_torch import native as nat
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.hash import poseidon2 as tps
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import transcript as tts
from qp_zk_circuits_tpu_torch.plonk import witness_tape as twt
from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers
from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

FIXTURES = Path(__file__).parent / "torch_fixtures"


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_leaf_fixture", FIXTURES / "make_leaf_fixture.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _fixture_module()
META = json.loads((FIXTURES / "fixtures.json").read_text())
#: the small circuit's witnesses (x, y): the fixture's, then three more
WITNESSES = [MK.SMALL_WITNESS, (12, 17), (5, 40), (3, 1)]


def _witnesses(pkg_builder, x, y, which):
    out = []
    for xv, yv in (WITNESSES[i] for i in which):
        pw = pkg_builder.PartialWitness()
        pw.set_target(x, xv)
        pw.set_target(y, yv)
        out.append(pw)
    return out


@pytest.fixture(scope="module")
def small():
    """The port's small circuit on the CPU, and a maker of its witnesses."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch")
    data = b.build(device="cpu")
    return data, lambda which: _witnesses(tbuilder, x, y, which)


@pytest.fixture(scope="module")
def batch3(small):
    data, pws = small
    return [proof_to_bytes(p) for p in tprover.prove_batch(data, pws([0, 1, 2]), seed=0)]


@pytest.fixture(scope="module")
def batch1(small):
    data, pws = small
    return [proof_to_bytes(p) for p in tprover.prove_batch(data, pws([3]), seed=0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# whole proofs


def test_small_batch_equals_jax_prove_batch(batch3, batch1, monkeypatch):
    """K = 3 and K = 1 against the JAX package's prove_batch (staged): equal
    bytes, in input order; the fixture witness's proof is the fixture."""
    monkeypatch.setenv("QZKT_STAGED_PROVER", "1")
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu")
    jdata = b.build()
    want = [j_proof_to_bytes(p) for p in jprover.prove_batch(
        jdata, _witnesses(jbuilder, x, y, [0, 1, 2, 3]), seed=0)]
    assert batch3 + batch1 == want
    assert batch3[0] == (FIXTURES / "small_circuit_proof.bin").read_bytes()
    assert len(set(want)) == 4


def test_leaf_batch_equals_fixtures():
    """The leaf at full width, K = 2 (two real spends: Merkle walk, fee,
    nullifier and header bindings): each proof equals the JAX package's
    committed proof of its inputs, in input order."""
    prover = WormholeProver(device="cpu")
    proofs = prover.prove_inputs_batch(list(thelpers.two_real_leaves_same_block()), seed=0)
    for proof, name in zip(proofs, MK.REAL_LEAF_FIXTURES, strict=True):
        blob = proof_to_bytes(proof)
        assert hashlib.sha256(blob).hexdigest() == META[name]["sha256"], name
        assert blob == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("source", ["list", "generator"])
def test_stream_equals_batch(small, batch3, batch1, source):
    """A stream of 4 witnesses in chunks of 2 equals the batches' proofs."""
    data, pws = small
    items = pws([0, 1, 2, 3])
    stream = items if source == "list" else (pw for pw in items)
    got = tprover.prove_stream(data, stream, 2, seed=0, total=4 if source == "list" else None)
    assert [proof_to_bytes(p) for p in got] == batch3 + batch1


def test_stream_length_must_tile_the_batch(small):
    data, pws = small
    with pytest.raises(AssertionError, match="tile"):
        tprover.prove_stream(data, pws([0, 1, 2]), 2, total=3)
    with pytest.raises(AssertionError, match="tile"):
        tprover.prove_stream(data, (pw for pw in pws([0, 1, 2])), 4)
    leaf_like = SimpleNamespace(data=data)  # the length is checked before any witness
    with pytest.raises(AssertionError, match="tile"):
        WormholeProver.prove_inputs_stream(leaf_like, [object()] * 3, batch=2)


def test_stream_worker_exception_reaches_the_caller(small):
    data, pws = small

    def broken():
        yield from pws([0])
        raise KeyError("witness source failed")

    with pytest.raises(KeyError, match="witness source failed"):
        tprover.prove_stream(data, broken(), 2)


def test_zk_batch_raises(small):
    """A ZK batch raises without its host salts and a non-ZK batch with
    them, as the single path does; a non-ZK batch witness draws nothing."""
    from qp_zk_circuits_tpu_torch.plonk.config import CircuitConfig

    data, pws = small
    zk = dataclasses.replace(data, config=CircuitConfig(zero_knowledge=True))
    traces = np.zeros((1, 135, data.n), dtype=np.uint64)
    pis = np.zeros((1, 0), dtype=np.uint64)
    with pytest.raises(ValueError, match="ZK batch"):
        tprover.prove_from_traces(zk, traces, pis)
    with pytest.raises(ValueError, match="ZK batch"):
        tprover.prove_from_traces(data, traces, pis, salts=np.zeros((1, 3, data.n << 3, 4),
                                                                    dtype=np.uint64))
    rng = np.random.default_rng(1)
    state = rng.bit_generator.state
    assert tbuilder.generate_witness_batch(data, pws([0]), rng)[2] is None
    assert rng.bit_generator.state == state


# ---------------------------------------------------------------------------
# the host pieces: K at once equals K single calls


def test_native_batch_calls_equal_single_calls():
    """The absorb, duplex and witness-tape calls over K states are bit-equal
    to K single calls."""
    rng = np.random.default_rng(3)
    k = 5
    states = JF.rand_felts((k, 12), rng)
    for fill, n in ((0, 3), (3, 5), (5, 16), (7, 97)):
        bufs = JF.rand_felts((k, fill), rng)
        felts = JF.rand_felts((k, n), rng)
        got_st, got_buf = nat.absorb_batch(states, bufs, felts)
        for i in range(k):
            st, buf = nat.absorb_many(states[i], list(bufs[i]), felts[i])
            assert np.array_equal(got_st[i], st)
            assert got_buf[i].tolist() == [int(v) for v in buf]
        st2 = states.copy()
        st2[:, :fill] = bufs
        assert np.array_equal(nat.duplex_batch(states, bufs), nat.permute_batch(st2))


def test_witness_batch_equals_single_witnesses(small):
    """One tape call over K value arrays gives each witness's trace and
    public inputs; the first batch of a circuit records its program."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch")
    data = b.build(device="cpu")
    pws = _witnesses(tbuilder, x, y, [0, 1, 2, 3])
    before = dict(nat.counts)
    traces, pis, salts = tbuilder.generate_witness_batch(data, pws)
    assert salts is None  # a non-ZK circuit draws no salts
    # the first witness took the Python replay, which recorded the program
    assert nat.counts["wt_run_many"] == before.get("wt_run_many", 0) + 1
    for i, pw in enumerate(pws):
        trace, pi = tbuilder.generate_witness(data, pw)
        assert np.array_equal(traces[i], trace) and np.array_equal(pis[i], pi)
    rows = twt.run_tape_many(data, pws)
    for row, pw in zip(rows, pws):
        assert np.array_equal(row, twt.run_tape(data, pw))


def test_witness_batch_tape_failure_raises():
    """A witness whose range check fails makes the batch's tape call raise."""
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch")
    data = b.build(device="cpu")
    tbuilder.generate_witness_batch(data, _witnesses(tbuilder, x, y, [0]))  # records
    bad = _witnesses(tbuilder, x, y, [1]) + [tbuilder.PartialWitness()]
    bad[1].set_target(x, 1 << 20)
    bad[1].set_target(y, 1 << 20)  # x * y + 3 x is above the 32-bit range check
    with pytest.raises(tbuilder.WitnessError, match="range check"):
        tbuilder.generate_witness_batch(data, bad)


def test_challenger_batch_equals_challengers():
    """K transcripts in lockstep: every challenge and the states they reach
    equal K Challengers driven alike, across observes that leave the buffer
    partly full, fill it exactly, and run over it."""
    rng = np.random.default_rng(4)
    k = 3
    batch = tts.ChallengerBatch(k)
    singles = [tts.Challenger() for _ in range(k)]
    shared = JF.rand_felts(4, rng)
    batch.observe_many(np.tile(shared, (k, 1)))
    for c in singles:
        c.observe_many(shared)
    for n, draws in ((5, 2), (3, 0), (64, 3), (0, 1), (21, 2), (8, 9)):
        felts = JF.rand_felts((k, n), rng)
        batch.observe_many(felts)
        for c, f in zip(singles, felts):
            c.observe_many(f)
        got = batch.challenge_many(draws)
        for i, c in enumerate(singles):
            assert got[i].tolist() == [int(v) for v in c.challenge_many(draws)]
    for mine, ref in zip(batch.unbind(), singles):
        assert np.array_equal(mine.state, ref.state)
        assert mine.input_buf == ref.input_buf and mine.output_buf == ref.output_buf
        assert mine.challenge() == ref.challenge()


@pytest.mark.parametrize("pending", [0, 7])
def test_grind_batch_equals_single_grinds(pending):
    """Each transcript keeps its own lowest passing witness; sweeps of 64
    candidates make some transcripts finish before others."""
    rng = np.random.default_rng(5 + pending)
    chs = []
    for _ in range(4):
        c = tts.Challenger()
        c.observe_many(JF.rand_felts(8 + pending, rng))
        chs.append(c)
    want = [tts.grind_pow(c, 8, "cpu", batch=64) for c in chs]
    before = tps.permute.launches
    assert tts.grind_pow_batch(chs, 8, "cpu", batch=64) == want
    assert tps.permute.launches == before  # the CPU takes the plain version
    assert tts.grind_pow_batch(chs, 0, "cpu") == [0] * 4


# ---------------------------------------------------------------------------
# the batched kernels' plain versions and launches


def _plain_inputs(data, k, seed):
    """K random traces, LDE stacks and distinct challenges for the circuit."""
    rng = np.random.default_rng(seed)
    cfg = data.config
    nc = cfg.num_challenges
    m = data.n << cfg.rate_bits
    zcols = nc + nc * (-(-cfg.num_routed_wires // cfg.max_quotient_degree_factor) - 1)
    return dict(
        traces=gl.from_u64(JF.rand_felts((k, cfg.num_wires, data.n), rng), "cpu"),
        wires=gl.from_u64(JF.rand_felts((k, cfg.num_wires, m), rng), "cpu"),
        zpp=gl.from_u64(JF.rand_felts((k, zcols, m), rng), "cpu"),
        **{name: JF.rand_felts((k, nc), rng) for name in ("alphas", "betas", "gammas")},
        pis=JF.rand_felts((k, 4), rng),
    )


def test_batched_plain_forms_equal_single_plain_calls(small):
    """The forest, B and A over K = 2 proofs with distinct challenges equal
    K single plain calls, proof by proof."""
    data, _ = small
    x = _plain_inputs(data, 2, seed=6)
    leaves = x["wires"][:, :20].transpose(1, 2)  # K LDEs of 20 columns read as rows, strided
    forest = tps.merkle_forest(leaves, 2)
    for i in range(2):
        for got, want in zip(forest[i], tps.merkle_levels_plain(leaves[i], 2), strict=True):
            assert torch.equal(got, want)
    nc = data.config.num_challenges
    zpp = tprover.compute_permutation_polys_batch(data, x["traces"], _records(x, nc, "cpu"))
    evals = tprover.quotient_evals_batch(data, x["wires"], x["zpp"], _records(x, nc, "cpu"))
    for i in range(2):
        rec = tprover.host_records("cpu", 1, nc, alphas=x["alphas"][i], betas=x["betas"][i],
                                   gammas=x["gammas"][i], pis=x["pis"][i])[0]
        assert torch.equal(zpp[i], tprover.compute_permutation_polys_plain(
            data, x["traces"][i], rec))
        assert torch.equal(evals[i], tprover.quotient_evals_plain(
            data, x["wires"][i], x["zpp"][i], rec))
    assert not torch.equal(zpp[0], zpp[1]) and not torch.equal(evals[0], evals[1])


def _records(x, nc, device):
    """The K proofs' host challenges of `_plain_inputs` as K records on
    `device`, one copy (what the staged batch uploads)."""
    return tprover.host_records(device, len(x["pis"]), nc, alphas=x["alphas"], betas=x["betas"],
                                gammas=x["gammas"], pis=x["pis"])


class _Recorder:
    """A stand-in kernel library: records each entry's arguments, copying the
    host felts each call's pointers name while they are alive."""

    def __init__(self, felts_at):
        self.calls = []
        self.felts_at = felts_at  # entry -> {argument index: felts a proof}

    def __getattr__(self, entry):
        def call(*args):
            proofs = next(a for i, a in enumerate(args) if i == self.felts_at[entry]["proofs"])
            host = {i: np.ctypeslib.as_array((ctypes.c_uint64 * (proofs * width)).from_address(
                args[i])).copy() for i, width in self.felts_at[entry]["felts"].items()}
            self.calls.append((entry, args, host))
            return 0
        return call


@pytest.mark.parametrize("k", [3, tprover.PROOFS_PER_LAUNCH + 1])
def test_batched_launches_split_at_the_cap(small, monkeypatch, k):
    """Kernels A and B take at most PROOFS_PER_LAUNCH proofs a launch: a
    larger batch is split, each launch gets its proofs' rows and
    challenges; the forest is one call for every tree."""
    data, _ = small
    nc = data.config.num_challenges
    x = _plain_inputs(data, k, seed=7)
    words = tts.REC_WORDS
    rec = _Recorder({
        "qzk_permutation": {"proofs": 8, "felts": {4: words}},
        "qzk_quotient": {"proofs": 14, "felts": {12: words}},
    })
    monkeypatch.setattr(tprover._cuda, "lib", lambda: rec)
    monkeypatch.setattr(tprover._cuda, "stream", lambda: 0)
    monkeypatch.setattr(tprover, "_kernel_lib", lambda index: rec)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    zpp, launches = tprover._permutation_rec_launches(data, x["traces"], _records(x, nc, "cpu"))
    groups = tprover._groups(k)
    assert launches == len(groups) == -(-k // tprover.PROOFS_PER_LAUNCH)
    for (entry, args, host), (g0, g1) in zip(rec.calls, groups, strict=True):
        assert entry == "qzk_permutation" and args[8] == g1 - g0 and args[5] == words
        assert args[0] == x["traces"][g0].data_ptr() and args[6] == zpp[g0].data_ptr()
        records = host[4].reshape(g1 - g0, words)
        assert np.array_equal(records[:, tts.REC_BETA : tts.REC_BETA + nc], x["betas"][g0:g1])
        assert np.array_equal(records[:, tts.REC_GAMMA : tts.REC_GAMMA + nc], x["gammas"][g0:g1])
    consts = data.constants_oracle.lde
    rec.calls.clear()
    out, launches = tprover._quotient_rec_launches(data, x["wires"], x["zpp"],
                                                   _records(x, nc, "cpu"), consts)
    assert launches == 2 * len(groups)
    for (entry, args, host), (g0, g1) in zip(rec.calls, groups, strict=True):
        assert entry == "qzk_quotient" and args[14] == g1 - g0 and args[13] == words
        assert args[0] == x["wires"][g0].data_ptr() and args[3] == x["zpp"][g0].data_ptr()
        assert args[11] == out[g0].data_ptr()
        records = host[12].reshape(g1 - g0, words)
        for slot, name, width in ((tts.REC_ALPHA, "alphas", nc), (tts.REC_BETA, "betas", nc),
                                  (tts.REC_GAMMA, "gammas", nc), (tts.REC_PI, "pis", 4)):
            assert np.array_equal(records[:, slot : slot + width], x[name][g0:g1]), name

    calls = []
    monkeypatch.setattr(tps, "_launch", lambda entry, device, *args: calls.append((entry, args)))
    leaves = x["wires"].transpose(1, 2)
    before = tps.merkle_forest.launches
    plan = tps.tree_plan(leaves.shape[1], 2, 132, k)
    forest = tps._launch_forest(leaves, 2, plan, tps.merkle_forest)
    (entry, args), = calls
    assert entry == "qzk_poseidon2_merkle_forest"
    m, cols = leaves.shape[1], leaves.shape[2]
    assert args[2:] == (k, cols * m, m, cols, 1, m, *plan)
    assert tps.merkle_forest.launches == before + (2 if plan[2] else 1)
    nodes = sum(m >> lvl for lvl in range(len(forest[0])))
    for t, levels in enumerate(forest):
        assert levels[0].data_ptr() == args[1] + 8 * 4 * nodes * t
        assert [lvl.shape[0] for lvl in levels] == [m >> lvl for lvl in range(len(levels))]


def test_forest_plan_fills_the_card():
    """Sixteen leaf trees take 64-row blocks (six levels in the block), where
    one tree takes blocks of 8; the levels always add up."""
    assert tps.tree_plan(2048, 4, 132, 16) == (64, 6, 1)
    assert tps.tree_plan(2048, 4, 132, 1) == tps.tree_plan(2048, 4, 132)
    for trees in (1, 2, 3, 16, 17, 64):
        run, in_block, left = tps.tree_plan(2048, 4, 132, trees)
        assert in_block + left == 7 and 2048 % run == 0


# ---------------------------------------------------------------------------
# the card


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, tprover.PROOFS_PER_LAUNCH + 1])
def test_batched_kernels_match_plain_on_card(small, cuda, k):
    """The forest (the leaf's 2048 x 135 LDE shape), B and A (the small
    circuit) over K proofs, on the card against their plain versions."""
    data, _ = small
    x = _plain_inputs(data, k, seed=8)
    rng = np.random.default_rng(9)
    lde = gl.from_u64(JF.rand_felts((k, 135, 2048), rng), cuda)
    got = tps.merkle_forest(lde.transpose(1, 2), 4)
    want = tps.merkle_forest_plain(lde.cpu().transpose(1, 2), 4)
    for g, w in zip(got, want, strict=True):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w, strict=True))
    dev = {name: x[name].to(cuda) for name in ("traces", "wires", "zpp")}
    nc = data.config.num_challenges
    zpp = tprover.compute_permutation_polys_batch(data, dev["traces"], _records(x, nc, cuda))
    assert torch.equal(zpp.cpu(), tprover.compute_permutation_polys_batch_plain(
        data, x["traces"], _records(x, nc, "cpu")))
    evals = tprover.quotient_evals_batch(data, dev["wires"], dev["zpp"], _records(x, nc, cuda))
    assert torch.equal(evals.cpu(), tprover.quotient_evals_batch_plain(
        data, x["wires"], x["zpp"], _records(x, nc, "cpu")))
