"""The port's host runtime in C (qp_zk_circuits_tpu_torch/native/) against
the port's pure-Python forms and against the JAX package's C library.

Inputs come from `np.random.default_rng(seed)` with the edge felts p - 1, 0,
2^32 and 2^32 - 1 mixed in. Exact equality everywhere:

  * the permutation, its witness trace, the sponge, the 2-to-1 compression
    and the Merkle walk;
  * the transcript's batched absorb against the per-felt path, at every
    buffer fill and length around the rate, and on a block boundary;
  * the leaf's constraint tape against the JAX package's tape and the pure
    vanishing walk, on the leaf fixture's openings and on tampered ones.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from qp_zk_circuits_tpu import native as jnat
from qp_zk_circuits_tpu.plonk import constraint_tape as jct
from qp_zk_circuits_tpu.wormhole.leaf_circuit import WormholeCircuit as JWormholeCircuit
from qp_zk_circuits_tpu_torch import native as tnat
from qp_zk_circuits_tpu_torch.field import gf_np as F
from qp_zk_circuits_tpu_torch.hash import merkle as tmerkle
from qp_zk_circuits_tpu_torch.hash import poseidon2 as tps
from qp_zk_circuits_tpu_torch.plonk import constraint_tape as tct
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import transcript as tts
from qp_zk_circuits_tpu_torch.plonk import verifier as tverifier
from qp_zk_circuits_tpu_torch.plonk.gates import Poseidon2Gate
from qp_zk_circuits_tpu_torch.wormhole.leaf_circuit import WormholeCircuit as TWormholeCircuit

P = 0xFFFFFFFF00000001
EDGES = np.array([P - 1, 0, 1 << 32, (1 << 32) - 1], dtype=np.uint64)
FIXTURES = Path(__file__).parent / "torch_fixtures"


def _felts(shape, seed):
    """Random canonical felts with the edge values at the front."""
    x = F.rand_felts(shape, np.random.default_rng(seed)).ravel()
    k = min(len(EDGES), x.size)
    x[:k] = EDGES[:k]
    return x.reshape(shape)


@pytest.mark.parametrize("n", [1, 7, 64, 100])
def test_permute_batch(n):
    states = _felts((n, 12), n)
    got = tnat.permute_batch(states)
    assert np.array_equal(got, tps._permute_np_pure(states))
    assert np.array_equal(got, jnat.permute_batch(states))
    assert np.array_equal(tps.permute_np(states), got)
    assert tps.permute_np(states[0]).tolist() == tps._permute_scalar_pure(states[0])


@pytest.mark.parametrize("n", [1, 33])
def test_permute_trace_batch(n):
    states = _felts((n, 12), 100 + n)
    got = tnat.permute_trace_batch(states)
    for mine, ref in zip(got, jnat.permute_trace_batch(states)):
        assert np.array_equal(mine, ref)
    assert np.array_equal(got[3], tps._permute_np_pure(states))
    # the gate's fill of each row against its pure-Python fill
    gate = Poseidon2Gate()
    for row in states[: min(n, 4)]:
        fast, pure = {}, {}
        gate.fill_row(lambda c, row=row: int(row[c]) if c < 12 else 0, fast.__setitem__)
        gate._fill_row_pure(lambda c, row=row: int(row[c]) if c < 12 else 0, pure.__setitem__)
        assert fast == pure and len(fast) == 118


@pytest.mark.parametrize("length", [0, 1, 4, 5, 8, 9, 16, 135])
def test_hash_no_pad(length):
    rows = _felts((5, length), 200 + length)
    got = tnat.hash_no_pad_many(rows)
    assert np.array_equal(got, jnat.hash_no_pad_many(rows))
    for row, digest in zip(rows, got):
        assert np.array_equal(tps.hash_no_pad(row), digest)
        assert np.array_equal(tps._hash_no_pad_pure(row), digest)
        assert np.array_equal(tps.hash_or_noop(row), jnat.hash_no_pad(row) if length > 4
                              else np.pad(row, (0, 4 - length)))


@pytest.mark.parametrize("n", [1, 70])
def test_two_to_one(n):
    left, right = _felts((n, 4), 300 + n), _felts((n, 4), 400 + n)
    got = tnat.two_to_one_many(left, right)
    assert np.array_equal(got, jnat.two_to_one_many(left, right))
    for i in range(min(n, 4)):
        assert np.array_equal(tps.two_to_one_np(left[i], right[i]), got[i])
        assert np.array_equal(tps._two_to_one_pure(left[i], right[i]), got[i])


@pytest.mark.parametrize("levels", [0, 1, 5, 10])
def test_merkle_walk(levels):
    leaf, sibs = _felts(4, 500 + levels), _felts((levels, 4), 600 + levels)
    for index in (0, 1, (1 << levels) - 1, 0b1011010 % (1 << levels) + (3 << levels)):
        got = tnat.merkle_walk(leaf, index, sibs)
        assert np.array_equal(got, jnat.merkle_walk(leaf, index, sibs))
        assert np.array_equal(tmerkle.merkle_root_from_proof(leaf, index, sibs), got)
        assert np.array_equal(tmerkle._merkle_root_from_proof_pure(leaf, index, sibs), got)


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError):
        tnat.permute_batch(np.zeros(11, dtype=np.uint64))
    with pytest.raises(ValueError):
        tnat.merkle_walk(np.zeros(3, dtype=np.uint64), 0, np.zeros((1, 4), dtype=np.uint64))
    with pytest.raises(ValueError):
        tnat.two_to_one_many(np.zeros((2, 4), dtype=np.uint64), np.zeros((3, 4), dtype=np.uint64))


# ---------------------------------------------------------------------------
# the transcript's absorb


def _per_felt(ch, felts):
    for f in np.asarray(felts, dtype=np.uint64).ravel():
        ch.observe(f)


def _assert_same(fast, slow):
    assert np.array_equal(fast.state, slow.state)
    assert fast.input_buf == slow.input_buf
    assert list(fast.output_buf) == list(slow.output_buf)


@pytest.mark.parametrize("prefix", [0, 1, 3, 7])
@pytest.mark.parametrize("n", [16, 17, 23, 24, 64, 100, 129])
def test_absorb_many_matches_per_felt(prefix, n):
    pre, felts = _felts(prefix, 700 + prefix), _felts(n, 800 + n)
    fast, slow = tts.Challenger(), tts.Challenger()
    for c in (fast, slow):
        _per_felt(c, pre)
    calls = tnat.counts["absorb_many"]
    fast.observe_many(felts)
    assert tnat.counts["absorb_many"] == calls + 1
    _per_felt(slow, felts)
    _assert_same(fast, slow)
    # the next challenges agree (the output-buffer rule)
    assert fast.challenge() == slow.challenge()
    assert np.array_equal(fast.challenge_many(9), slow.challenge_many(9))


def test_absorb_block_boundary_keeps_output_buffer():
    """Ending on a rate boundary leaves a squeezable output buffer."""
    felts = _felts(16, 900)
    fast, slow = tts.Challenger(), tts.Challenger()
    fast.observe_many(felts)
    _per_felt(slow, felts)
    assert len(slow.output_buf) == tps.RATE
    _assert_same(fast, slow)
    assert fast.challenge() == slow.challenge()


def test_absorb_schedule():
    """A mixed observe / challenge schedule through both paths."""
    fast, slow = tts.Challenger(), tts.Challenger()
    for i, size in enumerate([1, 16, 2, 31, 8, 40]):
        felts = _felts(size, 1000 + i)
        fast.observe_many(felts)
        _per_felt(slow, felts)
        assert fast.challenge() == slow.challenge()
    _assert_same(fast, slow)


# ---------------------------------------------------------------------------
# the constraint tape


@pytest.fixture(scope="module")
def leaf_vanishing():
    """The leaf's verifier data (port and reference), and the arguments the
    port's verifier passes to its vanishing check on the leaf fixture."""
    meta = json.loads((FIXTURES / "fixtures.json").read_text())["leaf_proof_inputs0.bin"]
    data = TWormholeCircuit().build(shape_only=True)
    v = tser.VerifierCircuitData(
        data.config, data.degree_bits, list(data.gate_types), data.num_selectors,
        data.const_cols.shape[0], np.array(meta["constants_cap"], dtype=np.uint64),
        np.array(meta["circuit_digest"], dtype=np.uint64), len(data.public_input_targets))
    seen = []
    mp = pytest.MonkeyPatch()
    mp.setattr(tverifier, "verify_vanishing_at_zeta",
               lambda *args: seen.append(args) or tprover.verify_vanishing_at_zeta(*args))
    try:
        tverifier.verify(v, tser.proof_from_bytes((FIXTURES / "leaf_proof_inputs0.bin").read_bytes()))
    finally:
        mp.undo()
    return v, JWormholeCircuit().build(shape_only=True), seen[0]


def test_constraint_tape_equals_reference(leaf_vanishing):
    v, jdata, _ = leaf_vanishing
    mine, ref = tct.get_tape(v), jct.build_tape(jdata)
    for name in ("ops", "ia", "ib", "pool", "out_ids"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name
    assert mine.n_inputs == ref.n_inputs and mine.slices == ref.slices
    inputs = _felts((mine.n_inputs, 2), 1100)
    assert np.array_equal(tnat.eval_tape(mine, inputs), jnat.eval_tape(ref, inputs))


@pytest.mark.parametrize("field", [None, "wires", "constants", "selectors", "sigmas", "zs",
                                   "zs_next", "pps", "quotient"])
def test_taped_vanishing_equals_pure(leaf_vanishing, field):
    v, _, (data, openings, pi_hash, alphas, betas, gammas, zeta) = leaf_vanishing
    if field is not None:
        import copy

        openings = copy.deepcopy(openings)
        arr = np.array(getattr(openings, field), dtype=np.uint64)
        arr[0, 1] = (int(arr[0, 1]) + 1) % P
        setattr(openings, field, arr)
    args = (data, openings, pi_hash, alphas, betas, gammas, zeta)
    calls = tnat.counts["eval_tape"]
    taped = tprover.verify_vanishing_at_zeta(*args)
    assert tnat.counts["eval_tape"] == calls + 1
    assert taped == tprover._verify_vanishing_pure(*args) == (field is None)
