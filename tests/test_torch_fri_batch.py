"""The batch's FRI tail in the port: kernels C, D, E and F with a proof axis,
the rounds' forests, the stacked final iNTT and the lockstep transcripts.

On the CPU (the kernels' plain versions), small oracles (degree 6, rate 3,
three FRI rounds of arity 4, 4, 2; a salted oracle among them) of K = 3
proofs, each with its own points and challenges:

  * each batched function (openings, composition, fold, query gather, the
    round's forest, the stacked final iNTT) equals K calls of its single
    version;
  * `fri_commit_phase_batch`, `grind_pow_batch` and `fri_query_phase_batch`
    on a `ChallengerBatch` give the K `FriProof`s of K single `fri_prove`
    runs, and leave the transcripts where they leave theirs;
  * the new `ChallengerBatch` forms (`observe_cap`, `challenge_index`,
    `fork`, `of`) equal K `Challenger`s;
  * kernel F's plan with a proof axis, read back by its plain reader, gives
    the proofs' gathers, holds sixteen leaf proofs, and refuses more;
  * a stand-in kernel library checks that C, D, E and F launch once a group
    of at most PROOFS_PER_LAUNCH proofs (K = 17: 16 and 1), each launch with
    its proofs' pointers, points, alphas, betas and plans, and that kernel
    F's groups (K = 32 and 33: two of 16) write their own rows of the
    call's pinned buffer.

The `gpu` case holds the batched kernels to their plain versions on the card.
No JAX prover graph is built.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu_torch import _cuda
from qp_zk_circuits_tpu_torch.field import extension as ext
from qp_zk_circuits_tpu_torch.field import gf_np as F
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.fri import oracle as fo
from qp_zk_circuits_tpu_torch.fri import prover as fri
from qp_zk_circuits_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from qp_zk_circuits_tpu_torch.hash import merkle
from qp_zk_circuits_tpu_torch.plonk import transcript as ts
from qp_zk_circuits_tpu_torch.poly import ntt

K = 3
DEGREE_BITS = 6
CONFIG = FriConfig(rate_bits=3, cap_height=2, proof_of_work_bits=4, num_query_rounds=5,
                   reduction_strategy=FriReductionStrategy(arity_bits=2, final_poly_bits=1))
#: the oracles' polynomial counts: constants (shared), wires, Z and partial
#: products (salted, its first NZ opened at g * zeta too), quotient
COLUMNS = (5, 7, 4, 3)
NZ = 2


def _instance(zeta, zeta_next) -> fri.FriInstance:
    polys = tuple((o, j) for o, c in enumerate(COLUMNS) for j in range(c))
    return fri.FriInstance(batches=(
        fri.FriBatchInfo(point=tuple(int(v) for v in zeta), polys=polys),
        fri.FriBatchInfo(point=tuple(int(v) for v in zeta_next),
                         polys=tuple((2, j) for j in range(NZ)))))


def _proofs(k: int, seed: int, device="cpu") -> list[dict]:
    """k proofs' oracles (the constants shared; the others of one
    commit_batch each, the Z oracle salted), points, true openings and a
    transcript seed."""
    rng = np.random.default_rng(seed)
    n = 1 << DEGREE_BITS
    m = n << CONFIG.rate_bits
    consts = fo.commit(F.rand_felts((COLUMNS[0], n), rng), CONFIG.rate_bits, CONFIG.cap_height,
                       device=device)
    stacks = [fo.commit_batch(gl.from_u64(F.rand_felts((k, c, n), rng), device),
                              CONFIG.rate_bits, CONFIG.cap_height,
                              salts=F.rand_felts((k, m, 4), rng) if o == 2 else None)
              for o, c in enumerate(COLUMNS[1:], start=1)]
    g_n = F.primitive_root_of_unity(DEGREE_BITS)
    out = []
    for i in range(k):
        oracles = [consts] + [s[i] for s in stacks]
        zeta = F.rand_felts(2, rng)
        zeta_next = ext.scalar_mul(zeta.reshape(1, 2), g_n)[0]
        parts, nxt = fo.split_openings(gl.to_u64(fo.eval_openings_plain(
            oracles, fo.point_records(device, [zeta], [zeta_next])[0], 2, NZ)), oracles, NZ)
        out.append(dict(oracles=oracles, zeta=zeta, zeta_next=zeta_next,
                        instance=_instance(zeta, zeta_next),
                        openings=[np.concatenate(parts), nxt],
                        seed=F.rand_felts(11, rng), alpha=F.rand_felts(2, rng),
                        beta=F.rand_felts(2, rng)))
    return out


@pytest.fixture(scope="module")
def proofs():
    return _proofs(K, seed=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _lde_bits():
    return DEGREE_BITS + CONFIG.rate_bits


def _composition_args(ps_, device="cpu"):
    """The proofs' columns, claimed openings and records of their alphas and
    points as kernel C's batch form reads them (what the staged batch
    uploads: `composition_inputs`)."""
    ys, rec = fri.composition_inputs([p["instance"] for p in ps_], [p["openings"] for p in ps_],
                                     [p["alpha"] for p in ps_], device)
    return tuple(b.polys for b in ps_[0]["instance"].batches), ys, rec


def _point_records(ps_, device="cpu"):
    return fo.point_records(device, [p["zeta"] for p in ps_], [p["zeta_next"] for p in ps_])


# ---------------------------------------------------------------------------
# each batched function against K single calls


def test_openings_batch_equals_single_calls(proofs):
    values = fo.eval_openings_batch([p["oracles"] for p in proofs], _point_records(proofs), 2, NZ)
    got = [fo.split_openings(v, p["oracles"], NZ) for v, p in zip(gl.to_u64(values), proofs)]
    for (parts, nxt), p in zip(got, proofs, strict=True):
        rec = fo.point_records("cpu", [p["zeta"]], [p["zeta_next"]])[0]
        want_parts, want_next = fo.split_openings(
            gl.to_u64(fo.eval_openings(p["oracles"], rec, 2, NZ)), p["oracles"], NZ)
        assert all(np.array_equal(a, b) for a, b in zip(parts, want_parts, strict=True))
        assert np.array_equal(nxt, want_next)
    assert not np.array_equal(got[0][1], got[1][1])


@pytest.mark.parametrize("arity_bits", [0, 2])
def test_composition_batch_equals_single_calls(proofs, arity_bits):
    got = fri.compute_composition_batch([p["oracles"] for p in proofs], *_composition_args(proofs),
                                        _lde_bits(), arity_bits)
    assert got.shape == (K, (1 << _lde_bits()) >> arity_bits, 2 << arity_bits)
    for g, p in zip(got, proofs, strict=True):
        ys, rec = fri.composition_inputs([p["instance"]], [p["openings"]], [p["alpha"]], "cpu")
        polys = tuple(b.polys for b in p["instance"].batches)
        assert torch.equal(g, fri.compute_composition(
            p["oracles"], polys, ys[0], rec[0], _lde_bits(), arity_bits))


@pytest.mark.parametrize("a_bits, next_bits", [(2, 2), (1, 0), (4, 0)])
def test_fold_batch_equals_single_calls(proofs, a_bits, next_bits):
    log_m = 8
    rng = np.random.default_rng(a_bits)
    leaves = gl.from_u64(F.rand_felts((K, 1 << (log_m - a_bits), 2 << a_bits), rng), "cpu")
    betas = np.stack([p["beta"] for p in proofs])
    got = fri.fold_round_batch(leaves, fri.beta_records("cpu", betas), ts.REC_FRI_BETA, a_bits,
                               log_m, 1, next_bits)
    for g, x, b in zip(got, leaves, betas, strict=True):
        rec = fri.beta_records("cpu", [b])[0]
        assert torch.equal(g, fri.fold_round(x, rec, ts.REC_FRI_BETA, a_bits, log_m, 1,
                                             next_bits))


def _layers(proofs):
    """Each proof's first round: its composition's leaf rows (arity 2^2) and
    their tree."""
    leaves = fri.compute_composition_batch([p["oracles"] for p in proofs],
                                           *_composition_args(proofs), _lde_bits(), 2)
    return leaves, merkle.build_merkle_forest(leaves, CONFIG.cap_height)


def test_round_forest_equals_single_trees(proofs):
    leaves, forest = _layers(proofs)
    for x, tree in zip(leaves, forest, strict=True):
        single = merkle.build_merkle_tree(x, CONFIG.cap_height)
        assert np.array_equal(tree.cap, single.cap)
        assert all(torch.equal(a, b) for a, b in zip(tree.digests, single.digests, strict=True))


def test_stacked_final_intt_equals_single_calls():
    """The commit phase's stacked iNTT of K natural-order (m_f, 2) layers
    with the unshift folded in equals K single iNTTs of (2, m_f)."""
    rng = np.random.default_rng(3)
    layers = gl.from_u64(F.rand_felts((K, 8, 2), rng), "cpu")
    unshift = int(F.inv(F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << 5)))
    got = ntt.batched_ntt(layers.transpose(1, 2).reshape(2 * K, -1), 3, inverse=True,
                          out_shift=unshift).view(K, 2, -1)
    for g, x in zip(got, layers, strict=True):
        assert torch.equal(g, ntt.batched_ntt(x.T, 3, inverse=True, out_shift=unshift))


def test_query_gather_batch_equals_single_calls(proofs):
    leaves, forest = _layers(proofs)
    rng = np.random.default_rng(4)
    m = 1 << _lde_bits()
    indices = [[0, m - 1] + [int(i) for i in rng.integers(0, m, 5)] for _ in proofs]
    sources = [fri._gather_sources(p["oracles"], [(x, t)]) for p, x, t in zip(proofs, leaves, forest)]
    got = fri.query_gather_batch(sources, indices)
    assert got.shape[:2] == (K, 7)
    for g, s, i in zip(got, sources, indices, strict=True):
        assert np.array_equal(g, fri.query_gather(s, i))
    rounds = fri.gather_query_rounds_batch([p["oracles"] for p in proofs],
                                           [[(x, t)] for x, t in zip(leaves, forest)], indices)
    for r, p, x, t, i in zip(rounds, proofs, leaves, forest, indices, strict=True):
        _same_rounds(r, fri.gather_query_rounds(p["oracles"], [(x, t)], i))


def _same_rounds(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a.initial_rows + a.initial_siblings, b.initial_rows + b.initial_siblings,
                        strict=True):
            assert np.array_equal(x, y)
        for s, t in zip(a.steps, b.steps, strict=True):
            assert np.array_equal(s.leaf_values, t.leaf_values)
            assert np.array_equal(s.siblings, t.siblings)


# ---------------------------------------------------------------------------
# the phases in lockstep against single fri_prove runs


def test_fri_phases_in_lockstep_equal_single_fri_proves(proofs):
    """fri_commit_phase_batch + grind_pow_batch + fri_query_phase_batch over
    K transcripts in lockstep give each proof the FriProof of a single
    fri_prove, and leave each transcript in the state the single one
    reaches."""
    singles = []
    for p in proofs:
        ch = ts.Challenger()
        ch.observe_many(p["seed"])
        singles.append((fri.fri_prove(p["oracles"], p["instance"], p["openings"], ch, CONFIG,
                                      DEGREE_BITS), ch))
    batch = ts.ChallengerBatch(K)
    batch.observe_many(np.stack([p["seed"] for p in proofs]))
    oracles = [p["oracles"] for p in proofs]
    commitments = fri.fri_commit_phase_batch(oracles, [p["instance"] for p in proofs],
                                             [p["openings"] for p in proofs], batch, CONFIG,
                                             DEGREE_BITS)
    witnesses = ts.grind_pow_batch(batch, CONFIG.proof_of_work_bits, "cpu")
    got = fri.fri_query_phase_batch(oracles, commitments, witnesses, batch, CONFIG, DEGREE_BITS)
    assert len(commitments[0].layers) == len(CONFIG.reduction_strategy.schedule(DEGREE_BITS)) == 3
    for g, (want, ch), unbound in zip(got, singles, batch.unbind(), strict=True):
        assert all(np.array_equal(a, b) for a, b in zip(g.commit_caps, want.commit_caps,
                                                        strict=True))
        assert np.array_equal(g.final_poly, want.final_poly)
        assert g.pow_witness == want.pow_witness
        _same_rounds(g.query_rounds, want.query_rounds)
        assert np.array_equal(unbound.state, ch.state)
        assert unbound.input_buf == ch.input_buf and unbound.output_buf == ch.output_buf
    assert not np.array_equal(got[0].final_poly, got[1].final_poly)


def test_commit_phase_batch_refuses_a_high_degree_layer(proofs):
    """Claimed openings that are not the polynomials' values make the
    composition no polynomial of the bound: the batch raises as a single
    commit phase does."""
    bad = [list(p["openings"]) for p in proofs]
    bad[1][0] = bad[1][0].copy()
    bad[1][0][0, 0] ^= np.uint64(1)
    with pytest.raises(AssertionError, match="final poly exceeds degree bound"):
        fri.fri_commit_phase_batch([p["oracles"] for p in proofs],
                                   [p["instance"] for p in proofs], bad, ts.ChallengerBatch(K),
                                   CONFIG, DEGREE_BITS)


def test_challenger_batch_new_forms_equal_challengers():
    """observe_cap, challenge_index, fork and of on K transcripts equal K
    Challengers driven alike; `of` refuses transcripts out of lockstep."""
    rng = np.random.default_rng(5)
    singles = [ts.Challenger() for _ in range(K)]
    for c in singles:
        c.observe_many(F.rand_felts(5, rng))
    batch = ts.ChallengerBatch.of(singles)
    caps = F.rand_felts((K, 4, 4), rng)
    batch.observe_cap(caps)
    for c, cap in zip(singles, caps):
        c.observe_cap(cap)
    fork = batch.fork()
    got = [batch.challenge_index(1 << 9) for _ in range(4)]
    want = [[c.challenge_index(1 << 9) for c in singles] for _ in range(4)]
    assert [g.tolist() for g in got] == want
    assert fork.challenge_index(1 << 9).tolist() == want[0]  # the fork drew nothing before
    for mine, ref in zip(batch.unbind(), singles):
        assert np.array_equal(mine.state, ref.state) and mine.output_buf == ref.output_buf
    singles[0].observe(7)
    with pytest.raises(ValueError, match="not in lockstep"):
        ts.ChallengerBatch.of(singles)


# ---------------------------------------------------------------------------
# kernel F's plan with a proof axis


def test_batch_gather_plan_reads_back_the_proofs_gathers(proofs):
    """The plan of K proofs, read by the kernel's plain reader over the
    sources' memory, gives each proof's gather in turn."""
    leaves, forest = _layers(proofs)
    sources = [fri._gather_sources(p["oracles"], [(x, t)]) for p, x, t in zip(proofs, leaves, forest)]
    m = 1 << _lde_bits()
    rng = np.random.default_rng(6)
    indices = [[int(i) for i in rng.integers(0, m, 9)] for _ in proofs]
    plan, width = fri.pack_gather_plan_batch(sources, indices)
    assert len(plan) == fri.GATHER_PLAN_BYTES
    memory = [s.matrix for srcs in sources for s in srcs]
    want = torch.cat([fri.query_gather_plain(s, i) for s, i in zip(sources, indices)])
    assert width == want.shape[1]
    assert torch.equal(fri.query_gather_packed_plain(plan, memory), want)


def test_batch_gather_plan_capacity():
    """Sixteen leaf proofs (10 segments) fit one plan, and sixteen of the
    degree-16 tail's (14 segments): the query indices lie on the card, a
    pointer a proof; a plan over PROOFS_PER_LAUNCH proofs, over its bytes,
    or of proofs whose sources differ in shape raises."""
    assert fri.gather_group(10) == _cuda.PROOFS_PER_LAUNCH == 16
    assert fri.gather_group(14) == 16
    assert fri._plan_bytes(16, 10) == 1592 <= fri.GATHER_PLAN_BYTES
    assert fri.gather_group(40) == 8 and fri.gather_group(128) == 1
    buf = torch.arange(1 << 12, dtype=torch.int64)
    src = [fri.GatherSource(buf.as_strided((256, 3), (3, 1)), 255)] * 10
    fri.pack_gather_plan_batch([src] * 16, [[1] * 28] * 16)
    with pytest.raises(ValueError, match="proofs"):
        fri.pack_gather_plan_batch([src] * 17, [[1] * 28] * 17)
    with pytest.raises(ValueError, match="bytes"):
        fri.pack_gather_plan_batch([src * 4] * 9, [[1] * 128] * 9)
    other = src[:9] + [fri.GatherSource(buf.as_strided((256, 4), (4, 1)), 255)]
    with pytest.raises(ValueError, match="differ in shape"):
        fri.pack_gather_plan_batch([src, other], [[1] * 28] * 2)


# ---------------------------------------------------------------------------
# the launches of a batch of 17: a stand-in kernel library


def _host(ptr: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_uint64 * count).from_address(ptr)).copy()


class _Library:
    """Records each entry's arguments and, while the call's host arrays are
    alive, copies the ones it names."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _records(ch, stride, proofs):
        return _host(ch, stride * proofs).reshape(proofs, stride)

    def qzk_fri_composition(self, ptrs, n_src, terms, ys, xs, batches, n_b, ch, stride, out, m,
                            a_bits, proofs, stream):
        self.calls.append(dict(ptrs=_host(ptrs, proofs * n_src), batches=_host(
            batches, n_b * 2).reshape(n_b, 2), records=self._records(ch, stride, proofs),
            ys=ys, out=out, proofs=proofs))
        return 0

    def qzk_eval_openings(self, segs, n_segs, ch, stride, out, part, n, proofs, stream):
        self.calls.append(dict(segs=_host(segs, proofs * n_segs * 3).reshape(proofs, n_segs, 3),
                               records=self._records(ch, stride, proofs), out=out, proofs=proofs))
        return 0

    def qzk_fri_fold(self, leaves, consts, ch, stride, beta_slot, out, mp, a_bits, next_bits,
                     proofs, stream):
        self.calls.append(dict(leaves=leaves, records=self._records(ch, stride, proofs),
                               beta_slot=beta_slot, out=out, proofs=proofs))
        return 0

    def qzk_query_gather(self, plan, stream):
        self.calls.append(dict(plan=bytes(plan)))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "stream", lambda: 0)
    return lib


@pytest.fixture(scope="module")
def proofs17():
    return _proofs(17, seed=2)


def test_batched_fri_launches_split_at_the_cap(proofs17, recorder, monkeypatch):
    """C, D, E and F over 17 proofs take two launches each (16 proofs, then
    1), each launch with its proofs' LDE and coefficient pointers, outputs
    and gather plan, and their points, alphas and betas in their challenge
    records (one copy for the batch), the query indices on the device."""
    ps_ = proofs17
    groups = _cuda.proof_groups(17)
    assert groups == [(0, 16), (16, 17)]
    oracles = [p["oracles"] for p in ps_]
    out, launches = fri._composition_rec_launches(oracles, *_composition_args(ps_), _lde_bits(), 2)
    assert launches == 2 and out.shape[0] == 17
    for call, (g0, g1) in zip(recorder.calls, groups, strict=True):
        assert call["proofs"] == g1 - g0 and call["out"] == out[g0].data_ptr()
        assert call["ptrs"].tolist() == [o.lde.data_ptr() for os_ in oracles[g0:g1] for o in os_]
        rec = call["records"]
        assert rec[:, ts.REC_FRI_ALPHA : ts.REC_FRI_ALPHA + 2].tolist() == [
            [int(v) for v in p["alpha"]] for p in ps_[g0:g1]]
        assert call["batches"][:, 1].tolist() == list(fri.POINT_SLOTS[: call["batches"].shape[0]])
        assert [[rec[i, slot : slot + 2].tolist() for slot in call["batches"][:, 1]]
                for i in range(g1 - g0)] == [
            [list(b.point) for b in p["instance"].batches] for p in ps_[g0:g1]]
    recorder.calls.clear()
    values, launches = fo._openings_rec_launches(oracles, _point_records(ps_), 2, NZ)
    assert launches == 2 and values.shape == (17, sum(COLUMNS) + NZ, 2)
    for call, (g0, g1) in zip(recorder.calls, groups, strict=True):
        assert call["proofs"] == g1 - g0
        assert call["segs"][:, :, 0].tolist() == [
            [o.coeffs.data_ptr() for o in os_] + [os_[2].coeffs.data_ptr()] for os_ in oracles[g0:g1]]
        assert call["segs"][0, :, 1:].tolist() == [[c, 0] for c in COLUMNS] + [[NZ, 1]]
        assert call["records"][:, ts.REC_ZETA : ts.REC_ZETA + 4].ravel().tolist() == [
            int(v) for p in ps_[g0:g1] for v in (*p["zeta"], *p["zeta_next"])]
    recorder.calls.clear()
    leaves = gl.from_u64(F.rand_felts((17, 64, 8), np.random.default_rng(7)), "cpu")
    betas = np.stack([p["beta"] for p in ps_])
    out, launches = fri._fold_rec_launches(leaves, fri.beta_records("cpu", betas),
                                           ts.REC_FRI_BETA, 2, 8, 0, 0)
    assert launches == 2 and out.shape == (17, 64, 2)
    for call, (g0, g1) in zip(recorder.calls, groups, strict=True):
        assert call["proofs"] == g1 - g0 and call["leaves"] == leaves[g0].data_ptr()
        assert call["out"] == out[g0].data_ptr() and call["beta_slot"] == ts.REC_FRI_BETA
        assert call["records"][:, ts.REC_FRI_BETA : ts.REC_FRI_BETA + 2].tolist() == \
            betas[g0:g1].tolist()
    recorder.calls.clear()
    layers, forest = _layers(ps_)
    sources = [fri._gather_sources(o, [(x, t)]) for o, x, t in zip(oracles, layers, forest)]
    rng = np.random.default_rng(8)
    indices = [[int(i) for i in rng.integers(0, 1 << _lde_bits(), 4)] for _ in ps_]
    host = _stand_in_pinned(monkeypatch, sources, indices)
    idx = torch.tensor(indices, dtype=torch.int64)
    _, launches = fri._gather_launches(sources, idx, _cuda.proof_groups(
        17, fri.gather_group(len(sources[0]))))
    assert launches == 2
    memory = [s.matrix for srcs in sources for s in srcs] + [idx]
    for call, (g0, g1) in zip(recorder.calls, groups, strict=True):
        want = torch.cat([fri.query_gather_plain(s, i)
                          for s, i in zip(sources[g0:g1], indices[g0:g1])])
        assert torch.equal(fri.query_gather_packed_plain(call["plan"], memory), want)
        assert int.from_bytes(call["plan"][:8], "little") == host[g0].data_ptr()


def _stand_in_pinned(monkeypatch, sources, indices) -> torch.Tensor:
    """Kernel F's pinned (K, Q, width) buffer for these proofs, stood in by
    a host tensor; the stream's synchronize a no-op."""
    width = fri.pack_gather_plan(sources[0], indices[0])[1]
    host = torch.zeros((len(sources), len(indices[0]), width), dtype=torch.int64)
    monkeypatch.setitem(fri._pinned, tuple(host.shape), host)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(synchronize=lambda: None))
    return host


@pytest.mark.parametrize("k", [32, 33])
def test_batched_gather_groups_of_one_size_keep_their_own_rows(proofs17, monkeypatch, k):
    """Kernel F over k proofs in groups of 16 (and 1): a stand-in library
    writes each launch's rows, as the kernel does, at its plan's output
    address; every proof gets its own queries' rows, the two groups of 16
    included."""
    layers, forest = _layers(proofs17)
    sources17 = [fri._gather_sources(p["oracles"], [(x, t)])
                 for p, x, t in zip(proofs17, layers, forest)]
    sources = [sources17[i % 17] for i in range(k)]
    rng = np.random.default_rng(10 + k)
    indices = [[int(i) for i in rng.integers(0, 1 << _lde_bits(), 4)] for _ in range(k)]
    idx = torch.tensor(indices, dtype=torch.int64)
    memory = [s.matrix for srcs in sources17 for s in srcs] + [idx]
    launched = []

    def gather(plan, stream):
        rows = fri.query_gather_packed_plain(bytes(plan), memory).contiguous()
        ctypes.memmove(int.from_bytes(plan[:8], "little"), rows.data_ptr(),
                       rows.numel() * rows.element_size())
        launched.append(rows.shape[0])
        return 0

    monkeypatch.setattr(_cuda, "lib", lambda: types.SimpleNamespace(qzk_query_gather=gather))
    monkeypatch.setattr(_cuda, "stream", lambda: 0)
    _stand_in_pinned(monkeypatch, sources, indices)
    groups = _cuda.proof_groups(k, fri.gather_group(len(sources[0])))
    got, launches = fri._gather_launches(sources, idx, groups)
    assert launches == len(groups) == 3 - (k == 32) and launched == [4 * (g1 - g0)
                                                                     for g0, g1 in groups]
    want = [fri.query_gather_plain(s, i) for s, i in zip(sources, indices)]
    assert np.array_equal(got, gl.to_u64(torch.stack(want)))


# ---------------------------------------------------------------------------
# the card


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 17, 33])
def test_batched_fri_kernels_match_plain_on_card(cuda, k):
    """C, D, E and F with a proof axis over k proofs (17: two launches each;
    33: three, two of them of 16 proofs) equal their plain versions run on
    CPU copies."""
    ps_ = _proofs(k, seed=9, device=cuda)
    oracles = [p["oracles"] for p in ps_]
    cpu = [[types.SimpleNamespace(lde=o.lde.cpu(), coeffs=o.coeffs.cpu()) for o in os_]
           for os_ in oracles]
    got = fri.compute_composition_batch(oracles, *_composition_args(ps_, cuda), _lde_bits(), 2)
    assert torch.equal(got.cpu(), fri.compute_composition_batch_plain(
        cpu, *_composition_args(ps_), _lde_bits(), 2))
    assert torch.equal(fo.eval_openings_batch(oracles, _point_records(ps_, cuda), 2, NZ).cpu(),
                       fo.eval_openings_batch_plain(cpu, _point_records(ps_), 2, NZ))
    betas = np.stack([p["beta"] for p in ps_])
    folded = fri.fold_round_batch(got, fri.beta_records(cuda, betas), ts.REC_FRI_BETA, 2,
                                  _lde_bits(), 0, 2)
    assert torch.equal(folded.cpu(), fri.fold_round_batch_plain(
        got.cpu(), fri.beta_records("cpu", betas), ts.REC_FRI_BETA, 2, _lde_bits(), 0, 2))
    forest = merkle.build_merkle_forest(got, CONFIG.cap_height)
    sources = [fri._gather_sources(o, [(x, t)]) for o, x, t in zip(oracles, got, forest)]
    indices = [[0, (1 << _lde_bits()) - 1, 5, 77] for _ in ps_]
    want = np.stack([fri.query_gather(s, i) for s, i in zip(sources, indices)])
    assert np.array_equal(fri.query_gather_batch(sources, indices), want)
