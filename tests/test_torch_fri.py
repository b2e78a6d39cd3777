"""The port's FRI tail (kernels C-F of csrc/fri.cu) against the JAX package.

On the CPU the port's wrappers run their plain versions; inputs are made with
numpy from a seed and go through the JAX package's functions on the CPU
(jitted, no Pallas kernel involved) and through the port. The field is exact,
so every comparison is bit-exact:

  * the composition against `fri/prover.py::compute_composition` (two
    batches, the second on a subset of one oracle; one case with x - z = 0);
  * the openings against `fri/oracle.py::eval_openings`, also at n = 2^12
    with the leaf's segment layout (four oracles, then rows of the third at
    g * zeta), with none and with three rows at g * zeta;
  * one round's folds against `_fold_step` applied a times and
    `_regroup_leaves`, for a = 1..4, and two rounds of arity 2^4 in a chain
    (2^12 values into leaves of arity 2^4, then into natural order), the
    pattern of the degree-16 schedule; kernel E's constants against the
    JAX package's inverse twiddle tables;
  * the query gather against `fri/oracle.py::open_rows_many` and
    `hash/merkle.py::MerkleTree.prove`, indices 0 and m - 1 included;
    kernel F's packed parameter plan, decoded by its plain reader, against
    the plain gather at the leaf's and the degree-16 tail's layouts (a
    Merkle path a segment: 10 and 14 segments; a level a segment: 37 and
    89), and its capacity edges.

The `gpu` cases hold each kernel against its plain version at the leaf's
shapes with the edge values p - 1, 0 and 2^32, kernel D's sum across blocks
at n = 2^16, kernel E's on-card twiddles at every arity and coset shift up
to m = 2^19, and kernel F at its plan's edges (a width-1 segment, rows not a
multiple of a warp, the largest plan, a row wider than a block); they skip
without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import extension as jext
from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.field import goldilocks as jgl
from qp_zk_circuits_tpu.fri import oracle as joracle
from qp_zk_circuits_tpu.fri import prover as jfri
from qp_zk_circuits_tpu.hash import merkle as jmerkle
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.fri import oracle as toracle
from qp_zk_circuits_tpu_torch.fri import prover as tfri
from qp_zk_circuits_tpu_torch.hash import merkle as tmerkle
from qp_zk_circuits_tpu_torch.plonk import transcript as ts

P = 0xFFFFFFFF00000001
EDGES = np.array([P - 1, 0, 1 << 32], dtype=np.uint64)
ROWS = (5, 9, 4)  # three oracles' column counts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _felts(shape, rng, edges=False):
    x = JF.rand_felts(shape, rng)
    if edges:
        x.reshape(-1)[: EDGES.size] = EDGES
    return x


def _case(lde_bits, seed, zero_point=False, edges=False):
    """Random LDEs of three oracles, two batches (the second on three
    columns of oracle 1), claimed openings and alpha."""
    rng = np.random.default_rng(seed)
    m = 1 << lde_bits
    ldes = [_felts((c, m), rng, edges) for c in ROWS]
    polys0 = tuple((o, k) for o, c in enumerate(ROWS) for k in range(c))
    polys1 = ((1, 2), (1, 0), (1, 7))
    z0, z1 = (int(v) for v in JF.rand_felts(2, rng))
    if zero_point:  # z = x_3, so x - z = 0 at point 3
        z0, z1 = int(tfri._domain_points(lde_bits)[3]), 0
    zn = [int(v) for v in JF.rand_felts(2, rng)]
    return dict(
        ldes=ldes, lde_bits=lde_bits, polys=(polys0, polys1), points=((z0, z1), tuple(zn)),
        openings=[JF.rand_felts((len(polys0), 2), rng), JF.rand_felts((len(polys1), 2), rng)],
        alpha=JF.rand_felts(2, rng),
    )


def _instance(mod, case):
    return mod.FriInstance(batches=tuple(
        mod.FriBatchInfo(point=pt, polys=polys) for pt, polys in zip(case["points"], case["polys"])
    ))


def _port_oracles(case, device="cpu"):
    return [SimpleNamespace(lde=gl.from_u64(l, device)) for l in case["ldes"]]


def _composition(oracles, instance, openings, alpha, lde_bits, arity_bits=0, plain=False):
    """`compute_composition` (or its plain version) of host openings and
    alpha, uploaded as the staged prover uploads them."""
    ys, rec = tfri.composition_inputs([instance], [openings], [alpha], oracles[0].lde.device)
    fn = tfri.compute_composition_plain if plain else tfri.compute_composition
    return fn(oracles, tuple(b.polys for b in instance.batches), ys[0], rec[0], lde_bits,
              arity_bits)


def _fold(leaves, beta, a_bits, log_m, shift_pow, next_bits=0, plain=False):
    """`fold_round` (or its plain version) of a host beta in its record."""
    fn = tfri.fold_round_plain if plain else tfri.fold_round
    return fn(leaves, tfri.beta_records(leaves.device, [beta])[0], ts.REC_FRI_BETA, a_bits,
              log_m, shift_pow, next_bits)


def _openings(oracles, zeta, zeta_next, next_oracle=2, next_count=0, plain=False):
    """`eval_openings` (or its plain version) at host points, cut on the
    host: (per-oracle (C, 2) arrays, the rows at zeta_next)."""
    fn = toracle.eval_openings_plain if plain else toracle.eval_openings
    rec = toracle.point_records(oracles[0].coeffs.device, [zeta], [zeta_next])[0]
    values = fn(oracles, rec, next_oracle, next_count)
    return toracle.split_openings(gl.to_u64(values), oracles, next_count)


def _reference_composition(case) -> np.ndarray:
    oracles = [SimpleNamespace(lde=jgl.from_u64(l)) for l in case["ldes"]]
    q = jfri.compute_composition(oracles, _instance(jfri, case), case["openings"],
                                 case["alpha"], case["lde_bits"])
    return jext.j_to_u64(q)


@pytest.mark.parametrize("lde_bits, zero_point", [(6, False), (7, False), (6, True)])
def test_composition_matches_reference(lde_bits, zero_point):
    case = _case(lde_bits, seed=lde_bits, zero_point=zero_point)
    want = _reference_composition(case)
    if zero_point:
        assert jext.eq(jext.inv(np.zeros(2, np.uint64)), np.zeros(2, np.uint64))
    args = (_port_oracles(case), _instance(tfri, case), case["openings"], case["alpha"], lde_bits)
    assert np.array_equal(gl.to_u64(_composition(*args)), want)
    # in the leaf layout of a first round of arity 2^3: row q holds v[q + j m']
    leaves = gl.to_u64(_composition(*args, arity_bits=3))
    mp = want.shape[0] >> 3
    assert np.array_equal(leaves.reshape(mp, 8, 2), want.reshape(8, mp, 2).transpose(1, 0, 2))


def test_composition_at_arity_4_with_zero_denominator_matches_reference():
    """The largest arity's leaf layout with x_3 - z = 0 in the first batch."""
    case = _case(7, seed=17, zero_point=True)
    want = _reference_composition(case)
    args = (_port_oracles(case), _instance(tfri, case), case["openings"], case["alpha"], 7)
    leaves = gl.to_u64(_composition(*args, arity_bits=4))
    mp = want.shape[0] >> 4
    assert np.array_equal(leaves.reshape(mp, 16, 2), want.reshape(16, mp, 2).transpose(1, 0, 2))


def test_composition_limits_hold_on_every_device():
    case = _case(6, seed=1)
    args = (_port_oracles(case), _instance(tfri, case), case["openings"], case["alpha"], 6)
    with pytest.raises(ValueError):
        _composition(*args, arity_bits=tfri.MAX_ARITY_BITS + 1)
    many = dict(case, polys=(((0, 0),) * (tfri.MAX_TERMS + 1),),
                openings=[np.zeros((tfri.MAX_TERMS + 1, 2), np.uint64)])
    with pytest.raises(ValueError):
        _composition(_port_oracles(many), _instance(tfri, many), many["openings"],
                                 many["alpha"], 6)
    bad = dict(case, polys=(case["polys"][0], ((2, 4),)))  # oracle 2 has 4 columns
    with pytest.raises(ValueError):
        _composition(_port_oracles(bad), _instance(tfri, bad), bad["openings"],
                                 bad["alpha"], 6)
    with pytest.raises(ValueError):
        _composition(*args[:4], 7)  # LDEs of 2^6 points, not 2^7


def test_eval_openings_match_reference():
    rng = np.random.default_rng(11)
    n = 1 << 5
    coeffs = [_felts((c, n), rng) for c in ROWS + (2,)]
    zeta, zeta_next = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    jparts, jnext = joracle.eval_openings(
        [SimpleNamespace(coeffs_dev=jgl.from_u64(c)) for c in coeffs], zeta, zeta_next,
        next_oracle=2, next_count=3,
    )
    tparts, tnext = _openings(
        [SimpleNamespace(coeffs=gl.from_u64(c, "cpu")) for c in coeffs], zeta, zeta_next,
        next_oracle=2, next_count=3,
    )
    for t, j in zip(tparts + [tnext], list(jparts) + [jnext]):
        assert np.array_equal(t, j)


@pytest.fixture(scope="module")
def leaf_layout_openings():
    """n = 2^12 (four of kernel D's chunks), the leaf's four oracle segments
    and three rows of the third at g * zeta, through the JAX package once."""
    rows, _ = _leaf_shapes()
    rng = np.random.default_rng(12)
    coeffs = [_felts((c, 1 << 12), rng, edges=True) for c in rows]
    zeta, zeta_next = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    want = joracle.eval_openings(
        [SimpleNamespace(coeffs_dev=jgl.from_u64(c)) for c in coeffs], zeta, zeta_next,
        next_oracle=2, next_count=3,
    )
    return coeffs, zeta, zeta_next, want


@pytest.mark.parametrize("next_count", [0, 3])
def test_eval_openings_at_leaf_layout_match_reference(leaf_layout_openings, next_count):
    """The rows at zeta do not depend on next_count, so one JAX call holds
    both cases."""
    coeffs, zeta, zeta_next, (jparts, jnext) = leaf_layout_openings
    tparts, tnext = _openings(
        [SimpleNamespace(coeffs=gl.from_u64(c, "cpu")) for c in coeffs], zeta, zeta_next,
        next_oracle=2, next_count=next_count,
    )
    for t, j in zip(tparts, jparts):
        assert np.array_equal(t, j)
    assert np.array_equal(tnext, jnext[:next_count])


def _reference_round(values, beta, a_bits, log_m, shift_pow, next_bits):
    """The JAX package's round: its leaves, then a binary folds, then the
    next round's leaves."""
    gv = jext.j_from_u64(values)
    leaves = jgl.to_u64(jfri._get_regroup_jit(a_bits)(gv))
    beta_t = np.asarray(beta, dtype=np.uint64)
    for t in range(a_bits):
        inv_x = jfri._inv_x_table(log_m - t, shift_pow + t)
        gv = jfri._get_fold_jit()(gv, jext.j_from_u64(beta_t), jgl.from_u64(inv_x))
        beta_t = jext.mul(beta_t, beta_t)
    folded = jext.j_to_u64(gv)
    nxt = jgl.to_u64(jfri._get_regroup_jit(next_bits)(gv)) if next_bits else folded
    return leaves, nxt


@pytest.mark.parametrize("a_bits", [1, 2, 3, 4])
def test_fold_round_matches_reference(a_bits):
    log_m, shift_pow = 6, 2
    rng = np.random.default_rng(20 + a_bits)
    values = _felts((1 << log_m, 2), rng, edges=True)
    beta = JF.rand_felts(2, rng)
    next_bits = 1 if a_bits < 4 else 0
    want_leaves, want_next = _reference_round(values, beta, a_bits, log_m, shift_pow, next_bits)
    leaves = tfri._regroup_leaves(gl.from_u64(values, "cpu"), a_bits)
    assert np.array_equal(gl.to_u64(leaves), want_leaves)
    got = _fold(leaves, beta, a_bits, log_m, shift_pow, next_bits)
    assert np.array_equal(gl.to_u64(got), want_next)


def test_fold_rounds_in_a_chain_match_reference():
    """Two rounds of arity 2^4 as the degree-16 schedule runs them: 2^12
    values into leaves of arity 2^4, folded into natural order."""
    log_m, shift_pow = 12, 1
    rng = np.random.default_rng(28)
    values = _felts((1 << log_m, 2), rng, edges=True)
    betas = [JF.rand_felts(2, rng) for _ in range(2)]
    want_leaves, want_next = _reference_round(values, betas[0], 4, log_m, shift_pow, 4)
    leaves = tfri._regroup_leaves(gl.from_u64(values, "cpu"), 4)
    assert np.array_equal(gl.to_u64(leaves), want_leaves)
    got = _fold(leaves, betas[0], 4, log_m, shift_pow, 4)
    assert np.array_equal(gl.to_u64(got), want_next)
    folded = gl.to_u64(tfri._ungroup_leaves(got, 4))
    _, want_last = _reference_round(folded, betas[1], 4, log_m - 4, shift_pow + 4, 0)
    last = _fold(got, betas[1], 4, log_m - 4, shift_pow + 4, 0)
    assert np.array_equal(gl.to_u64(last), want_last)


@pytest.mark.parametrize("log_m, shift_pow, a_bits", [(11, 0, 3), (19, 0, 4), (15, 4, 4), (7, 3, 1)])
def test_fold_consts_give_the_inverse_twiddles(log_m, shift_pow, a_bits):
    """Kernel E forms fold t's inverse twiddle of value q + j m' as
    w^(-2^t q) c_tj from `_fold_consts`; the product must equal the plain
    version's `_inv_x_table` (the JAX package's table) at rows 0, 1, m' - 1
    and one between."""
    consts = [int(x) for x in tfri._fold_consts(log_m, shift_pow, a_bits)]
    wb, c, scale = consts[:32], consts[32:47], consts[47]
    mp = 1 << (log_m - a_bits)
    assert scale * pow(2, a_bits, P) % P == 1
    for t in range(a_bits):
        table = jfri._inv_x_table(log_m - t, shift_pow + t)
        for q in (0, 1, mp - 1, mp // 3):
            w_q = 1
            for b in range(32):
                if q >> b & 1:
                    w_q = w_q * wb[b] % P
            for j in range(1 << (a_bits - t - 1)):
                got = pow(w_q, 1 << t, P) * c[(1 << a_bits) - (1 << (a_bits - t)) + j] % P
                assert got == int(table[q + j * mp]), (t, q, j)


def test_fold_round_refuses_arity_above_its_limit():
    leaves = torch.zeros((4, 2 << 5), dtype=torch.int64)
    with pytest.raises(ValueError):
        _fold(leaves, np.zeros(2, np.uint64), 5, 7, 0)


def test_query_gather_matches_reference():
    """Initial rows and Merkle paths of three oracles and one FRI round's
    leaves and path, for indices that include 0 and m - 1."""
    rng = np.random.default_rng(30)
    log_m, a_bits, cap_h = 6, 2, 1
    m = 1 << log_m
    ldes = [_felts((c, m), rng) for c in ROWS]
    oracles = []
    for l in ldes:
        lde = gl.from_u64(l, "cpu")
        oracles.append(SimpleNamespace(lde=lde, tree=tmerkle.build_merkle_tree(lde.T, cap_h)))
    leaves = gl.from_u64(_felts((m >> a_bits, 2 << a_bits), rng), "cpu")
    layer_tree = tmerkle.build_merkle_tree(leaves, cap_h)
    indices = [0, m - 1, 5, 37, 5]
    rounds = tfri.gather_query_rounds(oracles, [(leaves, layer_tree)], indices)

    rows = joracle.open_rows_many([SimpleNamespace(lde=jgl.from_u64(l)) for l in ldes], indices)
    jtrees = [jmerkle.MerkleTree(levels=o.tree.levels, cap_height=cap_h) for o in oracles]
    jlayer = jmerkle.MerkleTree(levels=layer_tree.levels, cap_height=cap_h)
    leaves_host = gl.to_u64(leaves)
    for qi, q in enumerate(indices):
        r = rounds[qi]
        for oi in range(len(oracles)):
            assert np.array_equal(r.initial_rows[oi], rows[oi][qi])
            assert np.array_equal(r.initial_siblings[oi], jtrees[oi].prove(q))
        q1 = q % leaves_host.shape[0]
        (step,) = r.steps
        assert np.array_equal(step.leaf_values, leaves_host[q1].reshape(-1, 2))
        assert np.array_equal(step.siblings, jlayer.prove(q1))
    # the trees' digest levels stay where they were built; the cap is on the host
    assert all(isinstance(d, torch.Tensor) for d in layer_tree.digests)
    assert isinstance(layer_tree.cap, np.ndarray)


def test_wrappers_refuse_non_cuda_accelerator_tensors():
    case = _case(6, seed=3)
    meta = [SimpleNamespace(lde=torch.zeros((c, 64), dtype=torch.int64, device="meta"))
            for c in ROWS]
    with pytest.raises(ValueError):
        _composition(meta, _instance(tfri, case), case["openings"], case["alpha"], 6)
    with pytest.raises(ValueError):
        _fold(torch.zeros((16, 8), dtype=torch.int64, device="meta"),
                        np.zeros(2, np.uint64), 2, 6, 0)
    with pytest.raises(ValueError):
        _openings([SimpleNamespace(coeffs=o.lde) for o in meta], (1, 2), (3, 4))
    with pytest.raises(ValueError):
        tfri.query_gather([tfri.GatherSource(meta[0].lde, 63)], [1])


def _gather_layout(lde_bits, schedule, rows, cap=4, seed=0, device="cpu", paths=True):
    """Kernel F's sources as the prover lays them out (chip_smoke.py's
    construction): each oracle's rows (its LDE read as (m, C) rows) and the
    Merkle siblings of every level below the cap, then each FRI round's
    leaves and siblings; a tree's path as one source (`paths`, the prover's
    form: its levels one after another in one buffer) or a source a level.
    Every source is a strided view of one random buffer, so m = 2^19 costs
    a few tens of MB; the packing, not the hashing, is under test."""
    m = 1 << lde_bits
    buf = torch.randint(0, 1 << 62, (8 * m + 4096,), generator=torch.Generator().manual_seed(seed),
                        dtype=torch.int64).to(device)

    def view(n, w, rs, cs):
        return buf.as_strided((n, w), (rs, cs))

    def siblings(bits):
        mask = (1 << bits) - 1
        if paths:
            return [tfri.GatherSource(view(1 << bits, 4, 4, 1), mask, flip=1, levels=bits - cap)]
        return [tfri.GatherSource(view(1 << (bits - l), 4, 4 if bits - l < 10 else 1, 1),
                                  mask, shift=l, flip=1) for l in range(bits - cap)]

    sources = []
    for c in rows:
        sources.append(tfri.GatherSource(view(m, c, 1, 7), m - 1))
    for _ in rows:
        sources += siblings(lde_bits)
    bits = lde_bits
    for a in schedule:
        bits -= a
        sources.append(tfri.GatherSource(view(1 << bits, 2 << a, 2 << a if bits < 10 else 3, 1),
                                         (1 << bits) - 1))
        sources += siblings(bits) if bits > cap else []
    return sources, buf


def _gather_indices(m, count, seed):
    rng = np.random.default_rng(seed)
    return [0, m - 1] + [int(i) for i in rng.integers(0, m, count - 2)]


GATHER_LAYOUTS = [(11, [3], True, 10), (19, [4, 4, 3], True, 14),
                  (11, [3], False, 37), (19, [4, 4, 3], False, 89)]


@pytest.mark.parametrize("lde_bits, schedule, paths, segments", GATHER_LAYOUTS)
def test_packed_gather_plan_gives_the_plain_gather(lde_bits, schedule, paths, segments):
    """The leaf's plan (m = 2^11, one round of arity 2^3) and the degree-16
    tail's (m = 2^19, schedule [4, 4, 3]), with a tree's path as one segment
    (10 and 14 segments, the prover's form) or a segment a level (37 and
    89), 28 queries with 0 and m - 1: the plan kernel F receives, read back
    by its plain reader, gives `query_gather_plain`'s rows, and a path
    gives what its levels give one by one."""
    rows, _ = _leaf_shapes()
    sources, buf = _gather_layout(lde_bits, schedule, rows, seed=lde_bits, paths=paths)
    assert len(sources) == segments
    indices = _gather_indices(1 << lde_bits, 28, lde_bits)
    plan, width = tfri.pack_gather_plan(sources, indices)
    assert len(plan) == tfri.GATHER_PLAN_BYTES <= 4096
    want = tfri.query_gather_plain(sources, indices)
    assert width == want.shape[1]
    assert torch.equal(tfri.query_gather_packed_plain(plan, [buf]), want)
    assert np.array_equal(tfri.query_gather(sources, indices), gl.to_u64(want))


def test_merkle_path_source_gives_the_levels():
    """`_sibling_sources` of a built tree is one path source whose gather
    equals the per-level siblings ((q >> l) ^ 1 at level l)."""
    lde = torch.randint(0, 1 << 62, (5, 64), generator=torch.Generator().manual_seed(3))
    tree = tmerkle.build_merkle_tree(lde.T, 1)
    (path,) = tfri._sibling_sources(tree, 63)
    assert path.levels == len(tree.digests) - 1 == 5
    indices = [0, 63, 17, 40]
    want = torch.cat([lvl[[(q >> l) ^ 1 for q in indices]] for l, lvl in
                      enumerate(tree.digests[:-1])], dim=1)
    assert np.array_equal(tfri.query_gather([path], indices), gl.to_u64(want))
    plan, _ = tfri.pack_gather_plan([path], indices)
    assert torch.equal(tfri.query_gather_packed_plain(plan, [tree.digests[0]]), want)
    with pytest.raises(ValueError):  # levels that are not one buffer
        tfri._sibling_sources(tmerkle.MerkleTree([d.clone() for d in tree.digests], tree.cap, 1), 63)


def test_gather_plan_capacity():
    """The largest plan (128 segments, one of width 1, 128 queries) packs and
    reads back; one segment or one query over it raises, on the CPU too."""
    buf = torch.arange(1 << 12, dtype=torch.int64)
    sources = [tfri.GatherSource(buf.as_strided((256, 3), (3, 1)), 255, shift=k % 3, flip=k % 2)
               for k in range(tfri.MAX_GATHER_SEGMENTS - 1)]
    sources.append(tfri.GatherSource(buf.as_strided((256, 1), (1, 1)), 255))
    indices = _gather_indices(256, tfri.MAX_GATHER_QUERIES, 1)
    plan, width = tfri.pack_gather_plan(sources, indices)
    want = tfri.query_gather_plain(sources, indices)
    assert width == 3 * (tfri.MAX_GATHER_SEGMENTS - 1) + 1
    assert torch.equal(tfri.query_gather_packed_plain(plan, [buf]), want)
    assert np.array_equal(tfri.query_gather(sources, indices), gl.to_u64(want))
    for srcs, idx in ((sources + sources[:1], indices), (sources, indices + [7])):
        with pytest.raises(ValueError):
            tfri.pack_gather_plan(srcs, idx)
        with pytest.raises(ValueError):
            tfri.query_gather(srcs, idx)


@pytest.mark.parametrize("source, indices", [
    (dict(mask=6), [1]),  # not 2^k - 1
    (dict(mask=255, shift=32), [1]),
    (dict(mask=511), [1]),  # rows past the matrix
    (dict(mask=255), [-1]),
    (dict(mask=255), [1 << 32]),
    (dict(mask=255, levels=9), [1]),  # more levels than the tree has
    (dict(mask=255, levels=8), [1]),  # levels past the buffer
    (dict(mask=255, shift=1, levels=2), [1]),
])
def test_gather_plan_refuses_what_the_kernel_cannot_read(source, indices):
    mat = torch.zeros((256, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        tfri.pack_gather_plan([tfri.GatherSource(mat, **source)], indices)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version, leaf shapes


def _leaf_shapes():
    """The leaf's FRI shapes: the four oracles' column counts, m = 2048."""
    return (8 + 6 + 80, 135, 20, 16), 11


@pytest.mark.gpu
def test_fri_kernels_match_plain_on_card(cuda):
    rows, lde_bits = _leaf_shapes()
    m = 1 << lde_bits
    rng = np.random.default_rng(40)
    case = _case(lde_bits, seed=41, edges=True)
    case["ldes"] = [_felts((c, m), rng, edges=True) for c in rows]
    case["polys"] = (tuple((o, k) for o, c in enumerate(rows) for k in range(c)),
                     ((2, 0), (2, 1)))
    case["openings"] = [JF.rand_felts((sum(rows), 2), rng), JF.rand_felts((2, 2), rng)]
    args = (_instance(tfri, case), case["openings"], case["alpha"], lde_bits)
    before = [f.launches for f in (gl.add, gl.sub, gl.mul)]
    for arity in (3, 0, 4):  # the leaf's first round, natural order, the largest
        got = _composition(_port_oracles(case, cuda), *args, arity)
        assert torch.equal(got.cpu(), _composition(_port_oracles(case), *args, arity))

    beta = JF.rand_felts(2, rng)
    for a in (3, 1, 2, 4):
        for next_bits in (0, 2):
            leaves = gl.from_u64(_felts((m >> a, 2 << a), rng, edges=True), cuda)
            got_f = _fold(leaves, beta, a, lde_bits, 1, next_bits)
            want_f = _fold(leaves.cpu(), beta, a, lde_bits, 1, next_bits)
            assert torch.equal(got_f.cpu(), want_f), (a, next_bits)

    coeffs = [SimpleNamespace(coeffs=gl.from_u64(_felts((c, m >> 3), rng, edges=True), cuda))
              for c in rows]
    zeta, zn = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    got_o = _openings(coeffs, zeta, zn, next_oracle=2, next_count=2)
    want_o = _openings([SimpleNamespace(coeffs=c.coeffs.cpu()) for c in coeffs],
                                   zeta, zn, next_oracle=2, next_count=2)
    for g, w in zip(got_o[0] + [got_o[1]], want_o[0] + [want_o[1]]):
        assert np.array_equal(g, w)

    lde = gl.from_u64(case["ldes"][1], cuda)
    tree = tmerkle.build_merkle_tree(lde.T, 4)
    sources = [tfri.GatherSource(lde.T, m - 1)] + tfri._sibling_sources(tree, m - 1)
    indices = [0, m - 1, 7, 1000]
    got_g = tfri.query_gather(sources, indices)
    assert len(sources) == 2  # the rows, and the Merkle path as one segment
    assert np.array_equal(got_g, gl.to_u64(tfri.query_gather_plain(sources, indices)))
    assert [f.launches for f in (gl.add, gl.sub, gl.mul)] == before


@pytest.mark.gpu
def test_composition_matches_plain_over_many_tiles_on_card(cuda):
    """Kernel C at m = 2^13 (512 tiles of 16 points, several a block) with
    three batches, two of them at domain points (zero denominators), in
    every arity's leaf layout."""
    rows, lde_bits = _leaf_shapes()
    lde_bits += 2
    m = 1 << lde_bits
    rng = np.random.default_rng(42)
    case = _case(lde_bits, seed=43, edges=True)
    case["ldes"] = [_felts((c, m), rng, edges=True) for c in rows]
    xs = tfri._domain_points(lde_bits)
    case["polys"] = (tuple((o, k) for o, c in enumerate(rows) for k in range(c)),
                     ((2, 0), (2, 1)), ((1, 5),))
    case["points"] = ((int(xs[15]), 0), tuple(int(v) for v in JF.rand_felts(2, rng)),
                      (int(xs[16]), 0))
    case["openings"] = [JF.rand_felts((len(p), 2), rng) for p in case["polys"]]
    args = (_instance(tfri, case), case["openings"], case["alpha"], lde_bits)
    for arity in range(tfri.MAX_ARITY_BITS + 1):
        got = _composition(_port_oracles(case, cuda), *args, arity)
        assert torch.equal(got.cpu(), _composition(_port_oracles(case), *args, arity))


@pytest.mark.gpu
def test_openings_sum_across_blocks_on_card(cuda):
    """Kernel D at n = 2^16 (64 chunks: partial sums, then a second launch),
    265 rows at zeta and 2 at g * zeta (not a multiple of a 32-row tile),
    and at 2^16 + 1 (a last chunk of one coefficient), against the plain
    version run on the card."""
    rows, _ = _leaf_shapes()
    rng = np.random.default_rng(44)
    for n in (1 << 16, (1 << 16) + 1):
        oracles = [SimpleNamespace(coeffs=gl.from_u64(_felts((c, n), rng, edges=True), cuda))
                   for c in rows]
        zeta, zn = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
        before = toracle.eval_openings.launches
        got = _openings(oracles, zeta, zn, next_oracle=2, next_count=2)
        assert toracle.eval_openings.launches - before == 2
        want = _openings(oracles, zeta, zn, next_oracle=2, next_count=2, plain=True)
        for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
            assert np.array_equal(g, w), n


@pytest.mark.gpu
def test_fold_twiddles_on_card_match_plain(cuda):
    """Kernel E forms its inverse twiddles on the card: every arity 2^1..2^4
    and coset shift g^(2^0..2^3), at a layer of fewer rows than a block, the
    leaf's 2^11, and up to m = 2^19 (above the spread limit), against the
    plain version run on the card."""
    rng = np.random.default_rng(45)
    for a in range(1, tfri.MAX_ARITY_BITS + 1):
        for log_m in (a + 3, 11, 15 + a):
            leaves = gl.from_u64(_felts((1 << (log_m - a), 2 << a), rng, edges=True), cuda)
            for shift_pow in range(4):
                beta = JF.rand_felts(2, rng)
                nxt = min(4, log_m - a) if shift_pow % 2 else 0
                got = _fold(leaves, beta, a, log_m, shift_pow, nxt)
                want = _fold(leaves, beta, a, log_m, shift_pow, nxt, plain=True)
                assert torch.equal(got, want), (a, log_m, shift_pow)


@pytest.mark.gpu
def test_query_gather_plan_edges_on_card(cuda):
    """Kernel F against the plain gather: the leaf's and the degree-16
    tail's layouts (10 and 14 segments with a path a tree, 37 and 89 with a
    segment a level; indices 0 and m - 1), the largest plan (128 segments,
    one of width 1, 128 queries, a packed row of 382 values: not a multiple
    of a warp) and a packed row of 1,200 values (wider than a block: its
    threads stride), each in one launch into pinned host memory; one over
    the plan raises."""
    rows, _ = _leaf_shapes()
    cases = []
    for lde_bits, schedule, paths, _ in GATHER_LAYOUTS:
        sources, _ = _gather_layout(lde_bits, schedule, rows, seed=lde_bits, device=cuda,
                                    paths=paths)
        cases.append((sources, _gather_indices(1 << lde_bits, 28, lde_bits)))
    buf = torch.arange(1 << 12, dtype=torch.int64, device=cuda)
    big = [tfri.GatherSource(buf.as_strided((256, 3), (3, 1)), 255, shift=k % 3, flip=k % 2)
           for k in range(tfri.MAX_GATHER_SEGMENTS - 1)]
    big.append(tfri.GatherSource(buf.as_strided((256, 1), (1, 1)), 255))
    big_idx = _gather_indices(256, tfri.MAX_GATHER_QUERIES, 2)
    cases.append((big, big_idx))
    wide = torch.arange(64 * 600, dtype=torch.int64, device=cuda).reshape(64, 600)
    cases.append(([tfri.GatherSource(wide, 63), tfri.GatherSource(wide, 63, flip=1)],
                  _gather_indices(64, 28, 3)))
    for sources, indices in cases:
        want = tfri.query_gather_plain(sources, indices)
        before = tfri.query_gather.launches
        assert np.array_equal(tfri.query_gather(sources, indices), gl.to_u64(want))
        assert tfri.query_gather.launches - before == 1
    with pytest.raises(ValueError):
        tfri.query_gather(big + big[:1], big_idx)
    with pytest.raises(ValueError):
        tfri.query_gather(big, big_idx + [0])
