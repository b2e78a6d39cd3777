"""The port's Poseidon2 (kernel 2 and its plain version), Merkle levels and
PoW grind against the JAX package's host implementations. Bit-exact."""

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.hash import poseidon2 as jps
from qp_zk_circuits_tpu.plonk import transcript as jts
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.hash import merkle as tmerkle
from qp_zk_circuits_tpu_torch.hash import poseidon2 as tps
from qp_zk_circuits_tpu_torch.plonk import transcript as tts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def _t(x, device="cpu"):
    return gl.from_u64(x, device)


def test_constants_equal_reference():
    for mine, ref in zip(tps._constants(), jps._constants()):
        assert np.array_equal(mine, ref)


def test_permute_matches_reference_and_kats():
    rng = np.random.default_rng(1)
    states = JF.rand_felts((16, 12), rng)
    assert np.array_equal(gl.to_u64(tps.permute(_t(states))), jps.permute_np(states))
    zero = gl.to_u64(tps.permute(_t(np.zeros((1, 12), dtype=np.uint64))))[0]
    # frozen KAT of tests/test_poseidon2.py (the published t=12 instance)
    assert [int(v) for v in zero] == [
        0x7315F746536F5085, 0x7EE94CDFE16C5597, 0x8373CDEAD56208D9,
        0xBC6181B321506C57, 0x623A5D1FBF93D184, 0x993D9E22E95BE753,
        0x39BCED9D7A22A6F7, 0x21D8B250C32DDC93, 0x6FD552D761FDEA16,
        0x4E6BC4262CED27B8, 0x3601F3EB37D4CE60, 0xD41BFF6F8B5664BC,
    ]


def test_hash_rows_kat():
    got = gl.to_u64(tps.hash_rows(_t(np.arange(8, dtype=np.uint64).reshape(1, 8))))[0]
    assert [int(v) for v in got] == [
        0xF3F6401D6EEE907C, 0x4F06591DEA08D1F5, 0x6DC5FF5AB495D3D7, 0x858FB59F2524D0C2,
    ]


@pytest.mark.parametrize("cols", [1, 4, 5, 8, 9, 16, 17, 135])
def test_hash_rows_matches_hash_or_noop(cols):
    rng = np.random.default_rng(cols)
    rows = JF.rand_felts((6, cols), rng)
    got = gl.to_u64(tps.hash_rows(_t(rows)))
    want = np.stack([jps.hash_or_noop(r) for r in rows])
    assert np.array_equal(got, want)


def test_hash_rows_reads_strided_rows():
    rng = np.random.default_rng(2)
    cols_major = JF.rand_felts((11, 8), rng)  # an LDE (C, M): rows are columns
    got = gl.to_u64(tps.hash_rows(_t(cols_major).T))
    want = np.stack([jps.hash_no_pad(cols_major[:, i]) for i in range(8)])
    assert np.array_equal(got, want)


def test_two_to_one_matches_reference():
    rng = np.random.default_rng(3)
    left, right = JF.rand_felts((5, 4), rng), JF.rand_felts((5, 4), rng)
    got = gl.to_u64(tps.two_to_one(_t(left), _t(right)))
    want = np.stack([jps.two_to_one(l, r) for l, r in zip(left, right)])
    assert np.array_equal(got, want)


def test_host_sponges_match_reference():
    rng = np.random.default_rng(4)
    for n in (0, 3, 8, 21, 45):
        x = JF.rand_felts(n, rng)
        assert np.array_equal(tps.hash_no_pad(x), jps.hash_no_pad(x))
        assert np.array_equal(tps.hash_padded(x), jps.hash_padded(x))
    s = JF.rand_felts((3, 12), rng)
    assert np.array_equal(tps.permute_np(s), jps.permute_np(s))


def test_merkle_levels_match_host_tree():
    rng = np.random.default_rng(5)
    leaves = JF.rand_felts((16, 7), rng)
    tree = tmerkle.build_merkle_tree(_t(leaves), cap_height=1)
    level = np.stack([jps.hash_or_noop(r) for r in leaves])
    assert np.array_equal(tree.levels[0], level)
    while level.shape[0] > 2:
        level = np.stack([jps.two_to_one(level[i], level[i + 1]) for i in range(0, len(level), 2)])
    assert np.array_equal(tree.cap, level)
    # a query path recomputes the cap entry on the reference's host walk
    from qp_zk_circuits_tpu.hash.merkle import verify_merkle_proof

    assert verify_merkle_proof(leaves[13], 13, tree.prove(13), tree.cap)


def _host_levels(leaves, cap_height):
    """The reference's host walk: hash_or_noop of each row, then two_to_one
    of each pair up to the cap."""
    level = np.stack([jps.hash_or_noop(r) for r in leaves])
    levels = [level]
    while level.shape[0] > 1 << cap_height:
        level = np.stack([jps.two_to_one(level[i], level[i + 1]) for i in range(0, len(level), 2)])
        levels.append(level)
    return levels


@pytest.mark.parametrize("cap", [0, 2, "log_n"])
@pytest.mark.parametrize("leaves", [16, 256])
@pytest.mark.parametrize("cols", [4, 5, 135])
def test_merkle_levels_match_host_walk(cols, leaves, cap):
    cap = leaves.bit_length() - 1 if cap == "log_n" else cap
    rows = JF.rand_felts((leaves, cols), np.random.default_rng(cols * leaves + cap))
    got = tps.merkle_levels(_t(rows), cap)
    want = _host_levels(rows, cap)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(gl.to_u64(g), w)


def test_merkle_tree_matches_jax_build_merkle_tree():
    """One tree against the JAX package's own builder; a path from
    MerkleTree.prove passes the reference's verify_merkle_proof."""
    from qp_zk_circuits_tpu.field import goldilocks as jgl
    from qp_zk_circuits_tpu.hash import merkle as jmerkle

    # the shape of tests/test_poly_merkle.py's tree: one compiled JAX graph
    rows = JF.rand_felts((64, 7), np.random.default_rng(11))
    ref = jmerkle.build_merkle_tree(jgl.from_u64(rows), cap_height=2)
    tree = tmerkle.build_merkle_tree(_t(rows), cap_height=2)
    assert len(tree.levels) == len(ref.levels)
    for mine, theirs in zip(tree.levels, ref.levels):
        assert np.array_equal(mine, theirs)
    assert np.array_equal(tree.cap, ref.cap)
    for idx in (0, 6, 63):
        assert jmerkle.verify_merkle_proof(rows[idx], idx, tree.prove(idx), tree.cap)
    assert not jmerkle.verify_merkle_proof(rows[7], 6, tree.prove(6), tree.cap)


def test_merkle_levels_read_strided_lde():
    """A commit's tree over lde.T, read in place (row stride 1, column stride
    M), equals the tree over the same rows made contiguous and the host walk."""
    lde = _t(JF.rand_felts((11, 32), np.random.default_rng(12)))
    rows = lde.T
    assert rows.stride() == (1, 32)
    got = tps.merkle_levels(rows, 2)
    for g, c, w in zip(got, tps.merkle_levels(rows.contiguous(), 2),
                       _host_levels(gl.to_u64(rows.contiguous()), 2)):
        assert torch.equal(g, c)
        assert np.array_equal(gl.to_u64(g), w)


def test_tree_plan_at_the_leaf():
    """The four trees of a leaf proof on a 132-SM card: blocks of 8 rows (one
    warp) so that the blocks cover the SMs, at most two launches each; an
    aggregation-size tree takes 64-row blocks."""
    sms = 132
    assert tps.tree_plan(2048, 4, sms) == (8, 3, 4)  # the LDE trees
    assert tps.tree_plan(256, 4, sms) == (8, 3, 1)  # the FRI layer
    assert tps.tree_plan(2048, 11, sms) == (8, 0, 0)  # the leaves are the cap
    assert tps.tree_plan(1 << 19, 4, sms) == (64, 6, 9)
    assert tps.tree_plan(4, 0, sms) == (4, 2, 0)
    for rows in (1, 2, 16, 256, 2048, 1 << 15, 1 << 19):
        for cap in range(rows.bit_length()):
            run, in_block, left = tps.tree_plan(rows, cap, sms)
            assert rows % run == 0 and (1 << in_block) <= run <= 64
            assert in_block + left == rows.bit_length() - 1 - cap


def test_merkle_levels_launch_writes_one_buffer(monkeypatch):
    """The device path makes one entry call a tree, counts its launches and
    hands back (n_l, 4) views of one buffer in level order."""
    calls = []
    monkeypatch.setattr(tps, "_launch", lambda entry, device, *args: calls.append((entry, args)))
    before = tps.merkle_levels.launches
    leaves = torch.zeros((135, 2048), dtype=torch.int64).T
    levels = tps._launch_tree(leaves, 4, tps.tree_plan(2048, 4, 132))
    assert tps.merkle_levels.launches == before + 2
    (entry, args), = calls
    assert entry == "qzk_poseidon2_merkle_forest"  # a forest of one tree
    assert args[2] == 1 and args[4:] == (2048, 135, 1, 2048, 8, 3, 4)
    assert [lvl.shape[0] for lvl in levels] == [2048 >> i for i in range(8)]
    base = levels[0].data_ptr()
    offsets = [(lvl.data_ptr() - base) // 8 for lvl in levels]
    assert offsets == [4 * sum(2048 >> j for j in range(i)) for i in range(8)]
    assert args[1] == base
    tps._launch_tree(torch.zeros((256, 16), dtype=torch.int64), 4, tps.tree_plan(256, 4, 132))
    tps._launch_tree(torch.zeros((16, 16), dtype=torch.int64), 4, tps.tree_plan(16, 4, 132))
    assert tps.merkle_levels.launches == before + 5


@pytest.mark.parametrize("shape, cap", [((6, 4), 0), ((8, 4), 4), ((8,), 0)])
def test_merkle_levels_refuse_bad_trees(shape, cap):
    with pytest.raises(ValueError):
        tps.merkle_levels(torch.zeros(shape, dtype=torch.int64), cap)


def test_merkle_levels_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card raises; nothing falls
    back to the plain version."""
    with pytest.raises(ValueError):
        tps.merkle_levels(torch.zeros((8, 5), dtype=torch.int64, device="meta"), 1)


def _lowest_witness(challenger, pow_bits):
    w = 0
    while not jts.check_pow(challenger.fork(), np.uint64(w), pow_bits):
        w += 1
    return np.uint64(w)


@pytest.mark.parametrize("pending", [0, 3, 7])
def test_grind_returns_lowest_witness(pending):
    """Batches of 64 candidates force several sweeps; the result is the
    lowest passing index, as a sequential search finds it."""
    rng = np.random.default_rng(6 + pending)
    ref = jts.Challenger()
    mine = tts.Challenger()
    felts = JF.rand_felts(8 + pending, rng)
    ref.observe_many(felts)
    mine.observe_many(felts)
    got = tts.grind_pow(mine, 8, "cpu", batch=64)
    assert got == _lowest_witness(ref, 8)


_EDGES = np.array([0, 1, gl.P - 1, gl.P - 2, (1 << 32) - 1, 1 << 32], dtype=np.uint64)


def _edge_felts(shape, rng):
    """Random felts led by the field edge values: each repeated 12 times,
    then the six in turn, 12 times over."""
    x = JF.rand_felts(shape, rng)
    flat = x.reshape(-1)
    edges = np.concatenate([np.repeat(_EDGES, 12), np.tile(_EDGES, 12)])
    n = min(flat.size, edges.size)
    flat[:n] = edges[:n]
    return x


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    rng = np.random.default_rng(7)
    states = _t(JF.rand_felts((1 << 12, 12), rng), cuda)
    assert torch.equal(tps.permute(states), tps.permute_plain(states))
    lde = _t(JF.rand_felts((135, 256), rng), cuda)
    assert torch.equal(tps.hash_rows(lde.T), tps.hash_rows_plain(lde.T))
    level = _t(JF.rand_felts((256, 4), rng), cuda)
    assert torch.equal(
        tps.two_to_one(level[0::2], level[1::2]),
        tps.two_to_one_plain(level[0::2], level[1::2]),
    )
    # batches that are not a multiple of a block, with the field edge values
    # in the states: permute runs one thread a state, hash_rows and
    # two_to_one the lane-split form (rows of <= 4 felts pass unhashed)
    for batch in (1, 31, 33, 1029):
        s = _t(_edge_felts((batch, 12), rng), cuda)
        assert torch.equal(tps.permute(s), tps.permute_plain(s)), batch
        pairs = _t(_edge_felts((2 * batch, 4), rng), cuda)
        assert torch.equal(tps.two_to_one(pairs[0::2], pairs[1::2]),
                           tps.two_to_one_plain(pairs[0::2], pairs[1::2])), batch
    for cols in (1, 4, 5, 135):
        rows = _t(_edge_felts((cols, 2051), rng), cuda).T
        assert torch.equal(tps.hash_rows(rows), tps.hash_rows_plain(rows)), cols
    # the tree's edge plans: rows of <= 4 felts, the leaves as the cap
    # (cap == log_n), no second launch
    for cols in (4, 5, 135):
        for n in (16, 256):
            for cap in (0, 2, n.bit_length() - 1):
                leaves = _t(_edge_felts((n, cols), rng), cuda)
                got = tps.merkle_levels(leaves, cap)
                want = tps.merkle_levels_plain(leaves, cap)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (cols, n, cap)
    # the leaf proof's four trees: wires, Z and partial products, quotient
    # (each over a strided lde.T), and the FRI layer's contiguous rows
    for cols, m, strided, cap in ((135, 2048, True, 4), (20, 2048, True, 4),
                                  (16, 2048, True, 4), (16, 256, False, 4)):
        x = _t(_edge_felts((cols, m) if strided else (m, cols), rng), cuda)
        leaves = x.T if strided else x
        got = tps.merkle_levels(leaves, cap)
        want = tps.merkle_levels_plain(leaves, cap)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (cols, m)
        assert got[0].data_ptr() + 8 * got[0].numel() == got[1].data_ptr()
