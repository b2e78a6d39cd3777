"""The port's fused quotient evaluation (kernel A) and permutation argument
(kernel B) against the JAX package's host reference.

On the CPU the port's `quotient_evals` and `compute_permutation_polys` run
their plain versions; their values at sampled LDE points must equal the JAX
package's `vanishing.eval_constraints` run in the host extension algebra
(base values embedded as (v, 0)), alpha-combined and multiplied by 1/Z_H.
The field is exact, so every comparison is bit-exact. The `gpu` cases hold
each kernel against its plain version (on CPU copies of the same inputs) on
the card, one gate type at a time, and skip without one. No JAX graph is
compiled here.
"""

import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import extension as jext
from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.plonk import builder as jbuilder
from qp_zk_circuits_tpu.plonk import gates as jgates
from qp_zk_circuits_tpu.plonk import prover as jprover
from qp_zk_circuits_tpu.plonk import vanishing as jvanishing
from qp_zk_circuits_tpu.poly import ntt as jntt
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.plonk import gates as tgates
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.poly import ntt as tntt

P = 0xFFFFFFFF00000001
FIXTURES = Path(__file__).parent / "torch_fixtures"


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_leaf_fixture", FIXTURES / "make_leaf_fixture.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _fixture_module()

GATE_CASES = [
    ("noop", lambda g: g.NoopGate()),
    ("arith", lambda g: g.ArithmeticGate(3)),
    ("const", lambda g: g.ConstantGate(2)),
    ("public_input", lambda g: g.PublicInputGate()),
    ("poseidon2", lambda g: g.Poseidon2Gate()),
    ("reduce_ext", lambda g: g.ReducingGate(3, True, 20)),
    ("reduce_base", lambda g: g.ReducingGate(4, False, 20)),
    ("base_sum", lambda g: g.BaseSumGate(9)),
]


@pytest.fixture(scope="module")
def small():
    """(reference shape-only data, port data on the CPU) of the small circuit."""
    jb, _, _ = MK.small_real_circuit("qp_zk_circuits_tpu")
    tb, _, _ = MK.small_real_circuit("qp_zk_circuits_tpu_torch")
    return jb.build(shape_only=True), tb.build(device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _with_gates(jdata, tdata, make, seed):
    """Both packages' circuit data reduced to the one gate type `make`, with
    one selector row and random constants, selector and sigmas."""
    cfg = tdata.config
    rows = tdata.const_cols.shape[0] + 1 + cfg.num_routed_wires
    lde = JF.rand_felts((rows, tdata.n << cfg.rate_bits), np.random.default_rng(seed))
    tdata = dataclasses.replace(
        tdata, gate_types=[make(tgates)], num_selectors=1,
        constants_oracle=SimpleNamespace(lde=gl.from_u64(lde, "cpu")),
    )
    tdata.__dict__.pop("_torch_tables", None)
    return SimpleNamespace(gate_types=[make(jgates)], config=jdata.config), tdata


def _inputs(tdata, seed):
    """Random LDE operands for `quotient_evals`, made with numpy, and the
    circuit's constants LDE."""
    cfg = tdata.config
    rng = np.random.default_rng(seed)
    m = tdata.n << cfg.rate_bits
    nc = cfg.num_challenges
    npp = tprover.num_partial_products(cfg.num_routed_wires, cfg.max_quotient_degree_factor)
    return dict(
        wires=JF.rand_felts((cfg.num_wires, m), rng),
        consts=gl.to_u64(tdata.constants_oracle.lde),
        zpp=JF.rand_felts((nc + nc * npp, m), rng),
        alphas=JF.rand_felts(nc, rng),
        betas=JF.rand_felts(nc, rng),
        gammas=JF.rand_felts(nc, rng),
        pi=JF.rand_felts(4, rng),
    )


def _port_evals(tdata, x, device="cpu"):
    rec = tprover.host_records(device, 1, tdata.config.num_challenges, alphas=x["alphas"],
                               betas=x["betas"], gammas=x["gammas"], pis=x["pi"])[0]
    return tprover.quotient_evals(
        tdata, gl.from_u64(x["wires"], device), gl.from_u64(x["zpp"], device), rec)


def _perm_rec(device, betas, gammas):
    """The challenge record of kernel B's betas and gammas on `device`."""
    return tprover.host_records(device, 1, len(betas), betas=betas, gammas=gammas)[0]


def _reference_evals(jref, nconst, nsel, n, rate_bits, x, points):
    """The JAX package's host constraint list at LDE points, alpha-combined,
    times 1/Z_H: (nc, len(points)) Python ints."""
    cfg = jref.config
    nr, nc = cfg.num_routed_wires, cfg.num_challenges
    npp = jvanishing.num_partial_products(nr, cfg.max_quotient_degree_factor)
    m = n << rate_bits
    g = JF.MULTIPLICATIVE_GROUP_GENERATOR
    w = JF.primitive_root_of_unity(n.bit_length() - 1 + rate_bits)
    ks = [int(k) for k in jbuilder.coset_shifts(nr)]
    rate = 1 << rate_bits
    out = [[] for _ in range(nc)]

    def e(v):
        return (int(v), 0)

    for j in points:
        xj = int(g) * pow(int(w), j, P) % P
        zh = (pow(xj, n, P) - 1) % P
        l1 = zh * pow(n * (xj - 1) % P, P - 2, P) % P
        col = x["consts"][:, j]
        cons = jvanishing.eval_constraints(
            jgates.HostExtCtx([e(v) for v in x["wires"][:, j]],
                              [e(v) for v in col[:nconst]], [e(v) for v in x["pi"]]),
            jref,
            [e(v) for v in x["wires"][:, j]],
            [e(v) for v in col[:nconst]],
            [e(v) for v in col[nconst : nconst + nsel]],
            [e(v) for v in col[nconst + nsel : nconst + nsel + nr]],
            [e(x["zpp"][c, j]) for c in range(nc)],
            [e(x["zpp"][c, (j + rate) % m]) for c in range(nc)],
            [[e(x["zpp"][nc + c * npp + t, j]) for t in range(npp)] for c in range(nc)],
            [(k * xj % P, 0) for k in ks],
            (l1, 0),
            [e(b) for b in x["betas"]],
            [e(v) for v in x["gammas"]],
            jvanishing.HostExtAlg(),
        )
        vals = [jext.pair(v) for v in cons]
        assert all(v[1] == 0 for v in vals)
        for c in range(nc):
            acc = 0
            for k, v in enumerate(vals):
                acc = (acc + pow(int(x["alphas"][c]), k, P) * v[0]) % P
            out[c].append(acc * pow(zh, P - 2, P) % P)
    return out


def test_quotient_evals_match_reference_host_eval(small):
    jdata, tdata = small
    x = _inputs(tdata, seed=0)
    got = gl.to_u64(_port_evals(tdata, x))
    points = [int(j) for j in np.random.default_rng(1).choice(got.shape[1], 8, replace=False)]
    want = _reference_evals(jdata, jdata.const_cols.shape[0], jdata.num_selectors, tdata.n,
                            tdata.config.rate_bits, x, points)
    for c, row in enumerate(want):
        assert [int(got[c, j]) for j in points] == row


@pytest.mark.parametrize("name, make", GATE_CASES)
def test_quotient_evals_match_reference_per_gate(small, name, make):
    """One gate type at a time (with random constants and selector), so a
    gate whose constraints are wrong shows by name."""
    jdata, tdata = small
    jref, tone = _with_gates(jdata, tdata, make, seed=len(name))
    nconst = tdata.const_cols.shape[0]
    x = _inputs(tone, seed=len(name))
    got = gl.to_u64(_port_evals(tone, x))
    points = [0, 5, 17, got.shape[1] - 1]
    want = _reference_evals(jref, nconst, 1, tone.n, tone.config.rate_bits, x, points)
    for c, row in enumerate(want):
        assert [int(got[c, j]) for j in points] == row, name


def test_descriptor_table_covers_every_gate_type(small):
    _, tdata = small
    gates = [make(tgates) for _, make in GATE_CASES]
    data = dataclasses.replace(tdata, gate_types=gates, num_selectors=len(gates))
    desc, k_total = tprover.quotient_descriptors(data)
    cfg = data.config
    nchunks = -(-cfg.num_routed_wires // cfg.max_quotient_degree_factor)
    assert desc.shape == (len(gates) + cfg.num_challenges, tprover.DESC_WIDTH)
    assert set(desc[: len(gates), 0].tolist()) == set(range(7))
    assert desc[len(gates):, 0].tolist() == [tgates.PERMUTATION_TYPE_ID] * cfg.num_challenges
    # selector rows follow the constants; first indices follow the canonical order
    nconst = data.const_cols.shape[0]
    assert desc[: len(gates), 4].tolist() == [nconst + s for s in range(len(gates))]
    counts = [g.num_constraints for g in gates] + [1 + nchunks] * cfg.num_challenges
    assert desc[:, 5].tolist() == np.cumsum([0] + counts[:-1]).tolist()
    assert k_total == sum(counts)
    assert tuple(desc[5, :4]) == (5, 3, 1, 20)  # ReducingGate(3, ext, scratch 20)
    # threads a point: a quad for the Poseidon2 gate and the permutation
    # rows, one otherwise; each group's blocks follow the last group's
    lanes = [4 if t in (4, tgates.PERMUTATION_TYPE_ID) else 1 for t in desc[:, 0]]
    assert desc[:, 6].tolist() == lanes
    m = data.n << cfg.rate_bits
    blocks = [min(-(-m * lane // tprover.QUOTIENT_THREADS), tprover.QUOTIENT_GROUP_BLOCKS)
              for lane in lanes]
    assert desc[:, 7].tolist() == np.cumsum([0] + blocks[:-1]).tolist()


def test_unknown_gate_is_refused(small):
    """A gate type kernel A does not know raises when the table is built,
    even a subclass of a known one; it never falls back to the torch chain."""

    @dataclasses.dataclass(frozen=True)
    class MyArith(tgates.ArithmeticGate):
        pass

    _, tdata = small
    for gate in (MyArith(2), tgates.Gate()):
        with pytest.raises(ValueError):
            tgates.gate_descriptor(gate)
        data = dataclasses.replace(tdata, gate_types=[gate], num_selectors=1)
        with pytest.raises(ValueError):
            tprover.quotient_descriptors(data)


def _trace(jdata, seed):
    return JF.rand_felts((jdata.config.num_wires, jdata.n), np.random.default_rng(seed))


@pytest.mark.parametrize("zero_den", [False, True])
def test_permutation_polys_match_reference(small, zero_den):
    """Including a zero denominator factor: 0^-1 = 0 on both sides, so that
    row's ratio and every later Z are 0."""
    jdata, tdata = small
    trace = _trace(jdata, seed=3)
    rng = np.random.default_rng(4)
    betas, gammas = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    if zero_den:
        row = 3
        gammas[0] = (-(int(trace[0, row]) + int(betas[0]) * int(jdata.sigma_vals[0, row]))) % P
    want = jprover.compute_permutation_polys(jdata, trace, betas, gammas)
    got = gl.to_u64(tprover.compute_permutation_polys(tdata, gl.from_u64(trace, "cpu"),
                                                      _perm_rec("cpu", betas, gammas)))
    assert np.array_equal(got, want)
    assert (got[0, 4:] == 0).all() == zero_den


def test_permutation_size_limit_holds_on_every_device(small):
    """Kernel B takes up to MAX_PERMUTATION_ROWS rows (its tile scan has no
    one-block cap); both wrappers refuse more, on every device, before they
    read the trace (a stride-0 view of the right shape)."""
    _, tdata = small
    bits = tprover.MAX_PERMUTATION_ROWS.bit_length()
    assert tprover.MAX_PERMUTATION_ROWS >= 1 << 20
    big = dataclasses.replace(tdata, degree_bits=bits)
    trace = torch.zeros((tdata.config.num_wires, 1), dtype=torch.int64).expand(-1, 1 << bits)
    with pytest.raises(ValueError):
        tprover.compute_permutation_polys(big, trace, _perm_rec("cpu", [1, 1], [1, 1]))
    with pytest.raises(ValueError):
        tprover.compute_permutation_polys_plain(big, trace, _perm_rec("cpu", [1, 1], [1, 1]))


def test_permutation_polys_plain_above_old_cap_match_reference(small):
    """At n = 2^15 (above the one-block scan's old 2^14 cap) the plain
    version equals the JAX package's host compute_permutation_polys on the
    same stub circuit: 9 routed wires (two chunks, the last ragged), one
    challenge, random routing tables, and a zero denominator."""
    jdata, tdata = small
    n = 1 << 15
    rng = np.random.default_rng(15)
    ids, sigmas = JF.rand_felts((9, n), rng), JF.rand_felts((9, n), rng)
    trace = JF.rand_felts((9, n), rng)
    betas, gammas = JF.rand_felts(1, rng), JF.rand_felts(1, rng)
    trace[8, n - 2] = (-(int(betas[0]) * int(sigmas[8, n - 2]) + int(gammas[0]))) % P
    config = {"num_routed_wires": 9, "num_challenges": 1}
    jstub = SimpleNamespace(config=dataclasses.replace(jdata.config, **config),
                            id_coords=ids, sigma_vals=sigmas)
    tstub = dataclasses.replace(tdata, degree_bits=15, id_coords=ids, sigma_vals=sigmas,
                                config=dataclasses.replace(tdata.config, **config))
    want = jprover.compute_permutation_polys(jstub, trace, betas, gammas)
    got = tprover.compute_permutation_polys(tstub, gl.from_u64(trace, "cpu"),
                                            _perm_rec("cpu", betas, gammas))
    assert np.array_equal(gl.to_u64(got), want)
    assert (want[0, n - 1:] == 0).all() and want[0, n - 2] != 0


def test_wrappers_refuse_non_cuda_accelerator_tensors(small):
    jdata, tdata = small
    meta = torch.zeros((tdata.config.num_wires, tdata.n), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tprover.compute_permutation_polys(tdata, meta, _perm_rec("cpu", [1, 1], [1, 1]))
    x = _inputs(tdata, seed=5)
    with pytest.raises(ValueError):
        _port_evals(tdata, x, device="meta")


def test_failed_build_raises_and_never_falls_back(small, monkeypatch, tmp_path):
    """nvcc failing makes the build raise, and a kernel path that needs the
    library raises with it instead of taking the plain version."""
    from qp_zk_circuits_tpu_torch import _cuda

    monkeypatch.setattr(_cuda, "BUILD", tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "false")
    monkeypatch.setattr(_cuda, "_lib", None)
    with pytest.raises(RuntimeError):
        _cuda.build()
    tprover._kernel_lib.cache_clear()
    _, tdata = small
    x = _inputs(tdata, seed=9)
    nc = tdata.config.num_challenges
    rec = tprover.host_records("cpu", 1, nc, alphas=x["alphas"], betas=x["betas"],
                           gammas=x["gammas"], pis=x["pi"])[0]
    with pytest.raises(RuntimeError):
        tprover._launch_quotient(
            tdata, gl.from_u64(x["wires"], "cpu"), gl.from_u64(x["zpp"], "cpu"), rec,
            tdata.constants_oracle.lde,
        )
    with pytest.raises(RuntimeError):
        tprover._launch_permutation(tdata, gl.from_u64(_trace(tdata, 9), "cpu"), rec)
    tprover._kernel_lib.cache_clear()


@pytest.mark.parametrize("module, entry", [
    ("prover", "qzk_quotient_set_constants"), ("poseidon2", "qzk_poseidon2_set_constants"),
])
def test_constants_uploaded_once_per_device(monkeypatch, module, entry):
    """__constant__ memory is per device: kernel A's and kernel 2's Poseidon2
    tables are uploaded once to each device, with that device current."""
    import contextlib

    from qp_zk_circuits_tpu_torch import _cuda
    from qp_zk_circuits_tpu_torch.hash import poseidon2 as tps

    mod = {"prover": tprover, "poseidon2": tps}[module]
    current, uploads = [None], []

    @contextlib.contextmanager
    def device(index):
        before, current[0] = current[0], index
        yield
        current[0] = before

    def upload(*args):
        uploads.append(current[0])
        return 0

    monkeypatch.setattr(_cuda, "lib", lambda: SimpleNamespace(**{entry: upload}))
    monkeypatch.setattr(torch.cuda, "device", device)
    mod._kernel_lib.cache_clear()
    try:
        for index in (0, 1, 0, 1):
            mod._kernel_lib(index)
    finally:
        mod._kernel_lib.cache_clear()
    assert uploads == [0, 1]


def test_coset_intt_matches_reference():
    """The quotient's iNTT with the g^-i unshift folded in."""
    vals = JF.rand_felts((2, 1 << 7), np.random.default_rng(6))
    g_inv = JF.inv(np.uint64(JF.MULTIPLICATIVE_GROUP_GENERATOR))
    want = JF.mul(jntt.intt_np(vals), JF.powers(g_inv, 1 << 7))
    assert np.array_equal(gl.to_u64(tntt.coset_intt(gl.from_u64(vals, "cpu"))), want)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version on CPU copies


def _field_launches():
    return [f.launches for f in (gl.add, gl.sub, gl.mul)]


@pytest.mark.gpu
@pytest.mark.parametrize("name, make", GATE_CASES)
def test_quotient_kernel_per_gate_on_card(small, cuda, name, make):
    jdata, tdata = small
    _, tone = _with_gates(jdata, tdata, make, seed=len(name))
    tone = dataclasses.replace(
        tone, constants_oracle=SimpleNamespace(lde=tone.constants_oracle.lde.to(cuda))
    )
    x = _inputs(tone, seed=len(name))
    before = _field_launches()
    got = _port_evals(tone, x, cuda)
    assert _field_launches() == before
    assert torch.equal(got.cpu(), _port_evals(tone, x)), name


def _variant(data, **config):
    """The circuit data with its config changed, routing tables cut to the
    routed wires (a fresh object, so no tables are cached)."""
    cfg = dataclasses.replace(data.config, **config)
    nr = cfg.num_routed_wires
    return dataclasses.replace(data, config=cfg, id_coords=data.id_coords[:nr],
                               sigma_vals=data.sigma_vals[:nr])


# the leaf with 1, 2 and 4 challenges, and the canonical ZK profile's 60
# routed wires (qdf 8: a ragged last chunk)
VARIANTS = {"nc2": {}, "nc1": {"num_challenges": 1}, "nc4": {"num_challenges": 4},
            "routed60": {"num_routed_wires": 60}}


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", ["small", *(f"leaf_{v}" for v in VARIANTS)])
def test_fused_kernels_match_plain_on_card(small, cuda, circuit):
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    if circuit == "small":
        data = small[1]
    else:
        data = _variant(WormholeProver(device="cpu").data, **VARIANTS[circuit[5:]])
    nc = data.config.num_challenges
    x = _inputs(data, seed=7)
    got = _port_evals(data, x, cuda)
    assert torch.equal(got.cpu(), _port_evals(data, x))
    rng = np.random.default_rng(8)
    trace = JF.rand_felts((data.config.num_wires, data.n), rng)
    betas, gammas = JF.rand_felts(nc, rng), JF.rand_felts(nc, rng)
    gammas[-1] = (-(int(trace[5, 7]) + int(betas[-1]) * int(data.sigma_vals[5, 7]))) % P
    before = _field_launches()
    got = tprover.compute_permutation_polys(data, gl.from_u64(trace, cuda),
                                            _perm_rec(cuda, betas, gammas))
    assert _field_launches() == before
    want = tprover.compute_permutation_polys_plain(data, gl.from_u64(trace, "cpu"),
                                                   _perm_rec("cpu", betas, gammas))
    assert torch.equal(got.cpu(), want)
    vals = gl.from_u64(JF.rand_felts((2, data.n << 3), rng), cuda)
    assert torch.equal(tntt.coset_intt(vals).cpu(), tntt.coset_intt(vals.cpu()))


@pytest.mark.gpu
def test_permutation_kernel_across_tiles_on_card(cuda):
    """The leaf's routing over four tiles of rows (n = 1024): zero
    denominators on both sides of the tile boundary at row 256 and in the
    last row; two launches, equal to the plain version."""
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    leaf = WormholeProver(device="cpu").data
    data = dataclasses.replace(leaf, degree_bits=10, id_coords=np.tile(leaf.id_coords, 4),
                               sigma_vals=np.tile(leaf.sigma_vals, 4))
    rng = np.random.default_rng(9)
    trace = JF.rand_felts((data.config.num_wires, data.n), rng)
    betas, gammas = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    for c, row, wire in ((0, 255, 3), (0, 256, 70), (1, 256, 0), (1, data.n - 1, 9)):
        trace[wire, row] = (-(int(betas[c]) * int(data.sigma_vals[wire, row]) + int(gammas[c]))) % P
    before = tprover.compute_permutation_polys.launches
    got = tprover.compute_permutation_polys(data, gl.from_u64(trace, cuda),
                                            _perm_rec(cuda, betas, gammas))
    assert tprover.compute_permutation_polys.launches - before == 2
    want = tprover.compute_permutation_polys_plain(data, gl.from_u64(trace, "cpu"),
                                                   _perm_rec("cpu", betas, gammas))
    assert torch.equal(got.cpu(), want)
