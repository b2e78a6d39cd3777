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
    return tprover.quotient_evals(
        tdata, gl.from_u64(x["wires"], device), gl.from_u64(x["zpp"], device),
        x["alphas"], x["betas"], x["gammas"], x["pi"],
    )


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
    got = gl.to_u64(tprover.compute_permutation_polys(tdata, gl.from_u64(trace, "cpu"), betas, gammas))
    assert np.array_equal(got, want)
    assert (got[0, 4:] == 0).all() == zero_den


def test_permutation_size_limit_holds_on_every_device(small):
    _, tdata = small
    big = dataclasses.replace(tdata, degree_bits=15)
    trace = torch.zeros((tdata.config.num_wires, 1 << 15), dtype=torch.int64)
    with pytest.raises(ValueError):
        tprover.compute_permutation_polys(big, trace, [1, 1], [1, 1])
    with pytest.raises(ValueError):
        tprover.compute_permutation_polys_plain(big, trace, [1, 1], [1, 1])


def test_wrappers_refuse_non_cuda_accelerator_tensors(small):
    jdata, tdata = small
    meta = torch.zeros((tdata.config.num_wires, tdata.n), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tprover.compute_permutation_polys(tdata, meta, [1, 1], [1, 1])
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
    with pytest.raises(RuntimeError):
        tprover._launch_quotient(
            tdata, gl.from_u64(x["wires"], "cpu"), gl.from_u64(x["zpp"], "cpu"), x["alphas"],
            x["betas"], x["gammas"], x["pi"], tdata.constants_oracle.lde,
        )
    with pytest.raises(RuntimeError):
        tprover._launch_permutation(
            tdata, gl.from_u64(_trace(tdata, 9), "cpu"), x["betas"], x["gammas"]
        )
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


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", ["small", "leaf"])
def test_fused_kernels_match_plain_on_card(small, cuda, circuit):
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    data = small[1] if circuit == "small" else WormholeProver(device="cpu").data
    x = _inputs(data, seed=7)
    got = _port_evals(data, x, cuda)
    assert torch.equal(got.cpu(), _port_evals(data, x))
    rng = np.random.default_rng(8)
    trace = JF.rand_felts((data.config.num_wires, data.n), rng)
    betas, gammas = JF.rand_felts(2, rng), JF.rand_felts(2, rng)
    gammas[1] = (-(int(trace[5, 7]) + int(betas[1]) * int(data.sigma_vals[5, 7]))) % P
    before = _field_launches()
    got = tprover.compute_permutation_polys(data, gl.from_u64(trace, cuda), betas, gammas)
    assert _field_launches() == before
    want = tprover.compute_permutation_polys_plain(data, gl.from_u64(trace, "cpu"), betas, gammas)
    assert torch.equal(got.cpu(), want)
    vals = gl.from_u64(JF.rand_felts((2, data.n << 3), rng), cuda)
    assert torch.equal(tntt.coset_intt(vals).cpu(), tntt.coset_intt(vals.cpu()))
