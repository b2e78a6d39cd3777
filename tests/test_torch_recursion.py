"""The port's recursion gadgets (`qp_zk_circuits_tpu_torch/recursion/`)
against the JAX package's, on the CPU.

No proof is made here and no JAX graph is built:

  * each extension-field gadget, the ReducingGate Horner rows and the
    in-circuit challenger are built by both packages into one small circuit
    (shape-only builds), and both witnesses are equal cell for cell and
    equal to the values computed on the host (Python ints; the port's
    transcript for the challenger);
  * the recursion test's outer circuit (tests/test_recursion.py: an outer
    circuit that verifies a proof of z = x * y and re-exposes z), built by
    the port on the CPU, has the JAX package's verifier data bytes
    (tests/torch_fixtures/, make_agg_fixture.py `recursion`);
  * its witness for the JAX inner proof equals the JAX package's witness
    (the trace's SHA-256) and exposes 42, runs on the compiled witness tape
    from its second run on, and a tampered inner proof (a changed public
    input, a changed opening) makes it fail as in tests/test_recursion.py;
  * the port's verifier accepts the JAX outer proof and rejects tampered
    copies with the JAX verifier's class and message.

The outer proof itself (degree 11, about a minute with the plain versions
on the CPU) is made and compared byte for byte by `chip_smoke.py`.
"""

import copy
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import qp_zk_circuits_tpu as jpkg
from qp_zk_circuits_tpu.plonk import builder as jbuilder
from qp_zk_circuits_tpu.plonk import serialization as jser
from qp_zk_circuits_tpu.plonk import verifier as jverifier
from qp_zk_circuits_tpu.recursion import challenger_gadget as jchal
from qp_zk_circuits_tpu.recursion import ext_gadgets as jeg
import qp_zk_circuits_tpu_torch as tpkg
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.plonk import transcript as tts
from qp_zk_circuits_tpu_torch.plonk import verifier as tverifier
from qp_zk_circuits_tpu_torch.plonk import witness_tape as twt
from qp_zk_circuits_tpu_torch.recursion import challenger_gadget as tchal
from qp_zk_circuits_tpu_torch.recursion import ext_gadgets as teg
from qp_zk_circuits_tpu_torch.recursion import verifier_gadget as tvg

P = 0xFFFFFFFF00000001
W = 7
FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())
INNER, OUTER = "recursion_inner_proof.bin", "recursion_outer_proof.bin"

for _pkg, _name in ((jpkg, "qp_zk_circuits_tpu"), (tpkg, "qp_zk_circuits_tpu_torch")):
    for _mod in ("fri.config", "plonk.config", "recursion.verifier_gadget"):
        importlib.import_module(f"{_name}.{_mod}")


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_agg_fixture", FIXTURES / "make_agg_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _fixture_module()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions on one intra-op thread: idle torch threads
    spinning on a busy host slow them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# host arithmetic in F_p^2 = F_p[X]/(X^2 - 7), Python ints


def _emul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _einv(a):
    ninv = pow((a[0] * a[0] - W * a[1] * a[1]) % P, P - 2, P)
    return (a[0] * ninv % P, (P - a[1]) * ninv % P)


def _epow(a, e):
    out = (1, 0)
    for _ in range(e):
        out = _emul(out, a)
    return out


def _horner(alpha, coeffs):
    """sum_k alpha^k coeffs[k]."""
    acc = (0, 0)
    for c in reversed(coeffs):
        acc = _emul(acc, alpha)
        acc = ((acc[0] + c[0]) % P, (acc[1] + c[1]) % P)
    return acc


# ---------------------------------------------------------------------------
# gadget circuits: one builder function, each package's gadgets


def _ext_in(eg, b, n):
    return [eg.ext_virtual(b) for _ in range(n)]


def _gadget_mul(eg, b):
    x, y = _ext_in(eg, b, 2)
    return [x, y], [eg.ext_mul(b, x, y), eg.ext_add(b, x, y), eg.ext_sub(b, x, y)]


def _gadget_inverse(eg, b):
    x, y = _ext_in(eg, b, 2)
    return [x, y], [eg.ext_inverse(b, x), eg.ext_div(b, x, y)]


def _gadget_powers(eg, b):
    (x,) = _ext_in(eg, b, 1)
    return [x], [eg.ext_exp_u(b, x, 13), eg.ext_exp_pow2(b, x, 3)]


def _reduce(n, ext):
    def build(eg, b):
        alpha, *cs = _ext_in(eg, b, 1 + n)
        coeffs = cs if ext else [c[0] for c in cs]
        return [alpha, *cs], [eg.ext_reduce_with_powers(b, alpha, coeffs, ext=ext)]
    return build


GADGETS = {
    "mul_add_sub": (_gadget_mul, lambda v: [_emul(*v), tuple((a + c) % P for a, c in zip(*v)),
                                            tuple((a - c) % P for a, c in zip(*v))]),
    "inverse_div": (_gadget_inverse, lambda v: [_einv(v[0]), _emul(v[0], _einv(v[1]))]),
    "powers": (_gadget_powers, lambda v: [_epow(v[0], 13), _epow(v[0], 8)]),
    # 5 coefficients: plain Horner over arithmetic rows; 40 base and 30
    # extension coefficients: ReducingGate rows (front-padded to the row's
    # capacity)
    "reduce_arith": (_reduce(5, True), lambda v: [_horner(v[0], v[1:])]),
    "reduce_base_rows": (_reduce(40, False),
                         lambda v: [_horner(v[0], [(c[0], 0) for c in v[1:]])]),
    "reduce_ext_rows": (_reduce(30, True), lambda v: [_horner(v[0], v[1:])]),
}


def _witness(pkg, builder_mod, eg, build, values):
    """Build `build`'s gadget circuit with package `pkg` (shape-only),
    witness it with `values` (one (c0, c1) pair an input ExtTarget) and
    return (trace, the outputs as pairs)."""
    b = builder_mod.CircuitBuilder(MK.test_configs(pkg)[0])
    ins, outs = build(eg, b)
    b.register_public_inputs([t for o in outs for t in o])
    data = b.build(shape_only=True)
    pw = builder_mod.PartialWitness()
    for t, v in zip(ins, values):
        pw.set_target(t[0], v[0])
        pw.set_target(t[1], v[1])
    if builder_mod is jbuilder:
        trace, pis = jbuilder.generate_witness(data, pw)
    else:
        trace, pis = tbuilder.witness_trace(data, pw)
    pis = [int(v) for v in pis]
    return np.asarray(trace, dtype=np.uint64), list(zip(pis[::2], pis[1::2]))


@pytest.mark.parametrize("name", list(GADGETS))
def test_gadget_witness_matches_reference_and_host(name):
    build, host = GADGETS[name]
    rng = np.random.default_rng(sorted(GADGETS).index(name))
    n_in = {"mul_add_sub": 2, "inverse_div": 2, "powers": 1, "reduce_arith": 6,
            "reduce_base_rows": 41, "reduce_ext_rows": 31}[name]
    values = [tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64)) for _ in range(n_in)]
    jtrace, jouts = _witness(jpkg, jbuilder, jeg, build, values)
    ttrace, touts = _witness(tpkg, tbuilder, teg, build, values)
    assert np.array_equal(ttrace, jtrace)
    assert touts == jouts == host(values)


def _challenger_circuit(builder_mod, chal_mod, eg, n_obs):
    """Observe n_obs inputs, squeeze 3 challenges, observe 2 more, squeeze
    an extension challenge (the verifier's schedule in small)."""
    b = builder_mod.CircuitBuilder(MK.test_configs(jpkg if builder_mod is jbuilder else tpkg)[0])
    ins = b.add_virtual_targets(n_obs + 2)
    ch = chal_mod.RecursiveChallenger(b)
    ch.observe_many(ins[:n_obs])
    outs = ch.challenge_many(3)
    ch.observe_many(ins[n_obs:])
    outs += list(ch.challenge_ext())
    b.register_public_inputs(outs)
    return b.build(shape_only=True), ins


@pytest.mark.parametrize("n_obs", [3, 8, 11])
def test_challenger_gadget_follows_host_transcript(n_obs):
    values = [int(v) for v in np.random.default_rng(n_obs).integers(0, P, n_obs + 2,
                                                                    dtype=np.uint64)]
    host = tts.Challenger()
    host.observe_many(np.array(values[:n_obs], dtype=np.uint64))
    want = [int(v) for v in host.challenge_many(3)]
    host.observe_many(np.array(values[n_obs:], dtype=np.uint64))
    want += [int(v) for v in host.challenge_ext()]
    got = {}
    for mod, chal_mod, eg in ((jbuilder, jchal, jeg), (tbuilder, tchal, teg)):
        data, ins = _challenger_circuit(mod, chal_mod, eg, n_obs)
        pw = mod.PartialWitness()
        pw.set_many(ins, values)
        wit = jbuilder.generate_witness if mod is jbuilder else tbuilder.witness_trace
        trace, pis = wit(data, pw)
        got[mod] = (np.asarray(trace, dtype=np.uint64), [int(v) for v in pis])
    assert np.array_equal(got[tbuilder][0], got[jbuilder][0])
    assert got[tbuilder][1] == got[jbuilder][1] == want


# ---------------------------------------------------------------------------
# the recursion test's outer circuit


@pytest.fixture(scope="module")
def outer():
    """The port's inner and outer circuits, committed on the CPU."""
    inner, _, _, _, outer_data, pt = MK.recursion_circuits(tpkg, lambda b: b.build(device="cpu"))
    return inner, outer_data, pt


def _proof(name, ser=tser):
    return ser.proof_from_bytes((FIXTURES / name).read_bytes())


def test_outer_verifier_data_bytes_equal_reference(outer):
    inner, outer_data, _ = outer
    vd = tser.VerifierCircuitData.from_circuit_data(outer_data)
    assert outer_data.degree_bits == META[OUTER]["degree_bits"]
    assert vd.to_common_bytes() == (FIXTURES / "recursion_outer_common.bin").read_bytes()
    assert vd.to_verifier_only_bytes() == (FIXTURES / "recursion_outer_verifier.bin").read_bytes()
    for data, name in ((inner, INNER), (outer_data, OUTER)):
        assert [[int(v) for v in row] for row in data.constants_oracle.cap] == \
            META[name]["constants_cap"]
        assert [int(v) for v in data.circuit_digest] == META[name]["circuit_digest"]


def test_outer_witness_equals_reference_and_runs_on_the_tape(outer):
    _, outer_data, pt = outer
    for run in range(2):
        pw = tbuilder.PartialWitness()
        tvg.fill_proof_targets(pw, pt, _proof(INNER))
        if run:
            assert twt.run_tape(outer_data, pw) is not None
        trace, pis = tbuilder.witness_trace(outer_data, pw)
        assert [int(v) for v in pis] == [42]
        assert MK.trace_sha256(trace, outer_data.num_rows_used) == META[OUTER]["trace_sha256"]


def _bump_pi(p):
    p.public_inputs = p.public_inputs.copy()
    p.public_inputs[0] = 43  # claim 6 * 7 == 43


def _bump_opening(p):
    p.openings.wires = p.openings.wires.copy()
    p.openings.wires[0, 0] = (int(p.openings.wires[0, 0]) + 1) % P


@pytest.mark.parametrize("tamper", [_bump_pi, _bump_opening], ids=["public_input", "opening"])
def test_tampered_inner_proof_makes_the_outer_witness_fail(outer, tamper):
    _, outer_data, pt = outer
    bad = copy.deepcopy(_proof(INNER))
    tamper(bad)
    pw = tbuilder.PartialWitness()
    tvg.fill_proof_targets(pw, pt, bad)
    with pytest.raises((tbuilder.WitnessError, ValueError, AssertionError)):
        tbuilder.witness_trace(outer_data, pw)


def _outcome(fn):
    """(error class as the JAX package names it, message), or "accepted"."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class itself is compared
        module = type(e).__module__.replace("qp_zk_circuits_tpu_torch", "qp_zk_circuits_tpu")
        return f"{module}.{type(e).__name__}", str(e)
    return "accepted"


def _bump(a, at):
    a = np.array(a, dtype=np.uint64)
    a[at] = (int(a[at]) + 1) % P
    return a


RECURSION_TAMPERS = {
    "public_input": lambda p: setattr(p, "public_inputs", _bump(p.public_inputs, 0)),
    "opening": lambda p: setattr(p.openings, "zs", _bump(p.openings.zs, (1, 1))),
    "fold_leaf_round_2": lambda p: setattr(
        p.fri_proof.query_rounds[3].steps[-1], "leaf_values",
        _bump(p.fri_proof.query_rounds[3].steps[-1].leaf_values, (2, 0))),
    "final_poly": lambda p: setattr(p.fri_proof, "final_poly",
                                    _bump(p.fri_proof.final_poly, (1, 0))),
}


@pytest.mark.parametrize("name", ["accepted", *RECURSION_TAMPERS])
def test_port_verifier_on_reference_outer_proof(outer, name):
    """The JAX outer proof, and tampered copies, through both verifiers."""
    _, outer_data, _ = outer
    vd = tser.VerifierCircuitData.from_circuit_data(outer_data)
    jvd = jser.VerifierCircuitData.from_bytes(vd.to_bytes())
    jproof, tproof = _proof(OUTER, jser), _proof(OUTER)
    if name != "accepted":
        RECURSION_TAMPERS[name](jproof)
        RECURSION_TAMPERS[name](tproof)
    want = _outcome(lambda: jverifier.verify(jvd, jproof))
    got = _outcome(lambda: tverifier.verify(vd, tproof))
    assert got == want
    assert (want == "accepted") == (name == "accepted")
