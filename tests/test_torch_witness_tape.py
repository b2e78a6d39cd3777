"""The port's witness tape (plonk/witness_tape.py, native/witness_tape.c)
against its Python generator replay and the JAX package's `run_generators`.

The tape must give the replay's values bit for bit for every opcode, on a
circuit that uses them all and on the Wormhole leaf, and keep the strict
semantics: a failed range check and a conflicting value raise, and a
witness that seeds other targets than the recorded program gets no tape.
Exact equality everywhere.
"""

import numpy as np
import pytest

from qp_zk_circuits_tpu.plonk import builder as jbuilder
from qp_zk_circuits_tpu.plonk.config import CircuitConfig as JCircuitConfig
from qp_zk_circuits_tpu.recursion.ext_gadgets import ext_inverse as j_ext_inverse
from qp_zk_circuits_tpu.wormhole import leaf_circuit as jleaf
from qp_zk_circuits_tpu.wormhole import test_helpers as jhelpers
from qp_zk_circuits_tpu_torch import native as tnat
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import witness_tape as wt
from qp_zk_circuits_tpu_torch.plonk.config import CircuitConfig
from qp_zk_circuits_tpu_torch.wormhole import leaf_circuit as tleaf
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers

P = 0xFFFFFFFF00000001
W = 7  # the extension's X^2


def _ext_inverse(b, x):
    """The JAX package's `recursion/ext_gadgets.py::ext_inverse` on the port's
    builder (the same targets in the same order): a witnessed inverse with
    its `extinv` tape descriptor and the product check x * inv == 1."""
    inv = (b.add_virtual_target(), b.add_virtual_target())

    def gen(get, x=x):
        x0, x1 = get(x[0]), get(x[1])
        ninv = pow((x0 * x0 - W * x1 * x1) % P, P - 2, P)
        return [(x0 * ninv) % P, (P - x1) * ninv % P]

    b._simple_generator([x[0], x[1]], gen, list(inv), desc=("extinv", x[0], x[1]))
    t00 = b.mul(x[0], inv[0])
    t11 = b.mul(x[1], inv[1])
    c0 = b._arith_op(7, 1, t11, b.one(), t00)
    t01 = b.mul(x[0], inv[1])
    c1 = b.mul_add(x[1], inv[0], t01)
    b.assert_one(c0)
    b.assert_zero(c1)
    return inv


def _all_opcode_circuit(pkg):
    """One circuit touching every tape opcode: const, fmadd, inv, invz,
    split64, splitbits (range_check), poseidon (permute), extinv."""
    if pkg == "port":
        b, ext_inverse = tbuilder.CircuitBuilder(CircuitConfig()), _ext_inverse
    else:
        b, ext_inverse = jbuilder.CircuitBuilder(JCircuitConfig()), j_ext_inverse
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    m = b.mul(x, y)
    s = b.add(m, b.constant(12345))
    inv = b.inverse(s)
    eq = b.is_equal(x, y)
    lo, hi, _bits = b.split_64(s)
    b.range_check(x, 16)
    digest = b.hash_n_to_hash_no_pad([x, y, m, s])
    e0 = b.add_virtual_target()
    e1 = b.add_virtual_target()
    ei = ext_inverse(b, (e0, e1))
    b.register_public_inputs([m, inv, eq, lo, hi, digest[0], ei[0], ei[1]])
    return b.build(shape_only=True), (x, y, e0, e1)


def _pw(targets, values, pkg="port"):
    pw = (tbuilder if pkg == "port" else jbuilder).PartialWitness()
    for t, v in zip(targets, values):
        pw.set_target(t, v)
    return pw


def _assert_values(arr, values):
    """The tape's root array holds every value of a replay's dict."""
    for r, v in values.items():
        assert int(arr[r]) == v, r


@pytest.mark.parametrize("values", [(777, 777, 5, 9), (31337, 99, 123456789, 1),
                                    ((1 << 16) - 1, P - 1, 1 << 32, (1 << 32) - 1)])
def test_tape_matches_replays_all_opcodes(values):
    data, targets = _all_opcode_circuit("port")
    jdata, jtargets = _all_opcode_circuit("jax")
    assert targets == jtargets and data.num_targets == jdata.num_targets
    # a first witness records the program by the Python replay
    first = tbuilder.witness_root_values(data, _pw(targets, (3, 4, 5, 6)))
    _assert_values(first, tbuilder.run_generators(data, _pw(targets, (3, 4, 5, 6))))
    calls = tnat.counts["wt_run"]
    got = tbuilder.witness_root_values(data, _pw(targets, values))
    assert tnat.counts["wt_run"] == calls + 1
    assert data.__dict__["_witness_tape"][1] is not None, "the program did not lower"
    replay = tbuilder.run_generators(data, _pw(targets, values))
    _assert_values(got, replay)
    assert np.count_nonzero(got) == sum(1 for v in replay.values() if v)
    _assert_values(got, jbuilder.run_generators(jdata, _pw(jtargets, values, "jax")))


def test_tape_matches_replays_on_the_leaf():
    circuit = tleaf.WormholeCircuit()
    data = circuit.build(shape_only=True)
    jcircuit = jleaf.WormholeCircuit()
    jdata = jcircuit.build(shape_only=True)

    def pw(mod, c, helpers):
        w = mod.PartialWitness()
        (tleaf if mod is tbuilder else jleaf).fill_witness(w, helpers.test_inputs_0(), c.targets)
        return w

    recorded = tbuilder.witness_root_values(data, pw(tbuilder, circuit, thelpers))
    calls = tnat.counts["wt_run"]
    got = tbuilder.witness_root_values(data, pw(tbuilder, circuit, thelpers))
    assert tnat.counts["wt_run"] == calls + 1
    assert np.array_equal(got, recorded)
    _assert_values(got, tbuilder.run_generators(data, pw(tbuilder, circuit, thelpers)))
    _assert_values(got, jbuilder.run_generators(jdata, pw(jbuilder, jcircuit, jhelpers)))


def test_tape_range_check_failure():
    data, targets = _all_opcode_circuit("port")
    tbuilder.witness_root_values(data, _pw(targets, (3, 4, 1, 1)))  # record
    bad = _pw(targets, (1 << 20, 4, 1, 1))  # x fails range_check(x, 16)
    with pytest.raises(tbuilder.WitnessError, match="range check"):
        tbuilder.witness_root_values(data, bad)


def test_tape_conflict_detection():
    b = tbuilder.CircuitBuilder(CircuitConfig())
    x = b.add_virtual_target()
    y = b.mul(x, x)
    out = b.add_virtual_target()
    b.connect(y, out)
    data = b.build(shape_only=True)
    tbuilder.witness_root_values(data, _pw([x, out], [3, 9]))  # record: y = 9
    assert wt.run_tape(data, _pw([x, out], [3, 9])) is not None
    calls = tnat.counts["wt_run"]
    with pytest.raises(tbuilder.WitnessError, match="value conflict"):
        tbuilder.witness_root_values(data, _pw([x, out], [3, 10]))  # the VM: 10 != 9
    assert tnat.counts["wt_run"] == calls + 1
    # two seeds of one root that disagree, caught before the VM runs
    clash = tbuilder.PartialWitness()
    clash.set_many([x] * 7 + [out], [3] * 7 + [9])
    clash.set_many([x] * 8, [3] * 7 + [4])
    with pytest.raises(tbuilder.WitnessError, match="conflicting witness value"):
        wt.run_tape(data, clash)


def test_tape_requires_matching_keyset():
    """A witness seeding other targets never runs a stale program."""
    data, targets = _all_opcode_circuit("port")
    tbuilder.witness_root_values(data, _pw(targets, (5, 6, 7, 8)))  # record
    assert wt.run_tape(data, _pw(targets, (5, 6, 7, 8))) is not None
    extra = _pw(targets, (5, 6, 7, 8))
    extra.set_target(data.num_targets - 1, 42)
    assert wt.run_tape(data, extra) is None


def test_program_without_descriptor_replays_in_python():
    b = tbuilder.CircuitBuilder(CircuitConfig())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b._simple_generator([x], lambda get: [get(x) * 3 % P], [y])  # no descriptor
    b.register_public_inputs([b.mul(x, y)])
    data = b.build(shape_only=True)
    tbuilder.witness_root_values(data, _pw([x], [5]))  # record
    calls = tnat.counts["wt_run"]
    got = tbuilder.witness_root_values(data, _pw([x], [5]))
    assert tnat.counts["wt_run"] == calls
    assert data.__dict__["_witness_tape"][1] is None
    assert int(got[data.target_root[y]]) == 15
