"""Taped constraint evaluation for the host verifier.

The verifier's vanishing check evaluates every gate constraint at zeta
through the shared definitions (`vanishing.py::eval_constraints` and the
gates' `eval(ctx)`): the constraints exist once. Walking those definitions
in Python for every proof is slow, so this module runs `eval_constraints`
ONCE a circuit with a recording algebra whose values are node ids, which
gives a linear op tape (add, sub, mul and scalar mul over the quadratic
extension, and interned constants). Each verify then evaluates the tape in
one call into the C library (`native/fri_verify.c::eval_tape`). The tape is
the shared definitions, mechanically derived, so nothing is forked;
`plonk/prover.py::_verify_vanishing_pure` walks them directly and is the
tests' oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .vanishing import eval_constraints, num_partial_products

P = 0xFFFFFFFF00000001

OP_CONST = 0
OP_ADD = 1
OP_SUB = 2
OP_MUL = 3
OP_SMUL = 4  # scalar (base-field) multiply: value[a] * pool[b].c0


class _TapeBuilder:
    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.ops: list[int] = []
        self.ia: list[int] = []
        self.ib: list[int] = []
        self.pool: list[tuple[int, int]] = []
        self._const_ids: dict[tuple[int, int], int] = {}
        self._pool_ids: dict[tuple[int, int], int] = {}

    def _emit(self, op: int, a: int, b: int) -> int:
        self.ops.append(op)
        self.ia.append(a)
        self.ib.append(b)
        return self.n_inputs + len(self.ops) - 1

    def _pool_entry(self, c0: int, c1: int = 0) -> int:
        key = (c0 % P, c1 % P)
        pid = self._pool_ids.get(key)
        if pid is None:
            pid = len(self.pool)
            self.pool.append(key)
            self._pool_ids[key] = pid
        return pid

    def const(self, c0: int, c1: int = 0) -> int:
        key = (c0 % P, c1 % P)
        nid = self._const_ids.get(key)
        if nid is None:
            nid = self._emit(OP_CONST, self._pool_entry(c0, c1), 0)
            self._const_ids[key] = nid
        return nid

    def add(self, a: int, b: int) -> int:
        return self._emit(OP_ADD, a, b)

    def sub(self, a: int, b: int) -> int:
        return self._emit(OP_SUB, a, b)

    def mul(self, a: int, b: int) -> int:
        return self._emit(OP_MUL, a, b)

    def smul(self, a: int, c: int) -> int:
        return self._emit(OP_SMUL, a, self._pool_entry(c))


class TapeAlg:
    """`eval_constraints` algebra over tape node ids."""

    def __init__(self, tb: _TapeBuilder):
        self.tb = tb

    def add(self, a, b):
        return self.tb.add(a, b)

    def sub(self, a, b):
        return self.tb.sub(a, b)

    def mul(self, a, b):
        return self.tb.mul(a, b)

    def one(self):
        return self.tb.const(1)


class TapeCtx:
    """Gate-eval ctx over tape node ids (mirror of gates.HostExtCtx)."""

    def __init__(self, tb: _TapeBuilder, wire_ids, const_ids, pi_ids):
        self.tb = tb
        self._wires = wire_ids
        self._constants = const_ids
        self._pi = pi_ids

    def wire(self, i):
        return self._wires[i]

    def constant(self, k):
        return self._constants[k]

    def pi_hash(self, i):
        return self._pi[i]

    def add(self, a, b):
        return self.tb.add(a, b)

    def sub(self, a, b):
        return self.tb.sub(a, b)

    def mul(self, a, b):
        return self.tb.mul(a, b)

    def add_const(self, a, c: int):
        return self.tb.add(a, self.tb.const(c))

    def mul_const(self, a, c: int):
        return self.tb.smul(a, int(c) % P)

    def exp7(self, a):
        a2 = self.tb.mul(a, a)
        a4 = self.tb.mul(a2, a2)
        return self.tb.mul(self.tb.mul(a4, a2), a)

    def felt(self, c: int):
        return self.tb.const(int(c) % P)


@dataclass
class ConstraintTape:
    ops: np.ndarray  # (n_ops,) uint8
    ia: np.ndarray  # (n_ops,) uint32
    ib: np.ndarray  # (n_ops,) uint32
    pool: np.ndarray  # (n_pool, 2) uint64
    n_inputs: int
    out_ids: np.ndarray  # (num_challenges,) uint32 — alpha-combined sums
    slices: dict  # name -> (start, count) into the input vector


def _input_layout(data) -> dict:
    cfg = data.config
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    npp = num_partial_products(nr, cfg.max_quotient_degree_factor)
    counts = [
        ("wires", cfg.num_wires),
        ("constants", data.const_cols.shape[0]),
        ("selectors", data.num_selectors),
        ("sigmas", nr),
        ("zs", nc),
        ("zs_next", nc),
        ("pps", nc * npp),
        ("id_coords", nr),
        ("l1", 1),
        ("betas", nc),
        ("gammas", nc),
        ("alphas", nc),
        ("pi_hash", 4),
    ]
    slices, off = {}, 0
    for name, cnt in counts:
        slices[name] = (off, cnt)
        off += cnt
    slices["_total"] = (0, off)
    return slices


def build_tape(data) -> ConstraintTape:
    """Record the full vanishing-check computation (gate constraints through
    the shared definitions, the permutation argument, the alpha combination)
    as a linear op tape. Called once a CircuitData; `get_tape` caches it."""
    cfg = data.config
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    npp = num_partial_products(nr, cfg.max_quotient_degree_factor)
    slices = _input_layout(data)
    tb = _TapeBuilder(slices["_total"][1])

    ids = {name: list(range(s, s + c)) for name, (s, c) in slices.items() if name != "_total"}
    ctx = TapeCtx(tb, ids["wires"], ids["constants"], ids["pi_hash"])
    alg = TapeAlg(tb)
    pps_nested = [
        [ids["pps"][c * npp + j] for j in range(npp)] for c in range(nc)
    ]
    constraints = eval_constraints(
        ctx,
        data,
        ids["wires"],
        ids["constants"],
        ids["selectors"],
        ids["sigmas"],
        ids["zs"],
        ids["zs_next"],
        pps_nested,
        ids["id_coords"],
        ids["l1"][0],
        ids["betas"],
        ids["gammas"],
        alg,
    )
    # alpha combination: acc_c = sum_k alpha_c^k * constraint_k
    out_ids = []
    for c in range(nc):
        acc = tb.const(0)
        apow = tb.const(1)
        alpha = ids["alphas"][c]
        for k, cons in enumerate(constraints):
            acc = tb.add(acc, tb.mul(apow, cons))
            if k != len(constraints) - 1:
                apow = tb.mul(apow, alpha)
        out_ids.append(acc)

    return ConstraintTape(
        ops=np.asarray(tb.ops, dtype=np.uint8),
        ia=np.asarray(tb.ia, dtype=np.uint32),
        ib=np.asarray(tb.ib, dtype=np.uint32),
        pool=np.asarray(tb.pool, dtype=np.uint64).reshape(-1, 2),
        n_inputs=tb.n_inputs,
        out_ids=np.asarray(out_ids, dtype=np.uint32),
        slices=slices,
    )


def get_tape(data) -> ConstraintTape:
    tape = data.__dict__.get("_constraint_tape")
    if tape is None:
        tape = build_tape(data)
        data.__dict__["_constraint_tape"] = tape
    return tape
