"""Gate set for the PLONK circuit builder.

Every gate type gets a **one-hot selector column**, and its constraints are
evaluated ONCE over the whole LDE domain as batched tensor ops (the per-row
gate dispatch of CPU provers becomes a masked dense evaluation — uniform
work, no divergence). The same `eval(ctx)` code runs in two algebras:

  * device: int64 felt tensors over the quotient domain (prover), through
    the kernel-1 field wrappers;
  * host: quadratic-extension scalars at zeta (verifier).

Gate wires layout is per-row; routed wires (copy-constrainable) are the first
`num_routed_wires` columns. Degrees stay <= quotient_degree_factor + 1 = 9
including the selector multiply (reference constraint-degree policy,
`common/src/circuit.rs:431-449`: Poseidon gate degree 7, arithmetic packing
by routed-wire slots).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native as nat
from ..field import goldilocks as gl
from ..hash import poseidon2 as ps

P_INT = 0xFFFFFFFF00000001

# ---------------------------------------------------------------------------
# evaluation contexts


class DeviceBaseCtx:
    """Evaluate constraints over felt tensors (one value per domain point)."""

    def __init__(self, wires, constants, pi_hash_values):
        self.gl = gl
        self._wires = wires  # list of (m,) tensors
        self._constants = constants
        self._pi = pi_hash_values  # list of felt tensors (broadcastable)

    def wire(self, i):
        return self._wires[i]

    def constant(self, k):
        return self._constants[k]

    def pi_hash(self, i):
        return self._pi[i]

    def add(self, a, b):
        return self.gl.add(a, b)

    def sub(self, a, b):
        return self.gl.sub(a, b)

    def mul(self, a, b):
        return self.gl.mul(a, b)

    def add_const(self, a, c: int):
        return self.gl.add_const(a, c)

    def mul_const(self, a, c: int):
        return self.gl.mul_const(a, c)

    def exp7(self, a):
        return self.gl.exp7(a)

    def felt(self, c: int):
        return self.gl.felt(c, self._wires[0].device)


class HostExtCtx:
    """Evaluate constraints over extension scalars (verifier at zeta)."""

    def __init__(self, wires, constants, pi_hash_values):
        from ..field import extension as ext

        self.ext = ext
        self._wires = wires  # list of np (2,) ext values
        self._constants = constants
        self._pi = pi_hash_values

    def wire(self, i):
        return self._wires[i]

    def constant(self, k):
        return self._constants[k]

    def pi_hash(self, i):
        return self._pi[i]

    def add(self, a, b):
        return self.ext.add(a, b)

    def sub(self, a, b):
        return self.ext.sub(a, b)

    def mul(self, a, b):
        return self.ext.mul(a, b)

    def add_const(self, a, c: int):
        return self.ext.add(a, self.felt(c))

    def mul_const(self, a, c: int):
        return self.ext.scalar_mul(a, np.uint64(c % (1 << 64)))

    def exp7(self, a):
        a2 = self.mul(a, a)
        a4 = self.mul(a2, a2)
        return self.mul(self.mul(a4, a2), a)

    def felt(self, c: int):
        return (c % 0xFFFFFFFF00000001, 0)


# ---------------------------------------------------------------------------
# device batched context (prover quotient path)


class DeviceBatchCtx:
    """Wires/constants as stacked tensors (num_cols, m) for the one-shot
    vectorised gate evaluation on the LDE domain."""

    def __init__(self, wires: torch.Tensor, constants, pi_hash: torch.Tensor):
        self.gl = gl
        self.wires = wires  # (num_wires, m)
        self.constants = constants  # list of (m,)
        self.pi = pi_hash  # (4,)

    def wire_rows(self, idxs) -> torch.Tensor:
        """Stack wire rows at static indices -> (len(idxs), m)."""
        idx = torch.as_tensor(np.asarray(list(idxs), dtype=np.int64), device=self.wires.device)
        return self.wires.index_select(0, idx)

    @property
    def m(self) -> int:
        return self.wires.shape[1]


# ---------------------------------------------------------------------------
# gate base


@dataclass(frozen=True)
class Gate:
    def key(self) -> str:
        raise NotImplementedError

    @property
    def num_constraints(self) -> int:
        raise NotImplementedError

    def eval(self, ctx) -> list:
        """Return constraint values (must all be 0 on rows of this gate)."""
        raise NotImplementedError

    def eval_batched(self, ctx: DeviceBatchCtx):
        """Device path: return (num_constraints, m). MUST match the order
        of eval(). Default falls back to stacking eval() over a list ctx."""
        wires = [ctx.wires[i] for i in range(ctx.wires.shape[0])]
        list_ctx = DeviceBaseCtx(wires, ctx.constants, [ctx.pi[i] for i in range(4)])
        cons = self.eval(list_ctx)
        return torch.stack([c.expand(ctx.m) for c in cons], dim=0)

    def fill_row(self, get, set_) -> None:
        """Witness completion: compute scratch/output wires from input wires.

        get(i) -> int, set_(i, int). Default: nothing to fill."""
        return None


@dataclass(frozen=True)
class NoopGate(Gate):
    def key(self):
        return "noop"

    @property
    def num_constraints(self):
        return 0

    def eval(self, ctx):
        return []


@dataclass(frozen=True)
class ArithmeticGate(Gate):
    """num_ops independent ops: out = c0 * a * b + c1 * c.

    Wires per op: [a, b, c, out] (all routed). Constants: c0, c1 shared."""

    num_ops: int

    def key(self):
        return f"arith{self.num_ops}"

    @property
    def num_constraints(self):
        return self.num_ops

    @staticmethod
    def wires_op(i: int) -> tuple[int, int, int, int]:
        return (4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3)

    def eval(self, ctx):
        out = []
        c0, c1 = ctx.constant(0), ctx.constant(1)
        for i in range(self.num_ops):
            a, b, c, o = self.wires_op(i)
            t = ctx.mul(c0, ctx.mul(ctx.wire(a), ctx.wire(b)))
            t = ctx.add(t, ctx.mul(c1, ctx.wire(c)))
            out.append(ctx.sub(ctx.wire(o), t))
        return out

    def eval_batched(self, ctx: DeviceBatchCtx):
        a = ctx.wire_rows([4 * i for i in range(self.num_ops)])
        b = ctx.wire_rows([4 * i + 1 for i in range(self.num_ops)])
        c = ctx.wire_rows([4 * i + 2 for i in range(self.num_ops)])
        o = ctx.wire_rows([4 * i + 3 for i in range(self.num_ops)])
        t = gl.add(gl.mul(ctx.constants[0], gl.mul(a, b)), gl.mul(ctx.constants[1], c))
        return gl.sub(o, t)


@dataclass(frozen=True)
class ConstantGate(Gate):
    """wire_i == constant_i for i < num_consts (== number of constant columns)."""

    num_consts: int = 2

    def key(self):
        return f"const{self.num_consts}"

    @property
    def num_constraints(self):
        return self.num_consts

    def eval(self, ctx):
        return [ctx.sub(ctx.wire(i), ctx.constant(i)) for i in range(self.num_consts)]


@dataclass(frozen=True)
class PublicInputGate(Gate):
    """wires 0..3 == the public-input hash supplied by the verifier."""

    def key(self):
        return "public_input"

    @property
    def num_constraints(self):
        return 4

    def eval(self, ctx):
        return [ctx.sub(ctx.wire(i), ctx.pi_hash(i)) for i in range(4)]


@dataclass(frozen=True)
class Poseidon2Gate(Gate):
    """One full Poseidon2 permutation per row.

    Wires: in[12] @0..11 (routed), out[12] @12..23 (routed), then scratch
    sbox outputs: 4 ext rounds x 12 @24..71, 22 internal @72..93,
    3 ext rounds x 12 @94..129 (130 wires, fits the 135-wire config; the
    reference's gate similarly needs 135 columns at degree 7,
    `common/src/circuit.rs:431-449`)."""

    W_IN = 0
    W_OUT = 12
    W_EXT_A = 24  # 4 rounds x 12
    W_INT = 72  # 22 lanes
    W_EXT_B = 94  # 3 rounds x 12
    NUM_WIRES = 130

    def key(self):
        return "poseidon2"

    @property
    def num_constraints(self):
        return 48 + 22 + 36 + 12

    @staticmethod
    def _ext_linear(ctx, state):
        m4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))
        groups = [state[0:4], state[4:8], state[8:12]]
        y = []
        for g in groups:
            y.append(
                [
                    _lin_comb(ctx, [(m4[i][j], g[j]) for j in range(4)])
                    for i in range(4)
                ]
            )
        s = [ctx.add(ctx.add(y[0][i], y[1][i]), y[2][i]) for i in range(4)]
        out = []
        for gi in range(3):
            for i in range(4):
                out.append(ctx.add(y[gi][i], s[i]))
        return out

    @staticmethod
    def _int_linear(ctx, state, diag):
        total = state[0]
        for i in range(1, 12):
            total = ctx.add(total, state[i])
        return [ctx.add(ctx.mul_const(state[i], int(diag[i])), total) for i in range(12)]

    def eval(self, ctx):
        ext_rcs = ps.external_round_constants()
        int_rcs = ps.internal_round_constants()
        diag = ps.internal_diag()
        constraints = []
        state = [ctx.wire(self.W_IN + i) for i in range(12)]
        state = self._ext_linear(ctx, state)
        # external rounds 1-4: sbox outputs are wires
        for r in range(4):
            for i in range(12):
                t = ctx.add_const(state[i], int(ext_rcs[r][i]))
                w = ctx.wire(self.W_EXT_A + 12 * r + i)
                constraints.append(ctx.sub(w, ctx.exp7(t)))
            state = self._ext_linear(
                ctx, [ctx.wire(self.W_EXT_A + 12 * r + i) for i in range(12)]
            )
        # internal rounds: lane-0 sbox outputs are wires
        for k in range(22):
            t = ctx.add_const(state[0], int(int_rcs[k]))
            w = ctx.wire(self.W_INT + k)
            constraints.append(ctx.sub(w, ctx.exp7(t)))
            state = self._int_linear(ctx, [w] + state[1:], diag)
        # external rounds 5-7: wires; round 8 folds into the out constraint
        for r in range(3):
            for i in range(12):
                t = ctx.add_const(state[i], int(ext_rcs[4 + r][i]))
                w = ctx.wire(self.W_EXT_B + 12 * r + i)
                constraints.append(ctx.sub(w, ctx.exp7(t)))
            state = self._ext_linear(
                ctx, [ctx.wire(self.W_EXT_B + 12 * r + i) for i in range(12)]
            )
        # final round: out = M_E(sbox(state + rc8))
        sboxed = [
            ctx.exp7(ctx.add_const(state[i], int(ext_rcs[7][i]))) for i in range(12)
        ]
        final = self._ext_linear(ctx, sboxed)
        for i in range(12):
            constraints.append(ctx.sub(ctx.wire(self.W_OUT + i), final[i]))
        return constraints

    def eval_batched(self, ctx: DeviceBatchCtx):
        """Batched device evaluation, round by round over (12, m) lanes.

        Key structural fact: every sbox input is an affine function of WIRE
        values (the state is rebuilt from stored sbox-output wires each
        round), so each round is a few field ops over stacked wire rows."""
        dev = ctx.wires.device
        ext_rcs = gl.from_u64(ps.external_round_constants(), dev).unsqueeze(-1)  # (8, 12, 1)
        int_rcs = gl.from_u64(ps.internal_round_constants(), dev)  # (22,)
        diag = gl.from_u64(ps.internal_diag(), dev).unsqueeze(-1)  # (12, 1)
        m = ctx.m

        in_state = ctx.wire_rows(range(self.W_IN, self.W_IN + 12))
        out_w = ctx.wire_rows(range(self.W_OUT, self.W_OUT + 12))
        o_a = ctx.wire_rows(range(self.W_EXT_A, self.W_EXT_A + 48)).reshape(4, 12, m)
        w_int = ctx.wire_rows(range(self.W_INT, self.W_INT + 22))
        o_b = ctx.wire_rows(range(self.W_EXT_B, self.W_EXT_B + 36)).reshape(3, 12, m)

        cons = []
        state = _ext_linear_lanes(in_state)
        for r in range(4):
            cons.append(gl.sub(o_a[r], gl.exp7(gl.add(state, ext_rcs[r]))))
            state = _ext_linear_lanes(o_a[r])
        for k in range(22):
            w = w_int[k]
            cons.append(gl.sub(w, gl.exp7(gl.add(state[0], int_rcs[k]))).unsqueeze(0))
            state = torch.cat([w.unsqueeze(0), state[1:]], dim=0)
            total = gl.sum_tree(state, 0)
            state = gl.add(gl.mul(state, diag), total)
        for r in range(3):
            cons.append(gl.sub(o_b[r], gl.exp7(gl.add(state, ext_rcs[4 + r]))))
            state = _ext_linear_lanes(o_b[r])
        # final round folded into the out constraint
        final = _ext_linear_lanes(gl.exp7(gl.add(state, ext_rcs[7])))
        cons.append(gl.sub(out_w, final))
        return torch.cat(cons, dim=0)

    def fill_row(self, get, set_):
        """The row's S-box outputs from one traced permutation in the C
        library (`native.permute_trace_batch`)."""
        ins = np.array([int(get(self.W_IN + i)) for i in range(12)], dtype=np.uint64)
        traced = nat.permute_trace_batch(ins)  # ext_a (4 x 12), internal (22), ext_b (3 x 12), out
        cols = [*range(self.W_EXT_A, self.W_EXT_A + 48), *range(self.W_INT, self.W_INT + 22),
                *range(self.W_EXT_B, self.W_EXT_B + 36), *range(self.W_OUT, self.W_OUT + 12)]
        for col, v in zip(cols, np.concatenate([t.ravel() for t in traced]).tolist()):
            set_(col, v)

    def _fill_row_pure(self, get, set_):
        """fill_row in pure Python ints (the tests' oracle)."""
        ext_rcs, int_rcs, diag = ps._int_constants()
        P = P_INT
        ext_linear = ps._scalar_ext_linear
        state = ext_linear([get(self.W_IN + i) for i in range(12)])
        for r in range(4):
            sb = [pow(state[i] + ext_rcs[r][i], 7, P) for i in range(12)]
            for i in range(12):
                set_(self.W_EXT_A + 12 * r + i, sb[i])
            state = ext_linear(sb)
        for k in range(22):
            x0 = pow(state[0] + int_rcs[k], 7, P)
            set_(self.W_INT + k, x0)
            state[0] = x0
            tot = sum(state)
            state = [(diag[i] * state[i] + tot) % P for i in range(12)]
        for r in range(3):
            sb = [pow(state[i] + ext_rcs[4 + r][i], 7, P) for i in range(12)]
            for i in range(12):
                set_(self.W_EXT_B + 12 * r + i, sb[i])
            state = ext_linear(sb)
        out = ext_linear([pow(state[i] + ext_rcs[7][i], 7, P) for i in range(12)])
        for i in range(12):
            set_(self.W_OUT + i, out[i])


@dataclass(frozen=True)
class ReducingGate(Gate):
    """Horner alpha-reduction: acc_out = fold_k (acc * alpha + c_k) over
    `num_coeffs` coefficients, with alpha and the accumulator in the
    quadratic extension F_p[X]/(X^2 - 7) and coefficients either base
    (ext=False, 1 wire each) or extension (ext=True, 2 wires each).

    TPU-first equivalent of plonky2's Reducing(Extension)Gate (the reference
    recursion's dominant row sink is exactly these alpha-combinations; see
    `paper/main.tex` layer-0 table context): one row replaces ~25-100
    arithmetic-gate rows of the unrolled Horner chain.

    Wires: [alpha0, alpha1, acc_in0, acc_in1, acc_out0, acc_out1,
    coeffs...] (routed, coeffs at 6 + k*(2 if ext else 1)); intermediate
    accumulators acc_0..acc_{nc-2} as (lo, hi) pairs in the UNROUTED region
    starting at `scratch` (= num_routed_wires). Constraints per step k
    (degree 2):

        cur0 - (prev0*a0 + 7*prev1*a1 + ck0) = 0
        cur1 - (prev0*a1 + prev1*a0 + ck1) = 0   (ck1 = 0 for base coeffs)
    """

    num_coeffs: int
    ext: bool
    scratch: int  # first unrouted wire column (= config.num_routed_wires)

    W_ALPHA = 0  # (0, 1)
    W_ACC_IN = 2  # (2, 3)
    W_ACC_OUT = 4  # (4, 5)
    W_COEFFS = 6

    def key(self):
        return f"reduce{'e' if self.ext else 'b'}{self.num_coeffs}s{self.scratch}"

    @property
    def num_constraints(self):
        return 2 * self.num_coeffs

    def coeff_wires(self, k: int) -> tuple:
        base = self.W_COEFFS + (2 if self.ext else 1) * k
        return (base, base + 1) if self.ext else (base,)

    def acc_wires(self, k: int) -> tuple[int, int]:
        """Accumulator AFTER step k (the last one is the routed acc_out)."""
        if k == self.num_coeffs - 1:
            return (self.W_ACC_OUT, self.W_ACC_OUT + 1)
        return (self.scratch + 2 * k, self.scratch + 2 * k + 1)

    @property
    def num_wires(self) -> int:
        return max(
            self.W_COEFFS + (2 if self.ext else 1) * self.num_coeffs,
            self.scratch + 2 * max(self.num_coeffs - 1, 0),
        )

    def eval(self, ctx):
        a0, a1 = ctx.wire(0), ctx.wire(1)
        prev0, prev1 = ctx.wire(2), ctx.wire(3)
        constraints = []
        for k in range(self.num_coeffs):
            cw = self.coeff_wires(k)
            c0 = ctx.wire(cw[0])
            o0, o1 = self.acc_wires(k)
            t0 = ctx.add(
                ctx.mul(prev0, a0), ctx.mul_const(ctx.mul(prev1, a1), 7)
            )
            t0 = ctx.add(t0, c0)
            t1 = ctx.add(ctx.mul(prev0, a1), ctx.mul(prev1, a0))
            if self.ext:
                t1 = ctx.add(t1, ctx.wire(cw[1]))
            constraints.append(ctx.sub(ctx.wire(o0), t0))
            constraints.append(ctx.sub(ctx.wire(o1), t1))
            prev0, prev1 = ctx.wire(o0), ctx.wire(o1)
        return constraints

    def eval_batched(self, ctx: DeviceBatchCtx):
        nc = self.num_coeffs
        prev0 = ctx.wire_rows([2] + [self.acc_wires(k)[0] for k in range(nc - 1)])
        prev1 = ctx.wire_rows([3] + [self.acc_wires(k)[1] for k in range(nc - 1)])
        cur0 = ctx.wire_rows([self.acc_wires(k)[0] for k in range(nc)])
        cur1 = ctx.wire_rows([self.acc_wires(k)[1] for k in range(nc)])
        c0 = ctx.wire_rows([self.coeff_wires(k)[0] for k in range(nc)])
        a0, a1 = ctx.wires[0], ctx.wires[1]
        t0 = gl.add(
            gl.add(gl.mul(prev0, a0), gl.mul_const(gl.mul(prev1, a1), 7)), c0
        )
        t1 = gl.add(gl.mul(prev0, a1), gl.mul(prev1, a0))
        if self.ext:
            t1 = gl.add(t1, ctx.wire_rows([self.coeff_wires(k)[1] for k in range(nc)]))
        con0 = gl.sub(cur0, t0)  # (nc, m)
        con1 = gl.sub(cur1, t1)
        # interleave to match eval() order: k0c0, k0c1, k1c0, ...
        return torch.stack([con0, con1], dim=1).reshape(2 * nc, -1)


def _lin_comb(ctx, terms):
    acc = None
    for coef, v in terms:
        t = v if coef == 1 else ctx.mul_const(v, coef)
        acc = t if acc is None else ctx.add(acc, t)
    return acc


def _ext_linear_lanes(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 external layer on (12, m) lane-major felts."""
    m4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))
    g = state.reshape(3, 4, -1)
    ys = []
    for i in range(4):
        acc = None
        for j in range(4):
            col = g[:, j]  # (3, m)
            term = gl.mul_const(col, m4[i][j]) if m4[i][j] != 1 else col
            acc = term if acc is None else gl.add(acc, term)
        ys.append(acc)  # (3, m)
    y = torch.stack(ys, dim=1)  # (3, 4, m)
    s = gl.add(gl.add(y[0], y[1]), y[2])  # (4, m)
    return gl.add(y, s).reshape(12, -1)


@dataclass(frozen=True)
class BaseSumGate(Gate):
    """Binary decomposition: wire_0 = sum b_i 2^i, b_i boolean.

    Wires: [value, b_0 .. b_{num_bits-1}]."""

    num_bits: int

    def key(self):
        return f"base_sum{self.num_bits}"

    @property
    def num_constraints(self):
        return self.num_bits + 1

    def eval(self, ctx):
        constraints = []
        acc = None
        for i in range(self.num_bits):
            b = ctx.wire(1 + i)
            constraints.append(ctx.mul(b, ctx.add_const(b, -1)))
            t = ctx.mul_const(b, 1 << i) if i else b
            acc = t if acc is None else ctx.add(acc, t)
        constraints.append(ctx.sub(ctx.wire(0), acc))
        return constraints

    def eval_batched(self, ctx: DeviceBatchCtx):
        bits = ctx.wire_rows(range(1, 1 + self.num_bits))  # (nb, m)
        bools = gl.mul(bits, gl.add_const(bits, P_INT - 1))
        pows = gl.from_u64(
            np.array([(1 << i) % P_INT for i in range(self.num_bits)], dtype=np.uint64),
            bits.device,
        )
        weighted = gl.mul(bits, pows.unsqueeze(-1))
        total = gl.sum_tree(weighted, 0)
        recomb = gl.sub(ctx.wires[0], total)
        return torch.cat([bools, recomb.unsqueeze(0)], dim=0)

    def fill_row(self, get, set_):
        v = get(0)
        if v >> self.num_bits:
            # mirror the reference's BaseSplitGenerator panic: a range-checked
            # value that does not fit must fail at witness time, not produce
            # an unverifiable trace
            raise ValueError(
                f"range check failed: value {v} does not fit in {self.num_bits} bits"
            )
        for i in range(self.num_bits):
            set_(1 + i, (v >> i) & 1)


# ---------------------------------------------------------------------------
# kernel A's gate descriptors (csrc/quotient.cu)

#: kernel A's gate type ids, the one table of them: csrc/quotient.cu's enum
#: mirrors it and chip_smoke.py's op counts key on it; 7 marks a challenge's
#: permutation part
GATE_TYPE_IDS = {
    NoopGate: 0,
    ArithmeticGate: 1,
    ConstantGate: 2,
    PublicInputGate: 3,
    Poseidon2Gate: 4,
    ReducingGate: 5,
    BaseSumGate: 6,
}
PERMUTATION_TYPE_ID = 7


def gate_descriptor(gate: Gate) -> tuple[int, int, int, int]:
    """(type id, p0, p1, p2): what kernel A needs to evaluate `gate`'s
    constraints in its own registers. A gate type the kernel does not know
    raises; it never falls back to `eval_batched`."""
    tid = GATE_TYPE_IDS.get(type(gate))
    if tid is None:
        raise ValueError(f"kernel A has no evaluation for gate {type(gate).__name__}")
    if isinstance(gate, ArithmeticGate):
        return (tid, gate.num_ops, 0, 0)
    if isinstance(gate, ConstantGate):
        return (tid, gate.num_consts, 0, 0)
    if isinstance(gate, ReducingGate):
        return (tid, gate.num_coeffs, int(gate.ext), gate.scratch)
    if isinstance(gate, BaseSumGate):
        return (tid, gate.num_bits, 0, 0)
    return (tid, 0, 0, 0)
