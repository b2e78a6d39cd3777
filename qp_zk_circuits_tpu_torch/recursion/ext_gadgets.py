"""Quadratic-extension arithmetic on target pairs (c0, c1).

The verifier's algebra at zeta lives in F_{p^2} = F_p[X]/(X^2 - 7); these
gadgets express it over base-field arithmetic gates: an extension mul is
5 base muls, an inverse is a witness + product constraint."""

from __future__ import annotations

from ..field.extension import W
from ..plonk.builder import CircuitBuilder

P = 0xFFFFFFFF00000001


class ExtTarget(tuple):
    """(c0, c1) target pair."""

    def __new__(cls, c0: int, c1: int):
        return super().__new__(cls, (c0, c1))

    @property
    def c0(self):
        return self[0]

    @property
    def c1(self):
        return self[1]


def ext_from_base(b: CircuitBuilder, t: int) -> ExtTarget:
    return ExtTarget(t, b.zero())

def ext_zero(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.zero(), b.zero())


def ext_one(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.one(), b.zero())


def ext_constant(b: CircuitBuilder, c0: int, c1: int = 0) -> ExtTarget:
    return ExtTarget(b.constant(c0), b.constant(c1))


def ext_virtual(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.add_virtual_target(), b.add_virtual_target())


def ext_add(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(b.add(x[0], y[0]), b.add(x[1], y[1]))


def ext_sub(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(b.sub(x[0], y[0]), b.sub(x[1], y[1]))


def ext_mul(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    """(x0 y0 + 7 x1 y1, x0 y1 + x1 y0)."""
    t00 = b.mul(x[0], y[0])
    t11 = b.mul(x[1], y[1])
    c0 = b._arith_op(7, 1, t11, b.one(), t00)  # 7*t11 + t00
    t01 = b.mul(x[0], y[1])
    c1 = b.mul_add(x[1], y[0], t01)
    return ExtTarget(c0, c1)


def ext_scalar_mul(b: CircuitBuilder, x: ExtTarget, s: int) -> ExtTarget:
    """Multiply by a base-field TARGET s."""
    return ExtTarget(b.mul(x[0], s), b.mul(x[1], s))


def ext_mul_const(b: CircuitBuilder, x: ExtTarget, c: int) -> ExtTarget:
    """Multiply by a Python-int constant."""
    return ExtTarget(b.mul_const(c, x[0]), b.mul_const(c, x[1]))


def ext_inverse(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    """Witnessed inverse with in-circuit product check x * inv == 1
    (unprovable when x == 0). The witness tape lowers it to one OP_EXTINV
    (plonk/witness_tape.py); the Python replay takes ints."""
    inv = ext_virtual(b)

    def gen(get, x=x):
        x0, x1 = get(x[0]), get(x[1])
        norm = (x0 * x0 - W * x1 * x1) % P
        ninv = pow(norm, P - 2, P)
        return [(x0 * ninv) % P, (P - x1) * ninv % P]

    b._simple_generator(
        [x[0], x[1]], gen, [inv[0], inv[1]], desc=("extinv", x[0], x[1])
    )
    prod = ext_mul(b, x, inv)
    b.assert_one(prod[0])
    b.assert_zero(prod[1])
    return inv


def ext_div(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ext_mul(b, x, ext_inverse(b, y))


def ext_select(b: CircuitBuilder, flag: int, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(b.select(flag, x[0], y[0]), b.select(flag, x[1], y[1]))


def ext_eq_assert(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> None:
    b.connect(x[0], y[0])
    b.connect(x[1], y[1])


def ext_exp_pow2(b: CircuitBuilder, x: ExtTarget, k: int) -> ExtTarget:
    for _ in range(k):
        x = ext_mul(b, x, x)
    return x


def ext_exp_u(b: CircuitBuilder, x: ExtTarget, e: int) -> ExtTarget:
    """x^e for a Python-int exponent (square-and-multiply)."""
    acc = None
    base = x
    while e:
        if e & 1:
            acc = base if acc is None else ext_mul(b, acc, base)
        e >>= 1
        if e:
            base = ext_mul(b, base, base)
    return acc if acc is not None else ext_one(b)


def _reduce_row(b: CircuitBuilder, alpha: ExtTarget, acc_in: ExtTarget,
                chunk: list, ext: bool) -> ExtTarget:
    """One ReducingGate row: Horner over `chunk` (consumption order)."""
    from ..plonk.gates import ReducingGate

    nr = b.config.num_routed_wires
    g = ReducingGate(len(chunk), ext, nr)
    row = b.add_gate(g, ())
    wt = b.wire_target
    b.connect(wt(row, 0), alpha[0])
    b.connect(wt(row, 1), alpha[1])
    b.connect(wt(row, 2), acc_in[0])
    b.connect(wt(row, 3), acc_in[1])
    zero = b.zero()
    prev0, prev1 = acc_in[0], acc_in[1]
    for k, c in enumerate(chunk):
        cws = g.coeff_wires(k)
        if ext:
            c0t, c1t = c[0], c[1]
            b.connect(wt(row, cws[1]), c1t)
        else:
            c0t, c1t = c, zero
        b.connect(wt(row, cws[0]), c0t)
        o0, o1 = g.acc_wires(k)
        out0, out1 = wt(row, o0), wt(row, o1)
        # witness completion (constraints pin these): 2 fmadds per component
        t0 = b.add_virtual_target()
        b._fmadd_gen(7, prev1, alpha[1], 1, c0t, t0)
        b._fmadd_gen(1, prev0, alpha[0], 1, t0, out0)
        t1 = b.add_virtual_target()
        b._fmadd_gen(1, prev1, alpha[0], 1, c1t, t1)
        b._fmadd_gen(1, prev0, alpha[1], 1, t1, out1)
        prev0, prev1 = out0, out1
    return ExtTarget(prev0, prev1)


def ext_reduce_with_powers(b: CircuitBuilder, alpha: ExtTarget, coeffs: list,
                           ext: bool) -> ExtTarget:
    """sum_k alpha^k * coeffs[k] via ReducingGate rows (Horner, highest power
    first). coeffs are base targets (ext=False) or ExtTargets (ext=True).

    One 38-coeff (base) / 27-coeff (ext) row at the canonical 135/60 config
    replaces ~30-110 arithmetic rows — the reference recursion leans on the
    same gate for exactly this reason (plonky2 ReducingExtensionGate)."""
    nr, nw = b.config.num_routed_wires, b.config.num_wires
    cw = 2 if ext else 1
    cap = min((nr - 6) // cw, (nw - nr) // 2 + 1)
    if cap < 8 or len(coeffs) < 8:
        # tiny configs / short reductions: plain Horner over arith gates
        acc = ext_zero(b)
        for c in reversed(coeffs):
            acc = ext_mul(b, acc, alpha)
            acc = ext_add(b, acc, c if ext else ExtTarget(c, b.zero()))
        return acc
    rev = list(reversed(coeffs))
    zero = b.zero()
    pad_c = ExtTarget(zero, zero) if ext else zero
    # front-pad to a multiple of the row capacity: leading zero coefficients
    # are a no-op because the accumulator starts at zero — and every row then
    # uses ONE gate shape (one selector column)
    rev = [pad_c] * ((-len(rev)) % cap) + rev
    acc = ext_zero(b)
    for i in range(0, len(rev), cap):
        acc = _reduce_row(b, alpha, acc, rev[i : i + cap], ext)
    return acc
