"""Circuit builder DSL, preprocessing (CircuitData) and witness generation.

Covers the reference's consumed `CircuitBuilder` API census (SURVEY §2.1):
select / connect / is_equal / and-or-not / add-sub-mul / mul_const_add /
range_check / split_le / split_low_high / constants / virtual targets /
hashing / register_public_input / num_gates — built on the TPU-first gate set
in `gates.py` (one-hot selectors, dense masked evaluation).

Design:
  * A Target is an integer id. Wire cells (row, col) bind to targets; `connect`
    unions targets (union-find). Routed cells in one class form a sigma cycle
    (the PLONK copy-constraint permutation).
  * Witness generation is host-side: generators run in a worklist until all
    targets resolve (graph-like control flow stays on CPU — SURVEY §7), then
    the trace ships to the device as one (num_wires, n) matrix.
  * Public inputs are hashed in-circuit (Poseidon2 sponge over PI targets)
    and pinned to a PublicInputGate row; the verifier recomputes the hash
    from the claimed PIs (keeps verification O(1) in PI count and makes the
    circuit recursion-friendly).
  * Zero-knowledge: pad with noop rows filled with random wires (row
    blinding, the fork's low-memory choice — `common/src/circuit.rs:389-395`)
    plus salted commitments.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from ..field import gf_np as F
from ..fri.config import SALT_SIZE
from ..hash import poseidon2 as ps
from . import witness_tape
from .config import CircuitConfig
from .gates import (
    ArithmeticGate,
    BaseSumGate,
    ConstantGate,
    Gate,
    NoopGate,
    Poseidon2Gate,
    PublicInputGate,
)

P = 0xFFFFFFFF00000001


# -- polymorphic witness field ops -------------------------------------------
# Generator closures run in TWO modes: scalar Python ints (single witness)
# and numpy uint64 (K,)-vectors (batched witness generation — one fixpoint
# pass computes K witnesses at once). Plain `*`/`%` would silently wrap on
# uint64 arrays, so every closure goes through these helpers.


def _fmadd(c0: int, a, b, c1: int, c):
    """c0*a*b + c1*c (mod p) — the ArithmeticGate op."""
    if type(a) is int and type(b) is int and type(c) is int:
        return (c0 * a * b + c1 * c) % P
    ab = F.mul(np.asarray(a, np.uint64), np.asarray(b, np.uint64))
    return F.add(
        F.mul(np.uint64(c0), ab), F.mul(np.uint64(c1), np.asarray(c, np.uint64))
    )


def _finv_or_zero(d):
    """d^{-1} if d != 0 else 0 (the is_equal witness hint)."""
    if type(d) is int:
        return pow(d, P - 2, P) if d else 0
    d = np.asarray(d, np.uint64)
    return np.where(d == 0, np.uint64(0), F.inv(d))


def _finv(a):
    """a^{-1} (the inverse gadget witness; a == 0 yields 0 and the circuit's
    a*inv == 1 constraint fails to prove, as intended)."""
    if type(a) is int:
        return pow(a, P - 2, P)
    return F.inv(np.asarray(a, np.uint64))

# routed-coset shifts k_i = 7^i (distinct cosets of H for i < num_routed)
@functools.cache
def coset_shifts(num_routed: int) -> np.ndarray:
    return F.powers(F.MULTIPLICATIVE_GROUP_GENERATOR, num_routed)


# number of random blinding rows appended in zero-knowledge mode; covers the
# 28 FRI query openings + the zeta opening with margin (row-blinding
# calibration refined in later rounds).
ZK_BLINDING_ROWS = 64


class CircuitBuilder:
    def __init__(self, config: CircuitConfig):
        self.config = config
        self.rows: list[tuple[Gate, tuple[int, ...]]] = []  # (gate, constants)
        self.cell_target: dict[tuple[int, int], int] = {}
        self._parent: list[int] = []  # union-find
        self.generators: list[tuple[tuple[int, ...], object]] = []  # (deps, fn)
        self.public_input_targets: list[int] = []
        self._const_cache: dict[int, int] = {}
        self._const_slot: tuple[int, int] | None = None  # (row, used)
        self._arith_slots: dict[tuple[int, int], tuple[int, int]] = {}  # (c0,c1)->(row,used)
        self._built = False

    # -- targets -----------------------------------------------------------
    def add_virtual_target(self) -> int:
        t = len(self._parent)
        self._parent.append(t)
        return t

    def add_virtual_targets(self, n: int) -> list[int]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self) -> list[int]:
        return self.add_virtual_targets(4)

    def _find(self, t: int) -> int:
        while self._parent[t] != t:
            self._parent[t] = self._parent[self._parent[t]]
            t = self._parent[t]
        return t

    def connect(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[ra] = rb

    def connect_hashes(self, a: list[int], b: list[int]) -> None:
        for x, y in zip(a, b):
            self.connect(x, y)

    def wire_target(self, row: int, col: int) -> int:
        key = (row, col)
        if key not in self.cell_target:
            self.cell_target[key] = self.add_virtual_target()
        return self.cell_target[key]

    # -- gate rows ---------------------------------------------------------
    def add_gate(self, gate: Gate, constants: tuple[int, ...] = ()) -> int:
        assert not self._built
        self.rows.append((gate, constants))
        return len(self.rows) - 1

    def num_gates(self) -> int:
        return len(self.rows)

    # -- constants ---------------------------------------------------------
    def constant(self, value: int) -> int:
        value = value % P
        if value in self._const_cache:
            return self._const_cache[value]
        if self._const_slot is None or self._const_slot[1] >= 2:
            row = self.add_gate(ConstantGate(2), (0, 0))
            self._const_slot = (row, 0)
        row, used = self._const_slot
        gate, consts = self.rows[row]
        consts = list(consts)
        consts[used] = value
        self.rows[row] = (gate, tuple(consts))
        t = self.wire_target(row, used)
        self._const_slot = (row, used + 1)
        self._const_cache[value] = t
        self._simple_generator([], lambda get: [value], [t], desc=("const", value))
        return t

    def zero(self) -> int:
        return self.constant(0)

    def one(self) -> int:
        return self.constant(1)

    def two(self) -> int:
        return self.constant(2)

    def _true(self) -> int:
        return self.one()

    def _false(self) -> int:
        return self.zero()

    def constant_bool(self, b: bool) -> int:
        return self.one() if b else self.zero()

    # -- generators --------------------------------------------------------
    def _simple_generator(self, deps: list[int], fn, outputs: list[int], desc=None) -> None:
        """fn(get) -> list of output values (ints). `desc` is the witness-tape
        descriptor (plonk/witness_tape.py), a tuple like ("fmadd", c0, c1, a,
        b, c), that lets the recorded program be lowered to the C VM; a
        generator without one makes its circuit replay in Python."""
        self.generators.append((tuple(deps), (fn, tuple(outputs), desc)))

    # -- arithmetic --------------------------------------------------------
    def _arith_op(self, c0: int, c1: int, a: int, b: int, c: int) -> int:
        """Returns target for out = c0*a*b + c1*c. Packs ops with the same
        (c0, c1) constants into shared rows."""
        c0, c1 = c0 % P, c1 % P
        num_ops = self.config.num_routed_wires // 4
        key = (c0, c1)
        row, used = self._arith_slots.get(key, (None, num_ops))
        if used >= num_ops:
            row = self.add_gate(ArithmeticGate(num_ops), (c0, c1))
            used = 0
        self._arith_slots[key] = (row, used + 1)
        i = used
        wa, wb, wc, wo = ArithmeticGate.wires_op(i)
        self.connect(self.wire_target(row, wa), a)
        self.connect(self.wire_target(row, wb), b)
        self.connect(self.wire_target(row, wc), c)
        out = self.wire_target(row, wo)
        self._simple_generator(
            [a, b, c],
            lambda get, c0=c0, c1=c1, a=a, b=b, c=c: [
                _fmadd(c0, get(a), get(b), c1, get(c))
            ],
            [out],
            desc=("fmadd", c0, c1, a, b, c),
        )
        return out

    def _fmadd_gen(self, c0: int, a: int, b: int, c1: int, c: int, out: int) -> None:
        """Generator-only fmadd: out := c0*a*b + c1*c (NO gate row — used by
        gates whose constraints already pin `out`, e.g. ReducingGate)."""
        c0, c1 = c0 % P, c1 % P
        self._simple_generator(
            [a, b, c],
            lambda get, c0=c0, c1=c1, a=a, b=b, c=c: [
                _fmadd(c0, get(a), get(b), c1, get(c))
            ],
            [out],
            desc=("fmadd", c0, c1, a, b, c),
        )

    def add(self, a: int, b: int) -> int:
        return self._arith_op(1, 1, a, self.one(), b)

    def sub(self, a: int, b: int) -> int:
        return self._arith_op(1, P - 1, a, self.one(), b)

    def mul(self, a: int, b: int) -> int:
        return self._arith_op(1, 0, a, b, a)

    def mul_const(self, c: int, a: int) -> int:
        return self._arith_op(c, 0, a, self.one(), a)

    def mul_const_add(self, c0: int, a: int, c: int) -> int:
        return self._arith_op(c0, 1, a, self.one(), c)

    def mul_add(self, a: int, b: int, c: int) -> int:
        return self._arith_op(1, 1, a, b, c)

    def mul_sub(self, a: int, b: int, c: int) -> int:
        return self._arith_op(1, P - 1, a, b, c)

    def add_const(self, a: int, c: int) -> int:
        return self.add(a, self.constant(c))

    def neg(self, a: int) -> int:
        return self.mul_const(P - 1, a)

    def inverse(self, a: int) -> int:
        """out = a^{-1}; constrained by a * out == 1 (fails to prove if a == 0)."""
        inv = self.add_virtual_target()
        self._simple_generator(
            [a], lambda get, a=a: [_finv(get(a))], [inv], desc=("inv", a)
        )
        prod = self.mul(a, inv)
        self.connect(prod, self.one())
        return inv

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inverse(b))

    # -- booleans ----------------------------------------------------------
    def assert_bool(self, b: int) -> None:
        # b * b == b
        sq = self.mul(b, b)
        self.connect(sq, b)

    def add_virtual_bool_target_safe(self) -> int:
        b = self.add_virtual_target()
        self.assert_bool(b)
        return b

    def and_(self, a: int, b: int) -> int:
        return self.mul(a, b)

    def or_(self, a: int, b: int) -> int:
        # a + b - a*b
        ab = self.mul(a, b)
        return self.sub(self.add(a, b), ab)

    def not_(self, a: int) -> int:
        return self.sub(self.one(), a)

    def select(self, b: int, x: int, y: int) -> int:
        """b ? x : y  ==  b*(x - y) + y."""
        d = self.sub(x, y)
        return self._arith_op(1, 1, b, d, y)

    def is_equal(self, x: int, y: int) -> int:
        """Boolean target eq = (x == y), plonky2-style inverse trick."""
        d = self.sub(x, y)
        m = self.add_virtual_target()
        self._simple_generator(
            [d], lambda get, d=d: [_finv_or_zero(get(d))], [m], desc=("invz", d)
        )
        dm = self.mul(d, m)
        eq = self.sub(self.one(), dm)
        # d * eq == 0 forces eq = 0 whenever d != 0
        z = self.mul(d, eq)
        self.connect(z, self.zero())
        return eq

    def assert_zero(self, x: int) -> None:
        self.connect(x, self.zero())

    def assert_one(self, x: int) -> None:
        self.connect(x, self.one())

    # -- decomposition / range checks --------------------------------------
    def split_le(self, x: int, num_bits: int) -> list[int]:
        """Little-endian boolean decomposition (constrained); returns bit targets."""
        assert num_bits + 1 <= self.config.num_routed_wires, "split too wide for config"
        row = self.add_gate(BaseSumGate(num_bits), ())
        self.connect(self.wire_target(row, 0), x)
        bits = [self.wire_target(row, 1 + i) for i in range(num_bits)]
        gate = self.rows[row][0]
        self._gate_fill_generator(row, gate, [x], 1 + num_bits)
        return bits

    def range_check(self, x: int, num_bits: int) -> None:
        self.split_le(x, num_bits)

    def split_low_high(self, x: int, low_bits: int, total_bits: int) -> tuple[int, int]:
        """x = low + high * 2^low_bits, low < 2^low_bits, high < 2^(total-low)."""
        if total_bits + 1 > self.config.num_routed_wires:
            assert low_bits == 32 and total_bits == 64, "wide split only supports 32/64"
            lo, hi, _ = self.split_64(x)
            return lo, hi
        bits = self.split_le(x, total_bits)
        low = self._recombine(bits[:low_bits])
        high = self._recombine(bits[low_bits:])
        return low, high

    def split_64(self, x: int) -> tuple[int, int, list[int]]:
        """64-bit decomposition via TWO 32-bit rows (fits narrow routed-wire
        configs): returns (lo, hi, all 64 bits little-endian). NOT canonical
        on its own — see gadgets.split_canonical_u32_halves for the alias
        exclusion."""
        lo = self.add_virtual_target()
        hi = self.add_virtual_target()
        self._simple_generator(
            [x],
            lambda get, x=x: [get(x) & 0xFFFFFFFF, get(x) >> 32],
            [lo, hi],
            desc=("split64", x),
        )
        recomb = self.mul_const_add(1 << 32, hi, lo)
        self.connect(recomb, x)
        lo_bits = self.split_le(lo, 32)
        hi_bits = self.split_le(hi, 32)
        return lo, hi, lo_bits + hi_bits

    def _recombine(self, bits: list[int]) -> int:
        acc = bits[-1]
        for b in reversed(bits[:-1]):
            acc = self._arith_op(2, 1, acc, self.one(), b)  # acc = 2*acc + b
        return acc

    def exp_u64(self, base: int, exponent_bits: list[int]) -> int:
        acc = self.one()
        for b in reversed(exponent_bits):
            acc = self.mul(acc, acc)
            mult = self.select(b, base, self.one())
            acc = self.mul(acc, mult)
        return acc

    # -- hashing -----------------------------------------------------------
    def permute(self, inputs: list[int]) -> list[int]:
        """One Poseidon2 permutation row; returns 12 output targets."""
        assert len(inputs) == 12
        assert self.config.num_wires >= Poseidon2Gate.NUM_WIRES, (
            f"Poseidon2 gate needs {Poseidon2Gate.NUM_WIRES} wire columns; "
            f"config has {self.config.num_wires}"
        )
        row = self.add_gate(Poseidon2Gate(), ())
        for i, t in enumerate(inputs):
            self.connect(self.wire_target(row, Poseidon2Gate.W_IN + i), t)
        outs = [self.wire_target(row, Poseidon2Gate.W_OUT + i) for i in range(12)]
        self._gate_fill_generator(row, self.rows[row][0], inputs, Poseidon2Gate.NUM_WIRES)
        return outs

    def hash_n_to_hash_no_pad(self, inputs: list[int]) -> list[int]:
        """Sponge with overwrite absorption, rate 8; returns 4-target digest."""
        state = [self.zero()] * 12
        for start in range(0, len(inputs), 8):
            chunk = inputs[start : start + 8]
            state = list(chunk) + state[len(chunk) :]
            state = self.permute(state)
        return state[:4]

    def add_virtual_hash_public_input(self) -> list[int]:
        h = self.add_virtual_hash()
        self.register_public_inputs(h)
        return h

    # -- public inputs ------------------------------------------------------
    def register_public_input(self, t: int) -> None:
        self.public_input_targets.append(t)

    def register_public_inputs(self, ts: list[int]) -> None:
        for t in ts:
            self.register_public_input(t)

    def num_public_inputs(self) -> int:
        return len(self.public_input_targets)

    # -- gate fill generators ----------------------------------------------
    def _gate_fill_generator(
        self, row: int, gate: Gate, dep_targets: list[int], num_wires: int
    ) -> None:
        # Pre-bind every cell the fill may touch, so the cells exist in the
        # frozen cell->target map when the trace is materialised.
        cell_targets = {col: self.wire_target(row, col) for col in range(num_wires)}

        def fn(get, gate=gate, cell_targets=cell_targets):
            results = {}

            def getw(col):
                t = cell_targets.get(col)
                return 0 if t is None else get(t)

            def setw(col, val):
                results[col] = val % P

            gate.fill_row(getw, setw)
            return [(cell_targets[col], val) for col, val in results.items()]

        self.generators.append(
            (tuple(dep_targets), ("gate_fill", fn, (row, cell_targets)))
        )

    # -- build ---------------------------------------------------------------
    def build(self, shape_only: bool = False, device=None) -> "CircuitData":
        """Preprocess the circuit and commit its preprocessing oracle on
        `device` (CUDA unless the caller names one; see device.py).
        `shape_only=True` skips that commitment (constants_oracle stays None)
        — for shape/profile tooling that only needs gate counts, degree bits
        and layout (reference `wormhole/circuit/src/profile.rs` builds
        circuits purely to print metrics)."""
        assert not self._built
        # hash public inputs in-circuit and pin to a PublicInputGate
        if self.public_input_targets:
            pi_hash = self.hash_n_to_hash_no_pad(list(self.public_input_targets))
        else:
            pi_hash = [self.zero()] * 4
        pi_row = self.add_gate(PublicInputGate(), ())
        for i in range(4):
            self.connect(self.wire_target(pi_row, i), pi_hash[i])
        self._built = True

        cfg = self.config
        num_rows = len(self.rows)
        blinding = ZK_BLINDING_ROWS if cfg.zero_knowledge else 0
        degree_bits = max(2, (num_rows + blinding - 1).bit_length())
        n = 1 << degree_bits

        # gate types and selector columns
        gate_keys: list[str] = []
        gate_of_key: dict[str, Gate] = {}
        for gate, _ in self.rows:
            if not isinstance(gate, NoopGate) and gate.key() not in gate_of_key:
                gate_of_key[gate.key()] = gate
                gate_keys.append(gate.key())
        selector_of_key = {k: i for i, k in enumerate(gate_keys)}

        num_consts = 2
        num_selectors = len(gate_keys)
        const_cols = np.zeros((num_consts, n), dtype=np.uint64)
        sel_cols = np.zeros((num_selectors, n), dtype=np.uint64)
        row_gate = []
        for r, (gate, consts) in enumerate(self.rows):
            row_gate.append(gate)
            for k, v in enumerate(consts[:num_consts]):
                const_cols[k, r] = v
            if not isinstance(gate, NoopGate):
                sel_cols[selector_of_key[gate.key()], r] = 1

        # sigma permutation over routed cells
        nr = cfg.num_routed_wires
        ks = coset_shifts(nr)
        ws = F.powers_table(F.primitive_root_of_unity(degree_bits), n)
        # identity coordinates
        sigma_vals = np.empty((nr, n), dtype=np.uint64)
        for i in range(nr):
            sigma_vals[i] = F.mul(ks[i], ws)
        id_coords = sigma_vals.copy()
        groups: dict[int, list[tuple[int, int]]] = {}
        for (row, col), t in self.cell_target.items():
            if col < nr:
                groups.setdefault(self._find(t), []).append((col, row))
        for cells in groups.values():
            if len(cells) > 1:
                for idx, (ci, ri) in enumerate(cells):
                    cj, rj = cells[(idx + 1) % len(cells)]
                    sigma_vals[ci, ri] = id_coords[cj, rj]

        data = CircuitData(
            config=cfg,
            degree_bits=degree_bits,
            gate_types=[gate_of_key[k] for k in gate_keys],
            num_selectors=num_selectors,
            const_cols=const_cols,
            sel_cols=sel_cols,
            sigma_vals=sigma_vals,
            id_coords=id_coords,
            row_gate=row_gate,
            cell_target={k: self._find(t) for k, t in self.cell_target.items()},
            num_targets=len(self._parent),
            target_root=[self._find(t) for t in range(len(self._parent))],
            generators=self.generators,
            public_input_targets=[self._find(t) for t in self.public_input_targets],
            num_rows_used=num_rows,
        )
        if not shape_only:
            from ..device import resolve_device

            data.finalize(resolve_device(device))
        return data

    def print_gate_counts(self) -> None:
        from collections import Counter

        counts = Counter(g.key() for g, _ in self.rows)
        for k, v in sorted(counts.items()):
            print(f"  {k}: {v} rows")
        print(f"  total: {len(self.rows)} rows")


def compute_circuit_digest(cap, config, degree_bits, gate_keys, num_selectors,
                           num_const_cols, num_public_inputs) -> np.ndarray:
    """Fiat-Shamir circuit digest binding the FULL verifier identity.

    Covers the constants cap AND every field that changes which constraints
    are evaluated: the config knob set, degree_bits, the ordered gate-type
    keys, the column layout and the PI count — so a tampered serialized
    verifier-data artifact can never pass the digest check while altering
    verification semantics (ADVICE r1 medium; the reference pins artifacts by
    keccak over full bytes, `wormhole/verifier/src/lib.rs:101-112`)."""
    fc = config.fri_config
    felts = list(np.asarray(cap, dtype=np.uint64).ravel())
    felts += [
        config.num_wires, config.num_routed_wires, config.num_challenges,
        config.security_bits, config.max_quotient_degree_factor,
        int(config.zero_knowledge), fc.rate_bits, fc.cap_height,
        fc.proof_of_work_bits, fc.num_query_rounds,
        fc.reduction_strategy.arity_bits, fc.reduction_strategy.final_poly_bits,
        degree_bits, num_selectors, num_const_cols, num_public_inputs,
        len(gate_keys),
    ]
    for key in gate_keys:
        kb = key.encode()
        felts.append(len(kb))
        felts.extend(kb)
    return ps.hash_no_pad(np.array(felts, dtype=np.uint64))


@dataclass
class CircuitData:
    """Preprocessed circuit: constants/selectors/sigmas + commitment."""

    config: CircuitConfig
    degree_bits: int
    gate_types: list
    num_selectors: int
    const_cols: np.ndarray
    sel_cols: np.ndarray
    sigma_vals: np.ndarray
    id_coords: np.ndarray
    row_gate: list
    cell_target: dict
    num_targets: int
    target_root: list
    generators: list
    public_input_targets: list
    num_rows_used: int
    constants_oracle: object = None
    circuit_digest: np.ndarray = None
    device: object = None  # torch.device the preprocessing oracle lives on

    @property
    def n(self) -> int:
        return 1 << self.degree_bits

    def finalize(self, device) -> None:
        """Commit the preprocessing oracle (constants | selectors | sigmas) on
        `device`."""
        from ..fri import oracle as fo

        self.device = device
        cols = np.concatenate([self.const_cols, self.sel_cols, self.sigma_vals], axis=0)
        self.constants_oracle = fo.commit(
            cols,
            self.config.fri_config.rate_bits,
            self.config.fri_config.cap_height,
            device,
            from_values=True,
        )
        self.circuit_digest = compute_circuit_digest(
            self.constants_oracle.cap,
            self.config,
            self.degree_bits,
            [g.key() for g in self.gate_types],
            self.num_selectors,
            self.const_cols.shape[0],
            len(self.public_input_targets),
        )

    # column layout inside the constants oracle
    def const_col(self, k: int) -> int:
        return k

    def sel_col(self, s: int) -> int:
        return self.const_cols.shape[0] + s

    def sigma_col(self, i: int) -> int:
        return self.const_cols.shape[0] + self.num_selectors + i

    @property
    def num_preprocessed(self) -> int:
        return self.const_cols.shape[0] + self.num_selectors + self.sigma_vals.shape[0]


class PartialWitness:
    """Caller-supplied target assignments (the reference's PartialWitness).

    Large `set_many` calls are kept as (targets, values) numpy chunks, so
    the witness tape's seeding stays vectorized.

    Assignment semantics are WRITE-ONCE: re-assigning a target with the same
    canonical value is a no-op; a differing value raises WitnessError
    immediately on the dict path and in `run_generators` / `run_tape` for
    bulk chunks.
    Values are canonicalized with a Python-int `% P` (negative ints
    accepted) before any uint64 cast."""

    def __init__(self):
        self.values: dict[int, int] = {}
        self.bulk: list[tuple[np.ndarray, np.ndarray]] = []

    def set_target(self, t: int, value: int) -> None:
        v = int(value) % P
        prev = self.values.setdefault(t, v)
        if prev != v:
            raise WitnessError(
                f"conflicting witness value for target {t}: {prev} vs {v}"
            )

    def set_many(self, ts: list[int], vals) -> None:
        if len(ts) >= 8:
            va = np.asarray(vals)
            if va.dtype.kind == "u":  # hot path (fill_proof_targets): vector
                vs = va.astype(np.uint64) % np.uint64(P)
            else:  # Python ints / signed: canonicalize per value (negatives ok)
                vs = np.asarray([int(v) % P for v in vals], dtype=np.uint64)
            self.bulk.append((np.asarray(ts, dtype=np.int64), vs))
            return
        for t, v in zip(ts, vals):
            self.set_target(t, int(v))

    def set_hash_target(self, hs: list[int], digest) -> None:
        self.set_many(hs, [int(x) for x in digest])

    def all_items(self):
        """Iterate every (target, value) pair (dict + bulk chunks)."""
        yield from self.values.items()
        for ts, vs in self.bulk:
            yield from zip(ts.tolist(), vs.tolist())

    def seed_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """All assignments as (targets int64, values uint64) arrays."""
        parts_t = [np.fromiter(self.values.keys(), np.int64, len(self.values))]
        parts_v = [np.fromiter(self.values.values(), np.uint64, len(self.values))]
        for ts, vs in self.bulk:
            parts_t.append(ts)
            parts_v.append(vs)
        return np.concatenate(parts_t), np.concatenate(parts_v)


class WitnessError(Exception):
    pass


def run_generators(data: CircuitData, pw: PartialWitness) -> dict:
    """Run generators to a fixpoint; returns {root_target: value}.

    The firing ORDER depends only on which targets the PartialWitness seeds
    (fixed for a given circuit's prover), so the first run records it and
    subsequent runs REPLAY it linearly — no dependency rescanning (~40% of
    witness time on the leaf). A changed seed-set falls back to the fixpoint
    and records a fresh program."""
    if data.generators is None:
        raise WitnessError(
            "circuit data carries no witness generators (built from arrays): "
            "prove from a trace instead"
        )
    values: dict[int, int] = {}
    root = data.target_root

    def set_val(t, v):
        r = root[t]
        if r in values:
            if values[r] != v % P:
                raise WitnessError(f"conflicting witness value for target {t}")
            return
        values[r] = v % P

    def get_val(t):
        return values[root[t]]

    for t, v in pw.all_items():
        set_val(t, v)

    keyset = frozenset(root[t] for t, _ in pw.all_items())
    cached = data.__dict__.get("_witness_program")
    if cached is not None and cached[0] == keyset:
        for action in cached[1]:
            if action[0] == "gate_fill":
                for t, v in action[1](get_val):
                    set_val(t, v)
            else:
                fn, outputs = action[0], action[1]
                for t, v in zip(outputs, fn(get_val)):
                    set_val(t, v)
        return values

    def has_val(t):
        return root[t] in values

    program: list = []
    pending = list(data.generators)
    progress = True
    while pending and progress:
        progress = False
        still = []
        for deps, action in pending:
            if all(has_val(d) for d in deps):
                if action[0] == "gate_fill":
                    outs = action[1](get_val)
                    for t, v in outs:
                        set_val(t, v)
                else:
                    fn, outputs = action[0], action[1]
                    results = fn(get_val)
                    for t, v in zip(outputs, results):
                        set_val(t, v)
                program.append(action)
                progress = True
            else:
                still.append((deps, action))
        pending = still
    if pending:
        raise WitnessError(f"{len(pending)} generators never ran (missing inputs)")
    data.__dict__["_witness_program"] = (keyset, program)
    return values


def witness_scatter_tables(data: CircuitData):
    """Static (per-circuit) tables that scatter the ~|roots| distinct witness
    values into the (num_wires, n) trace in one indexed assignment.

    Returns (roots_order, slot_of_root, cell_flat_idx, cell_slot_idx)."""
    cached = data.__dict__.get("_scatter")
    if cached is not None:
        return cached
    root = data.target_root
    roots_order: list[int] = []
    slot_of_root: dict[int, int] = {}
    cell_flat = np.empty(len(data.cell_target), dtype=np.int32)
    cell_slot = np.empty(len(data.cell_target), dtype=np.int32)
    n = data.n
    for i, ((row, col), t) in enumerate(data.cell_target.items()):
        r = root[t]
        s = slot_of_root.get(r)
        if s is None:
            s = len(roots_order)
            slot_of_root[r] = s
            roots_order.append(r)
        cell_flat[i] = col * n + row
        cell_slot[i] = s
    tables = (roots_order, slot_of_root, cell_flat, cell_slot)
    data.__dict__["_scatter"] = tables
    return tables


def witness_root_values(data: CircuitData, pw: PartialWitness) -> np.ndarray:
    """(num_targets,) uint64 array of root-target values. Runs the circuit's
    witness tape in C (plonk/witness_tape.py) once its program is recorded
    and lowered; the first proof of a circuit (or of a new seed keyset), and
    a program that does not lower, take the Python replay
    (`run_generators`), which records it. Unset roots are zero."""
    arr = witness_tape.run_tape(data, pw)
    if arr is not None:
        return arr
    values = run_generators(data, pw)
    arr = np.zeros(data.num_targets, dtype=np.uint64)
    if values:
        ks = np.fromiter(values.keys(), dtype=np.int64, count=len(values))
        vs = np.fromiter(values.values(), dtype=np.uint64, count=len(values))
        arr[ks] = vs
    return arr


def _scatter_order(data: CircuitData) -> np.ndarray:
    ro = data.__dict__.get("_roots_order_arr")
    if ro is None:
        roots_order = witness_scatter_tables(data)[0]
        ro = np.asarray(roots_order, dtype=np.int64)
        data.__dict__["_roots_order_arr"] = ro
    return ro


def zk_draws(data: CircuitData, rng):
    """One proof's host-rng zero-knowledge randomness, drawn from `rng` in
    the JAX package's order (plonk/prover.py::prove_staged, prover_fused.py
    ::_flat_input): the blinding rows, `F.rand_felts((num_wires, n -
    rows_used), rng)`, then one salt seed an oracle, `rng.integers(0,
    2**63)`, for the wires, zs_pp and quotient in turn, each expanded by its
    own `default_rng(seed)` into (M, SALT_SIZE) felts (fri/oracle.py::
    commit). Returns (blinding rows, salts (3, M, SALT_SIZE)). The witness,
    the single proof, the batch and the stream all draw through here, a
    proof at a time, so one rng gives a batch's proofs in turn."""
    cfg = data.config
    blind = F.rand_felts((cfg.num_wires, data.n - data.num_rows_used), rng)
    m = data.n << cfg.rate_bits
    seeds = [int(rng.integers(0, 2**63)) for _ in range(3)]
    return blind, np.stack([F.rand_felts((m, SALT_SIZE), np.random.default_rng(s))
                            for s in seeds])


def witness_trace(data: CircuitData, pw: PartialWitness) -> tuple[np.ndarray, np.ndarray]:
    """Run generators to a fixpoint; returns the unblinded trace (num_wires,
    n), zero past `num_rows_used`, and the public inputs."""
    arr = witness_root_values(data, pw)
    trace = np.zeros((data.config.num_wires, data.n), dtype=np.uint64)
    _, _, cell_flat, cell_slot = witness_scatter_tables(data)
    trace.ravel()[cell_flat] = arr[_scatter_order(data)[cell_slot]]
    # public_input_targets are stored root-resolved by build()
    return trace, arr[np.asarray(data.public_input_targets, dtype=np.int64)]


def flat_values(data: CircuitData, pw: PartialWitness) -> tuple[np.ndarray, np.ndarray]:
    """The fused prover's witness payload (the JAX package's
    prover_fused.py::_flat_values): the distinct witness values in
    `witness_scatter_tables`' roots order, which the card scatters into the
    trace, and the public inputs."""
    arr = witness_root_values(data, pw)
    return arr[_scatter_order(data)], arr[np.asarray(data.public_input_targets, dtype=np.int64)]


def flat_input(data: CircuitData, pw: PartialWitness, rng) -> tuple[np.ndarray, np.ndarray,
                                                                     np.ndarray]:
    """A host-rng ZK proof's dense payload (the JAX package's
    prover_fused.py::_flat_input): the trace with its blinding rows and the
    three salts as (3, SALT_SIZE, M) LDE salt rows, `zk_draws`' draws from
    `rng` (the staged prover's, so the same bytes), and the public inputs."""
    trace, pis = witness_trace(data, pw)
    blind, salts = zk_draws(data, rng)
    trace[:, data.num_rows_used :] = blind
    return trace, np.ascontiguousarray(np.swapaxes(salts, 1, 2)), pis


def generate_witness(data: CircuitData, pw: PartialWitness, rng=None):
    """Run generators to a fixpoint; returns (trace (num_wires, n),
    public_inputs). A ZK circuit's rows past `num_rows_used` are blinding
    rows, the first of `zk_draws`'s draws from `rng` (its salts are drawn
    too, and dropped)."""
    trace, pis = witness_trace(data, pw)
    if data.config.zero_knowledge:
        trace[:, data.num_rows_used :] = zk_draws(data, rng or np.random.default_rng())[0]
    return trace, pis


def _root_values_batch(data: CircuitData, pws: list) -> np.ndarray:
    """`witness_root_values` for K PartialWitnesses of one circuit, (K,
    num_targets). A circuit's first proof records its generator program by
    the Python replay, so the first witness takes `witness_root_values`
    when the circuit has no tape yet; then every witness of the tape's seed
    keyset runs it in one C call (`witness_tape.run_tape_many`), and any
    other takes `witness_root_values` alone."""
    rows = witness_tape.run_tape_many(data, pws)
    if rows[0] is None:
        rows[0] = witness_root_values(data, pws[0])  # records the program
        rows[1:] = witness_tape.run_tape_many(data, pws[1:]) if len(pws) > 1 else []
    return np.stack([r if r is not None else witness_root_values(data, pw)
                     for r, pw in zip(rows, pws)])


def flat_values_batch(data: CircuitData, pws: list) -> tuple[np.ndarray, np.ndarray]:
    """`flat_values` for K PartialWitnesses (the fused batch's non-ZK
    payload): the (K, distinct values) rows, from one tape call
    (`_root_values_batch`), and the public inputs (K, num_pis)."""
    arr = _root_values_batch(data, pws)
    return arr[:, _scatter_order(data)], arr[:, np.asarray(data.public_input_targets,
                                                          dtype=np.int64)]


def flat_input_batch(data: CircuitData, pws: list, rng) -> tuple[np.ndarray, np.ndarray,
                                                                  np.ndarray]:
    """`flat_input` for K PartialWitnesses of a ZK circuit (the fused
    batch's host-rng payload): the traces with their blinding rows (K,
    num_wires, n), the salts as (K, 3, SALT_SIZE, M) LDE salt rows, and the
    public inputs, each proof in turn drawing from the one `rng`
    (`generate_witness_batch`)."""
    traces, pis, salts = generate_witness_batch(data, pws, rng)
    return traces, np.ascontiguousarray(np.swapaxes(salts, -1, -2)), pis


def generate_witness_batch(data: CircuitData, pws: list, rng=None):
    """`generate_witness` for K PartialWitnesses of one circuit: (traces (K,
    num_wires, n), public inputs (K, num_pis), salts). The witnesses come
    from one tape call (`_root_values_batch`). For a ZK circuit each proof
    in turn draws its blinding rows and its three salts from the one `rng`
    (`zk_draws`), as the JAX package's default batch does
    (prover_fused.py::_batch_flat_inputs), and salts is (K, 3, M,
    SALT_SIZE); for a non-ZK circuit it is None and nothing is drawn."""
    arr = _root_values_batch(data, pws)
    cfg = data.config
    traces = np.zeros((len(pws), cfg.num_wires * data.n), dtype=np.uint64)
    _, _, cell_flat, cell_slot = witness_scatter_tables(data)
    traces[:, cell_flat] = arr[:, _scatter_order(data)[cell_slot]]
    traces = traces.reshape(len(pws), cfg.num_wires, data.n)
    pis = arr[:, np.asarray(data.public_input_targets, dtype=np.int64)]
    if not cfg.zero_knowledge:
        return traces, pis, None
    rng = rng if rng is not None else np.random.default_rng()
    salts = []
    for trace in traces:
        blind, salt = zk_draws(data, rng)
        trace[:, data.num_rows_used :] = blind
        salts.append(salt)
    return traces, pis, np.stack(salts)
