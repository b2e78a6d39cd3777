"""Lower a circuit's recorded witness program to the C VM of native/.

`run_generators` (plonk/builder.py) records the generators' firing order
the first time a circuit proves; this module compiles that linear program
into an int32 opcode stream that `native/witness_tape.c::wt_run` executes:
one C call instead of a Python closure call a generator.

A program with a generator that has no tape descriptor (a custom fn) or a
gate fill the VM does not know makes `compile_tape` return None, and
`witness_root_values` replays that circuit in Python: the same values,
slower.
"""

from __future__ import annotations

import numpy as np

from .. import native as nat
from ..field.gf_np import P
from ..hash.poseidon2 import ROUNDS_P
from .gates import BaseSumGate, Poseidon2Gate

OP_CONST = 1
OP_FMADD = 2
OP_INV = 3
OP_INVZ = 4
OP_SPLIT64 = 5
OP_EXTINV = 6
OP_POSEIDON = 7
OP_SPLITBITS = 8

_ERRORS = {1: "value conflict", 2: "unknown opcode", 3: "range check failed"}


class Tape:
    __slots__ = ("code", "consts", "keyset")

    def __init__(self, code, consts, keyset):
        self.code = code
        self.consts = consts
        self.keyset = keyset


def compile_tape(data) -> Tape | None:
    """Lower data's recorded witness program; None if not lowerable."""
    rec = data.__dict__.get("_witness_program")
    if rec is None:
        return None
    keyset, program = rec
    root = data.target_root
    code: list[int] = []
    consts: list[int] = []

    for action in program:
        if action[0] == "gate_fill":
            if len(action) < 3 or action[2] is None:
                return None
            row, cell_targets = action[2]
            gate = data.row_gate[row]
            if isinstance(gate, Poseidon2Gate):
                g = gate
                code.append(OP_POSEIDON)
                code.extend(root[cell_targets[g.W_IN + i]] for i in range(12))
                for r in range(4):
                    code.extend(
                        root[cell_targets[g.W_EXT_A + 12 * r + i]] for i in range(12)
                    )
                code.extend(root[cell_targets[g.W_INT + k]] for k in range(ROUNDS_P))
                for r in range(3):
                    code.extend(
                        root[cell_targets[g.W_EXT_B + 12 * r + i]] for i in range(12)
                    )
                code.extend(root[cell_targets[g.W_OUT + i]] for i in range(12))
            elif isinstance(gate, BaseSumGate):
                nb = gate.num_bits
                code.extend([OP_SPLITBITS, root[cell_targets[0]], nb])
                code.extend(root[cell_targets[1 + i]] for i in range(nb))
            else:
                return None  # a gate fill the VM does not know: Python replay
            continue

        desc = action[2] if len(action) > 2 else None
        if desc is None:
            return None
        outs = action[1]
        kind = desc[0]
        if kind == "const":
            kidx = len(consts)
            consts.append(int(desc[1]) % P)
            code.extend([OP_CONST, root[outs[0]], kidx])
        elif kind == "fmadd":
            kidx = len(consts)
            consts.extend([int(desc[1]) % P, int(desc[2]) % P])
            code.extend(
                [OP_FMADD, root[outs[0]], root[desc[3]], root[desc[4]],
                 root[desc[5]], kidx]
            )
        elif kind == "inv":
            code.extend([OP_INV, root[outs[0]], root[desc[1]]])
        elif kind == "invz":
            code.extend([OP_INVZ, root[outs[0]], root[desc[1]]])
        elif kind == "split64":
            code.extend([OP_SPLIT64, root[outs[0]], root[outs[1]], root[desc[1]]])
        elif kind == "extinv":
            code.extend(
                [OP_EXTINV, root[outs[0]], root[outs[1]], root[desc[1]],
                 root[desc[2]]]
            )
        else:
            return None
    return Tape(
        code=np.asarray(code, dtype=np.int32),
        consts=np.ascontiguousarray(consts, dtype=np.uint64),
        keyset=keyset,
    )


def _keys(data, pw):
    """A PartialWitness's seeds by root target: (roots, values, keyset)."""
    root_arr = data.__dict__.get("_root_arr")
    if root_arr is None:
        root_arr = np.asarray(data.target_root, dtype=np.int64)
        data.__dict__["_root_arr"] = root_arr
    ts_all, vs_all = pw.seed_arrays()
    rs = root_arr[ts_all]
    return rs, vs_all, frozenset(np.unique(rs).tolist())


def _seed(data, rs, vs_all):
    """The tape's value and written arrays from the seeds, with the dict
    path's conflict semantics: duplicate assignments to one root are fine
    iff the values agree."""
    from .builder import WitnessError

    order = np.argsort(rs, kind="stable")
    rs_s, vs_s = rs[order], vs_all[order]
    dup = rs_s[1:] == rs_s[:-1]
    clash = dup & (vs_s[1:] != vs_s[:-1])
    if np.any(clash):
        raise WitnessError(f"conflicting witness value for target root {int(rs_s[1:][clash][0])}")
    vals = np.zeros(data.num_targets, dtype=np.uint64)
    written = np.zeros(data.num_targets, dtype=np.uint8)
    vals[rs] = vs_all
    written[rs] = 1
    return vals, written


def _tape(data, keyset) -> Tape | None:
    """The circuit's lowered tape for seed keyset `keyset`, or None: no
    recorded program, a program recorded for another keyset, or one that
    does not lower."""
    cached = data.__dict__.get("_witness_tape")
    if cached is None or cached[0] != keyset:
        rec = data.__dict__.get("_witness_program")
        if rec is None or rec[0] != keyset:
            return None  # not recorded yet: do NOT cache the None
        tape = compile_tape(data)
        # cache the None only for a recorded program that does not lower
        data.__dict__["_witness_tape"] = (keyset, tape)
        cached = (keyset, tape)
    return cached[1]


def _raise_rc(rc: int) -> None:
    from .builder import WitnessError

    raise WitnessError(
        f"witness tape: {_ERRORS.get(rc >> 32, rc >> 32)} at record {rc & 0xFFFFFFFF}"
    )


def run_tape(data, pw) -> np.ndarray | None:
    """Execute the circuit's tape for a PartialWitness. Returns the
    (num_targets,) uint64 root-value array, or None when there is no tape:
    no recorded program, a different seed keyset, or a program that does
    not lower. Raises WitnessError on value conflicts and failed range
    checks."""
    rs, vs_all, keyset = _keys(data, pw)
    tape = _tape(data, keyset)
    if tape is None:
        return None
    vals, written = _seed(data, rs, vs_all)
    rc = nat.witness_tape_run(tape.code, tape.consts, vals, written, ROUNDS_P)
    if rc:
        _raise_rc(rc)
    return vals


def run_tape_many(data, pws) -> list:
    """`run_tape` for a batch of PartialWitnesses: the ones with the first
    one's seed keyset run the circuit's tape for it in one C call over all
    their value arrays (`native.witness_tape_run_many`, spread over the
    host's cores). Returns a list of (num_targets,) arrays, None for a
    witness with no tape run (no tape for the first one's keyset, or
    another keyset). Raises WitnessError for the first witness that fails."""
    keys = [_keys(data, pw) for pw in pws]
    out = [None] * len(pws)
    tape = _tape(data, keys[0][2])
    if tape is None:
        return out
    live = [i for i, (_, _, keyset) in enumerate(keys) if keyset == tape.keyset]
    seeded = [_seed(data, *keys[i][:2]) for i in live]
    vals = np.stack([v for v, _ in seeded])
    written = np.stack([w for _, w in seeded])
    rcs = nat.witness_tape_run_many(tape.code, tape.consts, vals, written, ROUNDS_P)
    for rc in rcs:
        if rc:
            _raise_rc(int(rc))
    for row, i in enumerate(live):
        out[i] = vals[row]
    return out
