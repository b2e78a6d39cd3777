"""The in-circuit PLONK/FRI verifier — the engine of recursive aggregation.

Expresses the ENTIRE host verifier (`plonk/verifier.py` + `fri/verifier.py`)
as circuit gadgets over an inner proof's targets:

  * the Fiat-Shamir schedule via the Poseidon2 challenger gadget;
  * the vanishing identity at zeta, evaluated by the SAME algebra-generic
    `vanishing.eval_constraints` that the host verifier walks (and that the
    prover's kernel A and its plain version follow) — here in a
    circuit-extension algebra (`CircuitExtCtx`): the gates' `eval(ctx)`
    call nothing but the ctx's methods;
  * FRI: Merkle openings against caps (inner VK cap baked as CONSTANTS —
    the anti-substitution property of the reference's
    `constant_verifier_data`, `aggregator/src/common/recursive.rs:91`),
    composition recompute at query points, in-group fold walks with
    constant-table domain coordinates, final-poly Horner, PoW range check;
  * query-index bits from canonical 64-bit decompositions (the `x + p`
    witness alias is excluded, mirroring the gadget-layer canonical-split
    policy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gf_np as F
from ..plonk.builder import CircuitBuilder
from ..plonk.serialization import VerifierCircuitData
from ..plonk.vanishing import eval_constraints, num_partial_products
from .challenger_gadget import RecursiveChallenger
from .ext_gadgets import (
    ExtTarget,
    ext_add,
    ext_constant,
    ext_exp_pow2,
    ext_exp_u,
    ext_from_base,
    ext_inverse,
    ext_mul,
    ext_mul_const,
    ext_reduce_with_powers,
    ext_scalar_mul,
    ext_select,
    ext_sub,
    ext_virtual,
    ext_zero,
)

P = 0xFFFFFFFF00000001


# ---------------------------------------------------------------------------
# circuit algebra adapters (reuse the shared constraint definitions)


class CircuitExtCtx:
    """Gate-eval context over ExtTargets (the recursive verifier at zeta)."""

    def __init__(self, b: CircuitBuilder, wires, constants, pi_hash):
        self.b = b
        self._wires = wires
        self._constants = constants
        self._pi = pi_hash

    def wire(self, i):
        return self._wires[i]

    def constant(self, k):
        return self._constants[k]

    def pi_hash(self, i):
        return self._pi[i]

    def add(self, a, c):
        return ext_add(self.b, a, c)

    def sub(self, a, c):
        return ext_sub(self.b, a, c)

    def mul(self, a, c):
        return ext_mul(self.b, a, c)

    def add_const(self, a, c: int):
        return ext_add(self.b, a, ext_constant(self.b, c % P))

    def mul_const(self, a, c: int):
        return ext_mul_const(self.b, a, c % P)

    def exp7(self, a):
        a2 = self.mul(a, a)
        a4 = self.mul(a2, a2)
        return self.mul(self.mul(a4, a2), a)

    def felt(self, c: int):
        return ext_constant(self.b, c % P)


class CircuitExtAlg:
    def __init__(self, b: CircuitBuilder):
        self.b = b

    def add(self, a, c):
        return ext_add(self.b, a, c)

    def sub(self, a, c):
        return ext_sub(self.b, a, c)

    def mul(self, a, c):
        return ext_mul(self.b, a, c)

    def one(self):
        return ext_constant(self.b, 1)


# ---------------------------------------------------------------------------
# proof targets


@dataclass
class FriQueryStepTargets:
    leaf_values: list  # [2^a] ExtTarget
    siblings: list  # [levels][4]


@dataclass
class FriQueryRoundTargets:
    initial_rows: list  # per oracle: [C_total] targets
    initial_siblings: list  # per oracle: [levels][4]
    steps: list


@dataclass
class ProofTargets:
    public_inputs: list
    wires_cap: list  # [2^ch][4]
    zs_pp_cap: list
    quotient_cap: list
    # openings (ExtTargets)
    constants: list
    selectors: list
    sigmas: list
    wires: list
    zs: list
    zs_next: list
    pps: list
    quotient: list
    # fri
    commit_caps: list  # [layers][2^ch][4]
    final_poly: list  # [final_len] ExtTarget
    pow_witness: int
    query_rounds: list


def _cap_targets(b: CircuitBuilder, height: int) -> list:
    return [b.add_virtual_hash() for _ in range(1 << height)]


def _oracle_shapes(common: VerifierCircuitData):
    """(num_polys, salted_cols) per oracle 0..3 and tree levels."""
    cfg = common.config
    nz = cfg.num_challenges
    npp = num_partial_products(cfg.num_routed_wires, cfg.max_quotient_degree_factor)
    salt = 4 if cfg.zero_knowledge else 0
    polys = [
        common.num_preprocessed,
        cfg.num_wires,
        nz + nz * npp,
        cfg.num_challenges * cfg.max_quotient_degree_factor,
    ]
    salts = [0, salt, salt, salt]
    return polys, salts


def add_virtual_proof_with_pis(b: CircuitBuilder, common: VerifierCircuitData) -> ProofTargets:
    cfg = common.config
    ch = cfg.fri_config.cap_height
    lde_bits = common.degree_bits + cfg.rate_bits
    schedule = cfg.fri_config.reduction_strategy.schedule(common.degree_bits)
    polys, salts = _oracle_shapes(common)
    nz = cfg.num_challenges
    npp = num_partial_products(cfg.num_routed_wires, cfg.max_quotient_degree_factor)

    oracle_levels = lde_bits - ch
    pt = ProofTargets(
        public_inputs=b.add_virtual_targets(common.num_public_inputs),
        wires_cap=_cap_targets(b, ch),
        zs_pp_cap=_cap_targets(b, ch),
        quotient_cap=_cap_targets(b, ch),
        constants=[ext_virtual(b) for _ in range(common.num_const_cols)],
        selectors=[ext_virtual(b) for _ in range(common.num_selectors)],
        sigmas=[ext_virtual(b) for _ in range(cfg.num_routed_wires)],
        wires=[ext_virtual(b) for _ in range(cfg.num_wires)],
        zs=[ext_virtual(b) for _ in range(nz)],
        zs_next=[ext_virtual(b) for _ in range(nz)],
        pps=[ext_virtual(b) for _ in range(nz * npp)],
        quotient=[ext_virtual(b) for _ in range(nz * cfg.max_quotient_degree_factor)],
        commit_caps=[],
        final_poly=[],
        pow_witness=b.add_virtual_target(),
        query_rounds=[],
    )
    log_m = lde_bits
    for a_bits in schedule:
        cap_h = min(ch, log_m - a_bits)
        pt.commit_caps.append(_cap_targets(b, cap_h))
        log_m -= a_bits
    fpb = cfg.fri_config.reduction_strategy.final_poly_bits
    final_len = min(1 << fpb, 1 << (common.degree_bits - sum(schedule)))
    pt.final_poly = [ext_virtual(b) for _ in range(final_len)]

    for _ in range(cfg.fri_config.num_query_rounds):
        rows, sibs = [], []
        for oi in range(4):
            rows.append(b.add_virtual_targets(polys[oi] + salts[oi]))
            sibs.append([b.add_virtual_hash() for _ in range(oracle_levels)])
        steps = []
        log_m = lde_bits
        for li, a_bits in enumerate(schedule):
            cap_h = min(ch, log_m - a_bits)
            log_mp = log_m - a_bits
            steps.append(
                FriQueryStepTargets(
                    leaf_values=[ext_virtual(b) for _ in range(1 << a_bits)],
                    siblings=[b.add_virtual_hash() for _ in range(log_mp - cap_h)],
                )
            )
            log_m = log_mp
        pt.query_rounds.append(
            FriQueryRoundTargets(initial_rows=rows, initial_siblings=sibs, steps=steps)
        )
    return pt


# ---------------------------------------------------------------------------
# sub-gadgets


def _two_to_one_t(b: CircuitBuilder, left: list, right: list) -> list:
    state = list(left) + list(right) + [b.zero()] * 4
    return b.permute(state)[:4]


def _hash_or_noop_t(b: CircuitBuilder, row: list) -> list:
    if len(row) <= 4:
        return list(row) + [b.zero()] * (4 - len(row))
    return b.hash_n_to_hash_no_pad(row)


def _select_digest(b, flag, x: list, y: list) -> list:
    return [b.select(flag, x[i], y[i]) for i in range(4)]


def _mux_digest(b: CircuitBuilder, bits: list, entries: list) -> list:
    """Select entries[sum bits_i 2^i] by folding pairs per bit."""
    cur = entries
    for bit in bits:
        cur = [_select_digest(b, bit, cur[2 * i + 1], cur[2 * i]) for i in range(len(cur) // 2)]
    assert len(cur) == 1
    return cur[0]


def _merkle_check(b, row, index_bits, siblings, cap_entries, cap_is_const):
    """Verify a leaf row against a cap. `cap_entries`: list of 4-lists — either
    constant ints (VK cap) or targets."""
    cur = _hash_or_noop_t(b, row)
    for level, sib in enumerate(siblings):
        bit = index_bits[level]
        left = _select_digest(b, bit, sib, cur)
        right = _select_digest(b, bit, cur, sib)
        cur = _two_to_one_t(b, left, right)
    cap_bits = index_bits[len(siblings) :]
    if cap_is_const:
        entries = [[b.constant(int(v)) for v in e] for e in cap_entries]
    else:
        entries = cap_entries
    chosen = _mux_digest(b, cap_bits, entries)
    for i in range(4):
        b.connect(cur[i], chosen[i])


def _canonical_bits64(b: CircuitBuilder, x: int) -> list:
    """64 little-endian bits of the CANONICAL representation of x (the x + p
    alias is excluded via the wraparound-region check). Uses the two-row
    32-bit split so it fits narrow routed-wire configs."""
    lo, hi, bits = b.split_64(x)
    hi_is_max = b.is_equal(hi, b.constant(0xFFFFFFFF))
    lo_nonzero = b.not_(b.is_equal(lo, b.zero()))
    b.assert_zero(b.and_(hi_is_max, lo_nonzero))
    return bits


def _recombine(b: CircuitBuilder, bits: list) -> int:
    acc = bits[-1]
    for bit in reversed(bits[:-1]):
        acc = b._arith_op(2, 1, acc, b.one(), bit)
    return acc


def _pow_from_bits(b: CircuitBuilder, bits: list, base: int, invert=False) -> int:
    """Product over i of select(bit_i, base^(2^i), 1) — base a Python int."""
    acc = None
    e = base if not invert else pow(base, P - 2, P)
    cur = e
    for bit in bits:
        term = b.select(bit, b.constant(cur), b.one())
        acc = term if acc is None else b.mul(acc, term)
        cur = cur * cur % P
    return acc if acc is not None else b.one()


# ---------------------------------------------------------------------------
# the main gadget


def verify_proof_circuit(
    b: CircuitBuilder, pt: ProofTargets, common: VerifierCircuitData
) -> None:
    """Constrain `pt` to be a VALID proof for the inner circuit `common`,
    with the inner verifier key (cap + digest) baked as constants."""
    cfg = common.config
    fri = cfg.fri_config
    nz = cfg.num_challenges
    qdf = cfg.max_quotient_degree_factor
    npp = num_partial_products(cfg.num_routed_wires, qdf)
    degree_bits = common.degree_bits
    lde_bits = degree_bits + fri.rate_bits
    n = 1 << degree_bits
    schedule = fri.reduction_strategy.schedule(degree_bits)
    polys_counts, salts = _oracle_shapes(common)

    # --- Fiat-Shamir schedule ------------------------------------------------
    chal = RecursiveChallenger(b)
    for v in common.circuit_digest:
        chal.observe(b.constant(int(v)))
    pi_hash = b.hash_n_to_hash_no_pad(list(pt.public_inputs)) if pt.public_inputs else [b.zero()] * 4
    chal.observe_many(pi_hash)
    chal.observe_cap_targets(pt.wires_cap)
    betas = chal.challenge_many(nz)
    gammas = chal.challenge_many(nz)
    chal.observe_cap_targets(pt.zs_pp_cap)
    alphas = chal.challenge_many(nz)
    chal.observe_cap_targets(pt.quotient_cap)
    zeta = chal.challenge_ext()

    # --- vanishing identity at zeta -----------------------------------------
    ctx = CircuitExtCtx(
        b, pt.wires, pt.constants, [ext_from_base(b, pi_hash[i]) for i in range(4)]
    )
    alg = CircuitExtAlg(b)
    from ..plonk.builder import coset_shifts

    ks = [int(k) for k in coset_shifts(cfg.num_routed_wires)]
    id_coords = [ext_mul_const(b, zeta, k) for k in ks]
    zeta_n = ext_exp_pow2(b, zeta, degree_bits)
    one_e = ext_constant(b, 1)
    zh = ext_sub(b, zeta_n, one_e)
    l1_den = ext_mul_const(b, ext_sub(b, zeta, one_e), n)
    l1 = ext_mul(b, zh, ext_inverse(b, l1_den))
    pps_nested = [[pt.pps[c * npp + j] for j in range(npp)] for c in range(nz)]
    constraints = eval_constraints(
        ctx,
        common,
        pt.wires,
        pt.constants,
        pt.selectors,
        pt.sigmas,
        pt.zs,
        pt.zs_next,
        pps_nested,
        id_coords,
        l1,
        [ext_from_base(b, t) for t in betas],
        [ext_from_base(b, t) for t in gammas],
        alg,
    )
    for c in range(nz):
        alpha_e = ext_from_base(b, alphas[c])
        acc = ext_reduce_with_powers(b, alpha_e, list(constraints), ext=True)
        t_val = ext_reduce_with_powers(
            b, zeta_n, [pt.quotient[c * qdf + j] for j in range(qdf)], ext=True
        )
        lhs = ext_mul(b, zh, t_val)
        b.connect(acc[0], lhs[0])
        b.connect(acc[1], lhs[1])

    # --- FRI -----------------------------------------------------------------
    # observe openings in the canonical order, then derive fri alpha
    g_n = int(F.primitive_root_of_unity(degree_bits))
    zeta_next = ext_scalar_mul(b, zeta, b.constant(g_n))
    batch1 = (
        list(pt.constants) + list(pt.selectors) + list(pt.sigmas) + list(pt.wires)
        + list(pt.zs) + list(pt.pps) + list(pt.quotient)
    )
    batch2 = list(pt.zs_next)
    for e in batch1 + batch2:
        chal.observe(e[0])
        chal.observe(e[1])
    fri_alpha = chal.challenge_ext()

    fri_betas = []
    log_m = lde_bits
    for a_bits, cap in zip(schedule, pt.commit_caps):
        chal.observe_cap_targets(cap)
        fri_betas.append(chal.challenge_ext())
        log_m -= a_bits
    for coeff in pt.final_poly:
        chal.observe(coeff[0])
        chal.observe(coeff[1])
    # PoW: response must have >= proof_of_work_bits leading zeros
    chal.observe(pt.pow_witness)
    pow_response = chal.challenge()
    b.range_check(pow_response, 64 - fri.proof_of_work_bits)

    # reduced openings sum per batch (constant across queries). batch2's
    # terms carry continued powers alpha^(len(batch1)+k) in the prover's
    # combine; factor that as alpha^L * (unshifted sum) so both the per-proof
    # and per-query reductions are plain Horner runs (ReducingGate rows).
    cb1 = ext_reduce_with_powers(b, fri_alpha, batch1, ext=True)
    u2cb = ext_reduce_with_powers(b, fri_alpha, batch2, ext=True)
    alpha_l = ext_exp_u(b, fri_alpha, len(batch1))

    g = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    w0 = int(F.primitive_root_of_unity(lde_bits))
    oracle_caps = [None, pt.wires_cap, pt.zs_pp_cap, pt.quotient_cap]

    for qr in pt.query_rounds:
        qidx = chal.challenge()
        bits = _canonical_bits64(b, qidx)
        idx_bits = bits[:lde_bits]

        # initial merkle checks
        for oi in range(4):
            if oi == 0:
                cap_entries = [
                    [int(v) for v in common.constants_cap[k]]
                    for k in range(common.constants_cap.shape[0])
                ]
                _merkle_check(b, qr.initial_rows[oi], idx_bits, qr.initial_siblings[oi], cap_entries, True)
            else:
                _merkle_check(b, qr.initial_rows[oi], idx_bits, qr.initial_siblings[oi], oracle_caps[oi], False)

        # x and 1/x at the query point
        w_pow = _pow_from_bits(b, idx_bits, w0)
        x_q = b.mul_const(g, w_pow)
        w_pow_inv = _pow_from_bits(b, idx_bits, w0, invert=True)
        x_q_inv = b.mul_const(pow(g, P - 2, P), w_pow_inv)

        # recompute Q(x_q): batch1 at zeta, batch2 (zs) at g*zeta
        flat_rows = (
            [qr.initial_rows[0][k] for k in range(polys_counts[0])]
            + [qr.initial_rows[1][k] for k in range(polys_counts[1])]
            + [qr.initial_rows[2][k] for k in range(polys_counts[2])]
            + [qr.initial_rows[3][k] for k in range(polys_counts[3])]
        )
        s1 = ext_reduce_with_powers(b, fri_alpha, flat_rows, ext=False)
        zs_rows = [qr.initial_rows[2][k] for k in range(nz)]
        u2q = ext_reduce_with_powers(b, fri_alpha, zs_rows, ext=False)
        x_e = ExtTarget(x_q, b.zero())
        inv1 = ext_inverse(b, ext_sub(b, x_e, zeta))
        inv2 = ext_inverse(b, ext_sub(b, x_e, zeta_next))
        qval = ext_add(
            b,
            ext_mul(b, ext_sub(b, s1, cb1), inv1),
            ext_mul(b, alpha_l, ext_mul(b, ext_sub(b, u2q, u2cb), inv2)),
        )

        # fold walk
        cur_val = qval
        cur_bits = idx_bits
        log_m = lde_bits
        shift_pow = 0
        x_inv = x_q_inv
        for li, a_bits in enumerate(schedule):
            step = qr.steps[li]
            log_mp = log_m - a_bits
            j_bits = cur_bits[log_mp:log_m]
            next_bits = cur_bits[:log_mp]
            # selected leaf element must equal the running value
            folded_sel = list(step.leaf_values)
            for bit in j_bits:
                folded_sel = [
                    ext_select(b, bit, folded_sel[2 * i + 1], folded_sel[2 * i])
                    for i in range(len(folded_sel) // 2)
                ]
            chosen = folded_sel[0]
            b.connect(chosen[0], cur_val[0])
            b.connect(chosen[1], cur_val[1])
            # merkle check of the step leaf against the layer cap
            flat_leaf = [t for e in step.leaf_values for t in (e[0], e[1])]
            _merkle_check(b, flat_leaf, next_bits, step.siblings, pt.commit_caps[li], False)
            # in-group fold: points p_k^{-1} = x_next_inv * gamma^{-k}
            w_cur = pow(w0, 1 << shift_pow, P)
            x_next_inv = b.mul_const(
                pow(pow(g, 1 << shift_pow, P), P - 2, P),
                _pow_from_bits(b, next_bits, pow(w_cur, 1, P), invert=True),
            )
            gamma = pow(w_cur, 1 << log_mp, P)
            vals = list(step.leaf_values)
            pt_invs = [
                b.mul_const(pow(pow(gamma, k, P), P - 2, P), x_next_inv)
                for k in range(len(vals))
            ]
            beta_t = fri_betas[li]
            inv2c = pow(2, P - 2, P)
            while len(vals) > 1:
                half = len(vals) // 2
                nv = []
                for k in range(half):
                    vs = ext_add(b, vals[k], vals[k + half])
                    vd = ext_sub(b, vals[k], vals[k + half])
                    t = ext_scalar_mul(b, ext_mul(b, vd, beta_t), pt_invs[k])
                    nv.append(ext_mul_const(b, ext_add(b, vs, t), inv2c))
                vals = nv
                pt_invs = [b.mul(p_, p_) for p_ in pt_invs[:half]]
                beta_t = ext_mul(b, beta_t, beta_t)
            cur_val = vals[0]
            cur_bits = next_bits
            log_m = log_mp
            shift_pow += a_bits
            x_inv = x_next_inv  # retained for clarity

        # final polynomial evaluation at the folded point
        x_final = b.mul_const(
            pow(g, 1 << shift_pow, P),
            _pow_from_bits(b, cur_bits, pow(w0, 1 << shift_pow, P)),
        )
        acc = ext_reduce_with_powers(
            b, ExtTarget(x_final, b.zero()), list(pt.final_poly), ext=True
        )
        b.connect(acc[0], cur_val[0])
        b.connect(acc[1], cur_val[1])


def fill_proof_targets(pw, pt: ProofTargets, proof) -> None:
    """Witness the proof targets from a host Proof object."""
    pw.set_many(pt.public_inputs, proof.public_inputs)
    for cap_t, cap_v in [
        (pt.wires_cap, proof.wires_cap),
        (pt.zs_pp_cap, proof.zs_pp_cap),
        (pt.quotient_cap, proof.quotient_cap),
    ]:
        for e_t, e_v in zip(cap_t, np.asarray(cap_v, dtype=np.uint64)):
            pw.set_many(e_t, e_v)
    o = proof.openings
    for group_t, group_v in [
        (pt.constants, o.constants),
        (pt.selectors, o.selectors),
        (pt.sigmas, o.sigmas),
        (pt.wires, o.wires),
        (pt.zs, o.zs),
        (pt.zs_next, o.zs_next),
        (pt.pps, o.pps),
        (pt.quotient, o.quotient),
    ]:
        for e_t, e_v in zip(group_t, np.asarray(group_v, dtype=np.uint64)):
            pw.set_target(e_t[0], int(e_v[0]))
            pw.set_target(e_t[1], int(e_v[1]))
    fp = proof.fri_proof
    for cap_t, cap_v in zip(pt.commit_caps, fp.commit_caps):
        for e_t, e_v in zip(cap_t, np.asarray(cap_v, dtype=np.uint64)):
            pw.set_many(e_t, e_v)
    for c_t, c_v in zip(pt.final_poly, np.asarray(fp.final_poly, dtype=np.uint64)):
        pw.set_target(c_t[0], int(c_v[0]))
        pw.set_target(c_t[1], int(c_v[1]))
    pw.set_target(pt.pow_witness, int(fp.pow_witness))
    for qr_t, qr_v in zip(pt.query_rounds, fp.query_rounds):
        for oi in range(4):
            pw.set_many(qr_t.initial_rows[oi], qr_v.initial_rows[oi])
            for s_t, s_v in zip(qr_t.initial_siblings[oi], np.asarray(qr_v.initial_siblings[oi], dtype=np.uint64)):
                pw.set_many(s_t, s_v)
        for st_t, st_v in zip(qr_t.steps, qr_v.steps):
            leaf = np.asarray(st_v.leaf_values, dtype=np.uint64)
            for e_t, e_v in zip(st_t.leaf_values, leaf):
                pw.set_target(e_t[0], int(e_v[0]))
                pw.set_target(e_t[1], int(e_v[1]))
            for s_t, s_v in zip(st_t.siblings, np.asarray(st_v.siblings, dtype=np.uint64)):
                pw.set_many(s_t, s_v)
