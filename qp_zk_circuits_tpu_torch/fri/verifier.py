"""FRI verifier (host, numpy/int arithmetic).

The light counterpart of `fri/prover.py` — this is what the standalone
verifier crate does in the reference (no-std `qp-plonky2-verifier`, runs
on-chain; reference `wormhole/verifier/src/lib.rs:39-47`). It re-drives the
Fiat-Shamir transcript, checks the PoW grind, and for every query round:
verifies all Merkle openings, recomputes the composition value Q(x), walks
the fold layers, and checks the final polynomial evaluation.

The query rounds run in one call into the C library
(`native/fri_verify.c::fri_verify_queries`, flattened by `_native_flatten`);
a rejection there names its check and query round. A layout the C code does
not take (more than 8 oracles, 16 layers or arity 2^6, more than 1024
opening terms, a malformed shape) goes to `_query_rounds_pure`, the
Python-int loop, which also is the tests' oracle. Nothing here touches a
device.
"""

from __future__ import annotations

import numpy as np

from .. import native as nat
from ..field import extension as ext
from ..field import gf_np as F
from ..plonk import transcript as ts
from .config import FriConfig
from .oracle import verify_row
from .prover import FriInstance, FriProof

P = 0xFFFFFFFF00000001


class FriVerificationError(Exception):
    pass


def _fail(msg: str):
    raise FriVerificationError(msg)


def _native_flatten(
    oracle_caps, instance, openings, proof, config, lde_bits, schedule
):
    """Try to flatten proof + instance into the contiguous arrays the compiled
    query verifier consumes. Returns the kwargs dict, or None when any shape
    deviates from the canonical layout (the pure-Python loop then handles it
    and reports the precise failure)."""
    cap_h = config.cap_height
    n_oracles = len(oracle_caps)
    if n_oracles > 8 or len(schedule) > 16 or max(schedule, default=0) > 6:
        return None
    caps = []
    for c in oracle_caps:
        c = np.asarray(c, dtype=np.uint64)
        if c.shape != (1 << cap_h, 4):
            return None
        caps.append(c.reshape(-1))
    rounds = proof.query_rounds
    if not rounds or len(rounds[0].initial_rows) != n_oracles:
        return None
    widths = [np.asarray(r).shape for r in rounds[0].initial_rows]
    if any(len(s) != 1 for s in widths):
        return None
    widths = [s[0] for s in widths]
    init_sib = lde_bits - cap_h
    # per-layer geometry
    step_geom = []
    log_m = lde_bits
    for a_bits in schedule:
        mp = log_m - a_bits
        cl = min(cap_h, mp)
        step_geom.append((1 << a_bits, mp - cl, cl))
        log_m = mp
    ccaps = []
    for (arity, sib_l, cl), cap in zip(step_geom, proof.commit_caps):
        cap = np.asarray(cap, dtype=np.uint64)
        if cap.shape != (1 << cl, 4):
            return None
        ccaps.append(cap.reshape(-1))
    total_terms = instance.num_terms()
    if total_terms > 1024:
        return None
    all_rows, all_isibs, all_leaves, all_ssibs = [], [], [], []
    for rd in rounds:
        if len(rd.initial_rows) != n_oracles or len(rd.steps) != len(schedule):
            return None
        for oi, (row, sibs) in enumerate(zip(rd.initial_rows, rd.initial_siblings)):
            row = np.asarray(row, dtype=np.uint64)
            sibs = np.asarray(sibs, dtype=np.uint64)
            if row.shape != (widths[oi],) or sibs.shape != (init_sib, 4):
                return None
            all_rows.append(row)
            all_isibs.append(sibs.reshape(-1))
        for (arity, sib_l, _), st in zip(step_geom, rd.steps):
            leaf = np.asarray(st.leaf_values, dtype=np.uint64)
            sibs = np.asarray(st.siblings, dtype=np.uint64)
            if leaf.shape != (arity, 2) or sibs.shape != (sib_l, 4):
                return None
            all_leaves.append(leaf.reshape(-1))
            all_ssibs.append(sibs.reshape(-1))
    bsizes, poly_oi, poly_pj, bpoints = [], [], [], []
    for b in instance.batches:
        bsizes.append(len(b.polys))
        bpoints.extend((int(b.point[0]), int(b.point[1])))
        for oi, pj in b.polys:
            if pj >= widths[oi]:
                return None
            poly_oi.append(oi)
            poly_pj.append(pj)
    opens = np.concatenate(
        [np.asarray(o, dtype=np.uint64).reshape(-1, 2) for o in openings]
    )
    if opens.shape[0] != total_terms:
        return None
    cat = lambda parts: (  # noqa: E731
        np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint64)
    )
    return dict(
        lde_bits=lde_bits,
        schedule=np.asarray(schedule, dtype=np.uint64),
        oracle_widths=np.asarray(widths, dtype=np.uint64),
        oracle_caps=cat(caps),
        cap_height=cap_h,
        batch_sizes=np.asarray(bsizes, dtype=np.uint64),
        batch_points=np.asarray(bpoints, dtype=np.uint64),
        poly_oi=np.asarray(poly_oi, dtype=np.uint64),
        poly_pj=np.asarray(poly_pj, dtype=np.uint64),
        openings=opens.reshape(-1),
        commit_caps=cat(ccaps),
        initial_rows=cat(all_rows),
        initial_sibs=cat(all_isibs),
        step_leaves=cat(all_leaves),
        step_sibs=cat(all_ssibs),
    )


_NATIVE_ERRORS = {
    1: "initial Merkle proof failed (oracle {sub})",
    2: "fold consistency failed at layer {sub}",
    3: "commit-phase Merkle proof failed at layer {sub}",
    4: "final polynomial check failed",
}


_NATIVE_ERRORS = {
    1: "initial Merkle proof failed (oracle {sub})",
    2: "fold consistency failed at layer {sub}",
    3: "commit-phase Merkle proof failed at layer {sub}",
    4: "final polynomial check failed",
}


def fri_verify(
    oracle_caps: list[np.ndarray],
    oracle_num_polys: list[int],
    instance: FriInstance,
    openings: list[np.ndarray],
    proof: FriProof,
    challenger: ts.Challenger,
    config: FriConfig,
    degree_bits: int,
) -> None:
    """Raises FriVerificationError on any failure. The challenger must already
    have observed everything the prover observed before fri_prove."""
    alpha = challenger.challenge_ext()
    lde_bits = degree_bits + config.rate_bits
    m0 = 1 << lde_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    if len(proof.commit_caps) != len(schedule):
        _fail("wrong number of commit-phase caps")

    betas = []
    log_m = lde_bits
    for a_bits, cap in zip(schedule, proof.commit_caps):
        cap_h = min(config.cap_height, log_m - a_bits)
        if np.asarray(cap).shape != (1 << cap_h, 4):
            _fail("malformed commit cap")
        challenger.observe_cap(cap)
        betas.append(challenger.challenge_ext())
        log_m -= a_bits

    fpb = config.reduction_strategy.final_poly_bits
    expected_final = min(1 << fpb, 1 << (degree_bits - sum(schedule)))
    if proof.final_poly.shape[0] != expected_final:
        _fail("final polynomial has the wrong length")
    challenger.observe_many(proof.final_poly)

    if not ts.check_pow(challenger, proof.pow_witness, config.proof_of_work_bits):
        _fail("proof-of-work check failed")

    indices = [challenger.challenge_index(m0) for _ in range(config.num_query_rounds)]
    if len(proof.query_rounds) != len(indices):
        _fail("wrong number of query rounds")
    _query_rounds(oracle_caps, oracle_num_polys, instance, openings, proof, config,
                  degree_bits, alpha, betas, indices)


def _query_rounds(oracle_caps, oracle_num_polys, instance, openings, proof, config,
                  degree_bits, alpha, betas, indices) -> None:
    """Every query round in one call into the C library; a layout it does
    not take, or its capacity code (9), goes to the Python loop."""
    lde_bits = degree_bits + config.rate_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    flat = _native_flatten(oracle_caps, instance, openings, proof, config, lde_bits, schedule)
    if flat is not None:
        code = nat.fri_verify_queries(
            alpha=np.asarray(alpha, dtype=np.uint64),
            betas=np.asarray(betas, dtype=np.uint64).reshape(-1),
            final_poly=np.asarray(proof.final_poly, dtype=np.uint64).reshape(-1),
            g=int(F.MULTIPLICATIVE_GROUP_GENERATOR),
            w0=int(F.primitive_root_of_unity(lde_bits)),
            indices=np.asarray(indices, dtype=np.uint64),
            **flat,
        )
        if code == 0:
            return
        kind, rnd, sub = code >> 32, (code >> 16) & 0xFFFF, code & 0xFFFF
        if kind in _NATIVE_ERRORS:
            _fail(_NATIVE_ERRORS[kind].format(sub=sub) + f" (query round {rnd})")
    _query_rounds_pure(oracle_caps, oracle_num_polys, instance, openings, proof, config,
                       degree_bits, alpha, betas, indices)


def _query_rounds_pure(oracle_caps, oracle_num_polys, instance, openings, proof, config,
                       degree_bits, alpha, betas, indices) -> None:
    """The query rounds in Python ints (the tests' oracle)."""
    lde_bits = degree_bits + config.rate_bits
    m0 = 1 << lde_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    # the query loop runs in the (int, int) ext-tuple domain: pure Python-int
    # arithmetic through the shared ext ops (no numpy packing per op)
    alpha_t = ext.pair(alpha)
    total_terms = instance.num_terms()
    apows_int: list[tuple] = [(1, 0)]
    for _ in range(total_terms - 1):
        apows_int.append(ext.mul(apows_int[-1], alpha_t))
    batch_slices = []
    off = 0
    for b in instance.batches:
        batch_slices.append((off, off + len(b.polys)))
        off += len(b.polys)
    openings_t = [
        [ext.pair(y) for y in np.asarray(o, dtype=np.uint64).reshape(-1, 2)]
        for o in openings
    ]
    betas_t = [ext.pair(b) for b in betas]
    final_poly_t = [ext.pair(c) for c in proof.final_poly]
    half_inv = pow(2, P - 2, P)

    g = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    w0 = int(F.primitive_root_of_unity(lde_bits))

    for q0, round_ in zip(indices, proof.query_rounds):
        # 1. initial tree openings
        if len(round_.initial_rows) != len(oracle_caps):
            _fail("wrong oracle count in query round")
        for oi, (row, sibs) in enumerate(
            zip(round_.initial_rows, round_.initial_siblings)
        ):
            if len(row) < oracle_num_polys[oi]:
                _fail("short leaf row")
            if not verify_row(oracle_caps[oi], row, q0, sibs):
                _fail(f"initial Merkle proof failed (oracle {oi})")

        # 2. recompute Q(x) from the opened rows
        x = g * pow(w0, q0, P) % P
        qval = (0, 0)
        for bi, batch in enumerate(instance.batches):
            s, e = batch_slices[bi]
            sb0 = sb1 = 0
            for k, (oi, pj) in enumerate(batch.polys):
                ap = apows_int[s + k]
                v = int(round_.initial_rows[oi][pj])
                sb0 += ap[0] * v
                sb1 += ap[1] * v
            sb = (sb0 % P, sb1 % P)
            cb = (0, 0)
            for k, y in enumerate(openings_t[bi]):
                cb = ext.add(cb, ext.mul(apows_int[s + k], y))
            num = ext.sub(sb, cb)
            xz = ((x - int(batch.point[0])) % P, (-int(batch.point[1])) % P)
            qval = ext.add(qval, ext.mul(num, ext.inv(xz)))

        # 3. fold walk
        cur_val = qval
        q = q0
        m = m0
        for li, (a_bits, beta) in enumerate(zip(schedule, betas_t)):
            step = round_.steps[li]
            arity = 1 << a_bits
            mp = m >> a_bits
            j = q // mp
            q_next = q % mp
            leaf = np.asarray(step.leaf_values, dtype=np.uint64)
            if leaf.shape != (arity, 2):
                _fail("malformed fold leaf")
            if ext.pair(leaf[j]) != cur_val:
                _fail(f"fold consistency failed at layer {li}")
            flat_row = leaf.reshape(-1)
            if not verify_row(proof.commit_caps[li], flat_row, q_next, step.siblings):
                _fail(f"commit-phase Merkle proof failed at layer {li}")
            # fold the group: element k sits at global index q_next + k*mp,
            # i.e. point x_{q_next} * gamma^k with gamma = w^mp (order 2^a)
            w_cur = pow(w0, 1 << (lde_bits - (m.bit_length() - 1)), P)
            x_q = g_pow_shift(lde_bits, m, q_next)
            gamma = pow(w_cur, mp, P)
            vals = [ext.pair(leaf[k]) for k in range(arity)]
            pts = [x_q * pow(gamma, k, P) % P for k in range(arity)]
            beta_t = beta
            while len(vals) > 1:
                half = len(vals) // 2
                new_vals = []
                for k in range(half):
                    vs = ext.add(vals[k], vals[k + half])
                    vd = ext.sub(vals[k], vals[k + half])
                    inv_p = pow(pts[k], P - 2, P)
                    t = ext.scalar_mul(ext.mul(vd, beta_t), inv_p)
                    tot = ext.add(vs, t)
                    new_vals.append(ext.scalar_mul(tot, half_inv))
                vals = new_vals
                pts = [p * p % P for p in pts[:half]]
                beta_t = ext.mul(beta_t, beta_t)
            cur_val = vals[0]
            q = q_next
            m = mp

        # 4. final polynomial evaluation
        x_final = g_pow_shift(lde_bits, m, q)
        acc = (0, 0)
        for c in final_poly_t[::-1]:
            acc = ext.scalar_mul(acc, x_final)
            acc = ext.add(acc, c)
        if acc != cur_val:
            _fail("final polynomial check failed")


def g_pow_shift(lde_bits: int, m: int, q: int) -> int:
    """Coordinate of index q in the folded domain of size m: the original
    domain is g*H (|H| = 2^lde_bits); after folding down to size m the domain
    is g^(2^k) * H^(2^k) with 2^k = 2^lde_bits / m."""
    k = lde_bits - (m.bit_length() - 1)
    g = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    w = int(F.primitive_root_of_unity(m.bit_length() - 1))
    return pow(g, 1 << k, P) * pow(w, q, P) % P
