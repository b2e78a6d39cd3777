"""PLONK verifier (host): transcript re-derivation, vanishing check, FRI.

The standalone counterpart of `prover.py` — what the reference ships as the
no-std `qp-plonky2-verifier` crate for on-chain use (SURVEY §3.4: ~1.6 ms
leaf verify). Pure numpy/int host code with no device dependency: `data` is
a `CircuitData` (its constants cap read on the host) or a
`serialization.py::VerifierCircuitData`. The JAX package's verifier, check
for check and message for message.
"""

from __future__ import annotations

import numpy as np

from ..field import extension as ext
from ..field import gf_np as F
from ..fri.verifier import FriVerificationError, fri_verify
from ..hash import poseidon2 as ps
from . import transcript as ts
from .builder import CircuitData
from .proof import Proof, fri_instance, zs_pp_layout
from .prover import verify_vanishing_at_zeta


class VerificationError(Exception):
    pass


def check_proof_shape(data: CircuitData, proof: Proof) -> None:
    """Full structural preflight of a (possibly deserialized) proof BEFORE any
    transcript observation or Merkle walk: cap shapes, FRI round counts,
    initial-row widths, sibling path lengths and step leaf shapes.

    Mirrors the reference's `ensure_proof_shape_matches_targets` walk
    (`wormhole/aggregator/src/common/utils.rs:333-540`) so malformed proofs
    fail fast with VerificationError instead of raw index errors mid-verify."""
    from ..fri.config import SALT_SIZE

    cfg = data.config
    fcfg = cfg.fri_config
    cap_shape = (1 << fcfg.cap_height, 4)
    for name, cap in (
        ("wires", proof.wires_cap),
        ("zs_pp", proof.zs_pp_cap),
        ("quotient", proof.quotient_cap),
    ):
        if np.asarray(cap).shape != cap_shape:
            raise VerificationError(f"malformed {name} cap shape")

    nz, npp_total = zs_pp_layout(cfg)
    lde_bits = data.degree_bits + fcfg.rate_bits
    salt = SALT_SIZE if cfg.zero_knowledge else 0
    widths = [
        data.num_preprocessed,
        cfg.num_wires + salt,
        nz + npp_total + salt,
        cfg.num_challenges * cfg.max_quotient_degree_factor + salt,
    ]
    init_sib_len = lde_bits - fcfg.cap_height

    schedule = fcfg.reduction_strategy.schedule(data.degree_bits)
    fp = proof.fri_proof
    if len(fp.commit_caps) != len(schedule):
        raise VerificationError("wrong number of FRI commit caps")
    # per-layer expected shapes
    step_shapes = []
    log_m = lde_bits
    for a_bits in schedule:
        mp_bits = log_m - a_bits
        l_cap = min(fcfg.cap_height, mp_bits)
        step_shapes.append(((1 << a_bits, 2), mp_bits - l_cap, (1 << l_cap, 4)))
        log_m = mp_bits
    for li, (_, _, cap_sh) in enumerate(step_shapes):
        if np.asarray(fp.commit_caps[li]).shape != cap_sh:
            raise VerificationError(f"malformed FRI cap shape at layer {li}")

    final_len = min(
        1 << fcfg.reduction_strategy.final_poly_bits,
        1 << (data.degree_bits - sum(schedule)),
    )
    if np.asarray(fp.final_poly).shape != (final_len, 2):
        raise VerificationError("malformed FRI final polynomial shape")

    if len(fp.query_rounds) != fcfg.num_query_rounds:
        raise VerificationError("wrong number of FRI query rounds")
    for qr in fp.query_rounds:
        if len(qr.initial_rows) != 4 or len(qr.initial_siblings) != 4:
            raise VerificationError("wrong oracle count in FRI query round")
        for oi, (row, sibs) in enumerate(zip(qr.initial_rows, qr.initial_siblings)):
            if np.asarray(row).shape != (widths[oi],):
                raise VerificationError(f"malformed initial row width (oracle {oi})")
            if np.asarray(sibs).shape != (init_sib_len, 4):
                raise VerificationError(f"malformed initial sibling path (oracle {oi})")
        if len(qr.steps) != len(schedule):
            raise VerificationError("wrong number of FRI query steps")
        for li, st in enumerate(qr.steps):
            leaf_sh, sib_len, _ = step_shapes[li]
            if np.asarray(st.leaf_values).shape != leaf_sh:
                raise VerificationError(f"malformed step leaf shape at layer {li}")
            if np.asarray(st.siblings).shape != (sib_len, 4):
                raise VerificationError(f"malformed step sibling path at layer {li}")


def verify(data: CircuitData, proof: Proof) -> None:
    """Raises VerificationError if the proof is invalid."""
    cfg = data.config
    check_proof_shape(data, proof)
    pi_hash = ps.hash_no_pad(np.asarray(proof.public_inputs, dtype=np.uint64))

    ch = ts.Challenger()
    ch.observe_many(data.circuit_digest)
    ch.observe_many(pi_hash)
    ch.observe_cap(proof.wires_cap)
    betas = ch.challenge_many(cfg.num_challenges)
    gammas = ch.challenge_many(cfg.num_challenges)
    ch.observe_cap(proof.zs_pp_cap)
    alphas = ch.challenge_many(cfg.num_challenges)
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.challenge_ext()
    g_n = F.primitive_root_of_unity(data.degree_bits)
    zeta_next = ext.scalar_mul(zeta.reshape(1, 2), g_n)[0]

    # structural checks on opening shapes
    o = proof.openings
    nz, npp_total = zs_pp_layout(cfg)
    expected = {
        "constants": data.const_cols.shape[0],
        "selectors": data.num_selectors,
        "sigmas": cfg.num_routed_wires,
        "wires": cfg.num_wires,
        "zs": nz,
        "zs_next": nz,
        "pps": npp_total,
        "quotient": cfg.num_challenges * cfg.max_quotient_degree_factor,
    }
    for name, want in expected.items():
        got = getattr(o, name)
        if np.asarray(got).shape != (want, 2):
            raise VerificationError(f"malformed opening set: {name}")

    # the vanishing identity at zeta
    if not verify_vanishing_at_zeta(data, o, pi_hash, alphas, betas, gammas, zeta):
        raise VerificationError("vanishing polynomial check failed at zeta")

    # FRI: openings observed, then the low-degree opening proof
    o.observe_into(ch)
    instance = fri_instance(data, zeta, zeta_next)
    fri_openings = [o.batch_zeta(), o.batch_zeta_next()]
    caps = [
        data.constants_oracle.cap,
        proof.wires_cap,
        proof.zs_pp_cap,
        proof.quotient_cap,
    ]
    num_polys = [
        data.num_preprocessed,
        cfg.num_wires,
        nz + npp_total,
        cfg.num_challenges * cfg.max_quotient_degree_factor,
    ]
    try:
        fri_verify(
            caps,
            num_polys,
            instance,
            fri_openings,
            proof.fri_proof,
            ch,
            cfg.fri_config,
            data.degree_bits,
        )
    except FriVerificationError as e:
        raise VerificationError(f"FRI verification failed: {e}") from e
