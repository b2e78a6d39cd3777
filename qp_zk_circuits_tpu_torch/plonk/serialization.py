"""Deterministic byte serialization for proofs and verifier data.

The reference pins artifacts by raw-byte equality and keccak digests
(`aggregator/src/common/utils.rs:126-158`, `verifier/src/lib.rs:101-112`),
so serialization must be byte-exact and deterministic: little-endian u64
arrays with u32 length prefixes, no floats, no maps.

Layout mirrors the roles of the reference's artifact pair:
  * CommonCircuitData  — config + degree + gate set + column layout;
  * VerifierOnlyData   — constants-oracle cap + circuit digest.
Proof bytes carry caps, openings, PIs and the full FRI proof (the reference
walks the same structure at `utils.rs:333-540`). Every byte equals the JAX
package's: proofs, the full verifier data and both artifact views.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..fri.config import FriConfig, FriReductionStrategy
from ..fri.prover import FriProof, FriQueryRound, FriQueryStep
from .config import CircuitConfig
from .gates import (
    ArithmeticGate,
    BaseSumGate,
    ConstantGate,
    NoopGate,
    Poseidon2Gate,
    PublicInputGate,
    ReducingGate,
)
from .proof import OpeningSet, Proof

MAGIC = b"QZKT"
VERSION = 1


class SerializationError(ValueError):
    pass


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", v))

    def u64(self, v: int):
        self.buf.write(struct.pack("<Q", int(v)))

    def bool_(self, v: bool):
        self.buf.write(b"\x01" if v else b"\x00")

    def arr(self, a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
        self.u32(a.ndim)
        for d in a.shape:
            self.u32(d)
        self.buf.write(a.astype("<u8").tobytes())

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.buf.write(b)

    def bytes_(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, data: bytes, max_len: int | None = None):
        if max_len is not None and len(data) > max_len:
            raise SerializationError(f"artifact exceeds size cap ({len(data)} > {max_len})")
        self.buf = io.BytesIO(data)
        self.total = len(data)

    def _read(self, n: int) -> bytes:
        b = self.buf.read(n)
        if len(b) != n:
            raise SerializationError("truncated input")
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def bool_(self) -> bool:
        return self._read(1) == b"\x01"

    def arr(self) -> np.ndarray:
        ndim = self.u32()
        if ndim > 4:
            raise SerializationError("array rank too large")
        shape = tuple(self.u32() for _ in range(ndim))
        count = int(np.prod(shape)) if shape else 1
        # length sanity BEFORE allocation (poisoned-length rationale,
        # reference utils.rs:126-158)
        if count * 8 > self.total:
            raise SerializationError("array length exceeds input size")
        raw = self._read(count * 8)
        return np.frombuffer(raw, dtype="<u8").astype(np.uint64).reshape(shape)

    def string(self) -> str:
        n = self.u32()
        if n > 1024:
            raise SerializationError("string too long")
        return self._read(n).decode("utf-8")

    def expect_end(self):
        if self.buf.read(1):
            raise SerializationError("trailing bytes")


# ---------------------------------------------------------------------------
# gate registry


def gate_from_key(key: str):
    if key == "noop":
        return NoopGate()
    if key == "poseidon2":
        return Poseidon2Gate()
    if key == "public_input":
        return PublicInputGate()
    if key.startswith("arith"):
        return ArithmeticGate(int(key[5:]))
    if key.startswith("const"):
        return ConstantGate(int(key[5:]))
    if key.startswith("base_sum"):
        return BaseSumGate(int(key[8:]))
    if key.startswith("reduce"):
        # reduce{b|e}{num_coeffs}s{scratch}
        ext = key[6] == "e"
        nc, scratch = key[7:].split("s")
        return ReducingGate(int(nc), ext, int(scratch))
    raise SerializationError(f"unknown gate key: {key}")


# ---------------------------------------------------------------------------
# config


def write_config(w: Writer, cfg: CircuitConfig):
    w.u32(cfg.num_wires)
    w.u32(cfg.num_routed_wires)
    w.u32(cfg.num_challenges)
    w.u32(cfg.security_bits)
    w.u32(cfg.max_quotient_degree_factor)
    w.bool_(cfg.zero_knowledge)
    f = cfg.fri_config
    w.u32(f.rate_bits)
    w.u32(f.cap_height)
    w.u32(f.proof_of_work_bits)
    w.u32(f.num_query_rounds)
    w.u32(f.reduction_strategy.arity_bits)
    w.u32(f.reduction_strategy.final_poly_bits)


def read_config(r: Reader) -> CircuitConfig:
    num_wires = r.u32()
    num_routed = r.u32()
    nc = r.u32()
    sec = r.u32()
    qdf = r.u32()
    zk = r.bool_()
    fri = FriConfig(
        rate_bits=r.u32(),
        cap_height=r.u32(),
        proof_of_work_bits=r.u32(),
        num_query_rounds=r.u32(),
        reduction_strategy=FriReductionStrategy(r.u32(), r.u32()),
    )
    return CircuitConfig(
        num_wires=num_wires,
        num_routed_wires=num_routed,
        num_challenges=nc,
        security_bits=sec,
        max_quotient_degree_factor=qdf,
        zero_knowledge=zk,
        fri_config=fri,
    )


# ---------------------------------------------------------------------------
# verifier data


class VerifierCircuitData:
    """Lean verifier view (reference VerifierCircuitData + CommonCircuitData)."""

    def __init__(self, config, degree_bits, gate_types, num_selectors, num_const_cols,
                 constants_cap, circuit_digest, num_public_inputs):
        self.config = config
        self.degree_bits = degree_bits
        self.gate_types = gate_types
        self.num_selectors = num_selectors
        self.num_const_cols = num_const_cols
        self.constants_cap = np.asarray(constants_cap, dtype=np.uint64)
        self.circuit_digest = np.asarray(circuit_digest, dtype=np.uint64)
        self.num_public_inputs = num_public_inputs

    @property
    def n(self):
        return 1 << self.degree_bits

    @property
    def num_preprocessed(self):
        return self.num_const_cols + self.num_selectors + self.config.num_routed_wires

    # CircuitData-compat views used by the verifier paths
    @property
    def const_cols(self):
        class _Shape:
            def __init__(s, k):
                s.shape = (k, None)

        return _Shape(self.num_const_cols)

    class _Oracle:
        def __init__(self, cap):
            self.cap = cap

    @property
    def constants_oracle(self):
        return VerifierCircuitData._Oracle(self.constants_cap)

    @classmethod
    def from_circuit_data(cls, data) -> "VerifierCircuitData":
        return cls(
            config=data.config,
            degree_bits=data.degree_bits,
            gate_types=list(data.gate_types),
            num_selectors=data.num_selectors,
            num_const_cols=data.const_cols.shape[0],
            constants_cap=data.constants_oracle.cap,
            circuit_digest=data.circuit_digest,
            num_public_inputs=len(data.public_input_targets),
        )

    def _write_layout(self, w: Writer) -> None:
        """Config, degree, gate set, column layout and PI count: the part
        that the full and the common views share."""
        write_config(w, self.config)
        w.u32(self.degree_bits)
        w.u32(len(self.gate_types))
        for g in self.gate_types:
            w.string(g.key())
        w.u32(self.num_selectors)
        w.u32(self.num_const_cols)
        w.u32(self.num_public_inputs)

    def to_bytes(self) -> bytes:
        w = Writer()
        w.buf.write(MAGIC)
        w.u32(VERSION)
        self._write_layout(w)
        w.arr(self.constants_cap)
        w.arr(self.circuit_digest)
        return w.bytes_()

    # -- split artifact views (reference separates VerifierOnlyCircuitData
    #    from CommonCircuitData — `wormhole/verifier/src/lib.rs:199-204`) ----

    def to_common_bytes(self) -> bytes:
        """CommonCircuitData view: config + degree + gate set + column layout
        + PI count. No cap, no digest — those are the VerifierOnly view."""
        w = Writer()
        w.buf.write(MAGIC)
        w.u32(VERSION + 200)  # common-data format tag
        self._write_layout(w)
        return w.bytes_()

    def to_verifier_only_bytes(self) -> bytes:
        """VerifierOnlyCircuitData view: constants-oracle cap + circuit
        digest (the digest binds the full identity across both views)."""
        w = Writer()
        w.buf.write(MAGIC)
        w.u32(VERSION + 300)  # verifier-only format tag
        w.arr(self.constants_cap)
        w.arr(self.circuit_digest)
        return w.bytes_()

    @staticmethod
    def _read_layout(r: Reader) -> tuple:
        """`_write_layout`'s fields, each checked as it is read."""
        cfg = read_config(r)
        degree_bits = r.u32()
        if degree_bits > 30:
            raise SerializationError("degree_bits too large")
        n_gates = r.u32()
        if n_gates > 64:
            raise SerializationError("too many gate types")
        gates = [gate_from_key(r.string()) for _ in range(n_gates)]
        return cfg, degree_bits, gates, r.u32(), r.u32(), r.u32()

    @classmethod
    def _from_parts(cls, layout: tuple, cap, digest, mismatch: str) -> "VerifierCircuitData":
        """The verifier data of a read layout, cap and digest. The digest
        binds the FULL verifier identity (cap, config, gate set, layout, PI
        count): it is recomputed so a tampered artifact can never pass while
        changing which constraints get evaluated."""
        cfg, degree_bits, gates, num_selectors, num_const_cols, num_pis = layout
        if cap.shape != (1 << cfg.fri_config.cap_height, 4):
            raise SerializationError("malformed constants cap")
        if digest.shape != (4,):
            raise SerializationError("malformed circuit digest")
        from .builder import compute_circuit_digest

        expect = compute_circuit_digest(
            cap, cfg, degree_bits, [g.key() for g in gates],
            num_selectors, num_const_cols, num_pis,
        )
        if not np.array_equal(expect, digest):
            raise SerializationError(mismatch)
        return cls(cfg, degree_bits, gates, num_selectors, num_const_cols, cap, digest, num_pis)

    @classmethod
    def from_artifact_bytes(
        cls, verifier_only: bytes, common: bytes, max_len: int = 1 << 20
    ) -> "VerifierCircuitData":
        """Rebuild from the (verifier.bin, common.bin) artifact pair. The
        recomputed circuit digest binds the two views together: swapping
        either against a different circuit's artifact fails."""
        r = Reader(common, max_len=max_len)
        if r._read(4) != MAGIC:
            raise SerializationError("bad magic (common data)")
        if r.u32() != VERSION + 200:
            raise SerializationError("unsupported common-data version")
        layout = cls._read_layout(r)
        r.expect_end()

        r2 = Reader(verifier_only, max_len=max_len)
        if r2._read(4) != MAGIC:
            raise SerializationError("bad magic (verifier-only data)")
        if r2.u32() != VERSION + 300:
            raise SerializationError("unsupported verifier-only version")
        cap = r2.arr()
        digest = r2.arr()
        r2.expect_end()
        return cls._from_parts(layout, cap, digest,
                          "circuit digest does not bind the verifier/common artifact pair")

    @classmethod
    def from_bytes(cls, data: bytes, max_len: int = 1 << 20) -> "VerifierCircuitData":
        r = Reader(data, max_len=max_len)
        if r._read(4) != MAGIC:
            raise SerializationError("bad magic")
        if r.u32() != VERSION:
            raise SerializationError("unsupported version")
        layout = cls._read_layout(r)
        cap = r.arr()
        digest = r.arr()
        r.expect_end()
        return cls._from_parts(layout, cap, digest, "circuit digest does not match verifier data")


# ---------------------------------------------------------------------------
# proofs


def proof_to_bytes(proof: Proof) -> bytes:
    w = Writer()
    w.buf.write(MAGIC)
    w.u32(VERSION + 100)  # proof format tag
    w.arr(proof.public_inputs)
    w.arr(proof.wires_cap)
    w.arr(proof.zs_pp_cap)
    w.arr(proof.quotient_cap)
    o = proof.openings
    for part in [o.constants, o.selectors, o.sigmas, o.wires, o.zs, o.zs_next, o.pps, o.quotient]:
        w.arr(part)
    fp = proof.fri_proof
    w.u32(len(fp.commit_caps))
    for cap in fp.commit_caps:
        w.arr(cap)
    w.arr(fp.final_poly)
    w.u64(fp.pow_witness)
    w.u32(len(fp.query_rounds))
    for qr in fp.query_rounds:
        w.u32(len(qr.initial_rows))
        for row, sibs in zip(qr.initial_rows, qr.initial_siblings):
            w.arr(row)
            w.arr(sibs)
        w.u32(len(qr.steps))
        for st in qr.steps:
            w.arr(st.leaf_values)
            w.arr(st.siblings)
    return w.bytes_()


def proof_from_bytes(data: bytes, max_len: int = 64 << 20) -> Proof:
    r = Reader(data, max_len=max_len)
    if r._read(4) != MAGIC:
        raise SerializationError("bad magic")
    if r.u32() != VERSION + 100:
        raise SerializationError("unsupported proof version")
    pis = r.arr()
    wires_cap = r.arr()
    zs_pp_cap = r.arr()
    quotient_cap = r.arr()
    parts = [r.arr() for _ in range(8)]
    openings = OpeningSet(*parts)
    n_caps = r.u32()
    if n_caps > 32:
        raise SerializationError("too many commit caps")
    caps = [r.arr() for _ in range(n_caps)]
    final_poly = r.arr()
    pow_witness = np.uint64(r.u64())
    n_rounds = r.u32()
    if n_rounds > 256:
        raise SerializationError("too many query rounds")
    rounds = []
    for _ in range(n_rounds):
        n_oracles = r.u32()
        if n_oracles > 16:
            raise SerializationError("too many oracles")
        rows, sibs = [], []
        for _ in range(n_oracles):
            rows.append(r.arr())
            sibs.append(r.arr())
        n_steps = r.u32()
        if n_steps > 32:
            raise SerializationError("too many fold steps")
        steps = [FriQueryStep(leaf_values=r.arr(), siblings=r.arr()) for _ in range(n_steps)]
        rounds.append(FriQueryRound(initial_rows=rows, initial_siblings=sibs, steps=steps))
    r.expect_end()
    return Proof(
        wires_cap=wires_cap,
        zs_pp_cap=zs_pp_cap,
        quotient_cap=quotient_cap,
        openings=openings,
        fri_proof=FriProof(
            commit_caps=caps,
            final_poly=final_poly,
            pow_witness=pow_witness,
            query_rounds=rounds,
        ),
        public_inputs=pis,
    )
