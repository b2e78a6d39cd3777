"""FRI prover: batched composition, commit/fold phase, PoW grind, queries.

Implements the low-degree opening argument consumed by the PLONK prover
(the reference hot loop "FRI commit/fold (ConstantArityBits(4,5)) -> 28 query
rounds -> 16-bit PoW", SURVEY §3.1). Device layout, kernels C, E and F of
csrc/fri.cu:

  * The composition polynomial Q(X) = sum_k alpha^k (p_k(X) - y_k)/(X - z_b)
    is computed **in evaluation form over the whole LDE domain on device**
    by kernel C, two launches: the alpha powers and each batch's
    sum_k alpha^k y_k, then Q, whose committed LDE columns are read in place
    through a per-circuit (oracle, row) table; each point inverts its own
    x - z_b.
  * A round's layer is held as the leaf matrix its Merkle tree hashes: leaf
    q = [v[q + j*M'] for j < 2^a], so one query opens the whole arity coset.
    Kernel C writes Q in the first round's leaf layout; kernel E folds a
    round's leaves a times with betas beta^(2^t), forming the inverse
    twiddles on the card, and writes the result in the next round's leaf
    layout (one launch a round). Each
    layer is a kernel-2 tree whose levels stay on the device.
  * The final polynomial is one kernel-3 inverse NTT of the last layer with
    the coset unshift folded in; the PoW grind is a kernel-2 sweep
    (plonk/transcript.py).
  * The queries' leaf rows, layer leaves and Merkle siblings of every tree
    are gathered by kernel F, its plan passed by value, into one packed
    buffer of pinned host memory: one launch, no copy. A ZK proof's salted
    oracles open whole rows, salt included (their LDE buffers hold the salt
    rows after the polynomials'), while the composition reads only the
    polynomials the instance names; the FRI rounds' own trees have no salt,
    as in the JAX package.

Host keeps (the staged prover): transcript, query assembly. Every kernel
reads its Fiat-Shamir values from device memory (C and E: the proof's
challenge record, plonk/transcript.py REC_*; F: its index vector), where
the fused prover's transcript writes them (plonk/prover_fused.py); the
staged prover and the batch forms upload their host values in one copy
(`composition_inputs`, `beta_records`).
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from ..field import extension as ext
from ..field import gf_np as F
from ..field import goldilocks as gl
from ..hash import merkle
from ..plonk import transcript as ts
from ..poly import ntt
from .config import FriConfig
from .oracle import PolynomialBatch, ext_powers

#: kernel C reads at most this many oracles and batches (opening points),
#: and stages at most this many terms in a block's shared memory
MAX_ORACLES = 8
MAX_BATCHES = 4
MAX_TERMS = 4096
#: kernel E folds at most 2^4 values a leaf row in a round
MAX_ARITY_BITS = 4
#: where kernel C reads batch b's point in a challenge record: zeta and g *
#: zeta for a PLONK instance's two batches; a third and fourth batch (no
#: PLONK instance has them) in the first two round-beta slots, which kernel
#: C does not read
POINT_SLOTS = (ts.REC_ZETA, ts.REC_ZETA_NEXT, ts.REC_FRI_BETA, ts.REC_FRI_BETA + 2)


# ---------------------------------------------------------------------------
# instance description


@dataclass(frozen=True)
class FriBatchInfo:
    """One opening point and the (oracle, poly) columns opened there."""

    point: tuple[int, int]  # extension point (c0, c1) as ints
    polys: tuple[tuple[int, int], ...]  # (oracle_index, poly_index)


@dataclass(frozen=True)
class FriInstance:
    batches: tuple[FriBatchInfo, ...]

    def num_terms(self) -> int:
        return sum(len(b.polys) for b in self.batches)


# ---------------------------------------------------------------------------
# proof objects


@dataclass
class FriQueryStep:
    leaf_values: np.ndarray  # (2^a, 2) extension values of the committed layer
    siblings: np.ndarray  # merkle siblings (per level, 4)


@dataclass
class FriQueryRound:
    initial_rows: list  # per oracle: np (C_total,) leaf row
    initial_siblings: list  # per oracle: np (L, 4)
    steps: list  # [FriQueryStep]


@dataclass
class FriProof:
    commit_caps: list  # per layer: np (2^cap, 4)
    final_poly: np.ndarray  # (2^final_poly_bits, 2) extension coefficients
    pow_witness: np.uint64
    query_rounds: list = field(default_factory=list)  # [FriQueryRound]


# ---------------------------------------------------------------------------
# cached tables


@functools.cache
def _inv_x_table(log_m: int, shift_pow: int) -> np.ndarray:
    """(shift * w^i)^{-1} for i < 2^(log_m-1), with shift = g^(2^shift_pow),
    w the 2^log_m-th root of unity."""
    g = F.MULTIPLICATIVE_GROUP_GENERATOR
    shift = F.pow_scalar(g, 1 << shift_pow)
    w = F.primitive_root_of_unity(log_m)
    inv_w = F.inv(w)
    inv_shift = F.inv(shift)
    return F.mul(F.powers_table(inv_w, 1 << (log_m - 1)), inv_shift)


@functools.cache
def _domain_points(lde_bits: int) -> np.ndarray:
    """x_i = g * w^i over the LDE domain (natural order)."""
    return F.mul(
        F.powers_table(F.primitive_root_of_unity(lde_bits), 1 << lde_bits),
        F.MULTIPLICATIVE_GROUP_GENERATOR,
    )


@functools.cache
def _device_domain_points(lde_bits: int, device: torch.device) -> torch.Tensor:
    return gl.from_u64(_domain_points(lde_bits), device)


@functools.cache
def _fold_consts(log_m: int, shift_pow: int, a_bits: int) -> np.ndarray:
    """Kernel E's constants for one round, passed by value: w^(-2^b) for
    b < 32 (w of order m = 2^log_m); c_tj = shift^(-2^t) w_t^(-j m') for t <
    a, j < 2^(a - t - 1) (at 2^a - 2^(a - t) + j, zero-padded to 15), with
    shift = g^(2^shift_pow) and w_t = w^(2^t); and 2^-a. The inverse twiddle
    of value q + j m' in fold t is w^(-2^t q) c_tj: the kernel forms it."""
    p = int(F.P)
    inv_w = int(F.inv(F.primitive_root_of_unity(log_m)))
    inv_shift = int(F.inv(F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << shift_pow)))
    mp = 1 << (log_m - a_bits)
    wb = [pow(inv_w, 1 << b, p) for b in range(32)]
    c = [pow(inv_shift, 1 << t, p) * pow(inv_w, (j * mp) << t, p) % p
         for t in range(a_bits) for j in range(1 << (a_bits - t - 1))]
    c += [0] * ((1 << MAX_ARITY_BITS) - 1 - len(c))
    return np.array(wb + c + [pow(_INV2, a_bits, p)], dtype=np.uint64)


@functools.cache
def _term_table(polys_per_batch: tuple) -> np.ndarray:
    """Kernel C's column table: (K, 2) int32 (oracle, row), the batches'
    terms in order."""
    rows = [t for polys in polys_per_batch for t in polys]
    return np.array(rows, dtype=np.int32).reshape(-1, 2)


@functools.cache
def _device_term_table(polys_per_batch: tuple, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_term_table(polys_per_batch), device=device)


_INV2 = int(pow(2, 0xFFFFFFFF00000001 - 2, 0xFFFFFFFF00000001))


# ---------------------------------------------------------------------------
# layers as leaf rows


def _regroup_leaves(values: torch.Tensor, arity_bits: int) -> torch.Tensor:
    """(m, 2) ext -> (m/2^a, 2^(a+1)) felts: leaf q = [v(q + j*m') for j], with
    each extension element flattened (c0, c1)."""
    m = values.shape[0]
    a = 1 << arity_bits
    mp = m // a
    return values.reshape(a, mp, 2).transpose(0, 1).reshape(mp, 2 * a)


def _ungroup_leaves(leaves: torch.Tensor, arity_bits: int) -> torch.Tensor:
    """The inverse of `_regroup_leaves`: (m', 2^(a+1)) leaf rows -> (m, 2)."""
    mp = leaves.shape[0]
    a = 1 << arity_bits
    return leaves.reshape(mp, a, 2).transpose(0, 1).reshape(mp * a, 2)


# ---------------------------------------------------------------------------
# kernel C: the composition


def _composition_limits(oracles, polys_per_batch, lde_bits: int, arity_bits: int) -> None:
    m = 1 << lde_bits
    if not 1 <= len(oracles) <= MAX_ORACLES or not 1 <= len(polys_per_batch) <= MAX_BATCHES:
        raise ValueError(
            f"{len(oracles)} oracles and {len(polys_per_batch)} batches: kernel C takes "
            f"1..{MAX_ORACLES} and 1..{MAX_BATCHES}"
        )
    if any(o.lde.dim() != 2 or o.lde.shape[1] != m for o in oracles):
        raise ValueError(f"an oracle's LDE is not (C, {m})")
    if any(not polys for polys in polys_per_batch):
        raise ValueError("a batch opens no polynomial")
    terms = _term_table(tuple(polys_per_batch))
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} terms: kernel C takes at most {MAX_TERMS}")
    rows = np.array([o.lde.shape[0] for o in oracles])
    if terms[:, 0].min() < 0 or terms[:, 0].max() >= len(oracles) or \
            (terms[:, 1] < 0).any() or (terms[:, 1] >= rows[terms[:, 0]]).any():
        raise ValueError("the instance names a column outside the oracles")
    if not 0 <= arity_bits <= min(MAX_ARITY_BITS, lde_bits):
        raise ValueError(f"arity bits {arity_bits} outside 0..{MAX_ARITY_BITS}")


def composition_inputs(instances, openings_k, alphas, dev):
    """K proofs' host claimed openings and alphas as `compute_composition`
    reads them: the openings (K, terms, 2) and records (alpha, each batch's
    point at POINT_SLOTS) on `dev`, one copy each."""
    k = len(instances)
    ys = np.stack([np.concatenate([np.asarray(y, dtype=np.uint64).reshape(-1, 2) for y in op])
                   for op in openings_k])  # (K, terms, 2)
    terms = instances[0].num_terms()
    if ys.shape[1] != terms:
        raise ValueError(f"{ys.shape[1]} claimed openings for {terms} terms")
    fields = {ts.REC_FRI_ALPHA: np.asarray(alphas, dtype=np.uint64).reshape(k, 2)}
    for b in range(len(instances[0].batches)):
        fields[POINT_SLOTS[b]] = np.array(
            [[int(inst.batches[b].point[0]) % gl.P, int(inst.batches[b].point[1]) % gl.P]
             for inst in instances], dtype=np.uint64)
    return gl.from_u64(ys, dev), ts.challenge_records(dev, k, fields)


def compute_composition_plain(oracles, polys_per_batch, ys, rec, lde_bits: int,
                              arity_bits: int = 0) -> torch.Tensor:
    """Plain torch version of `compute_composition` (same arguments)."""
    _composition_limits(oracles, polys_per_batch, lde_bits, arity_bits)
    dev = oracles[0].lde.device
    xs = gl.from_u64(_domain_points(lde_bits), dev)
    apows = ext_powers(rec[ts.REC_FRI_ALPHA : ts.REC_FRI_ALPHA + 2],
                       sum(len(p) for p in polys_per_batch))  # (terms, 2)
    term = 0
    q = None
    for b_idx, polys in enumerate(polys_per_batch):
        k = len(polys)
        ja = apows[term : term + k]
        # c_b = sum_k alpha^k y_k
        c_b = gl.sum_tree(ext.j_mul(ja, ys[term : term + k]), 0)
        term += k
        cols = torch.stack([oracles[oi].lde[pj] for oi, pj in polys])  # (k, m)
        # S_b(x) = sum_k alpha^k p_k(x): weighted column sum
        s_b = torch.stack([
            gl.sum_tree(gl.mul(cols, ja[:, 0:1]), 0),
            gl.sum_tree(gl.mul(cols, ja[:, 1:2]), 0),
        ], dim=-1)  # (m, 2)
        z = rec[POINT_SLOTS[b_idx] : POINT_SLOTS[b_idx] + 2]
        xz = torch.stack([gl.sub(xs, z[0]), gl.neg(z[1]).expand_as(xs)], dim=-1)
        contrib = ext.j_mul(gl.sub(s_b, c_b), ext.j_inv(xz))
        q = contrib if q is None else gl.add(q, contrib)
    return _regroup_leaves(q, arity_bits)


def compute_composition(oracles, polys_per_batch, ys: torch.Tensor, rec: torch.Tensor,
                        lde_bits: int, arity_bits: int = 0) -> torch.Tensor:
    """Q over the full LDE domain, as the (m >> a, 2^(a+1)) leaf rows of a
    first FRI round of arity 2^a (a = 0: natural order, (m, 2)).

    polys_per_batch: each batch's (oracle, poly) columns; ys (terms, 2) the
    claimed openings on the device (kernel D's output on the fused path);
    alpha and the batches' points in the challenge record `rec`
    (REC_WORDS,) on the device (REC_FRI_ALPHA; batch b's point at
    POINT_SLOTS[b]). The staged prover uploads its host values
    (`composition_inputs`). On CUDA LDEs: kernel C (csrc/fri.cu), one
    launch that also forms the alpha powers and the batches' c_b. On CPU
    LDEs: the plain version."""
    _composition_limits(oracles, polys_per_batch, lde_bits, arity_bits)
    if oracles[0].lde.device.type == "cpu":
        return compute_composition_plain(oracles, polys_per_batch, ys, rec, lde_bits, arity_bits)
    _cuda.require_cuda_int64(ys, rec, *(o.lde for o in oracles))
    out, launches = _composition_rec_launches([oracles], polys_per_batch, ys.unsqueeze(0),
                                              rec.unsqueeze(0), lde_bits, arity_bits)
    compute_composition.launches += launches
    return out[0]


def _composition_batch_limits(oracles_k, polys_per_batch, ys, rec, lde_bits, arity_bits):
    k = len(oracles_k)
    if not k or len(ys) != k or len(rec) != k:
        raise ValueError(f"{k} proofs' oracles for {len(ys)} openings and {len(rec)} records")
    if len({tuple(tuple(o.lde.shape) for o in oracles) for oracles in oracles_k}) != 1:
        raise ValueError("the proofs' oracles differ in shape")
    _composition_limits(oracles_k[0], polys_per_batch, lde_bits, arity_bits)


def compute_composition_batch_plain(oracles_k, polys_per_batch, ys, rec, lde_bits: int,
                                    arity_bits: int = 0) -> torch.Tensor:
    """Plain torch version of `compute_composition_batch` (same arguments):
    `compute_composition_plain` a proof, stacked."""
    _composition_batch_limits(oracles_k, polys_per_batch, ys, rec, lde_bits, arity_bits)
    return torch.stack([compute_composition_plain(o, polys_per_batch, y, r, lde_bits, arity_bits)
                        for o, y, r in zip(oracles_k, ys, rec)])


def compute_composition_batch(oracles_k, polys_per_batch, ys: torch.Tensor, rec: torch.Tensor,
                              lde_bits: int, arity_bits: int = 0) -> torch.Tensor:
    """`compute_composition` for K proofs of one circuit, the same columns
    (polys_per_batch) of each proof's oracles oracles_k[i]: proof i's
    claimed openings ys[i] of ys (K, terms, 2) and its alpha and points in
    record rec[i] of rec (K, REC_WORDS) on the device (the fused batch's
    transcripts write them there; the staged batch uploads its host values,
    `composition_inputs`). Returns the (K, m >> a, 2^(a+1)) stack of the
    proofs' first-round leaf rows.

    On CUDA LDEs: kernel C with a proof axis, one launch for at most
    PROOFS_PER_LAUNCH proofs. On CPU LDEs: the plain version."""
    _composition_batch_limits(oracles_k, polys_per_batch, ys, rec, lde_bits, arity_bits)
    if oracles_k[0][0].lde.device.type == "cpu":
        return compute_composition_batch_plain(oracles_k, polys_per_batch, ys, rec, lde_bits,
                                               arity_bits)
    _cuda.require_cuda_int64(ys, rec, *(o.lde for oracles in oracles_k for o in oracles))
    out, launches = _composition_rec_launches(oracles_k, polys_per_batch, ys, rec, lde_bits,
                                              arity_bits)
    compute_composition_batch.launches += launches
    return out


def _composition_rec_launches(oracles_k, polys_per_batch, ys, rec, lde_bits, arity_bits):
    """Kernel C over K proofs, proof i's claimed openings ys[i] and its
    alpha and points in record rec[i] on the device: ((K, m >> a, 2^(a+1))
    leaf rows, launches)."""
    dev = oracles_k[0][0].lde.device
    m = 1 << lde_bits
    k = len(oracles_k)
    ldes = [[o.lde.contiguous() for o in oracles] for oracles in oracles_k]
    ptrs = np.array([[t.data_ptr() for t in proof] for proof in ldes], dtype=np.uint64)
    terms = sum(len(p) for p in polys_per_batch)
    if ys.shape != (k, terms, 2) or not ys.is_contiguous():
        raise ValueError(f"claimed openings {tuple(ys.shape)}, expected a contiguous {(k, terms, 2)}")
    ends = np.cumsum([len(p) for p in polys_per_batch])
    batches = np.array([[end, POINT_SLOTS[b]] for b, end in enumerate(ends)], dtype=np.int64)
    terms_d = _device_term_table(polys_per_batch, dev)
    xs = _device_domain_points(lde_bits, dev)
    out = torch.empty((k, m >> arity_bits, 2 << arity_bits), dtype=torch.int64, device=dev)
    launches = 0
    for g0, g1 in _cuda.proof_groups(k):
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_fri_composition(
                ptrs[g0:g1].ctypes.data, ptrs.shape[1], terms_d.data_ptr(), ys[g0].data_ptr(),
                xs.data_ptr(), batches.ctypes.data, batches.shape[0], rec[g0].data_ptr(),
                rec.stride(0), out[g0].data_ptr(), m, arity_bits, g1 - g0, _cuda.stream(),
            )
        _cuda.check(err, "qzk_fri_composition")
        launches += 1
    return out, launches


compute_composition.launches = 0
compute_composition_batch.launches = 0


# ---------------------------------------------------------------------------
# kernel E: a round's folds


def _fold_step(values: torch.Tensor, beta: torch.Tensor, inv_x: torch.Tensor) -> torch.Tensor:
    """One binary fold of (m, 2) ext values: new_i = inv2 * [(e+o) + beta*inv_x_i*(e-o)]."""
    m = values.shape[0]
    e, o = values[: m // 2], values[m // 2 :]
    s = gl.add(e, o)
    d = ext.j_scalar_mul(gl.sub(e, o), inv_x)
    d = ext.j_mul(d, beta)
    return gl.mul_const(gl.add(s, d), _INV2)


def _fold_limits(leaves: torch.Tensor, a_bits: int, log_m: int, next_bits: int) -> None:
    if not 1 <= a_bits <= MAX_ARITY_BITS or not 0 <= next_bits <= MAX_ARITY_BITS:
        raise ValueError(
            f"arity bits {a_bits} (next {next_bits}): kernel E folds 1..{MAX_ARITY_BITS} "
            f"bits a round"
        )
    if leaves.dim() != 2 or leaves.shape[1] != 2 << a_bits or \
            leaves.shape[0] << a_bits != 1 << log_m:
        raise ValueError(f"leaves {tuple(leaves.shape)} are not a 2^{log_m} layer of arity 2^{a_bits}")
    if next_bits > log_m - a_bits:
        raise ValueError(f"next arity bits {next_bits} above the folded layer's {log_m - a_bits}")


def beta_records(dev, betas) -> torch.Tensor:
    """K challenge records (K, REC_WORDS) on `dev` holding each proof's host
    round beta (K, 2) at REC_FRI_BETA, one copy."""
    k = len(betas)
    return ts.challenge_records(dev, k, {
        ts.REC_FRI_BETA: np.asarray(betas, dtype=np.uint64).reshape(k, 2)})


def fold_round_plain(leaves, rec, beta_slot: int, a_bits: int, log_m: int, shift_pow: int,
                     next_bits: int = 0):
    """Plain torch version of `fold_round` (same arguments)."""
    _fold_limits(leaves, a_bits, log_m, next_bits)
    dev = leaves.device
    values = _ungroup_leaves(leaves, a_bits)
    bt = rec[beta_slot : beta_slot + 2]
    for t in range(a_bits):
        inv_x = gl.from_u64(_inv_x_table(log_m - t, shift_pow + t), dev)
        values = _fold_step(values, bt, inv_x)
        bt = ext.j_sqr(bt)
    return _regroup_leaves(values, next_bits)


def fold_round(leaves: torch.Tensor, rec: torch.Tensor, beta_slot: int, a_bits: int, log_m: int,
               shift_pow: int, next_bits: int = 0) -> torch.Tensor:
    """One FRI round's a binary folds of a layer of 2^log_m values over the
    coset g^(2^shift_pow) H, given as its (m', 2^(a+1)) leaf rows, with
    betas beta^(2^t), beta read from words beta_slot, beta_slot + 1 of the
    challenge record `rec` (REC_WORDS,) on the device (the fused prover's
    transcript writes it there; the staged prover uploads its host beta,
    `beta_records`). Returns the folded layer as the leaf rows of the next
    round, of arity 2^next_bits (0: natural order, (m', 2)).

    On a CUDA tensor: kernel E (csrc/fri.cu), one launch that forms the
    inverse twiddles on the card from a few constants passed by value
    (`_fold_consts`). On a CPU tensor: the plain version."""
    _fold_limits(leaves, a_bits, log_m, next_bits)
    if leaves.device.type == "cpu":
        return fold_round_plain(leaves, rec, beta_slot, a_bits, log_m, shift_pow, next_bits)
    _cuda.require_cuda_int64(leaves, rec)
    out, launches = _fold_rec_launches(leaves.unsqueeze(0), rec.unsqueeze(0), beta_slot, a_bits,
                                       log_m, shift_pow, next_bits)
    fold_round.launches += launches
    return out[0]


def _fold_batch_limits(leaves, rec, a_bits, log_m, next_bits) -> None:
    if leaves.dim() != 3 or not 1 <= leaves.shape[0] == len(rec):
        raise ValueError(f"a batch of layers is (K, m', 2^(a+1)) with K records, got "
                         f"{tuple(leaves.shape)} and {len(rec)}")
    _fold_limits(leaves[0], a_bits, log_m, next_bits)


def fold_round_batch_plain(leaves, rec, beta_slot: int, a_bits: int, log_m: int, shift_pow: int,
                           next_bits: int = 0) -> torch.Tensor:
    """Plain torch version of `fold_round_batch` (same arguments):
    `fold_round_plain` a proof, stacked."""
    _fold_batch_limits(leaves, rec, a_bits, log_m, next_bits)
    return torch.stack([fold_round_plain(x, r, beta_slot, a_bits, log_m, shift_pow, next_bits)
                        for x, r in zip(leaves, rec)])


def fold_round_batch(leaves: torch.Tensor, rec: torch.Tensor, beta_slot: int, a_bits: int,
                     log_m: int, shift_pow: int, next_bits: int = 0) -> torch.Tensor:
    """`fold_round` for K proofs of one FRI schedule: leaves (K, m',
    2^(a+1)), proof i's beta at words beta_slot, beta_slot + 1 of record
    rec[i] of rec (K, REC_WORDS) on the device (the fused batch's
    transcripts draw it there; the staged batch uploads its host betas,
    `beta_records`). Returns (K, m' >> next_bits, 2^(next_bits+1)).

    On a CUDA tensor: kernel E with a proof axis, one launch for at most
    PROOFS_PER_LAUNCH proofs. On a CPU tensor: the plain version."""
    _fold_batch_limits(leaves, rec, a_bits, log_m, next_bits)
    if leaves.device.type == "cpu":
        return fold_round_batch_plain(leaves, rec, beta_slot, a_bits, log_m, shift_pow, next_bits)
    _cuda.require_cuda_int64(leaves, rec)
    out, launches = _fold_rec_launches(leaves, rec, beta_slot, a_bits, log_m, shift_pow, next_bits)
    fold_round_batch.launches += launches
    return out


def _fold_rec_launches(leaves, rec, beta_slot, a_bits, log_m, shift_pow, next_bits):
    """Kernel E over K proofs' (K, m', 2^(a+1)) layers, proof i's beta at
    words beta_slot, beta_slot + 1 of record rec[i] on the device: (out,
    launches)."""
    dev = leaves.device
    leaves = leaves.contiguous()
    k, mp = leaves.shape[:2]
    consts = _fold_consts(log_m, shift_pow, a_bits)
    out = torch.empty((k, mp >> next_bits, 2 << next_bits), dtype=torch.int64, device=dev)
    launches = 0
    for g0, g1 in _cuda.proof_groups(k):
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_fri_fold(
                leaves[g0].data_ptr(), consts.ctypes.data, rec[g0].data_ptr(), rec.stride(0),
                beta_slot, out[g0].data_ptr(), mp, a_bits, next_bits, g1 - g0, _cuda.stream(),
            )
        _cuda.check(err, "qzk_fri_fold")
        launches += 1
    return out, launches


fold_round.launches = 0
fold_round_batch.launches = 0


# ---------------------------------------------------------------------------
# kernel F: the query gather

#: kernel F's plan (csrc/fri.cu GatherPlan) travels by value in the kernel's
#: parameters: at most this many segments and query indices a proof, 16-bit
#: segment offsets and widths, 32-bit strides; the indices, below 2^32, lie
#: on the card, a pointer a proof. Its GATHER_PLAN_BYTES hold one proof at
#: both limits, or several proofs of a batch, which share the segments'
#: shapes (`gather_group`)
MAX_GATHER_SEGMENTS = 128
MAX_GATHER_QUERIES = 128
MAX_GATHER_WIDTH = (1 << 16) - 1
_PLAN_HEAD = struct.Struct("<Q4i")  # out, queries, segments, row width, proofs
_PLAN_SHAPE = struct.Struct("<iiHHBBBB")  # strides, offset, width, mask bits, shift, flip, levels
GATHER_PLAN_BYTES = (_PLAN_HEAD.size + (8 + _PLAN_SHAPE.size) * MAX_GATHER_SEGMENTS
                     + 4 * MAX_GATHER_QUERIES)


def _plan_bytes(proofs: int, segments: int) -> int:
    """A plan's bytes: the header, each proof's source addresses, the
    segments' shapes, each proof's index-vector address."""
    return _PLAN_HEAD.size + (8 * proofs + _PLAN_SHAPE.size) * segments + 8 * proofs


def gather_group(segments: int) -> int:
    """The most proofs of `segments` segments one kernel-F plan holds (at
    most PROOFS_PER_LAUNCH): sixteen leaf proofs (10 segments) take 1,592 of
    its 3,608 bytes, sixteen of the degree-16 tail's (14) 2,168."""
    fits = (GATHER_PLAN_BYTES - _PLAN_HEAD.size - _PLAN_SHAPE.size * segments) // (
        8 * segments + 8)
    return max(1, min(_cuda.PROOFS_PER_LAUNCH, fits))


class GatherSource(NamedTuple):
    """Rows of `matrix` (R, W) picked by a query index q: row
    ((q & mask) >> shift) ^ flip. Strided matrices are read in place.

    With `levels` = L > 0, a Merkle path instead: `matrix` is level 0 of a
    tree's digests, (mask + 1, 4), and levels 1..L-1 follow it in the same
    buffer (`poseidon2.merkle_levels`' layout); level l gives the digest
    ((q & mask) >> l) ^ flip, 4 L values in all."""

    matrix: torch.Tensor
    mask: int
    shift: int = 0
    flip: int = 0
    levels: int = 0


def _path_level(s: GatherSource, level: int) -> torch.Tensor:
    """Level `level` of a path source's tree, a view of the same buffer."""
    n0 = s.matrix.shape[0]
    rs, cs = s.matrix.stride()
    return s.matrix.as_strided((n0 >> level, 4), (rs, cs),
                               s.matrix.storage_offset() + rs * (2 * n0 - (2 * n0 >> level)))


def query_gather_plain(sources: list[GatherSource], indices) -> torch.Tensor:
    """Plain torch version of `query_gather` (same arguments; the indices
    host values or an int64 tensor): the rows as an int64 tensor on the
    sources' device."""
    q = torch.as_tensor(np.asarray(indices, dtype=np.int64) if not isinstance(
        indices, torch.Tensor) else indices, device=sources[0].matrix.device)
    parts = []
    for s in sources:
        if s.levels:
            parts += [_path_level(s, l)[((q & s.mask) >> l) ^ s.flip] for l in range(s.levels)]
        else:
            parts.append(s.matrix[((q & s.mask) >> s.shift) ^ s.flip])
    return torch.cat(parts, dim=1)


def _gather_segment(s: GatherSource) -> tuple[int, tuple]:
    """A source's address and its plan segment's shape (strides, width,
    mask bits, shift, flip, levels); raises on what kernel F cannot read."""
    mat, mask, shift, flip, levels = s.matrix, s.mask, s.shift, s.flip, s.levels
    if mat.dim() != 2:
        raise ValueError("a gather source is not a matrix")
    rows, w = mat.shape
    rs, cs = mat.stride()
    if (mask < 0 or mask & (mask + 1) or mask >> 32 or not 0 <= shift < 32
            or not 0 <= flip < 256 or (mask >> shift) | flip >= rows or w < 1):
        raise ValueError(f"gather rule (mask {mask}, shift {shift}, flip {flip}) on "
                         f"{rows} rows: kernel F takes masks 2^k - 1 (k <= 32), shifts "
                         "below 32, flips below 256, rows within the matrix")
    if levels:
        # level 0 of 2^k digests, the levels above it in the same buffer
        if (w != 4 or shift or rows != mask + 1 or not 0 < levels < mask.bit_length() + 1
                or mat.untyped_storage().nbytes() < 8 * (
                    mat.storage_offset() + rs * (2 * rows - (2 * rows >> levels)))):
            raise ValueError(f"a Merkle path of {levels} levels over {rows} digests of "
                             f"{w} values: kernel F takes 2^k digest rows of 4 values, "
                             "at most k levels, all in the matrix's buffer")
        w = 4 * levels
    if rs >> 31 or cs >> 31:
        raise ValueError(f"gather strides {rs, cs} do not fit 32 bits")
    return mat.data_ptr(), (rs, cs, w, mask.bit_length(), shift, flip, levels)


class GatherPlanBytes(bytearray):
    """Kernel F's plan bytes, holding on to the index tensor they point at."""

    indices: torch.Tensor


def pack_gather_plan(sources: list[GatherSource], indices) -> tuple[bytearray, int]:
    """Kernel F's plan (csrc/fri.cu GatherPlan) for one proof as the bytes of
    its kernel parameter, and the packed row's width: `pack_gather_plan_batch`
    of one proof."""
    if isinstance(indices, torch.Tensor):
        return pack_gather_plan_batch([sources], indices.reshape(1, -1))
    return pack_gather_plan_batch([sources], [indices])


def pack_gather_plan_batch(sources_k: list, indices_k) -> tuple[bytearray, int]:
    """Kernel F's plan for K proofs of one shape as the bytes of its kernel
    parameter: the output address (0 until the launch sets it), the counts,
    each proof's source addresses, a 16-byte shape a segment in packed-row
    order (the same for every proof), each proof's index-vector address;
    and the packed row's width. `indices_k`: a (K, Q) int64 tensor of
    indices below 2^32 (on the card for a launch: the fused prover's, drawn
    there), or host lists, put into one such tensor on the sources' device;
    the plan (a `GatherPlanBytes`) holds it. Raises on what the kernel
    cannot read and above its capacity: there is no other path. One pass
    over the sources: this runs on every batch."""
    k = len(sources_k)
    n = len(sources_k[0]) if k else 0
    nq = len(indices_k[0]) if len(indices_k) else 0
    if not 1 <= n <= MAX_GATHER_SEGMENTS or not 1 <= nq <= MAX_GATHER_QUERIES:
        raise ValueError(f"{n} gather segments and {nq} queries: kernel F's plan holds 1 to "
                         f"{MAX_GATHER_SEGMENTS} and 1 to {MAX_GATHER_QUERIES}")
    if (not 1 <= k <= _cuda.PROOFS_PER_LAUNCH or len(indices_k) != k
            or any(len(s) != n for s in sources_k) or any(len(i) != nq for i in indices_k)):
        raise ValueError(f"{k} proofs' sources and {len(indices_k)} index lists: kernel F "
                         f"takes 1 to {_cuda.PROOFS_PER_LAUNCH} proofs of one plan's shape")
    if _plan_bytes(k, n) > GATHER_PLAN_BYTES:
        raise ValueError(f"{k} proofs of {n} segments: kernel F's plan holds "
                         f"{GATHER_PLAN_BYTES} bytes")
    if not isinstance(indices_k, torch.Tensor):
        host = np.asarray(indices_k, dtype=np.int64)
        if host.size and (host.min() < 0 or host.max() >> 32):
            raise ValueError("kernel F takes query indices below 2^32")
        indices_k = torch.as_tensor(host, device=sources_k[0][0].matrix.device)
    if indices_k.shape != (k, nq) or indices_k.dtype != torch.int64 or not indices_k.is_contiguous():
        raise ValueError(f"query indices {tuple(indices_k.shape)}, expected a contiguous int64 "
                         f"{(k, nq)}")
    buf = GatherPlanBytes(GATHER_PLAN_BYTES)
    buf.indices = indices_k
    shapes = None
    for j, sources in enumerate(sources_k):
        own = []
        for i, s in enumerate(sources):
            ptr, shape = _gather_segment(s)
            struct.pack_into("<Q", buf, _PLAN_HEAD.size + 8 * (j * n + i), ptr)
            own.append(shape)
        if shapes is None:
            shapes = own
        elif own != shapes:
            raise ValueError("the proofs' gather sources differ in shape")
    at, width = _PLAN_HEAD.size + 8 * k * n, 0
    for i, (rs, cs, w, bits, shift, flip, levels) in enumerate(shapes):
        if width + w > MAX_GATHER_WIDTH:
            raise ValueError(f"packed row above {MAX_GATHER_WIDTH} values: kernel F's plan "
                             "holds no more")
        _PLAN_SHAPE.pack_into(buf, at + _PLAN_SHAPE.size * i, rs, cs, width, w, bits, shift,
                              flip, levels)
        width += w
    _PLAN_HEAD.pack_into(buf, 0, 0, nq, n, width, k)
    struct.pack_into(f"<{k}Q", buf, at + _PLAN_SHAPE.size * n,
                     *(indices_k[j].data_ptr() for j in range(k)))
    return buf, width


def query_gather_packed_plain(plan: bytes, memory: list[torch.Tensor]) -> torch.Tensor:
    """Plain version of kernel F reading a packed plan (`pack_gather_plan`,
    `pack_gather_plan_batch`), for the tests: each value and each query
    index is read from the CPU tensors in `memory` (and the plan's own index
    tensor, when it is a `GatherPlanBytes`) at the plan's addresses, strides
    and path levels, as the kernel reads it; (proofs x queries, width) rows.
    Checks the plan as the kernel's entry does."""
    _, queries, segments, width, proofs = _PLAN_HEAD.unpack_from(plan, 0)
    if not (1 <= queries <= MAX_GATHER_QUERIES and 1 <= segments <= MAX_GATHER_SEGMENTS
            and 1 <= proofs <= _cuda.PROOFS_PER_LAUNCH
            and _plan_bytes(proofs, segments) <= len(plan)):
        raise ValueError("plan counts out of range")
    at = _PLAN_HEAD.size + 8 * proofs * segments
    stores = []
    for t in list(memory) + ([plan.indices] if isinstance(plan, GatherPlanBytes) else []):
        st = t.untyped_storage()
        stores.append((st.data_ptr(), st.nbytes(), torch.empty(0, dtype=torch.int64).set_(st)))

    def find(ptr):
        return next(st for st in stores if st[0] <= ptr < st[0] + st[1])

    q = torch.empty((proofs, queries), dtype=torch.int64)
    for p, ptr in enumerate(struct.unpack_from(f"<{proofs}Q", plan,
                                               at + _PLAN_SHAPE.size * segments)):
        base, _, flat = find(ptr)
        q[p] = flat[(ptr - base) // 8 : (ptr - base) // 8 + queries] & 0xFFFFFFFF
    out = torch.empty((proofs * queries, width), dtype=torch.int64)
    end = 0
    for i in range(segments):
        rs, cs, off, w, bits, shift, flip, levels = _PLAN_SHAPE.unpack_from(
            plan, at + _PLAN_SHAPE.size * i)
        if off != end or w < 1 or bits > 32 or (levels and (w != 4 * levels or shift)):
            raise ValueError(f"plan segment {i} is malformed")
        end += w
        col = torch.arange(w)
        level = col // 4 if levels else torch.zeros_like(col)
        j = col % 4 if levels else col
        n0 = 1 << bits
        before = (2 * n0 - (2 * n0 >> level)) * rs  # rows below the level; 0 at level 0
        for p in range(proofs):
            (src,) = struct.unpack_from("<Q", plan, _PLAN_HEAD.size + 8 * (p * segments + i))
            base, _, flat = find(src)
            rows = ((q[p, :, None] & (n0 - 1)) >> (shift + level)[None, :]) ^ flip
            out[p * queries : (p + 1) * queries, off : off + w] = flat[
                (src - base) // 8 + before + rows * rs + j * cs]
    if end != width:
        raise ValueError("plan segments do not cover the packed row")
    return out


#: kernel F's pinned host buffers, one a (proofs, queries, width) shape of
#: a whole call: each launch writes its group's rows at their offset
_pinned: dict = {}


def _upload_indices(sources_k, indices_k) -> torch.Tensor:
    """K proofs' host query indices as one (K, Q) int64 tensor on the
    sources' device, one copy."""
    host = np.asarray(indices_k, dtype=np.int64)
    if host.size and (host.min() < 0 or host.max() >> 32):
        raise ValueError("kernel F takes query indices below 2^32")
    return torch.as_tensor(host, device=sources_k[0][0].matrix.device)


def query_gather(sources: list[GatherSource], indices, out: torch.Tensor | None = None):
    """For each query index, the picked rows of every source side by side:
    (Q, sum of widths). The indices: an int64 vector below 2^32 on the
    sources' device (the fused prover's transcript draws them there), or
    host values, uploaded in one copy (the staged prover's). The rows go
    into `out` on the device when it is given (the fused proof's packed
    output), else into a pinned host buffer (one a shape), returned as a
    uint64 array after a synchronize of the stream. On CUDA sources: kernel
    F (csrc/fri.cu), one launch, its plan passed by value. On CPU sources:
    the plain version. Raises above the plan's capacity on either."""
    if not sources or all(s.matrix.device.type == "cpu" for s in sources):
        _, width = pack_gather_plan(sources, indices)  # the kernel's limits hold here too
        rows = query_gather_plain(sources, indices)
        if out is None:
            return gl.to_u64(rows)
        _gather_out(out, (1, len(indices), width))
        return out.copy_(rows)
    if not isinstance(indices, torch.Tensor):
        indices = _upload_indices([sources], [indices])[0]
    _cuda.require_cuda_int64(indices, *(s.matrix for s in sources),
                             *(() if out is None else (out,)))
    packed, launches = _gather_launches([sources], indices.reshape(1, -1),
                                        out=None if out is None else out.unsqueeze(0))
    query_gather.launches += launches
    return packed[0]


def query_gather_batch(sources_k: list, indices, out: torch.Tensor | None = None):
    """`query_gather` for K proofs whose sources have one shape (a batch's
    oracles and FRI layers), each with its own query indices: (K, Q) int64
    on the sources' device (the fused batch's transcripts draw them there),
    or host values, uploaded in one copy (the staged batch's). The rows go
    into `out` (K, Q, sum of widths) on the device when it is given (the
    fused batch's packed output), else into one pinned host buffer,
    returned as a uint64 array after a synchronize of the stream. On CUDA
    sources: kernel F with a proof axis, one launch for as many proofs as a
    plan holds (`gather_group`: at most PROOFS_PER_LAUNCH, sixteen leaf
    proofs). On CPU sources: the plain version, the kernel's limits checked
    alike."""
    k = len(sources_k)
    groups = _cuda.proof_groups(k, gather_group(len(sources_k[0])))
    if all(s.matrix.device.type == "cpu" for sources in sources_k for s in sources):
        for g0, g1 in groups:
            _, width = pack_gather_plan_batch(sources_k[g0:g1], indices[g0:g1])
        rows = torch.stack([query_gather_plain(s, i) for s, i in zip(sources_k, indices)])
        if out is None:
            return gl.to_u64(rows)
        _gather_out(out, (k, len(indices[0]), width))
        return out.copy_(rows)
    if not isinstance(indices, torch.Tensor):
        indices = _upload_indices(sources_k, indices)
    _cuda.require_cuda_int64(indices, *(s.matrix for sources in sources_k for s in sources),
                             *(() if out is None else (out,)))
    packed, launches = _gather_launches(sources_k, indices, groups, out=out)
    query_gather_batch.launches += launches
    return packed


def _gather_out(out: torch.Tensor, shape: tuple) -> None:
    if tuple(out.shape)[-2:] != shape[-2:] or out.numel() != np.prod(shape) or \
            not out.is_contiguous():
        raise ValueError(f"gather output {tuple(out.shape)}, expected a contiguous {shape[-2:]} "
                         f"a proof")


def _gather_launches(sources_k, indices: torch.Tensor, groups=((0, 1),), out=None):
    """Kernel F a group of proofs, the (K, Q) int64 indices on the sources'
    device, all into `out` (K, Q, width) on the device, or else into one
    pinned (K, Q, width) buffer, each group's launch at its first proof's
    rows; into pinned memory, one synchronize and one copy out of the
    buffer, which the next call of that shape reuses. Returns ((K, Q, width)
    host rows, or `out`; launches)."""
    host = out
    dev = sources_k[0][0].matrix.device
    for g0, g1 in groups:
        plan, width = pack_gather_plan_batch(sources_k[g0:g1], indices[g0:g1])
        if out is not None:
            _gather_out(out, (len(sources_k), indices.shape[1], width))
        elif host is None:
            key = (len(sources_k), indices.shape[1], width)
            if key not in _pinned:
                _pinned[key] = torch.empty(key, dtype=torch.int64, pin_memory=True)
            host = _pinned[key]
        struct.pack_into("<Q", plan, 0, host[g0].data_ptr())
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_query_gather(bytes(plan), _cuda.stream())
        _cuda.check(err, "qzk_query_gather")
    if out is not None:
        return out, len(groups)
    torch.cuda.current_stream(dev).synchronize()
    return host.numpy().view(np.uint64).copy(), len(groups)


query_gather.launches = 0
query_gather_batch.launches = 0


def _sibling_sources(tree: merkle.MerkleTree, mask: int) -> list[GatherSource]:
    """A Merkle path as one source: level l's sibling of leaf q is digest
    (q >> l) ^ 1, for every level below the cap (the levels lie one after
    another in one buffer; raises if they do not)."""
    levels = len(tree.digests) - 1
    if not levels:
        return []
    first = tree.digests[0]
    n0 = first.shape[0]
    if tree.digests[-1].data_ptr() != first.data_ptr() + 8 * first.stride(0) * (
            2 * n0 - (2 * n0 >> levels)):
        raise ValueError("the tree's digest levels are not one buffer")
    return [GatherSource(first, mask, flip=1, levels=levels)]


def _gather_sources(oracles, layers) -> list[GatherSource]:
    """Kernel F's sources of a proof's queries: the oracles' leaf rows (a
    salted oracle's with its salt, the width `lde.shape[0]`) and Merkle
    paths, then per FRI round the leaf and its path."""
    m0 = oracles[0].lde.shape[1]
    sources = [GatherSource(o.lde.T, m0 - 1) for o in oracles]
    for o in oracles:
        sources += _sibling_sources(o.tree, m0 - 1)
    for leaves, tree in layers:
        mask = leaves.shape[0] - 1  # q mod m' of the round
        sources.append(GatherSource(leaves, mask))
        sources += _sibling_sources(tree, mask)
    return sources


def _query_rounds(packed: np.ndarray, oracles, layers) -> list[FriQueryRound]:
    """A proof's (Q, width) gathered rows cut into views a segment group at
    a time."""
    q = packed.shape[0]
    widths = [o.lde.shape[0] for o in oracles]
    widths += [4 * (len(o.tree.digests) - 1) for o in oracles]
    for leaves, tree in layers:
        widths += [leaves.shape[1], 4 * (len(tree.digests) - 1)]
    cuts = np.cumsum([0] + widths)
    part = [packed[:, cuts[i] : cuts[i + 1]] for i in range(len(widths))]
    nor = len(oracles)
    rows = zip(*part[:nor])
    sibs = zip(*(p.reshape(q, -1, 4) for p in part[nor : 2 * nor]))
    steps = [[FriQueryStep(leaf_values=lv, siblings=sb) for lv, sb in zip(
        part[2 * nor + 2 * li].reshape(q, -1, 2), part[2 * nor + 2 * li + 1].reshape(q, -1, 4))]
        for li in range(len(layers))]
    return [FriQueryRound(initial_rows=list(r), initial_siblings=list(s),
                          steps=[st[i] for st in steps])
            for i, (r, s) in enumerate(zip(rows, sibs))]


def gather_query_rounds(oracles, layers, indices) -> list[FriQueryRound]:
    """Every query's opening: the oracles' leaf rows and Merkle paths, then
    per FRI round the leaf and its path (`_gather_sources`). `layers`:
    (leaves, tree) per round. One kernel-F gather into pinned host memory,
    then the host cuts the (Q, width) rows into views a segment group at a
    time."""
    return _query_rounds(query_gather(_gather_sources(oracles, layers), indices), oracles, layers)


def gather_query_rounds_batch(oracles_k, layers_k, indices_k) -> list[list[FriQueryRound]]:
    """`gather_query_rounds` for K proofs of one circuit, each with its own
    query indices: one kernel-F gather a group of proofs (sixteen leaf
    proofs a launch) and one transfer, then each proof's rows cut alike."""
    packed = query_gather_batch([_gather_sources(o, l) for o, l in zip(oracles_k, layers_k)],
                                indices_k)
    return [_query_rounds(p, o, l) for p, o, l in zip(packed, oracles_k, layers_k)]


# ---------------------------------------------------------------------------
# main prover entry


@dataclass
class FriCommitment:
    """What FRI's commit phase leaves for the grind and the queries: each
    round's (leaf rows, tree) and cap, and the final polynomial."""

    layers: list
    caps: list
    final_poly: np.ndarray


def fri_commit_phase(
    oracles: list[PolynomialBatch],
    instance: FriInstance,
    openings: list[np.ndarray],
    challenger: ts.Challenger,
    config: FriConfig,
    degree_bits: int,
) -> FriCommitment:
    """FRI's first phase: the composition (kernel C), each round's tree, cap
    and fold (kernel E), and the final polynomial (a kernel-3 iNTT), with
    the transcript's alpha, betas and the final polynomial observed."""
    alpha = challenger.challenge_ext()
    lde_bits = degree_bits + config.rate_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    arities = list(schedule) + [0]  # each layer's leaf arity; the last is natural order
    dev = oracles[0].lde.device
    ys, rec = composition_inputs([instance], [openings], [alpha], dev)
    layer = compute_composition(oracles, tuple(b.polys for b in instance.batches), ys[0], rec[0],
                                lde_bits, arities[0])

    caps = []
    layers = []
    log_m = lde_bits
    shift_pow = 0  # current coset shift is g^(2^shift_pow)
    for r, a_bits in enumerate(schedule):
        cap_h = min(config.cap_height, log_m - a_bits)
        tree = merkle.build_merkle_tree(layer, cap_h)
        layers.append((layer, tree))
        caps.append(tree.cap)
        challenger.observe_cap(tree.cap)
        beta = challenger.challenge_ext()
        layer = fold_round(layer, beta_records(dev, [beta])[0], ts.REC_FRI_BETA, a_bits, log_m,
                           shift_pow, arities[r + 1])
        log_m -= a_bits
        shift_pow += a_bits

    # final polynomial: coset-iNTT of the remaining values, unshift folded in
    final_shift = F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << shift_pow)
    coeffs = ntt.batched_ntt(layer.T, log_m, inverse=True, out_shift=int(F.inv(final_shift)))
    final_poly = _final_poly(gl.to_u64(coeffs.T), config, degree_bits)  # (len, 2)
    challenger.observe_many(final_poly)
    return FriCommitment(layers=layers, caps=caps, final_poly=final_poly)


def fri_query_phase(
    oracles: list[PolynomialBatch],
    commitment: FriCommitment,
    pow_witness: np.uint64,
    challenger: ts.Challenger,
    config: FriConfig,
    degree_bits: int,
) -> FriProof:
    """FRI's last phase, after the grind: the PoW witness observed and its
    response checked, the query indices drawn, and every opening of every
    query in one gather and one transfer (kernel F)."""
    challenger.observe(pow_witness)
    pow_response = challenger.challenge()
    if int(pow_response) >= 1 << (64 - config.proof_of_work_bits):
        raise AssertionError("PoW response above the grind threshold")
    m0 = 1 << (degree_bits + config.rate_bits)
    indices = [challenger.challenge_index(m0) for _ in range(config.num_query_rounds)]
    return FriProof(
        commit_caps=commitment.caps,
        final_poly=commitment.final_poly,
        pow_witness=pow_witness,
        query_rounds=gather_query_rounds(oracles, commitment.layers, indices),
    )


def _final_poly(coeffs: np.ndarray, config: FriConfig, degree_bits: int) -> np.ndarray:
    """The final polynomial's first coefficients, (len, 2), after its degree
    check: `_final_len`."""
    final_len = _final_len(config, degree_bits)
    if np.any(coeffs[final_len:]):
        raise AssertionError("final poly exceeds degree bound")
    return coeffs[:final_len]


def _final_len(config: FriConfig, degree_bits: int) -> int:
    """The final polynomial's length: the honest degree bound after folding
    (below 2^final_poly_bits for tiny circuits)."""
    schedule = config.reduction_strategy.schedule(degree_bits)
    return min(1 << config.reduction_strategy.final_poly_bits,
               1 << (degree_bits - sum(schedule)))


def fri_commit_phase_fused(oracles, polys_per_batch, ys, rec, challenger: ts.DeviceChallenger,
                           config: FriConfig, degree_bits: int, caps_out: list,
                           final_out: torch.Tensor) -> list:
    """`fri_commit_phase` on the fused prover's path, nothing read back:
    kernel C from the claimed openings `ys` and the record `rec` (alpha
    drawn there already), then a round at a time the tree, its cap observed
    straight from the tree's level (and copied into `caps_out[r]`) with the
    round's beta drawn into the record by kernel I, kernel E's fold reading
    it; the final iNTT into `final_out` (2, m_f), its first coefficients
    observed there. The degree check waits for the download (`_final_poly`
    on the unpacked output). Returns the rounds' (leaves, tree)."""
    lde_bits = degree_bits + config.rate_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    arities = list(schedule) + [0]
    layer = compute_composition(oracles, polys_per_batch, ys, rec, lde_bits, arities[0])
    layers = []
    log_m, shift_pow = lde_bits, 0
    for r, a_bits in enumerate(schedule):
        tree = merkle.build_merkle_tree(layer, min(config.cap_height, log_m - a_bits),
                                        host_cap=False)
        layers.append((layer, tree))
        slot = ts.REC_FRI_BETA + 2 * r
        challenger.segment(observe=[(tree.digests[-1], caps_out[r].view(-1))],
                           squeeze=[(rec[slot : slot + 2], 0)])
        layer = fold_round(layer, rec, slot, a_bits, log_m, shift_pow, arities[r + 1])
        log_m -= a_bits
        shift_pow += a_bits
    final_shift = F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << shift_pow)
    ntt.batched_ntt(layer.T, log_m, inverse=True, out_shift=int(F.inv(final_shift)), out=final_out)
    challenger.segment(observe=[(final_out[:, : _final_len(config, degree_bits)].T, None)])
    return layers


def fri_query_phase_fused(oracles, layers, challenger: ts.DeviceChallenger, config: FriConfig,
                          degree_bits: int, grind_words: torch.Tensor, pow_out: torch.Tensor,
                          indices_out: torch.Tensor, rows_out: torch.Tensor) -> None:
    """`fri_query_phase` (and the grind before it) on the fused prover's
    path, nothing read back: kernel J from the transcript's state into
    `grind_words` ((0, -1) before; a witness of 0 at 0 PoW bits), kernel I
    observing the witness into pow_out[0] and drawing its response into
    pow_out[1] and the query indices into `indices_out`, and kernel F
    gathering every query's rows and paths by those indices into `rows_out`
    (queries, width). The response is checked on the unpacked output."""
    if config.proof_of_work_bits:
        challenger.grind(config.proof_of_work_bits, grind_words)
    challenger.segment(observe=[(grind_words[1:], pow_out[:1])],
                       squeeze=[(pow_out[1:], 0),
                                (indices_out, degree_bits + config.rate_bits)])
    query_gather(_gather_sources(oracles, layers), indices_out, rows_out)


def fri_commit_phase_fused_batch(oracles_k, polys_per_batch, ys, rec,
                                 challengers: ts.DeviceChallengerBatch, config: FriConfig,
                                 degree_bits: int, caps_out: list, final_out: torch.Tensor) -> list:
    """`fri_commit_phase_fused` for K proofs of one circuit (the fused
    batch's), nothing read back: kernel C from the claimed openings ys (K,
    terms, 2) and the records rec (K, REC_WORDS), a launch a group of
    PROOFS_PER_LAUNCH proofs; then a round at a time one forest for the K
    layers, whose K caps kernel I observes in one launch straight from the
    forest's buffer (copying them into caps_out[r], (K, cap * 4)) while
    drawing the K betas into the records, and kernel E's folds reading
    them; one stacked final iNTT of the K layers into final_out (K, 2, m_f),
    whose first coefficients kernel I absorbs there. Returns each round's
    (leaves (K, m', 2^(a+1)), K trees)."""
    k = len(oracles_k)
    lde_bits = degree_bits + config.rate_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    arities = list(schedule) + [0]
    layer = compute_composition_batch(oracles_k, polys_per_batch, ys, rec, lde_bits, arities[0])
    rounds = []
    log_m, shift_pow = lde_bits, 0
    for r, a_bits in enumerate(schedule):
        trees = merkle.build_merkle_forest(layer, min(config.cap_height, log_m - a_bits),
                                           host_cap=False)
        rounds.append((layer, trees))
        slot = ts.REC_FRI_BETA + 2 * r
        challengers.segment(observe=[(merkle.forest_caps(trees), caps_out[r])],
                            squeeze=[(rec[:, slot : slot + 2], 0)])
        layer = fold_round_batch(layer, rec, slot, a_bits, log_m, shift_pow, arities[r + 1])
        log_m -= a_bits
        shift_pow += a_bits
    final_shift = F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << shift_pow)
    # (K, m_f, 2) natural order -> (2K, m_f) rows: proof i's c0, c1 at 2i, 2i + 1
    ntt.batched_ntt(layer.transpose(1, 2).reshape(2 * k, -1), log_m, inverse=True,
                    out_shift=int(F.inv(final_shift)), out=final_out.view(2 * k, -1))
    challengers.segment(observe=[(final_out[:, :, : _final_len(config, degree_bits)].transpose(1, 2),
                                  None)])
    return rounds


def fri_query_phase_fused_batch(oracles_k, rounds, challengers: ts.DeviceChallengerBatch,
                                config: FriConfig, degree_bits: int, grind_words: torch.Tensor,
                                pow_out: torch.Tensor, indices_out: torch.Tensor,
                                rows_out: torch.Tensor) -> list:
    """`fri_query_phase_fused` for K proofs (the fused batch's), nothing
    read back: kernel J's batch form grinds all K from their transcripts
    into grind_words (K, 2), each row (0, -1) before; kernel I observes the
    K witnesses into pow_out[:, 0] and draws the K responses into
    pow_out[:, 1] and the K x Q query indices into indices_out (K, Q) in
    one launch; kernel F gathers each proof's rows and paths by its indices
    into rows_out (K, Q, width), a launch a group of proofs. Returns each
    proof's FRI layers, (leaves, tree) a round."""
    if config.proof_of_work_bits:
        challengers.grind(config.proof_of_work_bits, grind_words)
    challengers.segment(observe=[(grind_words[:, 1:], pow_out[:, :1])],
                        squeeze=[(pow_out[:, 1:], 0),
                                 (indices_out, degree_bits + config.rate_bits)])
    layers_k = [[(leaves[i], trees[i]) for leaves, trees in rounds] for i in range(len(oracles_k))]
    query_gather_batch([_gather_sources(o, l) for o, l in zip(oracles_k, layers_k)],
                       indices_out, rows_out)
    return layers_k


def fri_commit_phase_batch(
    oracles_k: list,
    instances: list[FriInstance],
    openings_k: list,
    challengers: ts.ChallengerBatch,
    config: FriConfig,
    degree_bits: int,
) -> list[FriCommitment]:
    """`fri_commit_phase` for K proofs of one circuit, the K transcripts in
    lockstep: the composition (kernel C with a proof axis), each round's K
    trees (one kernel-2 forest call), caps observed and betas drawn for all
    K, the K folds (kernel E with a proof axis), and the K final
    polynomials (one stacked kernel-3 iNTT with the unshift folded in);
    each proof's degree bound checked. Returns each proof's commitment, its
    layers views of the round's stack."""
    k = len(oracles_k)
    alphas = challengers.challenge_ext()
    lde_bits = degree_bits + config.rate_bits
    schedule = config.reduction_strategy.schedule(degree_bits)
    arities = list(schedule) + [0]
    ys, rec = composition_inputs(instances, openings_k, alphas, oracles_k[0][0].lde.device)
    if len({tuple(b.polys for b in inst.batches) for inst in instances}) != 1:
        raise ValueError("the proofs' instances open other columns")
    layer = compute_composition_batch(oracles_k, tuple(b.polys for b in instances[0].batches), ys,
                                      rec, lde_bits, arities[0])
    layers, caps = [], []
    log_m, shift_pow = lde_bits, 0
    for r, a_bits in enumerate(schedule):
        trees = merkle.build_merkle_forest(layer, min(config.cap_height, log_m - a_bits))
        layers.append(list(zip(layer, trees)))
        caps.append([t.cap for t in trees])
        challengers.observe_cap(np.stack([t.cap for t in trees]))
        betas = challengers.challenge_ext()
        layer = fold_round_batch(layer, beta_records(layer.device, betas), ts.REC_FRI_BETA, a_bits,
                                 log_m, shift_pow, arities[r + 1])
        log_m -= a_bits
        shift_pow += a_bits
    final_shift = F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << shift_pow)
    # (K, m_f, 2) natural order -> (2K, m_f) rows: proof i's c0, c1 at 2i, 2i + 1
    coeffs = ntt.batched_ntt(layer.transpose(1, 2).reshape(2 * k, -1), log_m, inverse=True,
                             out_shift=int(F.inv(final_shift)))
    coeffs = gl.to_u64(coeffs.view(k, 2, -1).transpose(1, 2))  # (K, len, 2)
    finals = [_final_poly(c, config, degree_bits) for c in coeffs]
    challengers.observe_many(np.stack([f.ravel() for f in finals]))
    return [FriCommitment(layers=[rnd[i] for rnd in layers], caps=[c[i] for c in caps],
                          final_poly=finals[i]) for i in range(k)]


def fri_query_phase_batch(
    oracles_k: list,
    commitments: list[FriCommitment],
    pow_witnesses,
    challengers: ts.ChallengerBatch,
    config: FriConfig,
    degree_bits: int,
) -> list[FriProof]:
    """`fri_query_phase` for K proofs, the K transcripts in lockstep: the PoW
    witnesses observed and the responses checked, each proof's query
    indices drawn, and every opening of every query of every proof in one
    kernel-F gather a group of proofs (`gather_query_rounds_batch`)."""
    k = len(oracles_k)
    witnesses = np.asarray(pow_witnesses, dtype=np.uint64).reshape(k, 1)
    challengers.observe_many(witnesses)
    threshold = 1 << (64 - config.proof_of_work_bits)
    if any(int(r) >= threshold for r in challengers.challenge()):
        raise AssertionError("PoW response above the grind threshold")
    m0 = 1 << (degree_bits + config.rate_bits)
    indices = np.stack([challengers.challenge_index(m0)
                        for _ in range(config.num_query_rounds)], axis=1)  # (K, queries)
    rounds = gather_query_rounds_batch(oracles_k, [c.layers for c in commitments],
                                       indices.tolist())
    return [FriProof(commit_caps=c.caps, final_poly=c.final_poly, pow_witness=w,
                     query_rounds=r)
            for c, w, r in zip(commitments, witnesses[:, 0], rounds)]


def fri_prove(
    oracles: list[PolynomialBatch],
    instance: FriInstance,
    openings: list[np.ndarray],
    challenger: ts.Challenger,
    config: FriConfig,
    degree_bits: int,
) -> FriProof:
    """FRI for one proof: the commit phase, the proof-of-work grind, the
    queries. A batch of proofs runs each phase for all its proofs before
    the next (plonk/prover.py::prove_from_traces), so the grind is one."""
    commitment = fri_commit_phase(oracles, instance, openings, challenger, config, degree_bits)
    pow_witness = ts.grind_pow(challenger, config.proof_of_work_bits, oracles[0].lde.device)
    return fri_query_phase(oracles, commitment, pow_witness, challenger, config, degree_bits)
