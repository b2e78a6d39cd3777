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

Host keeps: transcript, the beta powers, query assembly.
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
from .oracle import PolynomialBatch

#: kernel C reads at most this many oracles and batches (opening points),
#: and stages at most this many terms in a block's shared memory
MAX_ORACLES = 8
MAX_BATCHES = 4
MAX_TERMS = 4096
#: kernel E folds at most 2^4 values a leaf row in a round
MAX_ARITY_BITS = 4


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


def _composition_limits(oracles, instance: FriInstance, lde_bits: int, arity_bits: int) -> None:
    m = 1 << lde_bits
    if not 1 <= len(oracles) <= MAX_ORACLES or not 1 <= len(instance.batches) <= MAX_BATCHES:
        raise ValueError(
            f"{len(oracles)} oracles and {len(instance.batches)} batches: kernel C takes "
            f"1..{MAX_ORACLES} and 1..{MAX_BATCHES}"
        )
    if any(o.lde.dim() != 2 or o.lde.shape[1] != m for o in oracles):
        raise ValueError(f"an oracle's LDE is not (C, {m})")
    if any(not b.polys for b in instance.batches):
        raise ValueError("a batch opens no polynomial")
    terms = _term_table(tuple(b.polys for b in instance.batches))
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} terms: kernel C takes at most {MAX_TERMS}")
    rows = np.array([o.lde.shape[0] for o in oracles])
    if terms[:, 0].min() < 0 or terms[:, 0].max() >= len(oracles) or \
            (terms[:, 1] < 0).any() or (terms[:, 1] >= rows[terms[:, 0]]).any():
        raise ValueError("the instance names a column outside the oracles")
    if not 0 <= arity_bits <= min(MAX_ARITY_BITS, lde_bits):
        raise ValueError(f"arity bits {arity_bits} outside 0..{MAX_ARITY_BITS}")


def compute_composition_plain(
    oracles: list[PolynomialBatch],
    instance: FriInstance,
    openings: list[np.ndarray],
    alpha: np.ndarray,
    lde_bits: int,
    arity_bits: int = 0,
) -> torch.Tensor:
    """Plain torch version of `compute_composition` (same arguments)."""
    _composition_limits(oracles, instance, lde_bits, arity_bits)
    dev = oracles[0].lde.device
    xs = gl.from_u64(_domain_points(lde_bits), dev)
    term = 0
    q = None
    for b_idx, batch in enumerate(instance.batches):
        k = len(batch.polys)
        apows = ext.powers_table(np.asarray(alpha, dtype=np.uint64), term + k)[term:]
        term += k
        y = np.asarray(openings[b_idx], dtype=np.uint64).reshape(k, 2)
        c_b = gl.from_u64(ext.sum_axis0(ext.mul(apows, y)), dev)
        cols = torch.stack([oracles[oi].lde[pj] for oi, pj in batch.polys])  # (k, m)
        ja = gl.from_u64(apows, dev)  # (k, 2)
        # S_b(x) = sum_k alpha^k p_k(x): weighted column sum
        s_b = torch.stack([
            gl.sum_tree(gl.mul(cols, ja[:, 0:1]), 0),
            gl.sum_tree(gl.mul(cols, ja[:, 1:2]), 0),
        ], dim=-1)  # (m, 2)
        z0 = gl.felt(batch.point[0], dev)
        z1 = gl.felt(batch.point[1], dev)
        xz = torch.stack([gl.sub(xs, z0), gl.neg(z1).expand_as(xs)], dim=-1)
        contrib = ext.j_mul(gl.sub(s_b, c_b), ext.j_inv(xz))
        q = contrib if q is None else gl.add(q, contrib)
    return _regroup_leaves(q, arity_bits)


def compute_composition(
    oracles: list[PolynomialBatch],
    instance: FriInstance,
    openings: list[np.ndarray],
    alpha: np.ndarray,
    lde_bits: int,
    arity_bits: int = 0,
) -> torch.Tensor:
    """Q over the full LDE domain, as the (m >> a, 2^(a+1)) leaf rows of a
    first FRI round of arity 2^a (a = 0: natural order, (m, 2)).

    openings: per batch, (K_b, 2) claimed values for the batch's polys. On
    CUDA LDEs: kernel C (csrc/fri.cu), one launch that also forms the alpha
    powers and the batches' c_b, the claimed values uploaded once. On CPU
    LDEs: the plain version."""
    _composition_limits(oracles, instance, lde_bits, arity_bits)
    if oracles[0].lde.device.type == "cpu":
        return compute_composition_plain(oracles, instance, openings, alpha, lde_bits, arity_bits)
    _cuda.require_cuda_int64(*(o.lde for o in oracles))
    out, launches = _composition_launches([oracles], [instance], [openings], [alpha], lde_bits,
                                          arity_bits)
    compute_composition.launches += launches
    return out[0]


def _composition_batch_limits(oracles_k, instances, openings_k, alphas, lde_bits, arity_bits):
    k = len(oracles_k)
    if not k or len(instances) != k or len(openings_k) != k or len(alphas) != k:
        raise ValueError(f"{k} proofs' oracles for {len(instances)} instances, "
                         f"{len(openings_k)} openings and {len(alphas)} alphas")
    if len({tuple(tuple(o.lde.shape) for o in oracles) for oracles in oracles_k}) != 1:
        raise ValueError("the proofs' oracles differ in shape")
    if len({tuple(b.polys for b in inst.batches) for inst in instances}) != 1:
        raise ValueError("the proofs' instances open other columns")
    _composition_limits(oracles_k[0], instances[0], lde_bits, arity_bits)


def compute_composition_batch_plain(oracles_k, instances, openings_k, alphas, lde_bits: int,
                                    arity_bits: int = 0) -> torch.Tensor:
    """Plain torch version of `compute_composition_batch` (same arguments):
    `compute_composition_plain` a proof, stacked."""
    _composition_batch_limits(oracles_k, instances, openings_k, alphas, lde_bits, arity_bits)
    return torch.stack([compute_composition_plain(o, inst, op, al, lde_bits, arity_bits)
                        for o, inst, op, al in zip(oracles_k, instances, openings_k, alphas)])


def compute_composition_batch(oracles_k, instances, openings_k, alphas, lde_bits: int,
                              arity_bits: int = 0) -> torch.Tensor:
    """`compute_composition` for K proofs of one circuit: oracles_k[i],
    instances[i] (the same columns, each proof its own points),
    openings_k[i] and alphas[i] (K, 2) are proof i's. Returns the (K, m >>
    a, 2^(a+1)) stack of the proofs' first-round leaf rows.

    On CUDA LDEs: kernel C with a proof axis, one launch for at most
    PROOFS_PER_LAUNCH proofs, each proof's points and alpha by value, the
    claimed values uploaded in one copy. On CPU LDEs: the plain version."""
    _composition_batch_limits(oracles_k, instances, openings_k, alphas, lde_bits, arity_bits)
    if oracles_k[0][0].lde.device.type == "cpu":
        return compute_composition_batch_plain(oracles_k, instances, openings_k, alphas,
                                               lde_bits, arity_bits)
    _cuda.require_cuda_int64(*(o.lde for oracles in oracles_k for o in oracles))
    out, launches = _composition_launches(oracles_k, instances, openings_k, alphas, lde_bits,
                                          arity_bits)
    compute_composition_batch.launches += launches
    return out


def _composition_launches(oracles_k, instances, openings_k, alphas, lde_bits, arity_bits):
    """Kernel C over K proofs: ((K, m >> a, 2^(a+1)) leaf rows, launches)."""
    dev = oracles_k[0][0].lde.device
    m = 1 << lde_bits
    k = len(oracles_k)
    ldes = [[o.lde.contiguous() for o in oracles] for oracles in oracles_k]
    ptrs = np.array([[t.data_ptr() for t in proof] for proof in ldes], dtype=np.uint64)
    ys = np.stack([np.concatenate([np.asarray(y, dtype=np.uint64).reshape(-1, 2) for y in op])
                   for op in openings_k])  # (K, terms, 2)
    terms = instances[0].num_terms()
    if ys.shape[1] != terms:
        raise ValueError(f"{ys.shape[1]} claimed openings for {terms} terms")
    ends = np.cumsum([len(b.polys) for b in instances[0].batches])
    batches = np.array(
        [[[end, int(b.point[0]) % gl.P, int(b.point[1]) % gl.P]
          for end, b in zip(ends, inst.batches)] for inst in instances], dtype=np.uint64)
    alphas_h = np.ascontiguousarray(np.asarray(alphas, dtype=np.uint64).reshape(k, 2))
    ys_d = gl.from_u64(ys, dev)
    terms_d = _device_term_table(tuple(b.polys for b in instances[0].batches), dev)
    xs = _device_domain_points(lde_bits, dev)
    out = torch.empty((k, m >> arity_bits, 2 << arity_bits), dtype=torch.int64, device=dev)
    launches = 0
    for g0, g1 in _cuda.proof_groups(k):
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_fri_composition(
                ptrs[g0:g1].ctypes.data, ptrs.shape[1], terms_d.data_ptr(), ys_d[g0].data_ptr(),
                xs.data_ptr(), batches[g0:g1].ctypes.data, batches.shape[1],
                alphas_h[g0:g1].ctypes.data, out[g0].data_ptr(), m, arity_bits, g1 - g0,
                _cuda.stream(),
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


def _beta_powers(beta, a_bits: int) -> np.ndarray:
    """beta^(2^t) for t < a_bits, (a_bits, 2)."""
    out = []
    bt = np.asarray(beta, dtype=np.uint64).reshape(2).copy()
    for _ in range(a_bits):
        out.append(bt)
        bt = ext.mul(bt, bt)
    return np.array(out, dtype=np.uint64).reshape(a_bits, 2)


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


def fold_round_plain(leaves, beta, a_bits: int, log_m: int, shift_pow: int, next_bits: int = 0):
    """Plain torch version of `fold_round` (same arguments)."""
    _fold_limits(leaves, a_bits, log_m, next_bits)
    dev = leaves.device
    values = _ungroup_leaves(leaves, a_bits)
    for t, bt in enumerate(_beta_powers(beta, a_bits)):
        inv_x = gl.from_u64(_inv_x_table(log_m - t, shift_pow + t), dev)
        values = _fold_step(values, gl.from_u64(bt, dev), inv_x)
    return _regroup_leaves(values, next_bits)


def fold_round(leaves: torch.Tensor, beta, a_bits: int, log_m: int, shift_pow: int,
               next_bits: int = 0) -> torch.Tensor:
    """One FRI round's a binary folds of a layer of 2^log_m values over the
    coset g^(2^shift_pow) H, given as its (m', 2^(a+1)) leaf rows, with
    betas beta^(2^t). Returns the folded layer as the leaf rows of the next
    round, of arity 2^next_bits (0: natural order, (m', 2)).

    On a CUDA tensor: kernel E (csrc/fri.cu), one launch that forms the
    inverse twiddles on the card from a few constants passed by value
    (`_fold_consts`). On a CPU tensor: the plain version."""
    _fold_limits(leaves, a_bits, log_m, next_bits)
    if leaves.device.type == "cpu":
        return fold_round_plain(leaves, beta, a_bits, log_m, shift_pow, next_bits)
    _cuda.require_cuda_int64(leaves)
    out, launches = _fold_launches(leaves.unsqueeze(0), [beta], a_bits, log_m, shift_pow,
                                   next_bits)
    fold_round.launches += launches
    return out[0]


def _fold_batch_limits(leaves, betas, a_bits, log_m, next_bits) -> None:
    if leaves.dim() != 3 or not 1 <= leaves.shape[0] == len(betas):
        raise ValueError(f"a batch of layers is (K, m', 2^(a+1)) with K betas, got "
                         f"{tuple(leaves.shape)} and {len(betas)}")
    _fold_limits(leaves[0], a_bits, log_m, next_bits)


def fold_round_batch_plain(leaves, betas, a_bits: int, log_m: int, shift_pow: int,
                           next_bits: int = 0) -> torch.Tensor:
    """Plain torch version of `fold_round_batch` (same arguments):
    `fold_round_plain` a proof, stacked."""
    _fold_batch_limits(leaves, betas, a_bits, log_m, next_bits)
    return torch.stack([fold_round_plain(x, b, a_bits, log_m, shift_pow, next_bits)
                        for x, b in zip(leaves, betas)])


def fold_round_batch(leaves: torch.Tensor, betas, a_bits: int, log_m: int, shift_pow: int,
                     next_bits: int = 0) -> torch.Tensor:
    """`fold_round` for K proofs of one FRI schedule: leaves (K, m',
    2^(a+1)), betas (K, 2), each proof its own beta. Returns (K, m' >>
    next_bits, 2^(next_bits+1)).

    On a CUDA tensor: kernel E with a proof axis, one launch for at most
    PROOFS_PER_LAUNCH proofs, each proof's beta powers by value. On a CPU
    tensor: the plain version."""
    _fold_batch_limits(leaves, betas, a_bits, log_m, next_bits)
    if leaves.device.type == "cpu":
        return fold_round_batch_plain(leaves, betas, a_bits, log_m, shift_pow, next_bits)
    _cuda.require_cuda_int64(leaves)
    out, launches = _fold_launches(leaves, betas, a_bits, log_m, shift_pow, next_bits)
    fold_round_batch.launches += launches
    return out


def _fold_launches(leaves, betas, a_bits, log_m, shift_pow, next_bits):
    """Kernel E over K proofs' (K, m', 2^(a+1)) layers: (out, launches)."""
    dev = leaves.device
    leaves = leaves.contiguous()
    k, mp = leaves.shape[:2]
    consts = _fold_consts(log_m, shift_pow, a_bits)
    powers = np.ascontiguousarray(np.stack([_beta_powers(b, a_bits) for b in betas]))
    out = torch.empty((k, mp >> next_bits, 2 << next_bits), dtype=torch.int64, device=dev)
    launches = 0
    for g0, g1 in _cuda.proof_groups(k):
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_fri_fold(
                leaves[g0].data_ptr(), consts.ctypes.data, powers[g0:g1].ctypes.data,
                out[g0].data_ptr(), mp, a_bits, next_bits, g1 - g0, _cuda.stream(),
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
#: segment offsets and widths, 32-bit indices and strides. Its
#: GATHER_PLAN_BYTES hold one proof at both limits, or several proofs of a
#: batch, which share the segments' shapes (`gather_group`)
MAX_GATHER_SEGMENTS = 128
MAX_GATHER_QUERIES = 128
MAX_GATHER_WIDTH = (1 << 16) - 1
_PLAN_HEAD = struct.Struct("<Q4i")  # out, queries, segments, row width, proofs
_PLAN_SHAPE = struct.Struct("<iiHHBBBB")  # strides, offset, width, mask bits, shift, flip, levels
GATHER_PLAN_BYTES = (_PLAN_HEAD.size + (8 + _PLAN_SHAPE.size) * MAX_GATHER_SEGMENTS
                     + 4 * MAX_GATHER_QUERIES)


def _plan_bytes(proofs: int, segments: int, queries: int) -> int:
    """A plan's bytes: the header, each proof's source addresses, the
    segments' shapes, each proof's query indices."""
    return _PLAN_HEAD.size + (8 * proofs + _PLAN_SHAPE.size) * segments + 4 * proofs * queries


def gather_group(segments: int, queries: int) -> int:
    """The most proofs of `segments` segments and `queries` queries one
    kernel-F plan holds (at most PROOFS_PER_LAUNCH): sixteen leaf proofs (10
    segments, 28 queries) take 3,256 of its 3,608 bytes."""
    fits = (GATHER_PLAN_BYTES - _PLAN_HEAD.size - _PLAN_SHAPE.size * segments) // (
        8 * segments + 4 * queries)
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
    """Plain torch version of `query_gather` (same arguments): the rows as an
    int64 tensor on the sources' device."""
    q = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=sources[0].matrix.device)
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


def pack_gather_plan(sources: list[GatherSource], indices) -> tuple[bytearray, int]:
    """Kernel F's plan (csrc/fri.cu GatherPlan) for one proof as the bytes of
    its kernel parameter, and the packed row's width: `pack_gather_plan_batch`
    of one proof."""
    return pack_gather_plan_batch([sources], [indices])


def pack_gather_plan_batch(sources_k: list, indices_k) -> tuple[bytearray, int]:
    """Kernel F's plan for K proofs of one shape as the bytes of its kernel
    parameter: the output address (0 until the launch sets it), the counts,
    each proof's source addresses, a 16-byte shape a segment in packed-row
    order (the same for every proof), each proof's 32-bit query indices; and
    the packed row's width. Raises on what the kernel cannot read and above
    its capacity: there is no other path. One pass over the sources: this
    runs on every batch."""
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
    if _plan_bytes(k, n, nq) > GATHER_PLAN_BYTES:
        raise ValueError(f"{k} proofs of {n} segments and {nq} queries: kernel F's plan holds "
                         f"{GATHER_PLAN_BYTES} bytes")
    buf = bytearray(GATHER_PLAN_BYTES)
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
    try:
        struct.pack_into(f"<{k * nq}I", buf, at + _PLAN_SHAPE.size * n,
                         *(q for indices in indices_k for q in indices))
    except struct.error as e:
        raise ValueError(f"kernel F takes query indices below 2^32: {e}") from None
    return buf, width


def query_gather_packed_plain(plan: bytes, memory: list[torch.Tensor]) -> torch.Tensor:
    """Plain version of kernel F reading a packed plan (`pack_gather_plan`,
    `pack_gather_plan_batch`), for the tests: each value is read from the
    CPU tensors in `memory` at the plan's addresses, strides and path
    levels, as the kernel reads it; (proofs x queries, width) rows. Checks
    the plan as the kernel's entry does."""
    _, queries, segments, width, proofs = _PLAN_HEAD.unpack_from(plan, 0)
    if not (1 <= queries <= MAX_GATHER_QUERIES and 1 <= segments <= MAX_GATHER_SEGMENTS
            and 1 <= proofs <= _cuda.PROOFS_PER_LAUNCH
            and _plan_bytes(proofs, segments, queries) <= len(plan)):
        raise ValueError("plan counts out of range")
    at = _PLAN_HEAD.size + 8 * proofs * segments
    q = torch.tensor(struct.unpack_from(f"<{proofs * queries}I", plan,
                                        at + _PLAN_SHAPE.size * segments),
                     dtype=torch.int64).view(proofs, queries)
    stores = []
    for t in memory:
        st = t.untyped_storage()
        stores.append((st.data_ptr(), st.nbytes(), torch.empty(0, dtype=torch.int64).set_(st)))
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
            base, _, flat = next(st for st in stores if st[0] <= src < st[0] + st[1])
            rows = ((q[p, :, None] & (n0 - 1)) >> (shift + level)[None, :]) ^ flip
            out[p * queries : (p + 1) * queries, off : off + w] = flat[
                (src - base) // 8 + before + rows * rs + j * cs]
    if end != width:
        raise ValueError("plan segments do not cover the packed row")
    return out


#: kernel F's pinned host buffers, one a (proofs, queries, width) shape of
#: a whole call: each launch writes its group's rows at their offset
_pinned: dict = {}


def query_gather(sources: list[GatherSource], indices) -> np.ndarray:
    """For each query index, the picked rows of every source side by side,
    on the host: a (Q, sum of widths) uint64 array. On CUDA sources: kernel
    F (csrc/fri.cu), one launch, its plan passed by value, writing the rows
    into a pinned host buffer (one a shape); the stream is synchronized and
    the rows copied out. On CPU sources: the plain version. Raises above the
    plan's capacity on either."""
    if not sources or all(s.matrix.device.type == "cpu" for s in sources):
        pack_gather_plan(sources, indices)  # the kernel's limits hold here too
        return gl.to_u64(query_gather_plain(sources, indices))
    _cuda.require_cuda_int64(*(s.matrix for s in sources))
    packed, launches = _gather_launches([sources], [indices])
    query_gather.launches += launches
    return packed[0]


def query_gather_batch(sources_k: list, indices_k) -> np.ndarray:
    """`query_gather` for K proofs whose sources have one shape (a batch's
    oracles and FRI layers), each with its own query indices: a (K, Q, sum
    of widths) uint64 array. On CUDA sources: kernel F with a proof axis,
    one launch for as many proofs as a plan holds (`gather_group`: at most
    PROOFS_PER_LAUNCH, sixteen leaf proofs), all into pinned host memory,
    then one synchronize and copy. On CPU sources: the plain version, the
    kernel's limits checked alike."""
    k = len(sources_k)
    groups = _cuda.proof_groups(k, gather_group(len(sources_k[0]), len(indices_k[0])))
    if all(s.matrix.device.type == "cpu" for sources in sources_k for s in sources):
        for g0, g1 in groups:
            pack_gather_plan_batch(sources_k[g0:g1], indices_k[g0:g1])
        return np.stack([gl.to_u64(query_gather_plain(s, i)) for s, i in zip(sources_k, indices_k)])
    _cuda.require_cuda_int64(*(s.matrix for sources in sources_k for s in sources))
    packed, launches = _gather_launches(sources_k, indices_k, groups)
    query_gather_batch.launches += launches
    return packed


def _gather_launches(sources_k, indices_k, groups=((0, 1),)):
    """Kernel F a group of proofs, all into one pinned (K, Q, width) buffer,
    each group's launch at its first proof's rows; one synchronize and one
    copy out of the buffer, which the next call of that shape reuses.
    Returns ((K, Q, width) host rows, launches)."""
    host = None
    dev = sources_k[0][0].matrix.device
    for g0, g1 in groups:
        plan, width = pack_gather_plan_batch(sources_k[g0:g1], indices_k[g0:g1])
        if host is None:
            key = (len(sources_k), len(indices_k[0]), width)
            if key not in _pinned:
                _pinned[key] = torch.empty(key, dtype=torch.int64, pin_memory=True)
            host = _pinned[key]
        struct.pack_into("<Q", plan, 0, host[g0].data_ptr())
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_query_gather(bytes(plan), _cuda.stream())
        _cuda.check(err, "qzk_query_gather")
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
    layer = compute_composition(oracles, instance, openings, alpha, lde_bits, arities[0])

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
        layer = fold_round(layer, beta, a_bits, log_m, shift_pow, arities[r + 1])
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
    check: the honest degree bound after folding (below 2^fpb for tiny
    circuits)."""
    schedule = config.reduction_strategy.schedule(degree_bits)
    final_len = min(1 << config.reduction_strategy.final_poly_bits,
                    1 << (degree_bits - sum(schedule)))
    if np.any(coeffs[final_len:]):
        raise AssertionError("final poly exceeds degree bound")
    return coeffs[:final_len]


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
    layer = compute_composition_batch(oracles_k, instances, openings_k, alphas, lde_bits,
                                      arities[0])
    layers, caps = [], []
    log_m, shift_pow = lde_bits, 0
    for r, a_bits in enumerate(schedule):
        trees = merkle.build_merkle_forest(layer, min(config.cap_height, log_m - a_bits))
        layers.append(list(zip(layer, trees)))
        caps.append([t.cap for t in trees])
        challengers.observe_cap(np.stack([t.cap for t in trees]))
        betas = challengers.challenge_ext()
        layer = fold_round_batch(layer, betas, a_bits, log_m, shift_pow, arities[r + 1])
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
