"""Polynomial batch commitments: coset LDE + salted Merkle cap ("oracles").

The prover's committed objects (wires, Zs/partial products, quotient chunks,
constants/sigmas) are each a `PolynomialBatch`: C polynomials of degree < N,
evaluated over the coset g*H' with blowup 2^rate_bits, rows Merkle-committed
with a cap (the `lde_size = 2^(degree_bits + rate_bits)` object of reference
`common/src/circuit.rs:451-457`). Blinding (zero knowledge) appends
SALT_SIZE random felt columns to every leaf row, as the JAX package's
`fri/oracle.py::commit` and `prover_fused.py::_commit_j` do: the salt is
committed and opened with each row but is no polynomial, so the openings
and the FRI composition read the first `num_polys` rows only.

Device path: the iNTT (from values) and the LDE are kernel-3 launches over all
columns; the LDE buffer holds C + SALT_SIZE rows when salted, kernel 3
writes the first C and the salt fills the last SALT_SIZE (uploaded from the
host's draw, or written by kernel G in device-rng mode, field/random.py).
The tree hashes the buffer's rows in place (the (C_total, M) matrix read as
(M, C_total) rows, no transpose or concatenation copy) with kernel 2, and
its levels stay on the device. The openings are kernel D (csrc/fri.cu).
`verify_row` is the verifier's host check of an opened row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _cuda
from ..field import extension as ext
from ..field import goldilocks as gl
from ..field import random as frandom
from ..hash import merkle
from ..poly import ntt
from .config import SALT_SIZE


@dataclass
class PolynomialBatch:
    """Committed batch: device coefficients (C, N) + LDE (C_total, M) +
    device tree."""

    coeffs: torch.Tensor  # (C, N) coefficient forms (no salt)
    lde: torch.Tensor  # (C_total, M): the C polynomials' evaluations, then the salt rows
    tree: merkle.MerkleTree
    degree_bits: int
    rate_bits: int
    blinding: bool = False

    @property
    def num_polys(self) -> int:
        return self.coeffs.shape[0]

    @property
    def lde_size(self) -> int:
        return 1 << (self.degree_bits + self.rate_bits)

    @property
    def cap(self) -> np.ndarray:
        return self.tree.cap

    @property
    def poly_lde(self) -> torch.Tensor:
        """The polynomials' rows of the LDE, without the salt: a contiguous
        view."""
        return self.lde[: self.num_polys]


def _fill_salt(salt, rows: torch.Tensor) -> None:
    """Write a salt into an LDE buffer's (SALT_SIZE, M) salt rows, or K
    salts into a stack's (K, SALT_SIZE, M): a `random.Draw`, which kernel G
    writes straight into the rows, or a host draw in the JAX package's
    (M, SALT_SIZE) layout, (K, M, SALT_SIZE) for a stack (LDE row C + j is
    salt column j), uploaded in one copy."""
    if isinstance(salt, frandom.Draw):
        frandom.rand_felts(salt.key, salt.stream, rows)
        return
    arr = np.asarray(salt, dtype=np.uint64)
    want = rows.shape[:-2] + (rows.shape[-1], SALT_SIZE)
    if arr.shape != want:
        raise ValueError(f"salt {arr.shape}, expected {want}")
    rows.copy_(torch.from_numpy(np.ascontiguousarray(np.swapaxes(arr, -1, -2)).view(np.int64)))


def commit(values, rate_bits: int, cap_height: int, device=None,
           from_values: bool = False, salt=None) -> PolynomialBatch:
    """Commit C polynomials. `values`: host (C, N) uint64 array or a device
    tensor (then `device` may be omitted); with `from_values=True` the rows
    are evaluations over H and an iNTT brings them to coefficients first.
    `salt` (blinding): a host (M, SALT_SIZE) array, or a `random.Draw` that
    kernel G writes on the device; the LDE then has C + SALT_SIZE rows."""
    if isinstance(values, torch.Tensor):
        vals = values
    else:
        vals = gl.from_u64(values, device)
    c, n = vals.shape
    degree_bits = n.bit_length() - 1
    if 1 << degree_bits != n:
        raise ValueError(f"polynomial length {n} is not a power of two")
    coeffs = ntt.intt(vals) if from_values else vals
    salt_rows = 0 if salt is None else SALT_SIZE
    lde = torch.empty((c + salt_rows, n << rate_bits), dtype=torch.int64, device=vals.device)
    ntt.coset_lde(coeffs, rate_bits, out=lde[:c])
    if salt is not None:
        _fill_salt(salt, lde[c:])
    tree = merkle.build_merkle_tree(lde.T, cap_height)
    return PolynomialBatch(coeffs=coeffs, lde=lde, tree=tree, degree_bits=degree_bits,
                           rate_bits=rate_bits, blinding=salt is not None)


def commit_batch(values: torch.Tensor, rate_bits: int, cap_height: int,
                 from_values: bool = False, salts=None) -> list[PolynomialBatch]:
    """`commit` for K batches of C polynomials of one shape, values (K, C, N)
    on the device: the K C columns stacked into one kernel-3 iNTT (when
    `from_values`) and one LDE, then one kernel-2 forest over the K LDEs read
    in place. `salts`: a host (K, M, SALT_SIZE) array (one upload), a list
    of K `random.Draw`s, or None; salted, the LDE buffer is (K, C +
    SALT_SIZE, M), kernel 3 writing each batch's first C rows in the same
    launch. Returns K `PolynomialBatch` views of the stacked coefficients
    and LDE, each with its tree."""
    k, c, n = values.shape
    degree_bits = n.bit_length() - 1
    if 1 << degree_bits != n:
        raise ValueError(f"polynomial length {n} is not a power of two")
    flat = values.reshape(k * c, n)
    coeffs = ntt.intt(flat) if from_values else flat
    if salts is not None and len(salts) != k:
        raise ValueError(f"{len(salts)} salts for {k} batches")
    salt_rows = 0 if salts is None else SALT_SIZE
    lde = torch.empty((k, c + salt_rows, n << rate_bits), dtype=torch.int64,
                      device=values.device)
    ntt.coset_lde(coeffs, rate_bits, out=lde[:, :c])
    if isinstance(salts, np.ndarray):
        _fill_salt(salts, lde[:, c:])
    elif salts is not None:
        for i, salt in enumerate(salts):
            _fill_salt(salt, lde[i, c:])
    trees = merkle.build_merkle_forest(lde.transpose(1, 2), cap_height)
    return [PolynomialBatch(coeffs=coeffs[i * c : (i + 1) * c], lde=lde[i], tree=tree,
                            degree_bits=degree_bits, rate_bits=rate_bits,
                            blinding=salts is not None)
            for i, tree in enumerate(trees)]


def stacked_lde(batches: list[PolynomialBatch]) -> torch.Tensor:
    """The LDEs of `commit_batch`'s K views as one (K, C_total, M) view of
    the buffer they share, salt rows included (raises for batches that do
    not lie one after another in one buffer)."""
    first = batches[0].lde
    rows, m = first.shape
    for i, b in enumerate(batches):
        if b.lde.shape != first.shape or b.lde.data_ptr() != first.data_ptr() + 8 * i * rows * m:
            raise ValueError("the batches' LDEs are not one stacked buffer")
    return first.as_strided((len(batches), rows, m), (rows * m, m, 1))


#: kernel D takes the oracles and the next-point rows as at most this many
#: row segments
MAX_SEGMENTS = 9
#: kernel D's coefficients a block (csrc/fri.cu's D_CHUNK); longer rows
#: take a second launch that adds the blocks' partial sums
D_CHUNK = 1024


def _eval_at(coeffs: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """y_c = sum_i coeffs[c, i] * z^i for ext powers zp (N, 2) -> (C, 2)."""
    y0 = gl.sum_tree(gl.mul(coeffs, zp[:, 0]), 1)
    y1 = gl.sum_tree(gl.mul(coeffs, zp[:, 1]), 1)
    return torch.stack([y0, y1], dim=-1)


def _zeta_powers(zeta, zeta_next, n: int) -> np.ndarray:
    """(2, n, 2) host powers of zeta and zeta_next."""
    return np.stack([
        ext.powers_table(np.asarray(zeta, dtype=np.uint64), n),
        ext.powers_table(np.asarray(zeta_next, dtype=np.uint64), n),
    ])


def _split(host: np.ndarray, oracles, next_count: int):
    parts, off = [], 0
    for o in oracles:
        c = o.coeffs.shape[0]
        parts.append(host[off : off + c])
        off += c
    return parts, host[off : off + next_count]


def _openings_limits(oracles, next_oracle: int, next_count: int) -> None:
    n = oracles[0].coeffs.shape[1]
    if len(oracles) + 1 > MAX_SEGMENTS:
        raise ValueError(f"{len(oracles)} oracles: kernel D takes at most {MAX_SEGMENTS - 1}")
    if any(o.coeffs.dim() != 2 or o.coeffs.shape[1] != n for o in oracles):
        raise ValueError("the oracles' coefficient matrices differ in length")
    if not 0 <= next_count <= oracles[next_oracle].coeffs.shape[0]:
        raise ValueError(f"{next_count} rows at zeta_next, oracle {next_oracle} has fewer")


def eval_openings_plain(oracles, zeta, zeta_next, next_oracle: int = 2, next_count: int = 0):
    """Plain torch version of `eval_openings` (same arguments and result)."""
    _openings_limits(oracles, next_oracle, next_count)
    dev = oracles[0].coeffs.device
    zp = gl.from_u64(_zeta_powers(zeta, zeta_next, oracles[0].coeffs.shape[1]), dev)
    at_zeta = _eval_at(torch.cat([o.coeffs for o in oracles], dim=0), zp[0])
    at_next = _eval_at(oracles[next_oracle].coeffs[:next_count], zp[1])
    return _split(gl.to_u64(torch.cat([at_zeta, at_next], dim=0)), oracles, next_count)


def eval_openings(oracles, zeta, zeta_next, next_oracle: int = 2, next_count: int = 0):
    """Evaluate ALL oracles at zeta (+ `next_count` rows of one oracle at
    zeta_next) with ONE transfer. Returns (per-oracle (C,2) arrays, next
    (next_count,2)).

    On CUDA coefficients: kernel D (csrc/fri.cu), which forms the points'
    powers on the card: one launch for rows of at most D_CHUNK coefficients,
    two above. On CPU coefficients: the plain version."""
    _openings_limits(oracles, next_oracle, next_count)
    if oracles[0].coeffs.device.type == "cpu":
        return eval_openings_plain(oracles, zeta, zeta_next, next_oracle, next_count)
    _cuda.require_cuda_int64(*(o.coeffs for o in oracles))
    host, launches = _openings_launches([oracles], [zeta], [zeta_next], next_oracle, next_count)
    eval_openings.launches += launches
    return _split(host[0], oracles, next_count)


def eval_openings_batch_plain(oracles_k, zetas, zeta_nexts, next_oracle: int = 2,
                              next_count: int = 0):
    """Plain torch version of `eval_openings_batch` (same arguments and
    result): `eval_openings_plain` a proof."""
    _openings_batch_limits(oracles_k, zetas, zeta_nexts, next_oracle, next_count)
    return [eval_openings_plain(o, z, zn, next_oracle, next_count)
            for o, z, zn in zip(oracles_k, zetas, zeta_nexts)]


def eval_openings_batch(oracles_k, zetas, zeta_nexts, next_oracle: int = 2,
                        next_count: int = 0):
    """`eval_openings` for K proofs of one circuit: oracles_k[i] proof i's
    oracles (the same shapes for every proof), zetas and zeta_nexts (K, 2)
    its points. Returns K of `eval_openings`' results.

    On CUDA coefficients: kernel D with a proof axis, each proof its own
    points and oracles, at most PROOFS_PER_LAUNCH proofs a call (each one
    launch for rows of at most D_CHUNK coefficients, two above), and one
    transfer for the batch. On CPU coefficients: the plain version."""
    _openings_batch_limits(oracles_k, zetas, zeta_nexts, next_oracle, next_count)
    if oracles_k[0][0].coeffs.device.type == "cpu":
        return eval_openings_batch_plain(oracles_k, zetas, zeta_nexts, next_oracle, next_count)
    _cuda.require_cuda_int64(*(o.coeffs for oracles in oracles_k for o in oracles))
    host, launches = _openings_launches(oracles_k, zetas, zeta_nexts, next_oracle, next_count)
    eval_openings_batch.launches += launches
    return [_split(h, oracles, next_count) for h, oracles in zip(host, oracles_k)]


def _openings_batch_limits(oracles_k, zetas, zeta_nexts, next_oracle, next_count) -> None:
    if not oracles_k or len(zetas) != len(oracles_k) or len(zeta_nexts) != len(oracles_k):
        raise ValueError(f"{len(oracles_k)} proofs' oracles for {len(zetas)} and "
                         f"{len(zeta_nexts)} points")
    shapes = [tuple(tuple(o.coeffs.shape) for o in oracles) for oracles in oracles_k]
    if len(set(shapes)) != 1:
        raise ValueError("the proofs' oracles differ in shape")
    _openings_limits(oracles_k[0], next_oracle, next_count)


def _openings_launches(oracles_k, zetas, zeta_nexts, next_oracle, next_count):
    """Kernel D over K proofs' oracles: ((K, rows, 2) host values,
    launches)."""
    dev = oracles_k[0][0].coeffs.device
    n = oracles_k[0][0].coeffs.shape[1]
    k = len(oracles_k)
    segs = []
    for oracles in oracles_k:
        coeffs = [o.coeffs.contiguous() for o in oracles]
        segs.append([(c.data_ptr(), c.shape[0], 0) for c in coeffs])
        if next_count:
            segs[-1].append((coeffs[next_oracle].data_ptr(), next_count, 1))
    segs = np.array(segs, dtype=np.uint64)  # (K, segments, 3)
    points = np.ascontiguousarray(np.stack([np.asarray(zetas, dtype=np.uint64).reshape(k, 2),
                                            np.asarray(zeta_nexts, dtype=np.uint64).reshape(k, 2)],
                                           axis=1))  # (K, 2, 2)
    rows = int(segs[0, :, 1].sum())
    chunks = -(-n // D_CHUNK)
    out = torch.empty((k, rows, 2), dtype=torch.int64, device=dev)
    part = torch.empty((k, rows, chunks, 2), dtype=torch.int64, device=dev) if chunks > 1 else None
    launches = 0
    for g0, g1 in _cuda.proof_groups(k):
        # the group's rows are whole rows of the C-ordered host arrays
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_eval_openings(
                segs[g0:g1].ctypes.data, segs.shape[1], points[g0:g1].ctypes.data,
                out[g0].data_ptr(), None if part is None else part[g0].data_ptr(), n, g1 - g0,
                _cuda.stream()
            )
        _cuda.check(err, "qzk_eval_openings")
        launches += 1 if chunks == 1 else 2
    return gl.to_u64(out), launches


eval_openings.launches = 0
eval_openings_batch.launches = 0


def verify_row(
    batch_cap: np.ndarray, row: np.ndarray, index: int, siblings: np.ndarray
) -> bool:
    """Host check: a claimed leaf row against an oracle cap."""
    return merkle.verify_merkle_proof(row, index, siblings, batch_cap)
