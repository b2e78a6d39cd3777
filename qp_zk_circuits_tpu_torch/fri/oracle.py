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
from ..plonk import transcript as ts
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
        """The cap on the host (the staged prover's transcript observes it);
        the fused prover reads `tree.digests[-1]` on the device instead."""
        return self.tree.cap

    @property
    def poly_lde(self) -> torch.Tensor:
        """The polynomials' rows of the LDE, without the salt: a contiguous
        view."""
        return self.lde[: self.num_polys]


def _fill_salt(salt, rows: torch.Tensor) -> None:
    """Write a salt into an LDE buffer's (SALT_SIZE, M) salt rows, or K
    salts into a stack's (K, SALT_SIZE, M): a `random.Draw`, which kernel G
    writes straight into the rows, a device tensor of the rows' shape
    (the fused prover's upload), copied on the device, or a host draw in the
    JAX package's (M, SALT_SIZE) layout, (K, M, SALT_SIZE) for a stack (LDE
    row C + j is salt column j), uploaded in one copy."""
    if isinstance(salt, frandom.Draw):
        frandom.rand_felts(salt.key, salt.stream, rows)
        return
    if isinstance(salt, torch.Tensor):
        rows.copy_(salt)
        return
    arr = np.asarray(salt, dtype=np.uint64)
    want = rows.shape[:-2] + (rows.shape[-1], SALT_SIZE)
    if arr.shape != want:
        raise ValueError(f"salt {arr.shape}, expected {want}")
    rows.copy_(torch.from_numpy(np.ascontiguousarray(np.swapaxes(arr, -1, -2)).view(np.int64)))


def commit(values, rate_bits: int, cap_height: int, device=None,
           from_values: bool = False, salt=None, host_cap: bool = True) -> PolynomialBatch:
    """Commit C polynomials. `values`: host (C, N) uint64 array or a device
    tensor (then `device` may be omitted); with `from_values=True` the rows
    are evaluations over H and an iNTT brings them to coefficients first.
    `salt` (blinding): a host (M, SALT_SIZE) array, a (SALT_SIZE, M) device
    tensor, or a `random.Draw` that kernel G writes on the device; the LDE
    then has C + SALT_SIZE rows. `host_cap=False` (the fused prover) leaves
    the cap on the device only: no transfer."""
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
    tree = merkle.build_merkle_tree(lde.T, cap_height, host_cap=host_cap)
    return PolynomialBatch(coeffs=coeffs, lde=lde, tree=tree, degree_bits=degree_bits,
                           rate_bits=rate_bits, blinding=salt is not None)


def commit_batch(values: torch.Tensor, rate_bits: int, cap_height: int,
                 from_values: bool = False, salts=None,
                 host_cap: bool = True) -> list[PolynomialBatch]:
    """`commit` for K batches of C polynomials of one shape, values (K, C, N)
    on the device: the K C columns stacked into one kernel-3 iNTT (when
    `from_values`) and one LDE, then one kernel-2 forest over the K LDEs read
    in place. `salts`: a host (K, M, SALT_SIZE) array (one upload), a (K,
    SALT_SIZE, M) device tensor (the fused batch's upload, one copy on the
    device), a list of K `random.Draw`s, or None; salted, the LDE buffer is
    (K, C + SALT_SIZE, M), kernel 3 writing each batch's first C rows in the
    same launch. `host_cap=False` (the fused batch) leaves the caps on the
    device (`merkle.forest_caps`). Returns K `PolynomialBatch` views of the
    stacked coefficients and LDE, each with its tree."""
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
    if isinstance(salts, (np.ndarray, torch.Tensor)):
        _fill_salt(salts, lde[:, c:])
    elif salts is not None:
        for i, salt in enumerate(salts):
            _fill_salt(salt, lde[i, c:])
    trees = merkle.build_merkle_forest(lde.transpose(1, 2), cap_height, host_cap=host_cap)
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


def ext_powers(z: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 2) powers z^0 .. z^(n-1) of an extension element z (2,) on its
    device, by doubling (the JAX package's _ext_powers_j)."""
    out = torch.tensor([[1, 0]], dtype=torch.int64, device=z.device)
    step = z
    while out.shape[0] < n:
        out = torch.cat([out, ext.j_mul(out, step)])
        step = ext.j_sqr(step)
    return out[:n]


def point_records(dev, zetas, zeta_nexts) -> torch.Tensor:
    """K challenge records (K, REC_WORDS) on `dev` holding each proof's host
    zeta and g * zeta (K, 2), one copy."""
    k = len(zetas)
    return ts.challenge_records(dev, k, {
        ts.REC_ZETA: np.asarray(zetas, dtype=np.uint64).reshape(k, 2),
        ts.REC_ZETA_NEXT: np.asarray(zeta_nexts, dtype=np.uint64).reshape(k, 2)})


def split_openings(host: np.ndarray, oracles, next_count: int):
    """(rows, 2) opened values as (per-oracle (C, 2) arrays, the next_count
    rows at zeta_next)."""
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


def eval_openings_plain(oracles, rec, next_oracle: int = 2, next_count: int = 0, out=None):
    """Plain torch version of `eval_openings` (same arguments and result)."""
    _openings_limits(oracles, next_oracle, next_count)
    n = oracles[0].coeffs.shape[1]
    at_zeta = _eval_at(torch.cat([o.coeffs for o in oracles], dim=0),
                       ext_powers(rec[ts.REC_ZETA : ts.REC_ZETA + 2], n))
    at_next = _eval_at(oracles[next_oracle].coeffs[:next_count],
                       ext_powers(rec[ts.REC_ZETA_NEXT : ts.REC_ZETA_NEXT + 2], n))
    values = torch.cat([at_zeta, at_next], dim=0)
    if out is None:
        return values
    out.copy_(values)
    return out


def eval_openings(oracles, rec, next_oracle: int = 2, next_count: int = 0, out=None):
    """Evaluate ALL oracles at zeta (+ `next_count` rows of one oracle at
    zeta_next), zeta and g * zeta read from the challenge record `rec`
    (REC_WORDS,) on the oracles' device (the fused prover's transcript
    writes them there; the staged prover uploads its host points,
    `point_records`). Returns the values on the device: a (rows, 2) tensor,
    every oracle's rows then the `next_count` (`split_openings` cuts them on
    the host), written into `out` when given (the fused proof's packed
    output).

    On CUDA coefficients: kernel D (csrc/fri.cu), which forms the points'
    powers on the card: one launch for rows of at most D_CHUNK coefficients,
    two above. On CPU coefficients: the plain version."""
    _openings_limits(oracles, next_oracle, next_count)
    if oracles[0].coeffs.device.type == "cpu":
        return eval_openings_plain(oracles, rec, next_oracle, next_count, out)
    _cuda.require_cuda_int64(rec, *(o.coeffs for o in oracles))
    values, launches = _openings_rec_launches([oracles], rec.unsqueeze(0), next_oracle,
                                              next_count, None if out is None else out.unsqueeze(0))
    eval_openings.launches += launches
    return values[0]


def eval_openings_batch_plain(oracles_k, rec, next_oracle: int = 2, next_count: int = 0,
                              out=None):
    """Plain torch version of `eval_openings_batch` (same arguments and
    result): `eval_openings_plain` a proof, stacked."""
    _openings_batch_limits(oracles_k, rec, next_oracle, next_count)
    values = torch.stack([eval_openings_plain(o, r, next_oracle, next_count)
                          for o, r in zip(oracles_k, rec)])
    if out is None:
        return values
    if out.shape != values.shape:
        raise ValueError(f"openings output {tuple(out.shape)}, expected {tuple(values.shape)}")
    return out.copy_(values)


def eval_openings_batch(oracles_k, rec, next_oracle: int = 2, next_count: int = 0,
                        out=None) -> torch.Tensor:
    """`eval_openings` for K proofs of one circuit: oracles_k[i] proof i's
    oracles (the same shapes for every proof), its zeta and g * zeta in
    record rec[i] of rec (K, REC_WORDS) on the device (the fused batch's
    transcripts write them there; the staged batch uploads its host points,
    `point_records`). Returns the (K, rows, 2) values on the device, in
    `out` when given (the fused batch's packed output).

    On CUDA coefficients: kernel D with a proof axis, each proof its own
    points and oracles, at most PROOFS_PER_LAUNCH proofs a call (each one
    launch for rows of at most D_CHUNK coefficients, two above). On CPU
    coefficients: the plain version."""
    _openings_batch_limits(oracles_k, rec, next_oracle, next_count)
    if oracles_k[0][0].coeffs.device.type == "cpu":
        return eval_openings_batch_plain(oracles_k, rec, next_oracle, next_count, out)
    _cuda.require_cuda_int64(rec, *(o.coeffs for oracles in oracles_k for o in oracles))
    values, launches = _openings_rec_launches(oracles_k, rec, next_oracle, next_count, out)
    eval_openings_batch.launches += launches
    return values


def _openings_batch_limits(oracles_k, rec, next_oracle, next_count) -> None:
    if not oracles_k or len(rec) != len(oracles_k):
        raise ValueError(f"{len(oracles_k)} proofs' oracles for {len(rec)} records")
    shapes = [tuple(tuple(o.coeffs.shape) for o in oracles) for oracles in oracles_k]
    if len(set(shapes)) != 1:
        raise ValueError("the proofs' oracles differ in shape")
    _openings_limits(oracles_k[0], next_oracle, next_count)


def _openings_rec_launches(oracles_k, rec, next_oracle, next_count, out=None):
    """Kernel D over K proofs' oracles, proof i's points in record rec[i] on
    the device: ((K, rows, 2) values on the device, in `out` when given,
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
    rows = int(segs[0, :, 1].sum())
    chunks = -(-n // D_CHUNK)
    if out is None:
        out = torch.empty((k, rows, 2), dtype=torch.int64, device=dev)
    elif out.shape != (k, rows, 2) or not out.is_contiguous():
        raise ValueError(f"openings output {tuple(out.shape)}, expected a contiguous {(k, rows, 2)}")
    part = torch.empty((k, rows, chunks, 2), dtype=torch.int64, device=dev) if chunks > 1 else None
    launches = 0
    for g0, g1 in _cuda.proof_groups(k):
        # the group's rows are whole rows of the C-ordered host arrays
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_eval_openings(
                segs[g0:g1].ctypes.data, segs.shape[1], rec[g0].data_ptr(), rec.stride(0),
                out[g0].data_ptr(), None if part is None else part[g0].data_ptr(), n, g1 - g0,
                _cuda.stream()
            )
        _cuda.check(err, "qzk_eval_openings")
        launches += 1 if chunks == 1 else 2
    return out, launches


eval_openings.launches = 0
eval_openings_batch.launches = 0


def verify_row(
    batch_cap: np.ndarray, row: np.ndarray, index: int, siblings: np.ndarray
) -> bool:
    """Host check: a claimed leaf row against an oracle cap."""
    return merkle.verify_merkle_proof(row, index, siblings, batch_cap)
