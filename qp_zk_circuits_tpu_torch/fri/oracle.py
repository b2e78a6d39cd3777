"""Polynomial batch commitments: coset LDE + Merkle cap ("oracles").

The prover's committed objects (wires, Zs/partial products, quotient chunks,
constants/sigmas) are each a `PolynomialBatch`: C polynomials of degree < N,
evaluated over the coset g*H' with blowup 2^rate_bits, rows Merkle-committed
with a cap (the `lde_size = 2^(degree_bits + rate_bits)` object of reference
`common/src/circuit.rs:451-457`).

Device path: the iNTT (from values) and the LDE are kernel-3 launches over all
columns; the tree hashes the LDE's rows in place (the (C, M) matrix read as
(M, C) rows, no transpose copy) with kernel 2, and its levels stay on the
device. The openings are kernel D (csrc/fri.cu). This module commits non-ZK
oracles only: no salt columns. `verify_row` is the verifier's host check of
an opened row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _cuda
from ..field import extension as ext
from ..field import goldilocks as gl
from ..hash import merkle
from ..poly import ntt


@dataclass
class PolynomialBatch:
    """Committed batch: device coefficients (C, N) + LDE (C, M) + device tree."""

    coeffs: torch.Tensor  # (C, N) coefficient forms
    lde: torch.Tensor  # (C, M) evaluations over the LDE coset
    tree: merkle.MerkleTree
    degree_bits: int
    rate_bits: int

    @property
    def lde_size(self) -> int:
        return 1 << (self.degree_bits + self.rate_bits)

    @property
    def cap(self) -> np.ndarray:
        return self.tree.cap


def commit(values, rate_bits: int, cap_height: int, device=None,
           from_values: bool = False) -> PolynomialBatch:
    """Commit C polynomials. `values`: host (C, N) uint64 array or a device
    tensor (then `device` may be omitted); with `from_values=True` the rows
    are evaluations over H and an iNTT brings them to coefficients first."""
    if isinstance(values, torch.Tensor):
        vals = values
    else:
        vals = gl.from_u64(values, device)
    c, n = vals.shape
    degree_bits = n.bit_length() - 1
    if 1 << degree_bits != n:
        raise ValueError(f"polynomial length {n} is not a power of two")
    coeffs = ntt.intt(vals) if from_values else vals
    lde = ntt.coset_lde(coeffs, rate_bits)
    tree = merkle.build_merkle_tree(lde.T, cap_height)
    return PolynomialBatch(
        coeffs=coeffs, lde=lde, tree=tree, degree_bits=degree_bits, rate_bits=rate_bits
    )


def commit_batch(values: torch.Tensor, rate_bits: int, cap_height: int,
                 from_values: bool = False) -> list[PolynomialBatch]:
    """`commit` for K batches of C polynomials of one shape, values (K, C, N)
    on the device: the K C columns stacked into one kernel-3 iNTT (when
    `from_values`) and one LDE, then one kernel-2 forest over the K LDEs read
    in place. Returns K `PolynomialBatch` views of the stacked coefficients
    and LDE, each with its tree."""
    k, c, n = values.shape
    degree_bits = n.bit_length() - 1
    if 1 << degree_bits != n:
        raise ValueError(f"polynomial length {n} is not a power of two")
    flat = values.reshape(k * c, n)
    coeffs = ntt.intt(flat) if from_values else flat
    lde = ntt.coset_lde(coeffs, rate_bits)
    m = lde.shape[1]
    trees = merkle.build_merkle_forest(lde.view(k, c, m).transpose(1, 2), cap_height)
    return [PolynomialBatch(coeffs=coeffs[i * c : (i + 1) * c], lde=lde[i * c : (i + 1) * c],
                            tree=tree, degree_bits=degree_bits, rate_bits=rate_bits)
            for i, tree in enumerate(trees)]


def stacked_lde(batches: list[PolynomialBatch]) -> torch.Tensor:
    """The LDEs of `commit_batch`'s K views as one (K, C, M) view of the
    buffer they share (raises for batches that do not lie one after
    another in one buffer)."""
    first = batches[0].lde
    c, m = first.shape
    for i, b in enumerate(batches):
        if b.lde.shape != first.shape or b.lde.data_ptr() != first.data_ptr() + 8 * i * c * m:
            raise ValueError("the batches' LDEs are not one stacked buffer")
    return first.as_strided((len(batches), c, m), (c * m, m, 1))


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
    return _split(_launch_openings(oracles, zeta, zeta_next, next_oracle, next_count),
                  oracles, next_count)


def _launch_openings(oracles, zeta, zeta_next, next_oracle, next_count) -> np.ndarray:
    dev = oracles[0].coeffs.device
    n = oracles[0].coeffs.shape[1]
    coeffs = [o.coeffs.contiguous() for o in oracles]
    segs = [(c.data_ptr(), c.shape[0], 0) for c in coeffs]
    if next_count:
        segs.append((coeffs[next_oracle].data_ptr(), next_count, 1))
    segs = np.array(segs, dtype=np.uint64)
    points = np.array([zeta, zeta_next], dtype=np.uint64).reshape(2, 2)
    rows = int(segs[:, 1].sum())
    chunks = -(-n // D_CHUNK)
    out = torch.empty((rows, 2), dtype=torch.int64, device=dev)
    part = torch.empty((rows, chunks, 2), dtype=torch.int64, device=dev) if chunks > 1 else None
    err = _cuda.lib().qzk_eval_openings(
        segs.ctypes.data, len(segs), points.ctypes.data, out.data_ptr(),
        None if part is None else part.data_ptr(), n, _cuda.stream()
    )
    _cuda.check(err, "qzk_eval_openings")
    eval_openings.launches += 1 if chunks == 1 else 2
    return gl.to_u64(out)


eval_openings.launches = 0


def verify_row(
    batch_cap: np.ndarray, row: np.ndarray, index: int, siblings: np.ndarray
) -> bool:
    """Host check: a claimed leaf row against an oracle cap."""
    return merkle.verify_merkle_proof(row, index, siblings, batch_cap)
