"""Tensor-parallel (by-polynomial) commitment: one oracle across a mesh axis.

The JAX package's `parallel/tp.py` shards ONE commitment's work over the
mesh: each device transforms its block of columns (no collective), one
tiled all_to_all re-shards the LDE from column blocks to row blocks (the
transpose), every device hashes its M/D rows and builds its subtree, and
the oracle is gathered back for the stages downstream. The port runs the
same body a shard at a time from one process (parallel/mesh.py):

  * column-block iNTT and coset LDE on each shard (kernel 3); the columns
    are padded to a multiple of D, and the pad columns, zero polynomials,
    are neither transformed nor sent;
  * the transpose: one exchange of (C/D, M/D) sub-blocks into each shard's
    (C + salt, M/D) row buffer (collectives.all_to_all), the pad columns
    dropped; the salt, drawn once for the whole oracle on the home device
    as `fri/oracle.py::commit` draws it (a host (M, SALT_SIZE) upload, or
    kernel G for a `random.Draw`), gives each shard its rows;
  * each shard's subtree (kernel 2 over its row buffer read in place; the
    shards of one device are one forest call over their stacked buffers),
    stopped at the shard's part of the cap, the reference's `local_levels`
    rule;
  * the assembly on the home device (the values' device, else the axis's
    first shard): each level laid out in shard order into one buffer, as
    `MerkleTree` holds the single-device tree, the top levels finished
    there by kernel 2's 2-to-1 when the cap is shallower than log2 D; the
    coefficients and the LDE gathered in column order.

The result is the `PolynomialBatch` of `fri/oracle.py::commit` on the same
inputs, bit for bit, so the proofs downstream (the openings, kernels C and
D reading the LDE, kernel F gathering the tree's siblings) are
byte-identical.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..fri import oracle as fo
from ..fri.config import SALT_SIZE
from ..hash import merkle
from ..hash import poseidon2 as ps
from ..poly import ntt
from . import collectives as col


def local_levels(log_m: int, n_dev: int, cap_height: int) -> int:
    """Levels a shard's subtree reduces above its leaf digests: down to one
    digest a shard, or to its part of the cap when the cap is deeper than
    the shard boundary (the JAX package's rule, parallel/tp.py:137-140)."""
    dev_bits = n_dev.bit_length() - 1
    return min(log_m - dev_bits - max(cap_height - dev_bits, 0), log_m - cap_height)


def _assemble_tree(shard_levels: list, cap_height: int, home: torch.device) -> merkle.MerkleTree:
    """The shards' subtree levels laid out in shard order into one buffer on
    `home` (the single-device tree's layout), the levels above them up to the
    cap formed there."""
    d = len(shard_levels)
    sizes = [lvl.shape[0] * d for lvl in shard_levels[0]]
    while sizes[-1] > 1 << cap_height:
        sizes.append(sizes[-1] // 2)
    digests = list(torch.empty((sum(sizes), ps.DIGEST_LEN), dtype=torch.int64,
                               device=home).split(sizes))
    for lvl, out in enumerate(digests[: len(shard_levels[0])]):
        col.gather([levels[lvl] for levels in shard_levels], out)
    for lvl in range(len(shard_levels[0]), len(sizes)):
        below = digests[lvl - 1]
        digests[lvl].copy_(ps.two_to_one(below[0::2], below[1::2]))
    return merkle.MerkleTree(digests=digests, cap=gl.to_u64(digests[-1]), cap_height=cap_height)


def commit_sharded(values, mesh, rate_bits: int, cap_height: int, from_values: bool = False,
                   salt=None) -> fo.PolynomialBatch:
    """`fri/oracle.py::commit` with its columns sharded over `mesh`'s "cols":
    the same arguments (`values` a host (C, N) array or a device tensor;
    `salt` a host (M, SALT_SIZE) array or a `random.Draw`) and the same
    `PolynomialBatch`, on the values' device (a host array's: the axis's
    first shard). Requires D | M/D."""
    devs = mesh.shards("cols")
    d = len(devs)
    vals = values if isinstance(values, torch.Tensor) else gl.from_u64(values, devs[0])
    home = vals.device
    c, n = vals.shape
    degree_bits = n.bit_length() - 1
    if 1 << degree_bits != n:
        raise ValueError(f"polynomial length {n} is not a power of two")
    m = n << rate_bits
    log_m = degree_bits + rate_bits
    if m % d or (m // d) % d:
        raise AssertionError("need D | M/D for the commit transpose")
    if not 0 <= cap_height <= log_m:
        raise ValueError(f"cap height {cap_height} outside the tree height {log_m}")
    ml = m // d
    salt_rows = 0 if salt is None else SALT_SIZE
    lde = torch.empty((c + salt_rows, m), dtype=torch.int64, device=home)
    if salt is not None:
        fo._fill_salt(salt, lde[c:])

    # 1. each shard's column block: iNTT, LDE (the pad columns not at all)
    cl = -(-c // d)
    coeffs_l, ldes_l = [], []
    for i, dev in enumerate(devs):
        rows = max(0, min(cl, c - i * cl))
        block = vals[i * cl : i * cl + rows].to(dev, non_blocking=True)
        if rows and from_values:
            block = ntt.intt(block)
        coeffs_l.append(block)
        ldes_l.append(ntt.coset_lde(block, rate_bits) if rows else
                      torch.empty((0, m), dtype=torch.int64, device=dev))

    # 2. the transpose into each shard's (C + salt, M/D) row buffer, the salt
    #    rows its own; the buffers of the shards on one device are one stack
    stacks = {}
    for j, dev in enumerate(devs):
        stacks.setdefault(dev, []).append(j)
    rowbufs = [None] * d
    for dev, shards in stacks.items():
        stack = torch.empty((len(shards), c + salt_rows, ml), dtype=torch.int64, device=dev)
        stacks[dev] = (shards, stack)
        for j, rb in zip(shards, stack):
            rowbufs[j] = rb
    col.all_to_all(ldes_l, 1, 0, out=[rb[:c] for rb in rowbufs])
    if salt is not None:
        for j, rb in enumerate(rowbufs):
            col.gather([lde[c:, j * ml : (j + 1) * ml]], rb[c:])

    # 3. the shards' subtrees over their rows, read in place: one kernel-2
    #    forest for the shards of a device
    local_cap = ml.bit_length() - 1 - local_levels(log_m, d, cap_height)
    shard_levels = [None] * d
    for shards, stack in stacks.values():
        for j, levels in zip(shards, ps.merkle_forest(stack.transpose(1, 2), local_cap)):
            shard_levels[j] = levels

    # 4. the assembly on the home device
    tree = _assemble_tree(shard_levels, cap_height, home)
    coeffs = col.gather(coeffs_l, torch.empty((c, n), dtype=torch.int64, device=home)) \
        if from_values else vals
    col.gather(ldes_l, lde[:c])
    return fo.PolynomialBatch(coeffs=coeffs, lde=lde, tree=tree, degree_bits=degree_bits,
                              rate_bits=rate_bits, blinding=salt is not None)
