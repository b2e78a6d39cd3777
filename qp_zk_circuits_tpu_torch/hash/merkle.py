"""Poseidon2 Merkle trees with caps — device build, device query gathers.

Commitment scheme of the prover: leaves are rows of an LDE matrix (all
polynomial evaluations at one domain point), leaf digest = hash_or_noop of the
row, internal nodes = two_to_one compressions, stopping `cap_height` levels
early so the commitment is a **cap** of `2^cap_height` digests (the
reference's `1 << cap_height` Merkle cap policy, `common/src/circuit.rs:459-468`).

Device mapping: a whole tree is one kernel-2 wrapper call
(`poseidon2.merkle_levels`) of at most two launches: blocks hash runs of rows
(strided rows are read in place) and reduce their subtrees, then, where
levels are left, one block per cap digest reduces the rest. Every level lands
in one device buffer; `MerkleTree.digests` holds its (n_l, 4) views. The
digest levels stay on the device; only the cap goes to the host at each
commitment, because the transcript observes it. The prover's query paths are
gathered on the device by kernel F (fri/prover.py::query_rounds);
`MerkleTree.prove` copies the levels to the host once, for callers outside
the prover path. A batch of proofs commits K trees of one shape in one
call (`build_merkle_forest`, kernel 2's forest), each a `MerkleTree` view,
whose caps stay on the device for the fused batch (`forest_caps`).
`verify_merkle_proof` and `merkle_root_from_proof` are the verifier's host
walk: one call into the C library of native/ a path
(`_merkle_root_from_proof_pure` is the tests' oracle).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native as nat
from ..field import goldilocks as gl
from . import poseidon2 as ps


def build_levels(leaves: torch.Tensor, cap_height: int) -> list[torch.Tensor]:
    """Device tree build, one `merkle_levels` call. leaves: (L, K) int64.
    Returns the digest levels, level 0 = leaf digests (L, 4), last = cap
    (2^cap_height, 4)."""
    return ps.merkle_levels(leaves, cap_height)


@dataclass
class MerkleTree:
    """A tree whose digest levels live on the build device; the cap is also
    kept on the host."""

    digests: list  # [torch.Tensor (n_i, 4)] — digests[0] = leaf digests
    cap: np.ndarray | None  # host copy of the last level, (2^cap_height, 4) u64
    cap_height: int
    _host: list | None = field(default=None, repr=False)

    @property
    def levels(self) -> list:
        """Host copies of the digest levels as numpy (n_i, 4) u64, made with
        one transfer at first use."""
        if self._host is None:
            host = gl.to_u64(torch.cat(self.digests, dim=0))
            self._host, off = [], 0
            for lvl in self.digests:
                self._host.append(host[off : off + lvl.shape[0]])
                off += lvl.shape[0]
        return self._host

    def prove(self, index: int) -> np.ndarray:
        """Sibling digests from leaf level up to (but excluding) the cap."""
        siblings = []
        idx = index
        for level in self.levels[:-1]:
            siblings.append(level[idx ^ 1])
            idx >>= 1
        return np.array(siblings, dtype=np.uint64).reshape(-1, 4)


def build_merkle_tree(leaves: torch.Tensor, cap_height: int, host_cap: bool = True) -> MerkleTree:
    """Build on the leaves' device; only the cap goes to the host, and not
    even that with `host_cap=False` (the fused prover, whose transcript reads
    the cap level on the device): `cap` is then None."""
    levels = build_levels(leaves, cap_height)
    return MerkleTree(digests=levels, cap=gl.to_u64(levels[-1]) if host_cap else None,
                      cap_height=cap_height)


def build_merkle_forest(leaves: torch.Tensor, cap_height: int,
                        host_cap: bool = True) -> list[MerkleTree]:
    """Trees of one shape in one `merkle_forest` call: leaves (T, L, K), tree
    t over the rows of leaves[t]. Every cap goes to the host in one
    transfer, or none with `host_cap=False` (the fused batch, whose
    transcripts read the caps on the device, `forest_caps`): `cap` is then
    None."""
    forest = ps.merkle_forest(leaves, cap_height)
    caps = ([None] * len(forest) if not host_cap
            else gl.to_u64(torch.stack([levels[-1] for levels in forest])))
    return [MerkleTree(digests=levels, cap=cap, cap_height=cap_height)
            for levels, cap in zip(forest, caps)]


def forest_caps(trees: list[MerkleTree]) -> torch.Tensor:
    """The caps of a forest's T trees (`build_merkle_forest`) as one (T,
    2^h, 4) view of the forest's one device buffer, tree t's cap at a
    constant proof stride (what kernel I's batch form reads); raises for
    trees that do not lie so."""
    first = trees[0].digests[-1]
    step = first.numel() if len(trees) == 1 else (
        trees[1].digests[-1].data_ptr() - first.data_ptr()) // 8
    for t, tree in enumerate(trees):
        cap = tree.digests[-1]
        if cap.shape != first.shape or cap.data_ptr() != first.data_ptr() + 8 * t * step:
            raise ValueError("the trees' caps are not one forest buffer")
    return first.as_strided((len(trees),) + tuple(first.shape), (step,) + first.stride(),
                            first.storage_offset())


def merkle_root_from_proof(leaf_digest: np.ndarray, index: int, siblings: np.ndarray) -> np.ndarray:
    """Host walk: recompute the cap entry from a leaf digest and its
    siblings, in one call into the C library."""
    return nat.merkle_walk(leaf_digest, index, siblings)


def _merkle_root_from_proof_pure(leaf_digest: np.ndarray, index: int, siblings: np.ndarray) -> np.ndarray:
    """merkle_root_from_proof in pure Python ints (the tests' oracle)."""
    cur = np.asarray(leaf_digest, dtype=np.uint64)
    idx = index
    for sib in siblings:
        if idx & 1:
            cur = ps._two_to_one_pure(sib, cur)
        else:
            cur = ps._two_to_one_pure(cur, sib)
        idx >>= 1
    return cur


def verify_merkle_proof(
    leaf_felts: np.ndarray, index: int, siblings: np.ndarray, cap: np.ndarray
) -> bool:
    """Host verification against a cap. leaf_felts: the raw row (K,) felts."""
    digest = ps.hash_or_noop(leaf_felts)
    root = merkle_root_from_proof(digest, index, siblings)
    cap_index = index >> len(siblings)
    return bool(np.array_equal(root, np.asarray(cap, dtype=np.uint64)[cap_index]))
