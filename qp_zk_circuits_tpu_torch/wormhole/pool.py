"""The miner-side proof pool: admission-verified private-batch proofs,
bucketed by (block_hash, asset_id, fee), with custody-safe snapshots.

The port of the JAX package's `wormhole/pool.py` (itself the reference
`aggregator/src/pool.rs`): host code, the same behaviour, classes and
messages. Key behaviors preserved:

  * `push` check ORDER is hardened against membership oracles: the bucket-cap
    and duplicate-nullifier rejections happen only AFTER cryptographic
    verification, so an unauthenticated caller cannot probe pool contents
    with invalid proofs (`pool.rs:315-449`);
  * a fixed-window verification-CPU budget bounds adversarial verify load
    (`PoolLimits.max_verifies_per_window`, `pool.rs:105-148`);
  * `snapshot_batch` is NON-consuming: proving workers get clones, the pool
    keeps custody, and a crashed worker needs no recovery (`pool.rs:17-27`);
  * eviction: `evict_settled` per imported block, `evict_older_than` expiry
    backstop, and `bucket_stats` exposes `last_snapshot_age` as the
    in-flight signal (`pool.rs:462-551`);
  * one lock guards the buckets, the nullifier index and the budget: a
    push, a snapshot, an eviction and the stats each hold it throughout.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from . import inputs as wi
from .public_batch import parse_private_batch_pis


@dataclass(frozen=True)
class BatchKey:
    block_hash: bytes
    asset_id: int
    volume_fee_bps: int


@dataclass(frozen=True)
class PoolLimits:
    max_proofs: int = 1024
    max_buckets: int = 256
    max_verifies_per_window: int = 256
    verify_window_secs: float = 60.0


@dataclass
class BucketStats:
    num_proofs: int
    batch_size: int
    oldest_age: float
    total_volume: int
    last_snapshot_age: float | None


class PoolError(ValueError):
    pass


@dataclass
class _Entry:
    proof: object
    parsed: object
    inserted_at: float
    nullifiers: tuple


class ProofPool:
    """In-memory bucketed pool of admission-verified private-batch proofs."""

    def __init__(self, verifier_fn, n_leaf: int, batch_size: int, limits: PoolLimits | None = None):
        wi.validate_proof_count(n_leaf, "num_leaf_proofs")
        wi.validate_proof_count(batch_size, "batch_size")
        self.verifier_fn = verifier_fn  # raises on invalid proof
        self.n_leaf = n_leaf
        self.batch_size = batch_size
        self.limits = limits or PoolLimits()
        self._buckets: dict[BatchKey, list[_Entry]] = {}
        self._nullifier_index: set[bytes] = set()
        self._last_snapshot: dict[BatchKey, float] = {}
        self._verify_window_start = time.monotonic()
        self._verifies_in_window = 0
        self._lock = threading.Lock()

    # -- admission ---------------------------------------------------------
    def _check_verify_budget(self) -> None:
        now = time.monotonic()
        if now - self._verify_window_start >= self.limits.verify_window_secs:
            self._verify_window_start = now
            self._verifies_in_window = 0
        if self._verifies_in_window >= self.limits.max_verifies_per_window:
            raise PoolError("verification budget exhausted for this window")
        self._verifies_in_window += 1

    def push(self, proof) -> BatchKey:
        """Admission order (oracle-hardened): global cap -> parse -> dummy
        reject -> verify budget -> CRYPTO VERIFY -> bucket cap -> duplicate
        nullifiers -> insert."""
        with self._lock:
            total = sum(len(v) for v in self._buckets.values())
            if total >= self.limits.max_proofs:
                raise PoolError("pool is full")
            parsed = parse_private_batch_pis(proof)  # shape/layout validation
            if int.from_bytes(bytes(parsed.block_data.block_hash), "little") == 0:
                raise PoolError("dummy private-batch proofs are not poolable")
            self._check_verify_budget()
            self.verifier_fn(proof)  # cryptographic verification
            key = BatchKey(
                block_hash=bytes(parsed.block_data.block_hash),
                asset_id=parsed.asset_id,
                volume_fee_bps=parsed.volume_fee_bps,
            )
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= self.limits.max_buckets:
                    raise PoolError("too many buckets")
                bucket = self._buckets.setdefault(key, [])
            if len(bucket) >= self.batch_size:
                raise PoolError("bucket is full")
            # real nullifiers only (dummy padding inside the batch yields
            # random values; include all — set semantics)
            nulls = tuple(bytes(nf) for nf in parsed.nullifiers)
            for nf in nulls:
                if nf in self._nullifier_index:
                    raise PoolError("duplicate nullifier already pooled")
            for nf in nulls:
                self._nullifier_index.add(nf)
            bucket.append(
                _Entry(proof=proof, parsed=parsed, inserted_at=time.monotonic(), nullifiers=nulls)
            )
            return key

    # -- snapshots (non-consuming custody) ---------------------------------
    def snapshot_batch(self, key: BatchKey) -> list:
        """Clone the oldest <= batch_size proofs of a bucket for proving.
        The pool keeps custody — a crashed worker changes nothing."""
        with self._lock:
            bucket = self._buckets.get(key)
            if not bucket:
                return []
            self._last_snapshot[key] = time.monotonic()
            oldest = sorted(bucket, key=lambda e: e.inserted_at)[: self.batch_size]
            return [e.proof for e in oldest]

    # -- eviction ----------------------------------------------------------
    def evict_settled(self, settled_nullifiers) -> int:
        """Drop proofs whose nullifiers settled on-chain (per imported block)."""
        settled = {bytes(n) for n in settled_nullifiers}
        removed = 0
        with self._lock:
            for key in list(self._buckets):
                keep = []
                for e in self._buckets[key]:
                    if any(nf in settled for nf in e.nullifiers):
                        for nf in e.nullifiers:
                            self._nullifier_index.discard(nf)
                        removed += 1
                    else:
                        keep.append(e)
                if keep:
                    self._buckets[key] = keep
                else:
                    del self._buckets[key]
                    self._last_snapshot.pop(key, None)
        return removed

    def evict_older_than(self, max_age_secs: float) -> int:
        """Expiry backstop for proofs that lost inclusion races."""
        cutoff = time.monotonic() - max_age_secs
        removed = 0
        with self._lock:
            for key in list(self._buckets):
                keep = []
                for e in self._buckets[key]:
                    if e.inserted_at < cutoff:
                        for nf in e.nullifiers:
                            self._nullifier_index.discard(nf)
                        removed += 1
                    else:
                        keep.append(e)
                if keep:
                    self._buckets[key] = keep
                else:
                    del self._buckets[key]
                    self._last_snapshot.pop(key, None)
        return removed

    # -- observability ------------------------------------------------------
    def bucket_stats(self) -> dict:
        now = time.monotonic()
        out = {}
        with self._lock:
            for key, bucket in self._buckets.items():
                oldest = min(e.inserted_at for e in bucket)
                volume = sum(
                    a.summed_output_amount for e in bucket for a in e.parsed.account_data
                )
                snap = self._last_snapshot.get(key)
                out[key] = BucketStats(
                    num_proofs=len(bucket),
                    batch_size=self.batch_size,
                    oldest_age=now - oldest,
                    total_volume=volume,
                    last_snapshot_age=(now - snap) if snap is not None else None,
                )
        return out

    def num_proofs(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._buckets.values())
