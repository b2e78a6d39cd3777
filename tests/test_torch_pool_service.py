"""The port's miner-side pool and aggregation service against the JAX
package's (`wormhole/pool.py`, `wormhole/aggregator_service.py`), on the CPU.

Every case runs on both packages' classes with the same fake private-batch
proofs (a public-input vector and a validity flag, as tests/test_pool_service.py
and tests/test_properties_admission.py make them) and compares what each
returns or raises: the outcome, the error's class name and its message.

  * the pool: tests/test_pool_service.py::TestPool's cases, and the
    admission properties of tests/test_properties_admission.py (any push
    sequence leaves unique pooled nullifiers, verified and non-dummy proofs
    only, an index equal to the buckets and no trace of a rejected push;
    eviction keeps the index exact; snapshots never consume);
  * the service on stub circuits and verifiers: the pool facade, `aggregate`
    on an empty bucket and on a pooled one (the prover's proof stood in),
    `verify`'s address binding;
  * `from_binaries_dir` over the committed test-profile artifact set (the
    pinned loaders and the dummy's verify, both packages' real verifiers),
    with an `aot/` subdirectory in the set that neither reads; the public
    batch circuit stood in by the fixture's verifier data, as
    tests/test_torch_aggregation.py does.

No proof is made here.
"""

import json
import threading
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from qp_zk_circuits_tpu.plonk import serialization as jser
from qp_zk_circuits_tpu.wormhole import aggregator_service as jsvc
from qp_zk_circuits_tpu.wormhole import inputs as jwi
from qp_zk_circuits_tpu.wormhole import pool as jpool
from qp_zk_circuits_tpu.wormhole import public_batch as jpub
from qp_zk_circuits_tpu_torch.plonk import serialization as tser
from qp_zk_circuits_tpu_torch.wormhole import aggregator_service as tsvc
from qp_zk_circuits_tpu_torch.wormhole import inputs as twi
from qp_zk_circuits_tpu_torch.wormhole import pool as tpool
from qp_zk_circuits_tpu_torch.wormhole import public_batch as tpub

FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())
#: (pool module, service module, public_batch module, inputs module,
#: serialization module) of each package, the JAX package's first
PACKAGES = {"jax": (jpool, jsvc, jpub, jwi, jser), "torch": (tpool, tsvc, tpub, twi, tser)}
DEFAULT = settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])


class FakeProof:
    """Carries a private-batch PI vector; verification controlled by a flag."""

    def __init__(self, pis, valid=True):
        self.public_inputs = np.asarray(pis, dtype=np.uint64)
        self.valid = valid


def make_pb_pis(n_leaf=2, block=1, asset=0, fee=10, nulls=(1000, 1001), amount=50):
    """A private batch's public inputs (tests/test_properties_admission.py's
    layout): header, 2 n_leaf exit slots, n_leaf nullifiers."""
    pis = np.zeros(21 * n_leaf + 8, dtype=np.uint64)
    pis[0] = 2 * n_leaf
    pis[1] = asset
    pis[2] = fee
    pis[3:7] = [block, 0, 0, 0]
    pis[7] = 100
    cursor = 8
    for _ in range(2 * n_leaf):
        pis[cursor] = amount
        pis[cursor + 1 : cursor + 5] = [7, 7, 7, 7]
        cursor += 5
    for k in range(n_leaf):
        pis[cursor : cursor + 4] = [nulls[k], 1, 2, 3]
        cursor += 4
    return pis


def seeded(null_seed, **kw):
    """tests/test_pool_service.py's nullifiers for a seed."""
    return make_pb_pis(nulls=(1000 + null_seed * 10, 1001 + null_seed * 10), **kw)


def verifier(proof):
    if not proof.valid:
        raise ValueError("invalid proof")


def _plain(value):
    """A value comparable across the packages: dataclasses as their fields."""
    if hasattr(value, "__dataclass_fields__"):
        return (type(value).__name__,) + tuple(_plain(getattr(value, f))
                                               for f in value.__dataclass_fields__)
    if isinstance(value, dict):
        return sorted((_plain(k), _plain(v)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, float):
        return "float"  # ages differ between the runs
    return value


def _attempt(fn):
    """("ok", fn()'s value) or the error's class name and message."""
    try:
        return ("ok", _plain(fn()))
    except Exception as e:  # noqa: BLE001 - the class itself is compared
        return (type(e).__name__, str(e))


def _both(case):
    """case(pool module) -> list of outcomes, for each package; asserts that
    the port's equal the JAX package's and returns them."""
    jout, tout = (case(PACKAGES[k][0]) for k in ("jax", "torch"))
    assert tout == jout
    return tout


def _pool(mod, batch_size=4, **limits):
    limits = {"max_proofs": 8, "max_buckets": 2, "max_verifies_per_window": 100, **limits}
    return mod.ProofPool(verifier, n_leaf=2, batch_size=batch_size,
                         limits=mod.PoolLimits(**limits))


# ---------------------------------------------------------------------------
# the pool: tests/test_pool_service.py::TestPool on both packages


def _push_and_bucket(mod):
    pool = _pool(mod)
    key = pool.push(FakeProof(seeded(1)))
    out = [_plain(key), _attempt(lambda: pool.push(FakeProof(seeded(2)))), pool.num_proofs()]
    stats = pool.bucket_stats()[key]
    return out + [stats.num_proofs, stats.last_snapshot_age]


def _invalid_before_bucket_checks(mod):
    pool = _pool(mod)
    return [_attempt(lambda: pool.push(FakeProof(seeded(3), valid=False))), pool.num_proofs()]


def _dummy_rejected(mod):
    return [_attempt(lambda: _pool(mod).push(FakeProof(seeded(4, block=0))))]


def _duplicate_nullifier(mod):
    pool = _pool(mod)
    pool.push(FakeProof(seeded(5)))
    return [_attempt(lambda: pool.push(FakeProof(seeded(5))))]


def _snapshot_non_consuming(mod):
    pool = _pool(mod)
    key = pool.push(FakeProof(seeded(6)))
    first = len(pool.snapshot_batch(key))
    return [first, pool.num_proofs(), pool.bucket_stats()[key].last_snapshot_age is not None,
            len(pool.snapshot_batch(key))]


def _evict_settled(mod):
    pool = _pool(mod)
    pool.push(FakeProof(seeded(7)))
    nf = bytes(np.array([1070, 1, 2, 3], dtype="<u8").tobytes())
    removed = pool.evict_settled([nf])
    return [removed, pool.num_proofs(), _attempt(lambda: pool.push(FakeProof(seeded(7))))]


def _evict_older_than(mod):
    pool = _pool(mod)
    pool.push(FakeProof(seeded(8)))
    return [pool.evict_older_than(1e6), pool.evict_older_than(-1.0)]


def _verify_budget(mod):
    pool = _pool(mod, max_proofs=1024, max_buckets=256, max_verifies_per_window=2,
                 verify_window_secs=9999)
    return [_attempt(lambda i=i: pool.push(FakeProof(seeded(i)))) for i in (10, 11, 12)]


def _bucket_and_pool_caps(mod):
    pool = _pool(mod, batch_size=1, max_buckets=1, max_verifies_per_window=256)
    return [_attempt(lambda: pool.push(FakeProof(seeded(20, block=5)))),
            _attempt(lambda: pool.push(FakeProof(seeded(21, block=5)))),
            _attempt(lambda: pool.push(FakeProof(seeded(22, block=6))))]


def _concurrent_settlement_custody(mod):
    pool = _pool(mod)
    key = pool.push(FakeProof(seeded(30)))
    threads = [threading.Thread(target=lambda: [pool.snapshot_batch(key) for _ in range(50)]),
               threading.Thread(target=lambda: [pool.evict_older_than(1e6) for _ in range(50)])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [pool.num_proofs()]


def _global_cap(mod):
    pool = _pool(mod, max_proofs=2, batch_size=8)
    return [_attempt(lambda i=i: pool.push(FakeProof(seeded(40 + i)))) for i in range(3)]


POOL_CASES = {
    "push_and_bucket": (_push_and_bucket, lambda out: out[1][0] == "ok" and out[2:] == [2, 2, None]),
    "invalid_proof_rejected_before_bucket_checks": (
        _invalid_before_bucket_checks, lambda out: out == [("ValueError", "invalid proof"), 0]),
    "dummy_rejected": (_dummy_rejected, lambda out: out == [
        ("PoolError", "dummy private-batch proofs are not poolable")]),
    "duplicate_nullifier_rejected": (_duplicate_nullifier, lambda out: out == [
        ("PoolError", "duplicate nullifier already pooled")]),
    "snapshot_non_consuming": (_snapshot_non_consuming, lambda out: out == [1, 1, True, 1]),
    "evict_settled": (_evict_settled, lambda out: out[:2] == [1, 0] and out[2][0] == "ok"),
    "evict_older_than": (_evict_older_than, lambda out: out == [0, 1]),
    "verify_budget": (_verify_budget, lambda out: [o[0] for o in out] == ["ok", "ok", "PoolError"]
                      and out[2][1] == "verification budget exhausted for this window"),
    "bucket_and_pool_caps": (_bucket_and_pool_caps, lambda out: out[1:] == [
        ("PoolError", "bucket is full"), ("PoolError", "too many buckets")]),
    "concurrent_settlement_custody": (_concurrent_settlement_custody, lambda out: out == [1]),
    "global_cap": (_global_cap, lambda out: out[2] == ("PoolError", "pool is full")),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_like_reference(case):
    """Each case gives the JAX package's outcomes, classes and messages, and
    the outcomes tests/test_pool_service.py asserts."""
    run, expected = POOL_CASES[case]
    assert expected(_both(run))


# ---------------------------------------------------------------------------
# the pool's admission properties (tests/test_properties_admission.py)


@st.composite
def push_plans(draw):
    """A sequence of pushes with controlled collision axes."""
    ops = []
    for i in range(draw(st.integers(1, 12))):
        ops.append(dict(
            block=draw(st.integers(0, 2)),  # 0 -> dummy sentinel reject
            asset=draw(st.integers(0, 1)),
            fee=draw(st.sampled_from([10, 20])),
            nulls=(draw(st.integers(0, 6)) + 100, i + 1000),  # cross-proof duplicates
            valid=draw(st.booleans()),
        ))
    return ops


def _fake(op):
    return FakeProof(make_pb_pis(block=op["block"], asset=op["asset"], fee=op["fee"],
                                 nulls=op["nulls"]), valid=op["valid"])


def _wide_pool(mod, verifier_fn=verifier):
    return mod.ProofPool(verifier_fn, n_leaf=2, batch_size=8, limits=mod.PoolLimits(
        max_proofs=64, max_buckets=8, max_verifies_per_window=1000))


@DEFAULT
@given(plan=push_plans())
def test_pool_invariants_after_any_push_sequence(plan):
    """After any push sequence, in both packages alike: the same pushes
    accepted and refused (class, message), pooled nullifiers unique, every
    pooled proof verified and not a dummy, the index exactly the buckets',
    and no trace of a refused push."""
    def run(mod):
        pool, out = _wide_pool(mod), []
        for op in plan:
            before = (set(pool._nullifier_index), sum(len(v) for v in pool._buckets.values()))
            out.append(_attempt(lambda op=op: pool.push(_fake(op))))
            if out[-1][0] != "ok":
                assert (set(pool._nullifier_index),
                        sum(len(v) for v in pool._buckets.values())) == before
        entries = [e for b in pool._buckets.values() for e in b]
        nulls = [nf for e in entries for nf in e.nullifiers]
        assert len(nulls) == len(set(nulls)) and set(nulls) == pool._nullifier_index
        assert all(e.proof.valid for e in entries)
        assert all(int.from_bytes(bytes(e.parsed.block_data.block_hash), "little")
                   for e in entries)
        assert len(entries) == sum(o[0] == "ok" for o in out)
        return out

    _both(run)


@DEFAULT
@given(plan=push_plans(), max_age=st.floats(0, 1e-6))
def test_pool_eviction_keeps_index_consistent(plan, max_age):
    """evict_settled and evict_older_than leave the nullifier index exactly
    the remaining buckets', and remove as many proofs, in both packages."""
    def run(mod):
        pool = _wide_pool(mod)
        for op in plan:
            _attempt(lambda op=op: pool.push(_fake(op)))
        removed = [pool.evict_settled(sorted(pool._nullifier_index)[::2])]
        for step in (lambda: None, lambda: removed.append(pool.evict_older_than(max_age))):
            step()
            entries = [e for b in pool._buckets.values() for e in b]
            assert {nf for e in entries for nf in e.nullifiers} == pool._nullifier_index
        return removed[:1] + [pool.num_proofs()]

    _both(run)


@DEFAULT
@given(n_push=st.integers(1, 4), n_snap=st.integers(1, 4))
def test_pool_snapshot_non_consuming_property(n_push, n_snap):
    """Any number of snapshots never changes the pool's contents."""
    def run(mod):
        pool = mod.ProofPool(lambda p: None, n_leaf=2, batch_size=4, limits=mod.PoolLimits(
            max_proofs=64, max_buckets=8, max_verifies_per_window=1000))
        keys = {pool.push(FakeProof(make_pb_pis(nulls=(100 + i, 1000 + i))))
                for i in range(n_push)}
        before = {_plain(k): len(v) for k, v in pool._buckets.items()}
        sizes = [len(pool.snapshot_batch(k)) for _ in range(n_snap) for k in keys]
        assert all(0 < s <= 4 for s in sizes)
        assert {_plain(k): len(v) for k, v in pool._buckets.items()} == before
        return sorted(sizes)

    _both(run)


# ---------------------------------------------------------------------------
# the service on stub circuits and verifiers


def _public_pis(address: int, m=2, n_leaf=2, block=1):
    """A public batch's public inputs: address, asset, fee, block hash and
    number, the slot count, m * 2 n_leaf (sum, exit) slots, m n_leaf
    nullifiers."""
    slots = m * 2 * n_leaf
    head = [address, 0, 0, 0, 0, 10, block, 0, 0, 0, 100, slots]
    return np.array(head + [50, 7, 7, 7, 7] * slots + [1, 2, 3, 4] * (m * n_leaf),
                    dtype=np.uint64)


ADDRESS = 0xA11CE


def _service(key, inner=verifier, outer=lambda proof: None, address=ADDRESS, **limits):
    """Package `key`'s aggregator over a stub circuit (m = 2, N = 2) and
    stub verifiers, the dummy template a zero-block private batch."""
    pool_mod, svc, _, wi, _ = PACKAGES[key]
    circuit = types.SimpleNamespace(m=2, n_leaf=2, data=None)
    dummy = FakeProof(make_pb_pis(block=0, amount=0, nulls=(0, 0)))
    return svc.PublicBatchAggregator(
        circuit, inner, outer, dummy, wi.BytesDigest(address.to_bytes(32, "little")),
        limits=pool_mod.PoolLimits(**limits) if limits else None)


def _service_outcomes(case, monkeypatch=None):
    out = {}
    for key in ("jax", "torch"):
        if monkeypatch is not None:
            # the prover's proof stood in: what it was asked to prove
            monkeypatch.setattr(PACKAGES[key][2].PublicBatchProver, "prove", lambda self, seed=None: (
                [_plain(p.public_inputs.tolist()) for p in self._slots], bytes(self._address),
                seed))
        out[key] = case(key)
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_service_pool_facade_like_reference():
    """push_proof, snapshot_batch, bucket_stats, evict_settled and
    evict_older_than go through the service's pool, sized by the circuit
    (batch size m = 2), in both packages alike."""
    def case(key):
        svc = _service(key)
        pk = svc.push_proof(FakeProof(seeded(1)))
        out = [_plain(pk), _attempt(lambda: svc.push_proof(FakeProof(seeded(1)))),
               _attempt(lambda: svc.push_proof(FakeProof(seeded(2)))),
               _attempt(lambda: svc.push_proof(FakeProof(seeded(3)))),
               len(svc.snapshot_batch(pk)), _plain(svc.bucket_stats())]
        out.append(svc.evict_settled([np.array([1020, 1, 2, 3], dtype="<u8").tobytes()]))
        out.append(svc.evict_older_than(-1.0))
        return out + [svc.pool.num_proofs(), svc.pool.batch_size]

    out = _service_outcomes(case)
    assert out[1] == ("PoolError", "duplicate nullifier already pooled")
    assert out[2][0] == "ok" and out[3] == ("PoolError", "bucket is full")
    assert out[4] == 2 and out[6:] == [1, 1, 0, 2]


def test_service_aggregate_like_reference(monkeypatch):
    """`aggregate` of an empty bucket raises the JAX package's class and
    message; of a pooled bucket it proves the pool's snapshot padded with
    the dummy, bound to the service's address, and the pool keeps custody."""
    def case(key):
        svc = _service(key)
        empty_key = PACKAGES[key][0].BatchKey(b"\x01" * 32, 0, 10)
        out = [_attempt(lambda: svc.aggregate(empty_key))]
        pk = svc.push_proof(FakeProof(seeded(4)))
        out.append(_attempt(lambda: svc.aggregate(pk, seed=9)))
        return out + [svc.pool.num_proofs()]

    out = _service_outcomes(case, monkeypatch)
    assert out[0] == ("BatchCompatibilityError", "no proofs pooled under this batch key")
    slots, address, seed = out[1][1]
    assert len(slots) == 2 and slots[0] == tuple(seeded(4).tolist())
    assert slots[1] == tuple(make_pb_pis(block=0, amount=0, nulls=(0, 0)).tolist())
    assert address == ADDRESS.to_bytes(32, "little") and seed == 9 and out[2] == 1


def test_service_verify_binds_the_address_like_reference():
    """`verify` runs the outer verifier, parses the public batch's inputs and
    refuses a proof bound to another aggregator address, in both packages
    with the JAX package's class and message; an outer verifier's failure
    comes first."""
    def outer(proof):
        if not proof.valid:
            raise ValueError("outer proof invalid")

    def case(key):
        svc = _service(key, outer=outer)
        return [_attempt(lambda a=a, v=v: svc.verify(FakeProof(_public_pis(a), valid=v)))
                for a, v in ((ADDRESS, True), (ADDRESS + 1, True), (ADDRESS + 1, False))]

    out = _service_outcomes(case)
    assert out[0][0] == "ok"
    assert out[1] == ("BatchCompatibilityError", "proof is bound to a different aggregator address")
    assert out[2] == ("ValueError", "outer proof invalid")


# ---------------------------------------------------------------------------
# from_binaries_dir over the committed artifact set


def _blob(name):
    return (FIXTURES / name).read_bytes()


def _bins_dir(root: Path) -> Path:
    """The test profile's artifact set (tests/test_torch_aggregation.py's),
    with an `aot/` subdirectory of junk beside it."""
    root.mkdir(parents=True)
    (root / "config.json").write_text('{"num_leaf_proofs": 2, "num_private_batch_proofs": 2}')
    for kind in ("private_batch", "public_batch"):
        for part in ("common", "verifier"):
            (root / f"{kind}_{part}.bin").write_bytes(_blob(f"agg_{kind}_{part}.bin"))
    (root / "dummy_private_batch_proof.bin").write_bytes(_blob("agg_dummy_private_batch.bin"))
    (root / "aot").mkdir()
    (root / "aot" / "entry.bin").write_bytes(b"not an executable")
    return root


def _pair_vdata(ser, prefix):
    return ser.VerifierCircuitData.from_artifact_bytes(
        _blob(f"{prefix}_verifier.bin"), _blob(f"{prefix}_common.bin"), max_len=64 << 20)


def _stand_in(ser):
    """A public batch circuit whose verifier data is the fixture's pair."""
    v = _pair_vdata(ser, "agg_public_batch")
    data = types.SimpleNamespace(
        config=v.config, degree_bits=v.degree_bits, gate_types=v.gate_types,
        num_selectors=v.num_selectors, const_cols=np.empty((v.num_const_cols, 0)),
        constants_oracle=types.SimpleNamespace(cap=v.constants_cap),
        circuit_digest=v.circuit_digest, public_input_targets=[None] * v.num_public_inputs)
    return types.SimpleNamespace(data=data, m=2, n_leaf=2)


def test_from_binaries_dir_like_reference(tmp_path, monkeypatch):
    """Both packages' services load the artifact set (both layers pinned,
    the dummy private batch verified), admit the fixture's private batch
    into one bucket, refuse a second push of it and the dummy, and accept
    the fixture's public batch under its own address and refuse it under
    another, alike; the `aot/` subdirectory is left as it was."""
    root = _bins_dir(tmp_path / "bins")
    monkeypatch.setenv("QZKT_AOT_CACHE", str(tmp_path / "aot_cache"))
    public = tser.proof_from_bytes(_blob("agg_public_batch.bin"))
    address = twi.PublicBatchPublicInputs.from_felts(public.public_inputs, 2, 2).aggregator_address

    def case(key):
        _, svc, pub, wi, ser = PACKAGES[key]
        monkeypatch.setattr(pub, "PublicBatchCircuit", lambda *a, **kw: _stand_in(ser))
        kw = {} if key == "jax" else {"device": "cpu"}
        agg = svc.PublicBatchAggregator.from_binaries_dir(
            root, wi.BytesDigest(bytes(address)),
            private_batch_rebuild=_pair_vdata(ser, "agg_private_batch"), **kw)
        private = ser.proof_from_bytes(_blob("agg_private_batch.bin"))
        out = [ser.proof_to_bytes(agg.dummy_template) == _blob("agg_dummy_private_batch.bin"),
               _attempt(lambda: agg.push_proof(private)),
               _attempt(lambda: agg.push_proof(ser.proof_from_bytes(_blob("agg_private_batch.bin")))),
               _attempt(lambda: agg.push_proof(agg.dummy_template)),
               agg.pool.num_proofs(), agg.pool.batch_size,
               _attempt(lambda: agg.verify(ser.proof_from_bytes(_blob("agg_public_batch.bin"))))]
        agg.aggregator_address = wi.BytesDigest(b"\x02" * 32)
        out.append(_attempt(lambda: agg.verify(ser.proof_from_bytes(_blob("agg_public_batch.bin")))))
        return out

    out = {key: case(key) for key in ("jax", "torch")}
    assert out["torch"] == out["jax"]
    loaded, pushed, again, dummy, count, size, accepted, refused = out["torch"]
    assert loaded and pushed[0] == "ok" and count == 1 and size == 2
    assert again == ("PoolError", "duplicate nullifier already pooled")
    assert dummy == ("PoolError", "dummy private-batch proofs are not poolable")
    assert accepted[0] == "ok"
    assert refused == ("BatchCompatibilityError", "proof is bound to a different aggregator address")
    assert sorted(p.name for p in (root / "aot").iterdir()) == ["entry.bin"]
    assert (root / "aot" / "entry.bin").read_bytes() == b"not an executable"
