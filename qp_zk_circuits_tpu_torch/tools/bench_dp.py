"""Time data-parallel batch proving (`parallel/mesh.py::sharded_prove_batch`,
whose dp groups run in turn) on the CUDA cards of one machine, beside the
same groups run at once, each on a host thread of its own.

    python qp_zk_circuits_tpu_torch/tools/bench_dp.py [--runs N]

The at-once form lives here and not in the prover because it measured
slower. It cuts the witnesses of one `generate_witness_batch` into the
mesh's groups as `sharded_prove_batch` does and runs each group's
`prove_from_traces(device=)` on a thread of a pool, with what threads need
that the prover does not give: every device's tables and kernel library
made first (a warm `sharded_prove_batch` call), kernel F's pinned host
buffers a thread's own (`fri/prover.py::_pinned` swapped for a mapping
per thread, else two groups of one shape write into one buffer) and the
host library's OpenMP team of each thread its share of the cores. The
wrappers' launch counts are not read: they are not exact under threads.

Leaf witnesses are the two real spends of `two_real_leaves_same_block()`,
alternating, seed 0. Cases: `batch K=16 1 card` (`prove_inputs_batch` on
card 0); for a mesh of four shards of card 0, and with C >= 2 cards
visible for one of one shard a card (K = 4C, a group of 4 a shard),
`... in turn` (`sharded_prove_batch`) and `... at once` (the threads).

Each case's first call is timed alone (`cold_ms`) and its proofs are
checked against the single-card batch's; then --runs rounds, each running
every case once, the order reversed every other round, on the host clock
with every visible card synchronized at the end of a call: `ms` (median),
`q1_ms`, `q3_ms`, `min_ms`. Prints one line a case, the card from
nvidia-smi, and a JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


class _PinnedPerThread(threading.local):
    """A dict a thread: kernel F's pinned buffers, keyed by shape."""

    def __init__(self):
        self.buffers = {}

    def __contains__(self, key):
        return key in self.buffers

    def __getitem__(self, key):
        return self.buffers[key]

    def __setitem__(self, key, value):
        self.buffers[key] = value


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch import native as nat
    from qp_zk_circuits_tpu_torch.fri import prover as tfri
    from qp_zk_circuits_tpu_torch.parallel.mesh import make_prover_mesh, sharded_prove_batch
    from qp_zk_circuits_tpu_torch.plonk.builder import generate_witness_batch
    from qp_zk_circuits_tpu_torch.plonk.prover import prove_from_traces
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.tools import timing
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import two_real_leaves_same_block

    if not torch.cuda.is_available():
        raise SystemExit("bench_dp needs a CUDA card")
    cards = torch.cuda.device_count()
    prover = WormholeProver(device="cuda:0")
    spends = two_real_leaves_same_block()
    omp_set = getattr(nat.lib(), "omp_set_num_threads", None)
    if omp_set is not None:
        omp_set.argtypes, omp_set.restype = [ctypes.c_int], None

    def pws(k):
        return [prover._partial_witness(spends[i % 2]) for i in range(k)]

    def synced(fn):
        def call():
            out = fn()
            for i in range(cards):
                torch.cuda.synchronize(i)
            return out

        return call

    def at_once(k, mesh, pool):
        traces, pis, _ = generate_witness_batch(prover.data, pws(k), np.random.default_rng(0))
        per = k // mesh.shape["proofs"]
        share = max(1, len(os.sched_getaffinity(0)) // mesh.shape["proofs"])

        def group(g, dev):
            if omp_set is not None:
                omp_set(share)
            return prove_from_traces(prover.data, traces[g * per : (g + 1) * per],
                                     pis[g * per : (g + 1) * per], 0, device=dev)

        running = [pool.submit(group, g, dev) for g, dev in enumerate(mesh.shards("proofs"))]
        return [proof for run in running for proof in run.result()]

    meshes = [("(4, 1) on 1 card", make_prover_mesh(4, dp=4, devices=["cuda:0"] * 4))]
    if cards >= 2:
        meshes.append((f"({cards}, 1) on {cards} cards", make_prover_mesh(cards, dp=cards)))
    cases = [("batch K=16 1 card", synced(lambda: prover.prove_inputs_batch(
        [spends[i % 2] for i in range(16)], seed=0)), 16)]
    pools = []
    for label, mesh in meshes:
        k = 4 * mesh.shape["proofs"]
        pools.append(ThreadPoolExecutor(max_workers=mesh.shape["proofs"]))
        cases.append((f"dp K={k} {label}, in turn",
                      synced(lambda k=k, mesh=mesh: sharded_prove_batch(prover.data, mesh, pws(k),
                                                                         seed=0)), k))
        cases.append((f"dp K={k} {label}, at once",
                      synced(lambda k=k, mesh=mesh, pool=pools[-1]: at_once(k, mesh, pool)), k))
    tfri._pinned = _PinnedPerThread()
    want, cold, digests = {}, {}, {}
    for name, fn, k in cases:
        t = time.perf_counter()
        blobs = [proof_to_bytes(p) for p in fn()]
        cold[name] = 1e3 * (time.perf_counter() - t)
        if k not in want:
            want[k] = [proof_to_bytes(p) for p in prover.prove_inputs_batch(
                [spends[i % 2] for i in range(k)], seed=0)]
        if blobs != want[k]:
            raise SystemExit(f"{name}: the proofs differ from the single-card batch's")
        digests[name] = hashlib.sha256(b"".join(blobs)).hexdigest()[:16]
    times = {name: [] for name, _, _ in cases}
    for run in range(args.runs):
        for name, fn, _ in cases if run % 2 == 0 else cases[::-1]:
            t = time.perf_counter()
            fn()
            times[name].append(1e3 * (time.perf_counter() - t))
    for pool in pools:
        pool.shutdown()
    results = {}
    for name, _, k in cases:
        q1, _, q3 = statistics.quantiles(times[name], n=4)
        med = statistics.median(times[name])
        results[name] = {"cold_ms": round(cold[name], 2), "ms": round(med, 2),
                         "q1_ms": round(q1, 2), "q3_ms": round(q3, 2),
                         "min_ms": round(min(times[name]), 2), "proofs": k,
                         "sha256": digests[name]}
        print(f"{name}: cold {cold[name]:.1f} ms, warm median {med:.1f} ms (quartiles "
              f"{q1:.1f}-{q3:.1f}, least {min(times[name]):.1f}) over {args.runs}, {k} proofs "
              f"== the batch's, sha256 {digests[name]}", flush=True)
    card = timing.card()
    print(card, flush=True)
    print(json.dumps({"card": card, "cards": cards, "cases": results}), flush=True)


if __name__ == "__main__":
    main()
