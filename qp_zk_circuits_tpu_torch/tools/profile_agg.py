"""Where the time of the aggregation layers goes, on one CUDA card and its
host: the canonical private batch (N leaves, ZK) and the public batch over
two private batches.

    python qp_zk_circuits_tpu_torch/tools/profile_agg.py [--root DIR] [--n-leaf 2 8] [--proofs 3]
        [--public-n 2]

Runs the checkout at `--root` (default: the checkout this file lies in).
For each N of `--n-leaf`, at the canonical configs:

  * the leaf circuit, N real leaves of one block
    (`n_real_leaves_same_block(N)`, a batch proof) and the dummy leaf;
  * `PrivateBatchCircuit(N)`: its build on the host (the port's builder and
    the preprocessing commit on the card), seconds, degree_bits and rows;
  * the cold host-rng proof (it records the witness program), then
    `--proofs` warm host-rng proofs (median, host clock ending in a
    synchronize); `warmup` (`plonk/prover.py`), then `--proofs` warm
    device-rng proofs; each through `PrivateBatchProver.aggregate`, so the
    admission (a verify of each leaf) and the witness fill are in the time;
  * one warm proof of each mode with each stage wrapped in a host timer
    (`profile_leaf.py`'s stages, plus the admission and the witness fill);
  * one warm proof of each mode under torch.profiler: device ms, device
    launches, the busy share, the top kernels; and one with each call into
    the kernel library replayed in a CUDA graph (`tools/timing.py::
    device_split`): the port's kernels' device ms and calls by library
    entry, torch's glue left out;
  * the verify (the port's `plonk/verifier.py::verify`) of a warm proof:
    median of `--proofs`.

For N = `--public-n` it then builds the public batch over two such private
batches (the device-rng batch and the all-dummy one) and gives the same
numbers for its (non-ZK) proof. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

#: the batch layers' stages besides the prover's (module under
#: qp_zk_circuits_tpu_torch, attribute, stage name, synchronizes)
AGG_STAGES = (
    ("wormhole.verifier.WormholeVerifier", "verify", "admission (leaf verifies)", False),
    ("wormhole.private_batch", "_batch_witness", "witness fill (proof targets)", False),
    ("wormhole.public_batch.PublicBatchProver", "_witness", "witness fill (proof targets)",
     False),
    ("wormhole.public_batch.PublicBatchProver", "preflight", "admission (inner verifies)", False),
)


def _median_s(fn, runs: int) -> tuple[float, list[float]]:
    import torch

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def _section(fn, verify_fn, runs: int) -> dict:
    """Warm timings, the stage split, the device profile and the verify of
    one proving function."""
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import (
        PROVE_STAGES,
        TRANSCRIPT_STAGES,
        _device_profile,
        stage_times,
    )
    from qp_zk_circuits_tpu_torch.tools.timing import device_split

    med, times = _median_s(fn, runs)
    split = stage_times(AGG_STAGES + PROVE_STAGES + TRANSCRIPT_STAGES, fn)
    prof = _device_profile(fn)
    _, entries = device_split(fn)
    proof = fn()
    verify_ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        verify_fn(proof)
        verify_ms.append(1e3 * (time.perf_counter() - t0))
    return {
        "warm_s_median": med,
        "warm_s": times,
        "stages_ms": {k: round(v["ms"], 3) for k, v in split.items()},
        "device_ms": prof["device_ms"],
        "device_launches": prof["device_launches"],
        "busy_share": None if prof["device_ms"] is None else prof["device_ms"] / (1e3 * med),
        "top_kernels": {k[:60]: v for k, v in prof["top_kernels"].items()},
        "library_device_ms": {name: {"device_ms": ms, "calls": calls}
                              for name, (ms, calls) in entries.items()},
        "verify_ms_median": statistics.median(verify_ms),
    }


def profile_private_batch(n_leaf: int, runs: int) -> tuple[dict, object, object, object]:
    """The canonical private batch of n_leaf: (record, circuit, a device-rng
    proof, the dummy leaf)."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData
    from qp_zk_circuits_tpu_torch.plonk.verifier import verify
    from qp_zk_circuits_tpu_torch.wormhole.dummy_proof import generate_dummy_proof
    from qp_zk_circuits_tpu_torch.wormhole.private_batch import PrivateBatchCircuit, PrivateBatchProver
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import n_real_leaves_same_block
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    t0 = time.perf_counter()
    leaf_prover = WormholeProver(device="cuda")
    leaf_build_s = time.perf_counter() - t0
    leaves = leaf_prover.prove_inputs_batch(n_real_leaves_same_block(n_leaf), seed=0)
    dummy = generate_dummy_proof(leaf_prover, seed=12)
    t0 = time.perf_counter()
    circuit = PrivateBatchCircuit(VerifierCircuitData.from_circuit_data(leaf_prover.data), n_leaf,
                                  device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    data = circuit.data
    prover = PrivateBatchProver(circuit, WormholeVerifier(leaf_prover.data), dummy)

    def host():
        return prover.aggregate(leaves, seed=20, rng=np.random.default_rng(7), rng_mode="host")

    t0 = time.perf_counter()
    host()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rec = {
        "n_leaf": n_leaf,
        "degree_bits": data.degree_bits,
        "rows_used": data.num_rows_used,
        "fri_rounds": len(data.config.fri_config.reduction_strategy.schedule(data.degree_bits)),
        "leaf_build_s": leaf_build_s,
        "build_s": build_s,
        "cold_host_s": cold_s,
        "host_rng": _section(host, lambda p: verify(data, p), runs),
    }
    t0 = time.perf_counter()
    warm = PrivateBatchProver(circuit, WormholeVerifier(leaf_prover.data), dummy, warm_start=True)
    torch.cuda.synchronize()
    rec["warmup_s"] = time.perf_counter() - t0

    def device():
        return warm.aggregate(leaves, seed=21, rng=np.random.default_rng(8))

    rec["device_rng"] = _section(device, lambda p: verify(data, p), runs)
    return rec, circuit, device(), dummy


def profile_public_batch(circuit, inner, dummy, runs: int) -> dict:
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData
    from qp_zk_circuits_tpu_torch.plonk.verifier import verify
    from qp_zk_circuits_tpu_torch.wormhole import inputs as wi
    from qp_zk_circuits_tpu_torch.wormhole.private_batch import generate_dummy_private_batch_proof
    from qp_zk_circuits_tpu_torch.wormhole.public_batch import PublicBatchCircuit, PublicBatchProver

    dummy_pb = generate_dummy_private_batch_proof(circuit, dummy, rng=np.random.default_rng(9),
                                                  seed=23)
    t0 = time.perf_counter()
    pub = PublicBatchCircuit(VerifierCircuitData.from_circuit_data(circuit.data), 2,
                             circuit.n_leaf, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prover = PublicBatchProver(pub, lambda p: verify(circuit.data, p), dummy_pb)
    address = wi.BytesDigest(bytes([9] * 8) + bytes(24))

    def prove():
        return prover.commit([inner], address).prove(seed=24)

    t0 = time.perf_counter()
    prove()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    return {
        "m": 2,
        "n_leaf": circuit.n_leaf,
        "degree_bits": pub.data.degree_bits,
        "rows_used": pub.data.num_rows_used,
        "fri_rounds": len(pub.data.config.fri_config.reduction_strategy.schedule(
            pub.data.degree_bits)),
        "build_s": build_s,
        "cold_s": cold_s,
        "warm": _section(prove, lambda p: verify(pub.data, p), runs),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--n-leaf", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--public-n", type=int, default=2)
    ap.add_argument("--proofs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    from qp_zk_circuits_tpu_torch.tools.timing import card

    out = {"card": card(), "private_batch": [], "public_batch": None}
    for n in args.n_leaf:
        rec, circuit, inner, dummy = profile_private_batch(n, args.proofs)
        out["private_batch"].append(rec)
        print(f"[agg N={n}] degree_bits {rec['degree_bits']}, build {rec['build_s']:.1f} s, cold "
              f"{rec['cold_host_s']:.2f} s, warm host-rng {rec['host_rng']['warm_s_median']:.3f} s, "
              f"device-rng {rec['device_rng']['warm_s_median']:.3f} s, verify "
              f"{rec['host_rng']['verify_ms_median']:.1f} ms; {out['card']}", flush=True)
        if n == args.public_n:
            out["public_batch"] = profile_public_batch(circuit, inner, dummy, args.proofs)
            pub = out["public_batch"]
            print(f"[agg public m=2, N={n}] degree_bits {pub['degree_bits']}, build "
                  f"{pub['build_s']:.1f} s, cold {pub['cold_s']:.2f} s, warm "
                  f"{pub['warm']['warm_s_median']:.3f} s, verify "
                  f"{pub['warm']['verify_ms_median']:.1f} ms", flush=True)
        del circuit, inner
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
