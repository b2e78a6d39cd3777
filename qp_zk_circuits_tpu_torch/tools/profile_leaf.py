"""Where the time of one Wormhole leaf proof and its verify goes, on one CUDA
card and its host.

    python qp_zk_circuits_tpu_torch/tools/profile_leaf.py [--root DIR] [--proofs 5] [--verifies 5]
    python qp_zk_circuits_tpu_torch/tools/profile_leaf.py [--root DIR] --batch K [--stream N --chunk K]
    python qp_zk_circuits_tpu_torch/tools/profile_leaf.py [--root DIR] --zk [--rng device] [...]

Runs the checkout at `--root` (default: the checkout this file lies in), so
two checkouts can be timed in turns by separate processes, one after the
other (parent, change, change, parent); a stage a checkout does not have is
left out. A single proof takes `prove`'s own dispatch (the fused prover at
the leaf's degree, where the checkout has one); QZKT_STAGED_PROVER=1 in the
environment profiles the staged prover instead. Builds the kernel library (and the host library, where the
checkout has one), then `WormholeProver(device="cuda")` on `test_inputs_0()`:

  * the cold proof, the first of the prover (it also records the witness
    program by the Python replay), host clock;
  * `--proofs` timed proofs (host clock, ending in a synchronize): median
    and spread of the prove time, and the first of them alone (the second
    proof of the prover, which lowers the witness tape where the checkout
    has one);
  * one proof with each prover stage wrapped in a host timer, printed as
    inclusive times and call counts: witness generation, the three commits,
    the permutation argument, the quotient, openings, FRI composition, fold
    rounds, the grind, the query stage (kernel F's gather, its transfer and
    the host's unpacking into query rounds), and the transcript's host
    Poseidon2 (`Challenger._duplex`, and `native.absorb_many` where the
    checkout has it). A stage that launches kernels ends in a synchronize;
    the transcript's stages launch none and do not synchronize;
  * the verify of the warm proof by `WormholeVerifier(prover.data)`: the
    first verify (it records the constraint tape where the checkout has
    one), the median of `--verifies` more, and one verify split into the
    transcript (its duplexes and absorbs), the vanishing check, the FRI
    query rounds (`fri/verifier.py::_query_rounds`, where the checkout has
    it) and all of `fri_verify` (the FRI transcript and the query rounds);
  * one proof under torch.profiler: device time by kernel and the number of
    device launches; the device's busy share is that device time over the
    median prove time;
  * one proof with each call into the kernel library replayed in a CUDA
    graph (`tools/timing.py::device_split`): the port's own kernels' device
    time by library entry, torch's glue kernels left out.

With `--batch K` and/or `--stream N --chunk K` it profiles the batch and
stream paths instead (`prove_inputs_batch`, `prove_inputs_stream` on the
two real spends of `two_real_leaves_same_block()`, alternating), beside
the warm single proof's median. They take `prove_batch`'s and
`prove_stream`'s own dispatch: the fused batch and stream
(plonk/prover_fused.py, where the checkout has them), or the staged ones
with QZKT_STAGED_PROVER=1 in the environment:

  * a batch of K: the cold batch, then `--proofs` timed batches (median ms
    a batch and a proof); one batch under torch.profiler (device ms a
    proof, the device's busy share, device launches a batch, torch's glue
    kernels included); the split of a batch: for the fused batch the
    medians of its host split over the timed batches (`_last_prove_timings`:
    witness and pack, upload, dispatch, the wait for the card and the
    download, unpack), no stage timer (a synchronize between stages would
    undo the one round trip); for the staged batch one batch with each
    stage wrapped in a host timer, split into the witness, the commits, B,
    the quotient, the openings, FRI's commit phase, the grind, the
    queries, and the transcript's host calls (the lockstep absorbs and
    duplexes, and each proof's FRI transcript);
  * a stream of N in chunks of K (a generator of inputs): `--proofs` timed
    streams (median ms a proof), then its split: for the fused stream the
    medians of its host split summed over the chunks (the witness and pack
    of chunk i+1 run while the card proves chunk i; the wait is what the
    card took past them); for the staged stream one stream with the
    witness (on the worker thread, not synchronized) and each chunk's
    proving timed: the proving thread's wait for witnesses is the stream's
    time less its proving, and the witness time hidden behind the proving
    is the witness time less that wait.

With `--zk` every section runs the ZK leaf instead: the leaf circuit under
the private batch's config (`wormhole_private_batch_circuit_config()`:
row blinding and salted oracles, 60 routed wires, degree 9), seed 7, for
the same split; `--rng device` makes the single proofs device-rng proofs
(`plonk.prover.prove(..., rng_mode="device")`: kernel G draws the blinding
rows and salts on the card), where batches and streams stay host-rng, as
in the JAX package. A checkout without ZK proving raises.

Prints a JSON object as its last line. The stage timers and the profiler
each add host overhead, so the timed proofs run without them.
"""

from __future__ import annotations

import argparse
import collections
import functools
import importlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

# (module, attribute, stage name, synchronizes): the prover's stages as the
# modules that call them see them; module names under qp_zk_circuits_tpu_torch
PROVE_STAGES = (
    ("plonk.prover", "witness_trace", "witness (host)", True),
    ("plonk.prover", "generate_witness", "witness (host)", True),  # an older checkout's name
    ("plonk.prover", "zk_draws", "ZK draws (host rng: blinding rows, salts)", False),
    ("field.random", "rand_felts", "ZK draws (device rng: kernel G)", True),
    ("fri.oracle", "commit", "oracle commit (iNTT + LDE + tree)", True),
    ("hash.merkle", "build_merkle_tree", "merkle tree (hash + levels + cap transfer)", True),
    ("plonk.prover", "compute_permutation_polys", "permutation argument", True),
    ("plonk.prover", "compute_quotient", "quotient", True),
    ("fri.oracle", "eval_openings", "openings", True),
    ("plonk.prover", "fri_prove", "fri (all)", True),
    ("fri.prover", "compute_composition", "fri composition", True),
    ("fri.prover", "fold_round", "fri fold round", True),
    ("plonk.transcript", "grind_pow", "pow grind", True),
    ("fri.prover", "gather_query_rounds", "queries (gather + transfer + unpack)", True),
)
TRANSCRIPT_STAGES = (
    ("plonk.transcript.Challenger", "_duplex", "transcript duplex (host Poseidon2)", False),
    ("native", "absorb_many", "transcript absorb (host Poseidon2)", False),
)
BATCH_STAGES = (
    ("plonk.prover", "generate_witness_batch", "witness (host, tape over K)", True),
    ("plonk.builder", "zk_draws", "ZK draws (host rng, in the witness)", False),
    ("fri.oracle", "commit_batch", "oracle commits (stacked iNTT + LDE + forest)", True),
    ("plonk.prover", "compute_permutation_polys_batch", "permutation argument (B)", True),
    ("plonk.prover", "compute_quotient_batch", "quotient (A + coset iNTT)", True),
    ("fri.oracle", "eval_openings", "openings (D, a proof; an older checkout)", True),
    ("plonk.prover", "fri_commit_phase", "fri commit phase (a proof; an older checkout)", True),
    ("plonk.prover", "fri_query_phase", "fri queries (a proof; an older checkout)", True),
    ("fri.oracle", "eval_openings_batch", "openings (D, all K)", True),
    ("plonk.prover", "fri_commit_phase_batch",
     "fri commit phase (C, forests, E, stacked final iNTT; all K)", True),
    ("plonk.transcript", "grind_pow_batch", "pow grind (all K)", True),
    ("plonk.prover", "fri_query_phase_batch", "fri queries (F, all K)", True),
)
BATCH_TRANSCRIPT_STAGES = (
    ("native", "absorb_batch", "transcript absorb, K in lockstep (host Poseidon2)", False),
    ("native", "duplex_batch", "transcript duplex, K in lockstep (host Poseidon2)", False),
) + TRANSCRIPT_STAGES
STREAM_STAGES = (
    ("plonk.prover", "generate_witness_batch", "witness (worker thread)", False),
    ("plonk.prover", "prove_from_traces", "proving (main thread)", True),
)
VERIFY_STAGES = (
    ("plonk.verifier", "verify_vanishing_at_zeta", "vanishing check", False),
    ("fri.verifier", "_query_rounds", "fri query rounds", False),
    ("plonk.verifier", "fri_verify", "fri_verify (transcript + query rounds)", False),
)


def _resolve(path: str):
    """The module or class at `qp_zk_circuits_tpu_torch.<path>`, or None."""
    parts = path.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module("qp_zk_circuits_tpu_torch." + ".".join(parts[:cut]))
        except ImportError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr, None)
        return obj
    return None


def _timed(fn, name, acc, sync):
    import torch

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        acc[name][0] += time.perf_counter() - t0
        acc[name][1] += 1
        return out

    return inner


def stage_times(stages, run) -> dict:
    """Run `run()` once with each stage present in the checkout wrapped in a
    timer; returns {stage: {"ms", "calls"}}, the total, and the transcript's
    stages summed."""
    import torch

    acc = collections.defaultdict(lambda: [0.0, 0])
    present = [(owner, attr, name, sync) for path, attr, name, sync in stages
               if (owner := _resolve(path)) is not None and hasattr(owner, attr)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _, _ in present]
    try:
        for owner, attr, name, sync in present:
            setattr(owner, attr, _timed(getattr(owner, attr), name, acc, sync))
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    out = {name: {"ms": 1e3 * acc[name][0], "calls": acc[name][1]} for _, _, name, _ in present}
    out["total"] = {"ms": 1e3 * total, "calls": 1}
    names = [name for _, _, name, _ in TRANSCRIPT_STAGES if name in out]
    if names:
        out["transcript (duplex + absorb)"] = {key: sum(out[n][key] for n in names)
                                               for key in ("ms", "calls")}
    return out


def _device_profile(prove) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        # device-side events only: a CPU op's row repeats its kernels' time
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = {"device_ms": e.self_device_time_total / 1e3, "count": e.count}
    device_ms = sum(k["device_ms"] for k in kernels.values())
    launches = sum(k["count"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])[:12])
    return {
        "profiled_wall_ms": 1e3 * wall,
        "device_ms": device_ms if kernels else None,
        "device_launches": launches if kernels else None,
        "top_kernels": top,
    }


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def _prove_fn(prover, args):
    """prove(inputs, seed): the single proof the arguments ask for."""
    if args.rng == "device":
        from qp_zk_circuits_tpu_torch.plonk import prover as plonk_prover

        return lambda inputs, seed: plonk_prover.prove(
            prover.data, prover._partial_witness(inputs), seed=seed, rng_mode="device")
    return lambda inputs, seed: prover.prove_inputs(inputs, seed=seed)


#: the fused batch's and stream's host split (`_last_prove_timings`)
FUSED_SPLIT = (("witness_pack_s", "witness and pack (host)"), ("upload_s", "upload"),
               ("dispatch_s", "dispatch (enqueue every stage)"),
               ("execute_fetch_s", "wait for the card and download"), ("unpack_s", "unpack"))


def _fused_split(prover) -> dict:
    return dict(prover.data.__dict__.get("_last_prove_timings") or {})


def _split_stages(splits: list) -> dict:
    """The medians of the fused path's host split over timed runs, as
    {stage: {"ms", "calls"}}."""
    return {name: {"ms": 1e3 * statistics.median(s[key] for s in splits), "calls": len(splits)}
            for key, name in FUSED_SPLIT if all(key in s for s in splits)}


def _batch_sections(prover, args, seed) -> dict:
    """The batch and stream profiles (the module docstring says what)."""
    import torch

    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import two_real_leaves_same_block

    leaves = two_real_leaves_same_block()
    out = {}
    prove_one = _prove_fn(prover, args)
    fused = not os.environ.get("QZKT_STAGED_PROVER") and _resolve(
        "plonk.prover_fused.prove_fused_batch") is not None

    def single():
        prove_one(leaves[0], seed)
        torch.cuda.synchronize()

    single()
    out["single_prove_ms"] = statistics.median(_host_ms(single) for _ in range(args.proofs))
    if args.batch:
        k = args.batch
        inputs = [leaves[i % 2] for i in range(k)]

        def batch():
            prover.prove_inputs_batch(inputs, seed=seed)
            torch.cuda.synchronize()

        cold = _host_ms(batch)
        times, splits = [], []
        for _ in range(args.proofs):
            times.append(_host_ms(batch))
            splits.append(_fused_split(prover))
        median = statistics.median(times)
        device = _device_profile(batch)
        stages = _split_stages(splits) if fused else stage_times(
            BATCH_STAGES + BATCH_TRANSCRIPT_STAGES, batch)
        out["batch"] = {
            "k": k, "fused": fused, "cold_ms": cold, "median_ms": median, "ms_a_proof": median / k,
            "min_ms": min(times), "max_ms": max(times), "n": len(times),
            "device_ms_a_proof": None if device["device_ms"] is None else device["device_ms"] / k,
            "device_busy_share": None if device["device_ms"] is None else device["device_ms"] / median,
            "device_launches": device["device_launches"], "stages": stages,
            "top_kernels": device["top_kernels"],
        }
        print(f"[batch] K = {k}: cold {cold:.2f} ms, warm median {median:.2f} ms "
              f"({median / k:.2f} ms a proof; single proof {out['single_prove_ms']:.2f}); "
              f"device {out['batch']['device_ms_a_proof']} ms a proof, busy "
              f"{out['batch']['device_busy_share']}, {device['device_launches']} launches a batch")
        for name, v in stages.items():
            print(f"[batch stage] {name}: {v['ms']:.2f} ms over {v['calls']} calls")
    if args.stream:
        n, chunk = args.stream, args.chunk
        inputs = [leaves[i % 2] for i in range(n)]

        def stream():
            prover.prove_inputs_stream((x for x in inputs), batch=chunk, seed=seed)
            torch.cuda.synchronize()

        stream()
        times, splits = [], []
        for _ in range(args.proofs):
            times.append(_host_ms(stream))
            splits.append(_fused_split(prover))
        if fused:
            stages = _split_stages(splits)
            out["stream"] = {"n": n, "chunk": chunk, "fused": True,
                             "median_ms": statistics.median(times),
                             "ms_a_proof": statistics.median(times) / n, "stages": stages}
            print(f"[stream] {n} in chunks of {chunk}, fused: median "
                  f"{out['stream']['median_ms']:.2f} ms ({out['stream']['ms_a_proof']:.2f} ms a "
                  f"proof); split summed over the chunks (medians): "
                  + ", ".join(f"{name} {v['ms']:.2f} ms" for name, v in stages.items()))
            return out
        stages = stage_times(STREAM_STAGES, stream)
        wall = stages["total"]["ms"]
        proving = stages["proving (main thread)"]["ms"]
        witness = stages["witness (worker thread)"]["ms"]
        waited = wall - proving
        out["stream"] = {
            "n": n, "chunk": chunk, "fused": False, "median_ms": statistics.median(times),
            "ms_a_proof": statistics.median(times) / n, "timed_wall_ms": wall,
            "proving_ms": proving, "witness_ms": witness, "waited_ms": waited,
            "witness_hidden_ms": witness - waited,
        }
        print(f"[stream] {n} in chunks of {chunk}: median {out['stream']['median_ms']:.2f} ms "
              f"({out['stream']['ms_a_proof']:.2f} ms a proof); one timed stream {wall:.2f} ms: "
              f"proving {proving:.2f}, witness {witness:.2f} on the worker, the proving thread "
              f"waited {waited:.2f}, so {witness - waited:.2f} ms of witness hid behind proving")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--proofs", type=int, default=5)
    ap.add_argument("--verifies", type=int, default=5)
    ap.add_argument("--batch", type=int, default=0, help="profile batches of K proofs")
    ap.add_argument("--stream", type=int, default=0, help="profile a stream of N proofs")
    ap.add_argument("--chunk", type=int, default=16, help="the stream's chunk")
    ap.add_argument("--zk", action="store_true",
                    help="the leaf under the private batch's ZK config, seed 7")
    ap.add_argument("--rng", choices=("host", "device"), default="host",
                    help="where a ZK single proof draws its blinding rows and salts")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_leaf needs a CUDA card")
    # the package is the checkout's at --root: forget any other copy
    for name in [n for n in sys.modules if n.partition(".")[0] == "qp_zk_circuits_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import qp_zk_circuits_tpu_torch
    from qp_zk_circuits_tpu_torch import _cuda
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
    from qp_zk_circuits_tpu_torch.tools.timing import card, device_split
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import test_inputs_0
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    _cuda.lib()
    native = _resolve("native")
    host_flags = None
    if native is not None:
        host_flags = native.flags()
    config, seed = None, 0
    if args.zk:
        from qp_zk_circuits_tpu_torch.utils.config_policy import (
            wormhole_private_batch_circuit_config,
        )

        config, seed = wormhole_private_batch_circuit_config(), 7
    t0 = time.perf_counter()
    prover = WormholeProver(config, device="cuda")
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    mode = {"zk": args.zk, "rng": args.rng if args.zk else None, "seed": seed}
    if args.batch or args.stream:
        result = {"card": card(), "root": args.root, "host_flags": host_flags,
                  "build_ms": build_ms, **mode, **_batch_sections(prover, args, seed)}
        print(json.dumps(result))
        return
    inputs = test_inputs_0()
    prove_one = _prove_fn(prover, args)

    def prove():
        out = prove_one(inputs, seed)
        torch.cuda.synchronize()
        return out

    cold_ms = _host_ms(prove)
    times = [_host_ms(prove) for _ in range(args.proofs)]
    stages = stage_times(PROVE_STAGES + TRANSCRIPT_STAGES, prove)

    blob = proof_to_bytes(prove())
    verifier = WormholeVerifier(prover.data)
    first_verify_ms = _host_ms(lambda: verifier.verify(proof_from_bytes(blob)))
    proofs = [proof_from_bytes(blob) for _ in range(args.verifies + 1)]
    verify_times = [_host_ms(lambda p=p: verifier.verify(p)) for p in proofs[:-1]]
    split = stage_times(VERIFY_STAGES + TRANSCRIPT_STAGES, lambda: verifier.verify(proofs[-1]))

    device = _device_profile(prove)
    _, entries = device_split(prove)
    print(f"[package] {qp_zk_circuits_tpu_torch.__file__}; host library flags: {host_flags}")
    print(f"[prove] build {build_ms:.2f} ms, cold proof {cold_ms:.2f} ms, second proof "
          f"{times[0]:.2f} ms, warm median {statistics.median(times):.2f} ms over {len(times)}")
    for name, v in stages.items():
        print(f"[stage] {name}: {v['ms']:.2f} ms over {v['calls']} calls")
    print(f"[verify] first {first_verify_ms:.2f} ms, median {statistics.median(verify_times):.2f} "
          f"ms over {len(verify_times)}")
    for name, v in split.items():
        print(f"[verify stage] {name}: {v['ms']:.2f} ms over {v['calls']} calls")
    for name, v in device["top_kernels"].items():
        print(f"[kernel] {name[:70]}: {v['device_ms']:.3f} ms device, {v['count']} launches")
    for name, (ms, calls) in sorted(entries.items(), key=lambda kv: -kv[1][0]):
        print(f"[entry] {name}: {ms:.4f} ms device over {calls} calls (graph replay)")
    median = statistics.median(times)
    result = {
        "card": card(),
        "root": args.root,
        "host_flags": host_flags,
        "build_ms": build_ms,
        **mode,
        "cold_prove_ms": cold_ms,
        "second_prove_ms": times[0],
        "prove_ms": {"median": median, "min": min(times), "max": max(times), "n": len(times)},
        "stages": stages,
        "verify_ms": {"first": first_verify_ms, "median": statistics.median(verify_times),
                      "min": min(verify_times), "max": max(verify_times),
                      "n": len(verify_times)},
        "verify_stages": split,
        **{k: v for k, v in device.items() if k != "top_kernels"},
        "entry_device_ms": {name: ms for name, (ms, _) in entries.items()},
        "entry_calls": {name: calls for name, (_, calls) in entries.items()},
        # the profiler slows the host, not the kernels: the busy share is the
        # profiled proof's device time over the unprofiled median
        "device_busy_share": None if device["device_ms"] is None else device["device_ms"] / median,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
