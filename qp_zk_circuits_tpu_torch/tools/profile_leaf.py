"""Where the time of one Wormhole leaf proof goes, on one CUDA card.

    python -m qp_zk_circuits_tpu_torch.tools.profile_leaf [--proofs 5]

Builds `WormholeProver(device="cuda")`, proves `test_inputs_0()` once to warm
up, then:

  * `--proofs` timed proofs (host clock, ending in a synchronize): median
    and spread of the prove time;
  * one proof with each prover stage wrapped in a host timer that
    synchronizes on exit (witness generation, the three commits, the
    permutation argument, the quotient, openings, FRI composition, fold
    rounds, the grind, the query stage: kernel F's gather, its transfer
    and the host's unpacking into query rounds, and the transcript's host
    Poseidon2 duplexes), printed as inclusive times and call counts;
  * one proof under torch.profiler: device time by kernel and the number of
    device launches; the device's busy share is that device time over the
    median prove time;
  * one proof with each call into the kernel library replayed in a CUDA
    graph (`tools/timing.py::device_split`): the port's own kernels' device
    time by library entry, torch's glue kernels left out.

Prints a JSON object as its last line. The stage timers and the profiler
each add host overhead, so the timed proofs run without them.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import statistics
import time

import torch

from ..fri import oracle as fo
from ..fri import prover as fri_prover
from ..hash import merkle
from ..plonk import prover as plonk_prover
from ..plonk import transcript as ts
from ..tools.timing import card, device_split
from ..wormhole.prover import WormholeProver
from ..wormhole.test_helpers import test_inputs_0

# (module or class, attribute, stage name): the prover's stages as the
# modules that call them see them
STAGES = (
    (plonk_prover, "generate_witness", "witness (host)"),
    (fo, "commit", "oracle commit (iNTT + LDE + tree)"),
    (merkle, "build_merkle_tree", "merkle tree (hash + levels + cap transfer)"),
    (plonk_prover, "compute_permutation_polys", "permutation argument"),
    (plonk_prover, "compute_quotient", "quotient"),
    (fo, "eval_openings", "openings"),
    (plonk_prover, "fri_prove", "fri (all)"),
    (fri_prover, "compute_composition", "fri composition"),
    (fri_prover, "fold_round", "fri fold round"),
    (ts, "grind_pow", "pow grind"),
    (fri_prover, "gather_query_rounds", "queries (gather + transfer + unpack)"),
    (ts.Challenger, "_duplex", "transcript duplex (host Poseidon2)"),
)


def _timed(fn, name, acc):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[name][0] += time.perf_counter() - t0
        acc[name][1] += 1
        return out

    return inner


def _stage_times(prover, inputs) -> dict:
    acc = collections.defaultdict(lambda: [0.0, 0])
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in STAGES]
    try:
        for mod, attr, name in STAGES:
            setattr(mod, attr, _timed(getattr(mod, attr), name, acc))
        t0 = time.perf_counter()
        prover.prove_inputs(inputs, seed=0)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = {name: {"ms": 1e3 * acc[name][0], "calls": acc[name][1]} for _, _, name in STAGES}
    out["total"] = {"ms": 1e3 * total, "calls": 1}
    return out


def _device_profile(prover, inputs) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.prove_inputs(inputs, seed=0)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proofs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_leaf needs a CUDA card")
    prover = WormholeProver(device="cuda")
    inputs = test_inputs_0()
    prover.prove_inputs(inputs, seed=0)  # warm-up: kernel build, cached tables
    times = []
    for _ in range(args.proofs):
        t0 = time.perf_counter()
        prover.prove_inputs(inputs, seed=0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    stages = _stage_times(prover, inputs)
    device = _device_profile(prover, inputs)
    _, split = device_split(lambda: prover.prove_inputs(inputs, seed=0))
    for name, v in stages.items():
        print(f"[stage] {name}: {v['ms']:.2f} ms over {v['calls']} calls")
    for name, v in device["top_kernels"].items():
        print(f"[kernel] {name[:70]}: {v['device_ms']:.3f} ms device, {v['count']} launches")
    for name, (ms, calls) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"[entry] {name}: {ms:.4f} ms device over {calls} calls (graph replay)")
    median = statistics.median(times)
    result = {
        "card": card(),
        "prove_ms": {"median": median, "min": min(times), "max": max(times), "n": len(times)},
        "stages": stages,
        **{k: v for k, v in device.items() if k != "top_kernels"},
        "entry_device_ms": {name: ms for name, (ms, _) in split.items()},
        "entry_calls": {name: calls for name, (_, calls) in split.items()},
        # the profiler slows the host, not the kernels: the busy share is the
        # profiled proof's device time over the unprofiled median
        "device_busy_share": None if device["device_ms"] is None else device["device_ms"] / median,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
