"""Peak-memory + wall-time profiler for the port's proving workloads.

Port of reference `wormhole/memprof/` (memory.rs, report.rs, workload.rs,
config.rs): a single-shot profiler with a condvar-interruptible sampler
thread reading /proc/self/status (VmRSS / VmHWM on Linux), per-phase
bracketing, a report table, a `--peak-target-mb` CI guard, and a config-sweep
mode whose security-weakening knobs sit behind an explicit
`--allow-weakening-security` gate with auto-rebalancing of query rounds
against rate_bits (keeping `num_query_rounds * rate_bits + pow_bits`
at the 100-bit floor).

The workload runs on the port's provers on `--device` (the CUDA card by
default; without CUDA `--device cuda` is refused: no quiet fall-back to the
CPU). Beside each phase's RSS peak it records the card's own peak,
`torch.cuda.max_memory_allocated` over the phase (reset at its start), since
the proof's buffers live on the card; on the CPU that peak is null. MB here
is 2^20 bytes, for the RSS (kB / 1024) and the device peak alike.

    python -m qp_zk_circuits_tpu_torch.tools.memprof --canonical --num-leaf-proofs 2 --json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time

import torch


def _read_rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class MemorySampler:
    """Background sampler; condvar-interruptible (reference memory.rs:17-151)."""

    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self.peak_mb = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.peak_mb = max(self.peak_mb, _read_rss_mb())

    def __enter__(self):
        self.peak_mb = _read_rss_mb()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2)
        self.peak_mb = max(self.peak_mb, _read_rss_mb())

    def mark(self) -> float:
        """Phase boundary: return the peak since the last mark and restart
        peak tracking from the CURRENT rss (phase-separated accounting, like
        the reference memprof's phase bracketing)."""
        now = _read_rss_mb()
        peak = max(self.peak_mb, now)
        self.peak_mb = now
        return round(peak, 1)


@dataclasses.dataclass
class PhaseReport:
    name: str
    wall_secs: float
    peak_mb: float
    device_peak_mb: float | None = None  # None off CUDA


class Profiler:
    """Phases of a workload, each with its wall time, RSS peak and, on a
    CUDA `device`, the card's allocation peak (None otherwise)."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.phases: list[PhaseReport] = []

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def phase(self, name: str):
        prof = self

        class _Ctx:
            def __enter__(self_inner):
                if prof._on_card():
                    torch.cuda.synchronize(prof.device)
                    torch.cuda.reset_peak_memory_stats(prof.device)
                self_inner.sampler = MemorySampler()
                self_inner.sampler.__enter__()
                self_inner.t0 = time.perf_counter()
                return self_inner

            def __exit__(self_inner, *exc):
                device_peak = None
                if prof._on_card():
                    torch.cuda.synchronize(prof.device)
                    device_peak = torch.cuda.max_memory_allocated(prof.device) / 2**20
                wall = time.perf_counter() - self_inner.t0
                self_inner.sampler.__exit__()
                prof.phases.append(
                    PhaseReport(name, wall, self_inner.sampler.peak_mb, device_peak))

        return _Ctx()

    def report(self) -> str:
        def dev(mb):
            return "-" if mb is None else f"{mb:.1f}"

        lines = [f"{'phase':<40} {'wall (s)':>10} {'peak RSS (MB)':>14} {'device peak (MB)':>17}"]
        lines.append("-" * 84)
        for p in self.phases:
            lines.append(f"{p.name:<40} {p.wall_secs:>10.2f} {p.peak_mb:>14.1f} "
                         f"{dev(p.device_peak_mb):>17}")
        if self.phases:
            total = sum(p.wall_secs for p in self.phases)
            peak = max(p.peak_mb for p in self.phases)
            lines.append("-" * 84)
            lines.append(f"{'TOTAL':<40} {total:>10.2f} {peak:>14.1f} "
                         f"{dev(self.device_peak_mb):>17}")
        return "\n".join(lines)

    @property
    def peak_mb(self) -> float:
        return max((p.peak_mb for p in self.phases), default=0.0)

    @property
    def device_peak_mb(self) -> float | None:
        peaks = [p.device_peak_mb for p in self.phases if p.device_peak_mb is not None]
        return max(peaks) if peaks else None


SECURITY_FLOOR_BITS = 100
#: the `source` of the `--json` line (`sweep_shapes.py` takes no other anchor)
SOURCE = "qp_zk_circuits_tpu_torch.tools.memprof"


def rebalance_query_rounds(rate_bits: int, pow_bits: int) -> int:
    """Minimum query rounds keeping rate*rounds + pow >= the 100-bit floor
    (reference memprof/config.rs auto-rebalance)."""
    need = SECURITY_FLOOR_BITS - pow_bits
    return max(1, -(-need // rate_bits))


def run_workload(
    n_leaf_proofs: int,
    profiler: Profiler,
    seed: int = 0,
    include_public_batch: bool = False,
    config=None,
    device=None,
):
    """Phases mirror the reference workload: build leaf / generate N leaf
    proofs / build aggregation / commit+prove (workload.rs:1-144); optional
    public-batch layer on top. The private-batch circuit is built at the
    FULL width N (dummy padding fills the empty slots at commit). Every
    circuit is built and every proof made on `device` (CUDA unless named)."""
    import numpy as np

    from ..plonk.serialization import VerifierCircuitData
    from ..wormhole import test_helpers as th
    from ..wormhole.dummy_proof import generate_dummy_proof
    from ..wormhole.private_batch import (
        PrivateBatchCircuit,
        PrivateBatchProver,
        generate_dummy_private_batch_proof,
    )
    from ..wormhole.prover import WormholeProver
    from ..wormhole.verifier import WormholeVerifier

    with profiler.phase("build leaf circuit"):
        leaf_prover = WormholeProver(device=device)
    with profiler.phase(f"generate {n_leaf_proofs} leaf proofs"):
        # N DISTINCT real spends sharing one block/root: every generated
        # proof is batch-admissible (distinct nullifiers), so the private
        # batch below aggregates the FULL width — no padding, no discards
        all_inputs = th.n_real_leaves_same_block(n_leaf_proofs)
        proofs = [
            leaf_prover.prove_inputs(all_inputs[k], seed=seed + k)
            for k in range(n_leaf_proofs)
        ]
    with profiler.phase("build private-batch circuit"):
        common = VerifierCircuitData.from_circuit_data(leaf_prover.data)
        agg_circuit = PrivateBatchCircuit(common, n_leaf_proofs, config=config, device=device)
        dummy = generate_dummy_proof(leaf_prover, seed=seed)
        agg_prover = PrivateBatchProver(
            agg_circuit, WormholeVerifier(leaf_prover.data), dummy
        )
    with profiler.phase("commit + prove private batch"):
        agg = agg_prover.aggregate(proofs, seed=seed, rng=np.random.default_rng(seed))
    if include_public_batch:
        from functools import partial

        from ..plonk.verifier import verify as plonk_verify
        from ..wormhole import inputs as wi
        from ..wormhole.public_batch import PublicBatchCircuit, PublicBatchProver

        with profiler.phase("prove dummy private batch (padding template)"):
            dummy_pb = generate_dummy_private_batch_proof(agg_circuit, dummy, seed=seed)
        with profiler.phase("build public-batch circuit"):
            pb_common = VerifierCircuitData.from_circuit_data(agg_circuit.data)
            pub_circuit = PublicBatchCircuit(pb_common, 2, n_leaf_proofs, device=device)
            pub_prover = PublicBatchProver(
                pub_circuit, partial(plonk_verify, agg_circuit.data), dummy_pb
            )
        with profiler.phase("commit + prove public batch"):
            addr = wi.BytesDigest(bytes(range(1, 33)))
            pub_prover.commit([agg], addr).prove(seed=seed)
    return profiler


def card_label(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them ("NVIDIA
    H100 80GB HBM3, 700.00 W"); None off CUDA."""
    from .timing import card

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return card(torch.cuda.current_device() if device.index is None else device.index)


def json_record(prof: Profiler, n_leaf: int, canonical: bool) -> dict:
    """The `--json` line: the private batch's prove seconds, the RSS and
    device peaks, each phase's [wall s, RSS peak, device peak], and the
    card it ran on (None on the CPU)."""
    def rounded(mb):
        return None if mb is None else round(mb, 1)

    agg_phase = next(
        (p for p in prof.phases if p.name.startswith("commit + prove private")), None
    )
    return {
        "source": SOURCE,
        "metric": "private_batch_prove_s",
        "value": round(agg_phase.wall_secs, 3) if agg_phase else None,
        "unit": "s",
        "n_leaf": n_leaf,
        "config": "canonical-zk" if canonical else "sweep",
        "device": None if prof.device is None else str(prof.device),
        "card": None if prof.device is None else card_label(prof.device),
        "peak_mb": round(prof.peak_mb, 1),
        "device_peak_mb": rounded(prof.device_peak_mb),
        "phases": {
            p.name: [round(p.wall_secs, 3), round(p.peak_mb, 1), rounded(p.device_peak_mb)]
            for p in prof.phases
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="peak-memory profiler for proving workloads")
    ap.add_argument("--num-leaf-proofs", type=int, default=2)
    ap.add_argument("--peak-target-mb", type=float, default=None, help="CI guard: fail if exceeded")
    ap.add_argument("--rate-bits", type=int, default=3)
    ap.add_argument("--pow-bits", type=int, default=16)
    ap.add_argument("--num-routed-wires", type=int, default=None,
                    help="override routed wires of the private-batch config")
    ap.add_argument("--canonical", action="store_true",
                    help="run the canonical ZK private-batch profile "
                    "(135/60 wires, 28 queries, 16 PoW — the reference's "
                    "wormhole_private_batch_circuit_config)")
    ap.add_argument("--include-public-batch", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="emit one BENCH-style JSON line after the table")
    ap.add_argument(
        "--allow-weakening-security",
        action="store_true",
        help="required for any knob that would drop below the 100-bit floor",
    )
    ap.add_argument("--device", default="cuda",
                    help="where the circuits are built and proven (default: the CUDA card)")
    args = ap.parse_args(argv)

    rounds = rebalance_query_rounds(args.rate_bits, args.pow_bits)
    achieved = rounds * args.rate_bits + args.pow_bits
    if achieved < SECURITY_FLOOR_BITS and not args.allow_weakening_security:
        print(
            f"refusing config below {SECURITY_FLOOR_BITS}-bit floor "
            f"(achieved {achieved}); pass --allow-weakening-security to override",
            file=sys.stderr,
        )
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: CUDA is not available (pass --device cpu)",
              file=sys.stderr)
        return 2

    config = None
    if args.canonical:
        from ..utils.config_policy import wormhole_private_batch_circuit_config

        config = wormhole_private_batch_circuit_config()
    if args.num_routed_wires is not None or not args.canonical:
        # non-canonical runs honor the sweep knobs (reference memprof/config.rs)
        import dataclasses as dc

        from ..fri.config import FriConfig, FriReductionStrategy
        from ..utils.config_policy import wormhole_private_batch_circuit_config

        base = config or wormhole_private_batch_circuit_config()
        fri = FriConfig(
            rate_bits=args.rate_bits,
            cap_height=base.fri_config.cap_height,
            proof_of_work_bits=args.pow_bits,
            num_query_rounds=rounds,
            reduction_strategy=FriReductionStrategy(4, 5),
        )
        config = dc.replace(
            base,
            num_routed_wires=args.num_routed_wires or base.num_routed_wires,
            fri_config=base.fri_config if args.canonical else fri,
        )

    prof = Profiler(device)
    run_workload(
        args.num_leaf_proofs,
        prof,
        include_public_batch=args.include_public_batch,
        config=config,
        device=device,
    )
    print(prof.report())
    if args.json:
        import json

        print(json.dumps(json_record(prof, args.num_leaf_proofs, args.canonical)))
    if args.peak_target_mb is not None and prof.peak_mb > args.peak_target_mb:
        print(
            f"FAIL: peak RSS {prof.peak_mb:.1f} MB exceeds target {args.peak_target_mb} MB",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
