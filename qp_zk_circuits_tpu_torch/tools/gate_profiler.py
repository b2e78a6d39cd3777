"""Gate profiling: per-fragment gate-count checkpoints + circuit metrics
(the port's copy; host-only, shapes of a built `CircuitData`).

Port of reference `wormhole/circuit/src/profile.rs:17-72` (the `profile`
cargo feature): `GateProfiler` reports gate-count deltas between named
checkpoints while building, and `print_circuit_metrics` dumps the built
circuit's shape (degree bits, rows by gate type, PI count)."""

from __future__ import annotations

from collections import Counter


class GateProfiler:
    def __init__(self, builder):
        self.builder = builder
        self._last = builder.num_gates()
        self.checkpoints: list[tuple[str, int]] = []

    def checkpoint(self, name: str) -> int:
        now = self.builder.num_gates()
        delta = now - self._last
        self.checkpoints.append((name, delta))
        self._last = now
        return delta

    def report(self) -> str:
        lines = [f"{'fragment':<44} {'rows':>8}"]
        lines.append("-" * 54)
        for name, delta in self.checkpoints:
            lines.append(f"{name:<44} {delta:>8}")
        lines.append("-" * 54)
        lines.append(f"{'total':<44} {self.builder.num_gates():>8}")
        return "\n".join(lines)


def circuit_metrics(data) -> dict:
    """Shape summary of a built circuit (reference print_circuit_metrics)."""
    rows_by_gate = Counter(g.key() for g in data.row_gate)
    return {
        "degree_bits": data.degree_bits,
        "rows": data.n,
        "rows_used": data.num_rows_used,
        "rows_by_gate": dict(rows_by_gate),
        "num_gate_types": len(data.gate_types),
        "num_public_inputs": len(data.public_input_targets),
        "num_preprocessed_columns": data.num_preprocessed,
        "num_wires": data.config.num_wires,
        "num_routed_wires": data.config.num_routed_wires,
        "lde_size": data.n << data.config.rate_bits,
    }


def print_circuit_metrics(data) -> None:
    for k, v in circuit_metrics(data).items():
        print(f"  {k}: {v}")
