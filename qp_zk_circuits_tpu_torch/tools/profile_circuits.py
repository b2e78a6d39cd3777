"""Circuit-shape profiling: security tradeoffs + aggregation scaling (the
port's; host-only).

Counterpart of the reference's `profile` cargo feature:

- `wormhole_circuit_profile`     — reference `wormhole/circuit/src/profile.rs:80-119`
  (build the leaf circuit at the ZK and non-ZK profiles, print metrics)
- `security_tradeoffs`           — reference `wormhole/circuit/src/profile.rs:127-189`
  (vary num_query_rounds / proof_of_work_bits at rate 3, report degree bits)
- `aggregation_scaling`          — reference `wormhole/aggregator/src/profile.rs:187-226`
  (private-batch degree / gates / PI length as the leaf count grows)

All profiles build circuits SHAPE-ONLY (`build(shape_only=True)`: no
preprocessing commit, no device), so this tool runs on the host alone and is
safe to run while the card is busy. The aggregation profile uses a fake leaf
verifier-data with distinct dummy cap felts — constant deduplication in the
builder makes the resulting shape identical to one built over real leaf data
(the reference does the same via `build_fake_leaf_circuit_data_only`,
`wormhole/aggregator/src/profile.rs:193`).

CLI:
    python -m qp_zk_circuits_tpu_torch.tools.profile_circuits circuit
    python -m qp_zk_circuits_tpu_torch.tools.profile_circuits security
    python -m qp_zk_circuits_tpu_torch.tools.profile_circuits scaling [--n 2 4 8 16]
    python -m qp_zk_circuits_tpu_torch.tools.profile_circuits gadget
"""

from __future__ import annotations

import argparse
import functools
import json
from dataclasses import replace

import numpy as np

from ..fri.config import FriConfig, FriReductionStrategy
from ..plonk.config import CircuitConfig
from ..plonk.serialization import VerifierCircuitData
from ..utils.config_policy import (
    wormhole_leaf_circuit_config,
    wormhole_private_batch_circuit_config,
)
from .gate_profiler import circuit_metrics


def _leaf_shape(config: CircuitConfig):
    from ..wormhole.leaf_circuit import WormholeCircuit

    return WormholeCircuit(config).build(shape_only=True)


def wormhole_circuit_profile() -> dict:
    """Leaf-circuit metrics at the ZK and non-ZK profiles
    (reference `profile.rs:80-119`)."""
    out = {}
    out["zk"] = circuit_metrics(_leaf_shape(wormhole_private_batch_circuit_config()))
    out["no_zk"] = circuit_metrics(_leaf_shape(wormhole_leaf_circuit_config()))
    return out


# (name, num_query_rounds, proof_of_work_bits, expected_security_bits) at
# rate_bits=3 — the same grid the reference sweeps (`profile.rs:142-156`).
SECURITY_GRID = [
    ("Standard ZK (100-bit)", 28, 16, 100),
    ("88-bit", 24, 16, 88),
    ("85-bit", 23, 16, 85),
    ("82-bit", 22, 16, 82),
    ("79-bit", 21, 16, 79),
    ("76-bit", 20, 16, 76),
    ("84-bit (22q + 18pow)", 22, 18, 84),
    ("81-bit (21q + 18pow)", 21, 18, 81),
    ("80-bit (20q + 20pow)", 20, 20, 80),
    ("79-bit (19q + 22pow)", 19, 22, 79),
]


def security_tradeoffs(grid=None) -> list[dict]:
    """Build the full leaf circuit per FRI config; report degree bits
    (reference `profile.rs:127-189`). The proof-size driver is
    num_query_rounds; the circuit size driver is degree_bits."""
    rows = []
    for name, q, pow_bits, bits in grid or SECURITY_GRID:
        config = replace(
            wormhole_private_batch_circuit_config(),
            security_bits=bits,
            fri_config=FriConfig(
                rate_bits=3,
                cap_height=4,
                proof_of_work_bits=pow_bits,
                num_query_rounds=q,
                reduction_strategy=FriReductionStrategy(4, 5),
            ),
        )
        assert config.fri_config.security_bits() == bits
        data = _leaf_shape(config)
        rows.append(
            {
                "name": name,
                "num_query_rounds": q,
                "proof_of_work_bits": pow_bits,
                "security_bits": bits,
                "degree_bits": data.degree_bits,
                "circuit_size": data.n,
            }
        )
    return rows


def fake_leaf_verifier_data(config: CircuitConfig | None = None) -> VerifierCircuitData:
    """Shape-faithful leaf verifier-data with dummy (distinct) cap felts.

    Reference analogue: `build_fake_leaf_circuit_data_only`
    (`wormhole/aggregator/src/profile.rs:193`). Building the real leaf gives
    the true gate list / degree / PI count; only the cap + digest values are
    synthetic, and those are baked into the recursion gadget as *distinct
    constants* either way, so downstream circuit SHAPES are identical."""
    config = config or wormhole_leaf_circuit_config()
    data = _leaf_shape(config)
    n_cap = 1 << config.fri_config.cap_height
    cap = (np.arange(n_cap * 4, dtype=np.uint64) + 1).reshape(n_cap, 4) * np.uint64(
        0x9E3779B97F4A7C15
    )
    digest = cap[0] ^ np.uint64(0xD1B54A32D192ED03)
    return VerifierCircuitData(
        config=config,
        degree_bits=data.degree_bits,
        gate_types=list(data.gate_types),
        num_selectors=data.num_selectors,
        num_const_cols=data.const_cols.shape[0],
        constants_cap=cap,
        circuit_digest=digest,
        num_public_inputs=len(data.public_input_targets),
    )


def private_batch_shape(n_leaf: int, config: CircuitConfig | None = None,
                        leaf_config: CircuitConfig | None = None,
                        enforce_security_floor: bool = True):
    """The shape-only private-batch `CircuitData` of `n_leaf` leaves at
    `config` (canonical by default) over `fake_leaf_verifier_data(leaf_config)`.
    A build takes seconds (7-8 s at N = 2 on a CPU), and the profiles and
    sweeps ask for the canonical shape many times: each shape is built once
    a process."""
    return _private_batch_shape(n_leaf, config or wormhole_private_batch_circuit_config(),
                                leaf_config or wormhole_leaf_circuit_config(),
                                enforce_security_floor)


@functools.cache
def _private_batch_shape(n_leaf, config, leaf_config, enforce_security_floor):
    from ..wormhole.private_batch import PrivateBatchCircuit

    return PrivateBatchCircuit(fake_leaf_verifier_data(leaf_config), n_leaf, config=config,
                               shape_only=True,
                               enforce_security_floor=enforce_security_floor).data


def gadget_cost_vs_leaf_fri(grid=None, n_leaf: int = 2) -> list[dict]:
    """How the LEAF FRI config drives the aggregator's recursion-gadget size.

    The reference's tradeoff table (`profile.rs:127-189`) shows cheaper FRI
    configs don't shrink the leaf circuit; the real payoff is downstream —
    fewer query rounds mean fewer in-circuit FRI checks when the private
    batch verifies each leaf proof recursively. This sweep builds the
    private-batch circuit (shape-only) against leaves proven at each config
    and reports the rows the gadget costs."""
    rows = []
    for name, q, pow_bits, bits in grid or SECURITY_GRID:
        leaf_config = replace(
            wormhole_leaf_circuit_config(),
            security_bits=bits,
            fri_config=FriConfig(
                rate_bits=3,
                cap_height=4,
                proof_of_work_bits=pow_bits,
                num_query_rounds=q,
                reduction_strategy=FriReductionStrategy(4, 5),
            ),
        )
        data = private_batch_shape(n_leaf, leaf_config=leaf_config,
                                   enforce_security_floor=bits >= 100)
        rows.append(
            {
                "leaf_config": name,
                "num_query_rounds": q,
                "security_bits": bits,
                "pb_degree_bits": data.degree_bits,
                "pb_rows_used": data.num_rows_used,
            }
        )
    return rows


def aggregation_scaling(n_list=(2, 4, 8, 16), leaf_common=None) -> list[dict]:
    """Private-batch degree / gate count / PI length per leaf count
    (reference `wormhole/aggregator/src/profile.rs:187-226`)."""
    from ..wormhole.private_batch import PrivateBatchCircuit

    rows = []
    for n in n_list:
        if leaf_common is None:
            data = private_batch_shape(n)
        else:
            data = PrivateBatchCircuit(leaf_common, n, shape_only=True).data
        rows.append(
            {
                "num_leaves": n,
                "degree_bits": data.degree_bits,
                "gates": data.n,
                "rows_used": data.num_rows_used,
                "num_public_inputs": len(data.public_input_targets),
            }
        )
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="circuit shape profiles (host-only)")
    ap.add_argument("what", choices=["circuit", "security", "scaling", "gadget"])
    ap.add_argument("--n", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.what == "circuit":
        out = wormhole_circuit_profile()
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            for mode, m in out.items():
                print(f"\n=== wormhole leaf circuit ({mode}) ===")
                for k, v in m.items():
                    print(f"  {k}: {v}")
    elif args.what == "security":
        rows = security_tradeoffs()
        if args.json:
            print(json.dumps(rows, indent=2))
        else:
            print(f"{'config':<26} {'queries':>7} {'pow':>4} {'bits':>5} {'deg':>4} {'size':>7}")
            for r in rows:
                print(
                    f"{r['name']:<26} {r['num_query_rounds']:>7} {r['proof_of_work_bits']:>4}"
                    f" {r['security_bits']:>5} {r['degree_bits']:>4} {r['circuit_size']:>7}"
                )
    elif args.what == "gadget":
        rows = gadget_cost_vs_leaf_fri()
        if args.json:
            print(json.dumps(rows, indent=2))
        else:
            print(f"{'leaf config':<26} {'queries':>7} {'bits':>5} {'pb deg':>6} {'pb rows':>9}")
            for r in rows:
                print(
                    f"{r['leaf_config']:<26} {r['num_query_rounds']:>7} {r['security_bits']:>5}"
                    f" {r['pb_degree_bits']:>6} {r['pb_rows_used']:>9}"
                )
    else:
        rows = aggregation_scaling(tuple(args.n))
        if args.json:
            print(json.dumps(rows, indent=2))
        else:
            print(f"{'leaves':>6} {'degree_bits':>11} {'gates':>9} {'rows_used':>9} {'PI len':>7}")
            for r in rows:
                print(
                    f"{r['num_leaves']:>6} {r['degree_bits']:>11} {r['gates']:>9}"
                    f" {r['rows_used']:>9} {r['num_public_inputs']:>7}"
                )


if __name__ == "__main__":
    main()
