"""Trusted-CI artifact generation CLI (the port's).

Port of reference `wormhole/circuit-builder/src/main.rs`: clap-style flags
with parse-time validation, atomic staged publication (the heavy lifting
lives in `wormhole/artifacts.py`). The flags are the JAX package's tool's,
plus `--device`: every circuit is built and every proof made there, the
card by default; without CUDA `--device cuda` is refused (no quiet fall-back
to the CPU).

    python -m qp_zk_circuits_tpu_torch.tools.circuit_builder_cli --output DIR
        [--num-leaf-proofs N] [--num-private-batch-proofs M]
        [--include-aggregation] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..wormhole import inputs as wi


def _device_name(text: str) -> str:
    try:
        torch.device(text)
    except RuntimeError as e:
        raise argparse.ArgumentTypeError(f"not a torch device: {text!r}") from e
    return text


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="circuit-builder",
        description="Generate the canonical Wormhole circuit artifact set (atomic publish).",
    )
    ap.add_argument(
        "--num-leaf-proofs", type=int, default=8,
        help=f"leaf proofs per private batch (1..={wi.MAX_PROOF_COUNT})",
    )
    ap.add_argument(
        "--num-private-batch-proofs", type=int, default=None,
        help=f"private batches per public batch (1..={wi.MAX_PROOF_COUNT})",
    )
    ap.add_argument("--output", required=True, help="target artifact directory")
    ap.add_argument(
        "--skip-prover", action="store_true",
        help="(compat) prover data is never serialized in this framework",
    )
    ap.add_argument(
        "--include-aggregation", action="store_true",
        help="also generate aggregation-layer artifacts",
    )
    ap.add_argument(
        "--device", type=_device_name, default="cuda",
        help="where the circuits are built and proven (default: the CUDA card)",
    )
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        wi.validate_proof_count(args.num_leaf_proofs, "--num-leaf-proofs")
        if args.num_private_batch_proofs is not None:
            wi.validate_proof_count(args.num_private_batch_proofs, "--num-private-batch-proofs")
    except wi.InputsError as e:
        ap.error(str(e))
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available (pass --device cpu)")

    from ..wormhole.artifacts import generate_all_circuit_binaries

    generate_all_circuit_binaries(
        args.output,
        num_leaf_proofs=args.num_leaf_proofs,
        num_private_batch_proofs=args.num_private_batch_proofs,
        include_aggregation=args.include_aggregation,
        device=args.device,
    )
    print(f"artifact set published to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
