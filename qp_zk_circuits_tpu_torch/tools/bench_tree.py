"""Time a commit's Merkle tree on one CUDA card, for one checkout of the port.

    python qp_zk_circuits_tpu_torch/tools/bench_tree.py [--root DIR]

Times `hash/merkle.py::build_levels` of the checkout at `--root` (default:
the checkout this file lies in), as every checkout of the port has it, so
two checkouts can be timed in turns by separate processes within one
machine session (parent, change, change, parent). The timing helpers are
this checkout's. Shapes: the leaf's wires tree (2048 x 135, cap 2^4) and the
private batch's (2^19 x 135, cap 2^4), over a strided lde.T:

  * `ms`: CUDA events around one call, median of --runs (the card's span,
    gaps between launches included);
  * `device_ms`: every device event torch.profiler records over 5 calls,
    divided by 5 (the kernels alone);
  * the cap's SHA-256, so two checkouts can be seen to agree.

Prints one line a shape, the card from nvidia-smi, and a JSON object last.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from qp_zk_circuits_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        raise SystemExit("bench_tree needs a CUDA card")
    # the tree is the one of the checkout at --root: forget this checkout's
    # package, so that the import below finds that one
    for name in [n for n in sys.modules if n.partition(".")[0] == "qp_zk_circuits_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import qp_zk_circuits_tpu_torch
    from qp_zk_circuits_tpu_torch.hash import merkle

    trees = []
    for log_rows, cols, cap in ((11, 135, 4), (19, 135, 4)):
        # uniform below 2^63 < p: canonical felts, made on the card from a seed
        gen = torch.Generator(device="cuda").manual_seed(log_rows)
        lde = torch.randint(0, (1 << 63) - 1, (cols, 1 << log_rows), generator=gen,
                            dtype=torch.int64, device="cuda")
        fn = lambda: merkle.build_levels(lde.T, cap)  # noqa: E731
        cap_digest = hashlib.sha256(fn()[-1].cpu().numpy().tobytes()).hexdigest()[:16]
        row = dict(shape=f"2^{log_rows} x {cols}", cap=cap, ms=timing.median_ms(fn, args.runs),
                   device_ms=timing.device_ms(fn), cap_sha256=cap_digest)
        print(f"[tree] {row['shape']} cap 2^{cap}: {row['ms']:.4f} ms, device "
              f"{row['device_ms']} ms, cap {cap_digest}", flush=True)
        trees.append(row)
        del lde
        torch.cuda.empty_cache()
    card = timing.card()
    print(card)
    print(json.dumps({"root": args.root, "package": qp_zk_circuits_tpu_torch.__file__,
                      "card": card, "trees": trees}))


if __name__ == "__main__":
    main()
