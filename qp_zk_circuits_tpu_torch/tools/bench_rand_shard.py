"""Time a checkout's kernel G (Philox felts) and kernel H (the sharded NTT's
local steps) on one CUDA card.

    python qp_zk_circuits_tpu_torch/tools/bench_rand_shard.py [--root DIR] [--runs N]

Times the checkout at `--root` (default: the checkout this file lies in)
through the wrappers every checkout of the port has, so two checkouts can
be timed in turns by separate processes on one machine in one run
(parent, change, change, parent). The timing helpers are this checkout's.
Cases:

  * kernel G at the canonical N = 8 private batch's degree-16 draws: the
    blinding rows, 135 x 65,472 felts through the `[:, 64:]` view of a
    135 x 2^16 trace, and the three salts, 4 x 2^19 felts each (three
    calls), and the ZK leaf's blinding, 135 x 252 through `[:, 260:]` of
    135 x 512;
  * kernel H at one shard of N = 2^24 over D = 4 (L = 2^22): the
    deinterleave and the cross-shard DFT both ways, and the DFT at D = 2
    and 8 on slabs of 2^22 felts;
  * `ntt_sharded` of 2^24 over D = 4 shards of the card, both ways: its
    whole device time (kernel H, kernel 3 and the exchanges' copies)
    replayed in a CUDA graph (`tools/timing.py::graph_ms`), beside its
    kernel launches alone (`device_ms`).

Each case: `ms`, CUDA events around one call, median of --runs; `device_ms`,
the call's kernel-library launches replayed in a CUDA graph; the output's
SHA-256, so two checkouts can be seen to agree. Inputs are random felts
made on the card from fixed seeds. Prints one line a case, the card from
nvidia-smi, and a JSON object last.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

#: the proof key of the draws (any u64)
KEY = 0x5DEECE66D


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from qp_zk_circuits_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        raise SystemExit("bench_rand_shard needs a CUDA card")
    # the kernels are those of the checkout at --root: forget this
    # checkout's package, so that the imports below find that one
    for name in [n for n in sys.modules if n.partition(".")[0] == "qp_zk_circuits_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import qp_zk_circuits_tpu_torch
    from qp_zk_circuits_tpu_torch import _cuda
    from qp_zk_circuits_tpu_torch.field import random as frandom
    from qp_zk_circuits_tpu_torch.parallel.mesh import Mesh
    from qp_zk_circuits_tpu_torch.poly import ntt

    def felts(shape, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randint(0, (1 << 63) - 1, shape, generator=gen, dtype=torch.int64,
                             device="cuda")

    trace = torch.zeros((135, 1 << 16), dtype=torch.int64, device="cuda")
    salts = torch.empty((3, 4, 1 << 19), dtype=torch.int64, device="cuda")
    leaf = torch.zeros((135, 512), dtype=torch.int64, device="cuda")
    slab = felts((1 << 22,), 7)
    poly = felts((1 << 24,), 24)
    mesh = Mesh(["cuda:0"] * 4, ("cols",))
    cases = [
        ("G blinding 135 x 65472", lambda: frandom.rand_felts(KEY, 0, trace[:, 64:]),
         lambda: trace, False),
        ("G salts 3 x 4 x 2^19", lambda: [frandom.rand_felts(KEY, 1 + i, salts[i])
                                          for i in range(3)], lambda: salts, False),
        ("G leaf blinding 135 x 252", lambda: frandom.rand_felts(KEY, 0, leaf[:, 260:]),
         lambda: leaf, False),
        ("H deinterleave L = 2^22 D = 4", lambda: ntt.shard_deinterleave(slab, 4), None, False),
        ("H DFT L = 2^22 D = 4", lambda: ntt.shard_cross_ntt(slab.view(4, -1)), None, False),
        ("H DFT inverse L = 2^22 D = 4",
         lambda: ntt.shard_cross_ntt(slab.view(4, -1), inverse=True), None, False),
        ("H DFT L = 2^22 D = 2", lambda: ntt.shard_cross_ntt(slab.view(2, -1)), None, False),
        ("H DFT L = 2^22 D = 8", lambda: ntt.shard_cross_ntt(slab.view(8, -1)), None, False),
        ("ntt_sharded 2^24 D = 4", lambda: ntt.ntt_sharded(poly, mesh), None, True),
        ("ntt_sharded inverse 2^24 D = 4", lambda: ntt.ntt_sharded(poly, mesh, inverse=True),
         None, True),
    ]
    rows = []
    for name, fn, result, whole in cases:
        out = fn()
        torch.cuda.synchronize()
        out = result() if result is not None else out
        if isinstance(out, list):
            out = torch.cat([o.reshape(-1) for o in out])
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        row = dict(case=name, ms=timing.median_ms(fn, args.runs),
                   device_ms=timing.device_ms(fn, cuda=_cuda), sha256=digest)
        line = f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms"
        if whole:
            # kernels and the exchanges' copies, as one graph
            row["graph_ms"] = timing.graph_ms(fn)
            line += f" (kernels alone), whole call by graph replay {row['graph_ms']:.4f} ms"
        print(f"[bench] {name}: {line}, out {digest}", flush=True)
        rows.append(row)
    card = timing.card()
    print(card)
    print(json.dumps({"root": args.root, "package": qp_zk_circuits_tpu_torch.__file__,
                      "card": card, "cases": rows}))


if __name__ == "__main__":
    main()
