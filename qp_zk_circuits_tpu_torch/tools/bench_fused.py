"""Time a checkout's kernels A (quotient) and B (permutation argument) on one
CUDA card.

    python qp_zk_circuits_tpu_torch/tools/bench_fused.py [--root DIR] [--profiler N]

Times `plonk/prover.py::quotient_evals` and `compute_permutation_polys` of
the checkout at `--root` (default: the checkout this file lies in), as
every checkout of the port has them, so two checkouts can be timed in turns
by separate processes within one machine session (parent, change, change,
parent). The timing helpers are this checkout's. Shapes: the leaf (m = 2048
LDE points, n = 256 rows) and the private batch's degree 16 (m = 2^19,
n = 2^16), both with the leaf's config and gate table; the large circuit is
the leaf's with random constants, selectors, sigmas and routing tables.
Inputs are random felts made with numpy from fixed seeds.

  * `ms`: CUDA events around one wrapper call, median of --runs (host work
    and the gaps between launches included);
  * `device_ms`: the wrapper's kernel-library launches replayed in a CUDA
    graph (`tools/timing.py::device_ms`), the kernels alone;
  * `profiler_ms` (with --profiler N): N readings of a torch.profiler
    window over 5 calls, each divided by 5, to compare with `device_ms`;
  * the output's SHA-256, so two checkouts can be seen to agree.

A size a checkout refuses is reported as refused. Prints one line a case,
the card from nvidia-smi, and a JSON object last.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace


def _profiler_ms(fn, runs: int = 5) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3 / runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--profiler", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        raise SystemExit("bench_fused needs a CUDA card")
    # the kernels are those of the checkout at --root: forget this
    # checkout's package, so that the imports below find that one
    for name in [n for n in sys.modules if n.partition(".")[0] == "qp_zk_circuits_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import qp_zk_circuits_tpu_torch
    from qp_zk_circuits_tpu_torch import _cuda
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.plonk import prover as tp
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    leaf = WormholeProver(device="cuda").data
    cfg = leaf.config
    nc, nr = cfg.num_challenges, cfg.num_routed_wires
    npp = -(-nr // cfg.max_quotient_degree_factor) - 1

    def circuit(degree_bits, rng):
        if degree_bits == leaf.degree_bits:
            return leaf
        n = 1 << degree_bits
        lde = F.rand_felts((leaf.constants_oracle.lde.shape[0], n << cfg.rate_bits), rng)
        return dataclasses.replace(
            leaf, degree_bits=degree_bits,
            id_coords=F.rand_felts((nr, n), rng), sigma_vals=F.rand_felts((nr, n), rng),
            constants_oracle=SimpleNamespace(lde=gl.from_u64(lde, "cuda")))

    def quotient(degree_bits):
        rng = np.random.default_rng(degree_bits)
        data = circuit(degree_bits, rng)
        m = data.n << cfg.rate_bits
        wires = gl.from_u64(F.rand_felts((cfg.num_wires, m), rng), "cuda")
        zpp = gl.from_u64(F.rand_felts((nc + nc * npp, m), rng), "cuda")
        ch = [F.rand_felts(nc, rng) for _ in range(3)] + [F.rand_felts(4, rng)]
        name = f"quotient m = 2^{degree_bits + cfg.rate_bits}"
        if not hasattr(tp, "host_records"):  # a checkout of host-value wrappers
            return name, lambda: tp.quotient_evals(data, wires, zpp, *ch)
        # the challenges uploaded into their record in the call, as staged
        return name, lambda: tp.quotient_evals(data, wires, zpp, tp.host_records(
            "cuda", 1, nc, alphas=ch[0], betas=ch[1], gammas=ch[2], pis=ch[3])[0])

    def permutation(degree_bits):
        rng = np.random.default_rng(100 + degree_bits)
        data = circuit(degree_bits, rng)
        trace = gl.from_u64(F.rand_felts((cfg.num_wires, data.n), rng), "cuda")
        betas, gammas = F.rand_felts(nc, rng), F.rand_felts(nc, rng)
        name = f"permutation n = 2^{degree_bits}"
        if not hasattr(tp, "host_records"):  # a checkout of host-value wrappers
            return name, lambda: tp.compute_permutation_polys(data, trace, betas, gammas)
        return name, lambda: tp.compute_permutation_polys(data, trace, tp.host_records(
            "cuda", 1, nc, betas=betas, gammas=gammas)[0])

    cases = []
    for make, degree_bits in ((quotient, leaf.degree_bits), (quotient, 16),
                              (permutation, leaf.degree_bits), (permutation, 16)):
        name, fn = make(degree_bits)
        try:
            out = fn()
        except ValueError as e:  # a size this checkout refuses
            print(f"[fused] {name}: refused ({e})", flush=True)
            cases.append(dict(case=name, refused=str(e)))
            continue
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        row = dict(case=name, ms=timing.median_ms(fn, args.runs),
                   device_ms=timing.device_ms(fn, cuda=_cuda), sha256=digest)
        if args.profiler:
            row["profiler_ms"] = [_profiler_ms(fn) for _ in range(args.profiler)]
        print(f"[fused] {name}: {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms"
              + (f", profiler {row['profiler_ms']}" if args.profiler else "")
              + f", out {digest}", flush=True)
        cases.append(row)
        del fn, out
        torch.cuda.empty_cache()
    card = timing.card()
    print(card)
    print(json.dumps({"root": args.root, "package": qp_zk_circuits_tpu_torch.__file__,
                      "card": card, "cases": cases}))


if __name__ == "__main__":
    main()
