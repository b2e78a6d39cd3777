"""Time a checkout's kernel 3 (NTT) and the FRI tail's kernels C-F on one
CUDA card.

    python qp_zk_circuits_tpu_torch/tools/bench_ntt.py [--root DIR] [--runs N] [--cases A,B]

Times `poly/ntt.py::batched_ntt`, `fri/prover.py::compute_composition`,
`fri/oracle.py::eval_openings` (kernel D), `fri/prover.py::fold_round`
(kernel E) and `fri/prover.py::query_gather` (kernel F) of the checkout at
`--root` (default: the checkout this file lies in), as every checkout of the
port has them, so two checkouts can be timed in turns by separate processes
on one card, one after another (parent, change, change, parent). The timing
helpers and the bounds (`chip_smoke.py::ntt_work`, `fri_field_ops`,
`openings_work`, `fold_work`, `gather_work`) are this checkout's. Shapes:
the leaf proof's NTT calls (iNTT 135 x 256 and 20 x 256; LDE 135, 20 and
16 x 256 -> 2048; coset iNTT 2 x 2048; the final polynomial's iNTT 2 x 256
with its unshift), the K = 16 ZK leaf batch's LDE (16 x 135 x 2^9 -> 2^12)
into a contiguous matrix and into the salted (16, 139, 2^12) buffer's
groups, its composition (the leaf's four oracles and opening
instance, m = 2048, first FRI arity 2^3), its openings (the four oracles'
262 coefficient rows of 256 at zeta, 2 at g * zeta), its one fold round
(m = 2048, arity 2^3, natural order out) and its query gather (28 queries:
the four oracles' rows and paths, the round's leaf and path); then the
private batch's at degree 16 (LDE 135 x 2^16 -> 2^19, iNTT 135 x 2^16,
coset iNTT 2 x 2^19, the composition at m = 2^19, the openings of the same
264 rows at n = 2^16, the three fold rounds of schedule(16) = [4, 4, 3]
(m = 2^19 to 2^15 leaves of arity 2^4, 2^15 to 2^11 of 2^3, 2^11 to the
last layer), and the gather at m = 2^19 with its three rounds). A gather
case ends with the rows on the host, as the prover takes them: where a
checkout's `query_gather` returns them on the card, they are brought back
with `goldilocks.to_u64` as that checkout's `gather_query_rounds` does. The
"queries stage" cases time `fri/prover.py::gather_query_rounds` (kernel F's
gather, its return to the host and the unpacking into query rounds) at the
leaf and at m = 2^19 on the host's clock; the "timer floor" case is
`goldilocks_add` on 8 felts, the least a launch reads by these timers.
Inputs are random felts made on the card from fixed seeds. `--cases` keeps
the cases whose names contain one of the given words.

  * `ms`: CUDA events around one wrapper call, median of --runs (host work
    and the gaps between launches included);
  * `device_ms`: the wrapper's kernel-library launches replayed in a CUDA
    graph (`tools/timing.py::device_ms`), the kernels alone;
  * `host_ms` (queries stage): the host clock around one call, which ends
    with the rows on the host, median of --runs;
  * `bound_ms`: the larger of bytes over 3.35 TB/s (bytes written across the
    host link over 64 GB/s) and integer operations over 16.7 T op/s;
  * the output's SHA-256, so two checkouts can be seen to agree.

A size a checkout refuses is reported as refused. Prints one line a case,
the card from nvidia-smi, and a JSON object last.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--cases", default="", help="comma-separated words; a case runs if its "
                    "name contains one (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as cs
    from qp_zk_circuits_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        raise SystemExit("bench_ntt needs a CUDA card")
    # the kernels are those of the checkout at --root: forget this
    # checkout's package, so that the imports below find that one
    for name in [n for n in sys.modules if n.partition(".")[0] == "qp_zk_circuits_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import qp_zk_circuits_tpu_torch
    from qp_zk_circuits_tpu_torch import _cuda
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.fri import oracle as fo
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.hash import merkle
    from qp_zk_circuits_tpu_torch.plonk.proof import fri_instance
    from qp_zk_circuits_tpu_torch.poly import ntt
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    def felts(shape, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randint(0, (1 << 63) - 1, shape, generator=gen, dtype=torch.int64,
                             device="cuda")

    unshift = int(F.inv(F.MULTIPLICATIVE_GROUP_GENERATOR))

    def transform(name, cols, n_in, log_n, seed, **kw):
        def make():
            x = felts((cols, n_in), seed)
            work = cs.ntt_work(cols, n_in, log_n, shift="shift" in kw,
                               inverse=kw.get("inverse", False), out_shift="out_shift" in kw)
            return (lambda: ntt.batched_ntt(x, log_n, **kw)), work
        return name, make

    def grouped(name, k, cols, n_in, log_n, seed, **kw):
        """A salted batch's LDE buffer: k groups of `cols` transforms written
        into the first rows of (k, cols + 4, 2^log_n), the 4 salt rows a
        group between them."""
        def make():
            x = felts((k * cols, n_in), seed)
            buf = torch.zeros((k, cols + 4, 1 << log_n), dtype=torch.int64, device="cuda")
            work = cs.ntt_work(k * cols, n_in, log_n, shift="shift" in kw)
            return (lambda: ntt.batched_ntt(x, log_n, out=buf[:, :cols], **kw)), work
        return name, make

    leaf = WormholeProver(device="cuda").data
    cfg = leaf.config

    def composition(lde_bits):
        def make():
            m = 1 << lde_bits
            oracles = [SimpleNamespace(lde=felts((c, m), 40 + i))
                       for i, c in enumerate(cs.leaf_oracle_rows(leaf))]
            rng = np.random.default_rng(lde_bits)
            inst = fri_instance(leaf, F.rand_felts(2, rng), F.rand_felts(2, rng))
            openings = [F.rand_felts((len(b.polys), 2), rng) for b in inst.batches]
            arity = cfg.fri_config.reduction_strategy.schedule(lde_bits - cfg.rate_bits)[0]
            alpha = F.rand_felts(2, rng)
            k = inst.num_terms()
            cols = len({t for b in inst.batches for t in b.polys})
            muls, adds = cs.fri_field_ops(m, k, len(inst.batches))
            work = ((cols * m + 2 * k + 2 * m) * 8, muls * cs.OPS_MUL + adds * cs.OPS_ADD)
            if not hasattr(fri, "composition_inputs"):  # a checkout of host-value wrappers
                return (lambda: fri.compute_composition(oracles, inst, openings, alpha,
                                                        lde_bits, arity)), work

            def call():  # the host values uploaded in the call, as the staged prover does
                ys, rec = fri.composition_inputs([inst], [openings], [alpha], "cuda")
                return fri.compute_composition(oracles, tuple(b.polys for b in inst.batches),
                                               ys[0], rec[0], lde_bits, arity)

            return call, work
        return f"composition m = 2^{lde_bits}", make

    nc = cfg.num_challenges
    oracle_rows = cs.leaf_oracle_rows(leaf)
    fri_cfg = cfg.fri_config

    def openings(degree_bits):
        def make():
            n = 1 << degree_bits
            oracles = [SimpleNamespace(coeffs=felts((c, n), 50 + i))
                       for i, c in enumerate(oracle_rows)]
            rng = np.random.default_rng(degree_bits)
            zeta, zeta_next = F.rand_felts(2, rng), F.rand_felts(2, rng)
            rows = sum(oracle_rows)
            work = cs.openings_work(rows, rows + nc, n)
            if not hasattr(fo, "point_records"):  # a checkout of host-value wrappers
                return (lambda: fo.eval_openings(oracles, zeta, zeta_next, 2, nc)), work

            def call():  # the points uploaded and the values brought back, as staged
                rec = fo.point_records("cuda", [zeta], [zeta_next])[0]
                return fo.split_openings(gl.to_u64(fo.eval_openings(oracles, rec, 2, nc)),
                                         oracles, nc)

            return call, work
        return f"openings {sum(oracle_rows) + nc} x 2^{degree_bits}", make

    def fold(degree_bits, log_m, a, next_bits, seed):
        def make():
            leaves = felts((1 << (log_m - a), 2 << a), seed)
            beta = F.rand_felts(2, np.random.default_rng(seed))
            work = cs.fold_work(1 << log_m, a)
            if not hasattr(fri, "beta_records"):  # a checkout of host-value wrappers
                return (lambda: fri.fold_round(leaves, beta, a, log_m, 0, next_bits)), work
            from qp_zk_circuits_tpu_torch.plonk.transcript import REC_FRI_BETA

            return (lambda: fri.fold_round(leaves, fri.beta_records("cuda", [beta])[0],
                                           REC_FRI_BETA, a, log_m, 0, next_bits)), work
        return f"fold m = 2^{log_m}, arity 2^{a}, next 2^{next_bits} (degree {degree_bits})", make

    def gather_layout(degree_bits):
        """The prover's gather sources: the four oracles' rows and paths, then
        each FRI round's leaves and path; also the oracles and layers as
        `gather_query_rounds` takes them."""
        lde_bits = degree_bits + cfg.rate_bits
        m = 1 << lde_bits
        schedule = fri_cfg.reduction_strategy.schedule(degree_bits)
        oracles, layers = [], []
        for i, c in enumerate(oracle_rows):
            lde = felts((c, m), 60 + i)
            oracles.append(SimpleNamespace(
                lde=lde, tree=merkle.build_merkle_tree(lde.T, fri_cfg.cap_height)))
        bits = lde_bits
        for r, a in enumerate(schedule):
            leaves = felts((1 << (bits - a), 2 << a), 70 + r)
            layers.append((leaves, merkle.build_merkle_tree(leaves, min(fri_cfg.cap_height,
                                                                         bits - a))))
            bits -= a
        sources = [fri.GatherSource(o.lde.T, m - 1) for o in oracles]
        for o in oracles:
            sources += fri._sibling_sources(o.tree, m - 1)
        for leaves, tree in layers:
            sources.append(fri.GatherSource(leaves, leaves.shape[0] - 1))
            sources += fri._sibling_sources(tree, leaves.shape[0] - 1)
        rng = np.random.default_rng(lde_bits)
        q = fri_cfg.num_query_rounds
        indices = [0, m - 1] + [int(i) for i in rng.integers(0, m, q - 2)]
        trees = [o.tree for o in oracles] + [t for _, t in layers]
        width = (sum(oracle_rows) + sum(leaves.shape[1] for leaves, _ in layers)
                 + sum(4 * (len(t.digests) - 1) for t in trees))
        return sources, oracles, layers, indices, cs.gather_work(q, width)

    def gather(degree_bits):
        def make():
            sources, _, _, indices, work = gather_layout(degree_bits)

            def to_host():
                rows = fri.query_gather(sources, indices)
                return gl.to_u64(rows) if isinstance(rows, torch.Tensor) else rows

            return to_host, work
        return f"gather m = 2^{degree_bits + cfg.rate_bits}, {fri_cfg.num_query_rounds} queries", make

    def queries_stage(degree_bits):
        def make():
            _, oracles, layers, indices, work = gather_layout(degree_bits)
            return (lambda: fri.gather_query_rounds(oracles, layers, indices)), work
        return f"queries stage m = 2^{degree_bits + cfg.rate_bits}", make

    def floor():
        def make():
            a, b = felts((8,), 98), felts((8,), 99)
            return (lambda: gl.add(a, b)), (3 * 8 * 8, 8 * cs.OPS_ADD)
        return "timer floor: goldilocks_add of 8 felts", make

    lb = leaf.degree_bits
    lm = lb + cfg.rate_bits
    cases = [
        floor(),
        transform(f"iNTT 135 x 2^{lb}", 135, 1 << lb, lb, 1, inverse=True),
        transform(f"iNTT 20 x 2^{lb}", 20, 1 << lb, lb, 2, inverse=True),
        transform(f"LDE 135 x 2^{lb} -> 2^{lm}", 135, 1 << lb, lm, 3, shift=7),
        transform(f"LDE 20 x 2^{lb} -> 2^{lm}", 20, 1 << lb, lm, 4, shift=7),
        transform(f"LDE 16 x 2^{lb} -> 2^{lm}", 16, 1 << lb, lm, 5, shift=7),
        transform(f"coset iNTT 2 x 2^{lm}", 2, 1 << lm, lm, 6, inverse=True, out_shift=unshift),
        transform(f"final iNTT 2 x 2^{lb}", 2, 1 << lb, lb, 7, inverse=True, out_shift=unshift),
        composition(lm),
        openings(lb),
        *(fold(lb, bits, a, nxt, 80 + r) for r, (bits, a, nxt) in enumerate(cs.fri_rounds(leaf, lb))),
        gather(lb),
        queries_stage(lb),
        transform("LDE 2160 x 2^9 -> 2^12", 16 * 135, 1 << 9, 12, 11, shift=7),
        grouped("LDE 16 x 135 x 2^9 -> 2^12 into (16, 139, 2^12)", 16, 135, 1 << 9, 12, 11,
                shift=7),
        transform("LDE 135 x 2^16 -> 2^19", 135, 1 << 16, 19, 8, shift=7),
        transform("iNTT 135 x 2^16", 135, 1 << 16, 16, 9, inverse=True),
        transform("coset iNTT 2 x 2^19", 2, 1 << 19, 19, 10, inverse=True, out_shift=unshift),
        composition(16 + cfg.rate_bits),
        openings(16),
        *(fold(16, bits, a, nxt, 90 + r) for r, (bits, a, nxt) in enumerate(cs.fri_rounds(leaf, 16))),
        gather(16),
        queries_stage(16),
    ]
    if args.cases:
        words = args.cases.split(",")
        cases = [c for c in cases if any(w in c[0] for w in words)]
    rows = []
    for name, make in cases:
        fn, work = make()
        bound_ms, by = cs._bound(work)
        try:
            out = fn()
        except (ValueError, TypeError) as e:  # a size or an output this checkout refuses
            print(f"[bench] {name}: refused ({e})", flush=True)
            rows.append(dict(case=name, refused=str(e), bound_ms=bound_ms, bound_by=by))
            continue
        torch.cuda.synchronize()
        digest = _digest(out)
        row = dict(case=name, ms=timing.median_ms(fn, args.runs),
                   device_ms=timing.device_ms(fn, cuda=_cuda), bound_ms=bound_ms, bound_by=by,
                   sha256=digest)
        host = ""
        if name.startswith("queries stage"):
            row["host_ms"] = _host_ms(fn, args.runs)
            host = f", host {row['host_ms']:.4f} ms"
        print(f"[bench] {name}: {row['ms']:.4f} ms{host}, device {row['device_ms']:.4f} ms, "
              f"bound {bound_ms:.5f} ms by {by}, out {digest}", flush=True)
        rows.append(row)
        del fn, out
        torch.cuda.empty_cache()
    card = timing.card()
    print(card)
    print(json.dumps({"root": args.root, "package": qp_zk_circuits_tpu_torch.__file__,
                      "card": card, "cases": rows}))


def _host_ms(fn, runs: int) -> float:
    """Median host-clock ms of one call (after two warm-up calls)."""
    import statistics
    import time

    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _digest(out) -> str:
    """SHA-256 (16 hex digits) of a result: a tensor, the openings' per-oracle
    arrays and next rows, or query rounds."""
    import numpy as np

    if isinstance(out, list):  # query rounds
        data = np.concatenate([np.asarray(a, dtype=np.uint64).reshape(-1) for r in out for a in (
            *r.initial_rows, *r.initial_siblings,
            *(x for st in r.steps for x in (st.leaf_values, st.siblings)))])
    elif isinstance(out, tuple):
        data = np.concatenate([np.asarray(a).reshape(-1) for a in (*out[0], out[1])])
    elif isinstance(out, np.ndarray):
        data = out.view(np.int64)
    else:
        data = out.cpu().numpy()
    return hashlib.sha256(data.tobytes()).hexdigest()[:16]


if __name__ == "__main__":
    main()
