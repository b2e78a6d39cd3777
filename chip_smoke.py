#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (qp_zk_circuits_tpu_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA card,
nvcc (CUDA toolkit) and no network, and imports nothing of JAX or of the JAX
package. Phases, each printing one line:

  1. device — torch/CUDA versions and `nvidia-smi` name + power limit;
  2. build — compiles csrc/*.cu with nvcc for sm_90a (one process a source);
  3. kernels — each kernel against its plain PyTorch version, bit-exact, at
     the shapes of the leaf prover, plus the field edge vectors (the fused
     quotient and permutation kernels against their plain versions run on CPU
     copies of the same inputs, so no kernel is on the reference side); median
     wrapper times over CUDA-event-timed runs, each kernel's device-only time
     from torch.profiler, and each kernel's bound;
  4. main path — WormholeProver(device="cuda") on test_inputs_0(): build, then
     prove_inputs(seed=0) cold and warm; the proof bytes must equal the
     committed fixture (length and SHA-256), every kernel must have been
     launched during the cold proof, and the quotient and the permutation
     argument must have taken at most two launches each.

Then one JSON line with every kernel's numbers, and last the result line
{"ok": true, "device": {...}}. Any failure raises: the exit code is non-zero
and the result line is not printed.
"""

from __future__ import annotations

import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "torch_fixtures" / "leaf_proof_inputs0.bin"
FIXTURE_META = ROOT / "tests" / "torch_fixtures" / "fixtures.json"

# H100 SXM peaks: HBM 3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
# cores = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz. Hopper has 64 INT32
# lanes an SM, so the 32-bit integer peak is 132 x 64 x 1.98 GHz = 16.7 T op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer instructions per field op, counted from the sources: a mul
# is a 64x64->128 product (4 IMAD.WIDE-class ops, 8 instructions) plus the
# reduce128 fold (8), add and sub are a 64-bit add with carry, a compare and a
# select (4).
OPS_MUL = 16
OPS_ADD = 4
# field-op mix of one Poseidon2 permutation (csrc/poseidon2.cu): 118 S-boxes
# of 4 muls, 12 diagonal muls in each of 22 internal layers, 9 external layers
# of 48 small 64x64 products (half a mul each) and 12 reductions.
PERM_MULS = 118 * 4 + 22 * 12 + 9 * (48 // 2 + 12)
PERM_ADDS = 8 * 12 + 22 + 22 * 12 + 9 * 24
# multiplies of one Fermat inverse a^(p-2): 64 squarings and one multiply
# per set bit of p - 2
INV_MULS = 64 + bin((1 << 64) - (1 << 32) - 1).count("1")

# The bounds count the operations the function needs, not the ones a
# kernel's chosen algorithm spends (kernel B's inverse per thread, kernel A's
# k_i*x per challenge, its sum of group partials).


def quotient_field_ops(data) -> tuple[int, int]:
    """Field multiplies and adds (or subs) that one LDE point of kernel A's
    function (csrc/quotient.cu) needs, counted from the circuit's descriptor
    table: each gate type's constraints and selector mask, k_i*x once, each
    challenge's boundary and chunked permutation transitions, nc alpha terms
    per constraint and the 1/Z_H multiply."""
    from qp_zk_circuits_tpu_torch.plonk import gates as tgates
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    cfg = data.config
    nc, nr, qdf = cfg.num_challenges, cfg.num_routed_wires, cfg.max_quotient_degree_factor
    nchunks = -(-nr // qdf)
    ids = tgates.GATE_TYPE_IDS
    # (muls, adds) of one descriptor row with parameters p0, p1
    per_row = {
        ids[tgates.NoopGate]: lambda p0, p1: (0, 0),
        # c0*a*b + c1*c, then out - t
        ids[tgates.ArithmeticGate]: lambda p0, p1: (3 * p0, 2 * p0),
        # one sub a constraint
        ids[tgates.ConstantGate]: lambda p0, p1: (0, p0),
        ids[tgates.PublicInputGate]: lambda p0, p1: (0, 4),
        # a permutation's ops plus a sub for each of its 118 S-box outputs
        ids[tgates.Poseidon2Gate]: lambda p0, p1: (PERM_MULS, PERM_ADDS + 118),
        # a Horner step over the extension: 5 muls, 2 adds (3 with ext), 2 subs
        ids[tgates.ReducingGate]: lambda p0, p1: (5 * p0, (4 + p1) * p0),
        # b*(b-1) and b*2^i a bit, 2 adds a bit, one sub
        ids[tgates.BaseSumGate]: lambda p0, p1: (2 * p0, 2 * p0 + 1),
        # per challenge: the boundary L1*(Z-1); beta times k_i*x and sigma_i
        # with 2 adds each; the chunk products; nxt*D - prev*N a chunk
        tgates.PERMUTATION_TYPE_ID: lambda p0, p1: (
            1 + 2 * nr + 2 * (nr - nchunks) + 2 * nchunks, 1 + 4 * nr + nchunks),
    }
    desc, k_total = tprover.quotient_descriptors(data)
    muls, adds = nr, 0  # k_i * x, shared by the challenges
    for tid, p0, p1, _p2, sel, _first in desc.tolist():
        m, a = per_row[tid](p0, p1)
        muls, adds = muls + m, adds + a
        if sel >= 0 and (m or a):  # the selector masks each challenge's gate sum
            muls += nc
    muls += nc * k_total + nc  # alpha terms, 1/Z_H
    adds += nc * k_total  # alpha sums
    return muls, adds


def _median_ms(fn, runs: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"gpus {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from qp_zk_circuits_tpu_torch import _cuda

    t0 = time.time()
    so = _cuda.build()
    _cuda.lib()
    print(f"[build] {so.name} in {time.time() - t0:.1f} s", flush=True)


def _felts(shape, rng, device):
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl

    return gl.from_u64(F.rand_felts(shape, rng), device)


def _edge_pairs(device):
    """Every pair of the field edge values (tests/test_pallas_ops.py)."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.field import goldilocks as gl

    p = gl.P
    edges = [0, 1, p - 1, p - 2, (1 << 32) - 1, 1 << 32]
    a = np.array([x for x in edges for _ in edges], dtype=np.uint64)
    b = np.array([y for _ in edges for y in edges], dtype=np.uint64)
    return gl.from_u64(a, device), gl.from_u64(b, device)


def kernel_table(device) -> list[dict]:
    """Every kernel of the main path: its wrapper, a call at the main path's
    shapes and the same call on the plain version, and its bound."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.poly import ntt

    rng = np.random.default_rng(0)
    wires, lde_bits, rate = 135, 11, 3
    m = 1 << lde_bits
    a = _felts((wires, m), rng, device)
    b = _felts((wires, m), rng, device)
    ea, eb = _edge_pairs(device)
    a.view(-1)[: ea.numel()] = ea
    b.view(-1)[: eb.numel()] = eb
    n_el = a.numel()
    grind = _felts((1 << 17, ps.WIDTH), rng, device)
    lde = _felts((wires, m), rng, device)
    rows = lde.T  # the leaf matrix as the commit hashes it: strided rows
    level = _felts((m, ps.DIGEST_LEN), rng, device)
    coeffs = _felts((wires, m >> rate), rng, device)
    quot = _felts((2, m), rng, device)  # the quotient's nc rows
    unshift = int(F.inv(np.uint64(7)))  # g^-1, the coset iNTT's unshift
    perms_per_row = -(-wires // ps.RATE)
    ew_bytes = 3 * 8 * n_el

    def ntt_all(f_lde, f_inv, f_coset_inv):
        return [f_lde(coeffs), f_inv(coeffs), f_inv(quot), f_coset_inv(quot)]

    return [
        dict(name="goldilocks_add", wrapper=gl.add, source="qp_zk_circuits_tpu_torch/csrc/field_kernels.cu",
             replaces="qp_zk_circuits_tpu/field/goldilocks.py:137",
             run=lambda: gl.add(a, b), plain=lambda: gl.add_plain(a, b),
             bytes=ew_bytes, ops=OPS_ADD * n_el),
        dict(name="goldilocks_sub", wrapper=gl.sub, source="qp_zk_circuits_tpu_torch/csrc/field_kernels.cu",
             replaces="qp_zk_circuits_tpu/field/goldilocks.py:145",
             run=lambda: gl.sub(a, b), plain=lambda: gl.sub_plain(a, b),
             bytes=ew_bytes, ops=OPS_ADD * n_el),
        dict(name="goldilocks_mul", wrapper=gl.mul, source="qp_zk_circuits_tpu_torch/csrc/field_kernels.cu",
             replaces="qp_zk_circuits_tpu/ops/field_kernels.py:100",
             run=lambda: gl.mul(a, b), plain=lambda: gl.mul_plain(a, b),
             bytes=ew_bytes, ops=OPS_MUL * n_el),
        dict(name="poseidon2_permute", wrapper=ps.permute, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/poseidon2.py:415",
             run=lambda: ps.permute(grind), plain=lambda: ps.permute_plain(grind),
             bytes=2 * grind.numel() * 8,
             ops=grind.shape[0] * (PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD)),
        dict(name="poseidon2_hash_rows", wrapper=ps.hash_rows, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/poseidon2.py:449",
             run=lambda: ps.hash_rows(rows), plain=lambda: ps.hash_rows_plain(rows),
             bytes=(rows.numel() + m * ps.DIGEST_LEN) * 8,
             ops=m * perms_per_row * (PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD)),
        dict(name="poseidon2_two_to_one", wrapper=ps.two_to_one, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/poseidon2.py:492",
             run=lambda: ps.two_to_one(level[0::2], level[1::2]),
             plain=lambda: ps.two_to_one_plain(level[0::2], level[1::2]),
             bytes=(level.numel() + level.numel() // 2) * 8,
             ops=(m // 2) * (PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD)),
        # timed at the leaf LDE (135 x 256 -> 2048); checked in all three modes
        dict(name="ntt", wrapper=ntt.batched_ntt, source="qp_zk_circuits_tpu_torch/csrc/ntt.cu",
             replaces="qp_zk_circuits_tpu/poly/ntt.py:132",
             run=lambda: ntt.batched_ntt(coeffs, lde_bits, shift=7),
             plain=lambda: ntt.batched_ntt_plain(coeffs, lde_bits, shift=7),
             check=lambda: (
                 ntt_all(lambda x: ntt.batched_ntt(x, lde_bits, shift=7),
                         lambda x: ntt.batched_ntt(x, x.shape[1].bit_length() - 1, inverse=True),
                         lambda x: ntt.batched_ntt(x, lde_bits, inverse=True, out_shift=unshift)),
                 ntt_all(lambda x: ntt.batched_ntt_plain(x, lde_bits, shift=7),
                         lambda x: ntt.batched_ntt_plain(x, x.shape[1].bit_length() - 1, inverse=True),
                         lambda x: ntt.batched_ntt_plain(x, lde_bits, inverse=True, out_shift=unshift)),
             ),
             bytes=(coeffs.numel() + wires * m) * 8,
             ops=wires * ((m // 2) * lde_bits * (OPS_MUL + 2 * OPS_ADD) + (m >> rate) * OPS_MUL)),
        dict(name="quotient", wrapper=tprover.quotient_evals,
             source="qp_zk_circuits_tpu_torch/csrc/quotient.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover.py:114",
             setup=lambda: _quotient_case(device)),
        dict(name="permutation_polys", wrapper=tprover.compute_permutation_polys,
             source="qp_zk_circuits_tpu_torch/csrc/permutation.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:581",
             setup=lambda: _permutation_case(device)),
    ]


@functools.cache
def _leaf_data(device):
    """A leaf circuit of its own for the kernel checks, so the main path's
    prover starts with nothing cached."""
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    return WormholeProver(device=device).data


def _cpu(xs):
    return [x.cpu() if hasattr(x, "cpu") else x for x in xs]


def _quotient_case(device) -> dict:
    """Kernel A at the leaf: random LDE wires and Z/pp rows, the circuit's
    own constants, selectors and sigmas, random challenges."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    data = _leaf_data(device)
    cfg = data.config
    rng = np.random.default_rng(1)
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    npp = -(-cfg.num_routed_wires // cfg.max_quotient_degree_factor) - 1
    args = [_felts((cfg.num_wires, m), rng, device), _felts((nc + nc * npp, m), rng, device),
            *(F.rand_felts(nc, rng) for _ in range(3)), F.rand_felts(4, rng)]
    consts = data.constants_oracle.lde
    cpu_args = _cpu(args)
    muls, adds = quotient_field_ops(data)
    return dict(
        run=lambda: tprover.quotient_evals(data, *args),
        plain=lambda: tprover.quotient_evals_plain(data, *cpu_args), plain_on_host=True,
        bytes=(args[0].numel() + consts.numel() + args[1].numel() + 3 * m + nc * m) * 8,
        ops=m * (muls * OPS_MUL + adds * OPS_ADD),
    )


def _permutation_case(device) -> dict:
    """Kernel B at the leaf: a random trace and random beta, gamma."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    data = _leaf_data(device)
    cfg = data.config
    rng = np.random.default_rng(2)
    nc, nr, n = cfg.num_challenges, cfg.num_routed_wires, data.n
    nchunks = -(-nr // cfg.max_quotient_degree_factor)
    args = [_felts((cfg.num_wires, n), rng, device), F.rand_felts(nc, rng), F.rand_felts(nc, rng)]
    cpu_args = _cpu(args)
    # per (row, challenge): beta times id_i and sigma_i with 2 adds each, the
    # chunk products, one batch inverse across all rows (3 muls a chunk
    # denominator), cn_j * cd_j^-1, and one multiply a ratio for the running
    # products that give Z and the partial products; per challenge one
    # Fermat inverse
    muls = 2 * nr + 2 * (nr - nchunks) + 3 * nchunks + nchunks + nchunks
    return dict(
        run=lambda: tprover.compute_permutation_polys(data, *args),
        plain=lambda: tprover.compute_permutation_polys_plain(data, *cpu_args),
        plain_on_host=True,
        bytes=(3 * nr * n + nc * nchunks * n) * 8,
        ops=nc * ((n * muls + INV_MULS) * OPS_MUL + n * 4 * nr * OPS_ADD),
    )


def _host_median_ms(fn, runs: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _device_ms(fn, runs: int = 5):
    """Device-only time of one call: every device event torch.profiler
    records over `runs` calls, divided by `runs`; None if it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    return sum(e.self_device_time_total for e in events) / 1e3 / runs


def phase_kernels(kernels) -> None:
    import torch

    from qp_zk_circuits_tpu_torch.field import goldilocks as gl

    elementwise = (gl.add, gl.sub, gl.mul)
    for k in kernels:
        if "setup" in k:
            k.update(k["setup"]())
        before = [f.launches for f in elementwise]
        if "check" in k:
            got, want = k["check"]()
        else:
            got, want = [k["run"]()], [k["plain"]()]
        torch.cuda.synchronize()
        if k.get("plain_on_host") and [f.launches for f in elementwise] != before:
            raise AssertionError(f"{k['name']}: the fused kernel called the field wrappers")
        err = max(int((g.cpu() != w.cpu()).sum()) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{k['name']}: {err} elements differ from the plain version")
        k["max_abs_err"] = 0
        k["ms"] = _median_ms(k["run"], runs=20)
        k["device_ms"] = _device_ms(k["run"])
        if k.get("plain_on_host"):
            k["plain_ms"] = _host_median_ms(k["plain"], runs=3)
        else:
            k["plain_ms"] = _median_ms(k["plain"], runs=3, warmup=1)
        k["bound_by"] = "bytes" if k["bytes"] / HBM_BYTES_PER_S >= k["ops"] / INT32_OPS_PER_S else "operations"
        k["bound_ms"] = 1e3 * max(k["bytes"] / HBM_BYTES_PER_S, k["ops"] / INT32_OPS_PER_S)
        dev = "not measured" if k["device_ms"] is None else f"{k['device_ms']:.4f} ms"
        where = "host" if k.get("plain_on_host") else "card"
        print(f"[kernel] {k['name']}: bit-exact; {k['ms']:.4f} ms, device {dev} "
              f"(plain on the {where} {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']})", flush=True)


def phase_main_path(kernels) -> None:
    import torch

    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import test_inputs_0

    meta = json.loads(FIXTURE_META.read_text())[FIXTURE.name]
    t0 = time.time()
    prover = WormholeProver(device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    cfg = prover.data.config
    inputs = test_inputs_0()

    def prove_once():
        t = time.time()
        blob = proof_to_bytes(prover.prove_inputs(inputs, seed=0))
        torch.cuda.synchronize()
        return blob, time.time() - t

    for k in kernels:
        k["wrapper"].launches = 0
    blob, cold_s = prove_once()
    for k in kernels:
        k["launches"] = k["wrapper"].launches
    blob2, warm_s = prove_once()
    for name, b in (("cold", blob), ("warm", blob2)):
        digest = hashlib.sha256(b).hexdigest()
        if len(b) != meta["len"] or digest != meta["sha256"]:
            raise AssertionError(f"{name} proof differs from the fixture: {len(b)} B, {digest}")
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    fused = {k["name"]: k["launches"] for k in kernels if k["name"] in ("quotient", "permutation_polys")}
    if max(fused.values()) > 2:
        raise AssertionError(f"a fused stage took more than two launches: {fused}")
    counts = ", ".join(f"{k['name']}={k['launches']}" for k in kernels)
    print(f"[main] leaf: {cfg.num_wires} wires, degree_bits {prover.data.degree_bits}, "
          f"{cfg.fri_config.num_query_rounds} queries, {cfg.fri_config.proof_of_work_bits} PoW bits; "
          f"build {build_s:.2f} s, prove cold {1e3 * cold_s:.1f} ms, warm {1e3 * warm_s:.1f} ms; "
          f"proof {len(blob)} B == fixture; launches per proof: {counts}", flush=True)


def main() -> int:
    device_info = phase_device()
    sys.path.insert(0, str(ROOT))
    phase_build()
    kernels = kernel_table("cuda")
    phase_kernels(kernels)
    phase_main_path(kernels)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["route"] = "cuda"
        k["library_ms"] = None  # no single PyTorch call computes these functions
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
