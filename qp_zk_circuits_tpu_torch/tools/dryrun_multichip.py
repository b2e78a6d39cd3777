"""The multi-device dryrun on the port: the JAX package's
`__graft_entry__.py::dryrun_multichip` (its four sections) on a mesh of
the caller's devices.

  1. dp: a small real circuit's K = n proofs over the "proofs" axis
     (`parallel/mesh.py::sharded_prove_batch`), each verified on the host and
     byte-equal to the single-device proof of its witness;
  1b. tp: one proof with its three commits over an n-shard "cols" axis
     (`plonk/prover.py::prove(mesh=)`), verified and byte-equal;
  2. the coefficient-sharded NTT (`poly/ntt.py::ntt_sharded`, kernel H) of
     one polynomial of max(64, n^2) coefficients against the single NTT,
     and its inverse back to the input;
  3. the dp x tp commitment core (`sharded_batch_commit`) on (2 dp, 4 tp,
     32) traces against the unsharded `batch_commit_step`.

Run it as `python -m qp_zk_circuits_tpu_torch.tools.dryrun_multichip
[--shards N] [--one-card]`: N shards on the visible cards (one a card), or
with --one-card N shards on card 0.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..field import gf_np as F
from ..field import goldilocks as gl
from ..fri.config import FriConfig, FriReductionStrategy
from ..parallel.mesh import (
    Mesh,
    batch_commit_step,
    make_prover_mesh,
    sharded_batch_commit,
    sharded_prove_batch,
)
from ..plonk.builder import CircuitBuilder, PartialWitness
from ..plonk.config import CircuitConfig
from ..plonk.prover import prove
from ..plonk.serialization import proof_to_bytes
from ..plonk.verifier import verify
from ..poly import ntt


def small_real_circuit(device):
    """The JAX package's `__graft_entry__._small_real_circuit`: arithmetic,
    a range check, copy constraints, an in-circuit hash and public inputs,
    at a small FRI profile (cap 4, 2 queries, 1 PoW bit). Returns (data on
    `device`, witness(x, y))."""
    cfg = CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=1, num_query_rounds=2,
        reduction_strategy=FriReductionStrategy(4, 5)))
    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    s = b.add(b.mul(x, y), b.mul_const(3, x))
    b.range_check(s, 32)
    h = b.hash_n_to_hash_no_pad([x, y, s])
    b.register_public_inputs([s] + list(h))
    data = b.build(device=device)

    def witness(x_val: int, y_val: int) -> PartialWitness:
        pw = PartialWitness()
        pw.set_target(x, x_val)
        pw.set_target(y, y_val)
        return pw

    return data, witness


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """The four sections on `n_devices` shards of `devices` (default: the
    visible CUDA cards; a list may repeat a device). Raises on any
    divergence; returns the summary line."""
    mesh = make_prover_mesh(n_devices, dp=n_devices, devices=devices)
    devs = list(mesh.devices.ravel())
    home = devs[0]

    # 1. the real prover, dp over the "proofs" axis
    data, witness = small_real_circuit(home)
    k = n_devices
    proofs = sharded_prove_batch(data, mesh, [witness(3 + i, 5 + 2 * i) for i in range(k)], seed=7)
    for i, p in enumerate(proofs):
        verify(data, p)
        ref = prove(data, witness(3 + i, 5 + 2 * i), seed=0)
        if proof_to_bytes(p) != proof_to_bytes(ref):
            raise AssertionError("sharded proof diverged")

    # 1b. the three commits tensor-parallel inside the prover
    cols_mesh = Mesh(devs, ("cols",))
    tp_proof = prove(data, witness(3, 5), seed=0, rng_mode="host", mesh=cols_mesh)
    verify(data, tp_proof)
    if proof_to_bytes(tp_proof) != proof_to_bytes(prove(data, witness(3, 5), seed=0)):
        raise AssertionError("tp proof diverged")

    # 2. the coefficient-sharded NTT
    n = max(64, n_devices * n_devices)
    poly = gl.from_u64(F.rand_felts((n,), np.random.default_rng(2)), home)
    got = torch.cat([b.to(home) for b in ntt.ntt_sharded(poly, cols_mesh)])
    if not torch.equal(got, ntt.ntt(poly)):
        raise AssertionError("sharded NTT diverged from the single NTT")
    back = torch.cat([b.to(home) for b in ntt.ntt_sharded(got, cols_mesh, inverse=True)])
    if not torch.equal(back, poly):
        raise AssertionError("sharded iNTT did not invert")

    # 3. the dp x tp commitment core
    dp, tp = n_devices, 1
    if n_devices % 2 == 0 and n_devices >= 4:
        dp, tp = n_devices // 2, 2
    cmesh = make_prover_mesh(n_devices, dp=dp, devices=devs)
    b, c, nn = dp * 2, tp * 4, 32
    traces = gl.from_u64(F.rand_felts((b, c, nn), np.random.default_rng(1)), home)
    caps, ldes = sharded_batch_commit(cmesh, rate_bits=3, cap_height=1)(traces)
    want_caps, want_ldes = batch_commit_step(traces, 3, 1)
    if caps.shape != (b, 2, 4) or ldes.shape != (b, c, nn * 8):
        raise AssertionError(f"commit core shapes {tuple(caps.shape)}, {tuple(ldes.shape)}")
    if not (torch.equal(caps, want_caps) and torch.equal(ldes, want_ldes)):
        raise AssertionError("the sharded commit core diverged from the unsharded one")
    return (f"dryrun_multichip OK on {n_devices} shards ({', '.join(str(d) for d in devs)}): "
            f"{k} real proofs proven under dp sharding (byte-identical, all verify), "
            f"tp prove byte-identical, sharded NTT(n={n}) matches the single NTT, "
            f"commit core mesh {dp}x{tp}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=None,
                    help="shards (default: one a visible card)")
    ap.add_argument("--one-card", action="store_true", help="every shard on card 0")
    args = ap.parse_args()
    n = args.shards or torch.cuda.device_count()
    print(dryrun_multichip(n, ["cuda:0"] * n if args.one_card else None), flush=True)


if __name__ == "__main__":
    main()
