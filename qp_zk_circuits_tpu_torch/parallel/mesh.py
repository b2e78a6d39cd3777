"""Device meshes and the sharded prover steps over them.

The JAX package's `parallel/mesh.py` runs one controller: one process,
`jax.devices()`, `shard_map` over a `Mesh` whose collectives are XLA's. The
port keeps that model. A `Mesh` is a grid of `torch.device`s with named
axes, ("proofs", "cols") from `make_prover_mesh`; one process drives every
shard (a shard is one device's block of the work), and the collectives are
explicit copies between the shards' buffers (parallel/collectives.py):
peer copies between cards, device copies between shards of one card. A
device may appear more than once: `devices=["cuda:0"] * 4` is four shards on
one card, `["cpu"] * 8` eight on the CPU, the counterparts of the JAX
package's virtual CPU devices (`--xla_force_host_platform_device_count`).

`torch.distributed` with NCCL (one process a card) is not used: the JAX
package has no such launcher, and one process reaches every card of a host
through peer copies; it waits for a cell that needs more than one host.

The scaling axes are the JAX package's:

  * dp ("proofs"): a batch of independent proofs split over the shards,
    each shard proving its part on its device (`sharded_prove_batch`);
  * tp ("cols"): one commitment's polynomial columns split over the shards
    (parallel/tp.py::commit_sharded, under `plonk/prover.py::prove(mesh=)`);
  * `batch_commit_step`: both at once, the dp x tp commitment core.

A mesh is opt-in: every entry point without one runs the single-device
path unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fri import oracle as fo
from . import tp


def _index(device) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes (the counterpart of
    `jax.sharding.Mesh`): `devices` a numpy object array of
    `torch.device`s, one axis a name."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a {grid.shape} device grid for axes {axis_names}")
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [_index(d) for d in grid.ravel()]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def shards(self, axis: str, index: int = 0) -> list[torch.device]:
        """The devices along `axis`, the other axes at `index` (row-major)."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, index])

    def unique_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices.ravel()))


def make_prover_mesh(n_devices: int | None = None, dp: int | None = None,
                     devices=None) -> Mesh:
    """Mesh with axes ("proofs", "cols"): dp shards on "proofs", n_devices /
    dp on "cols". `devices` defaults to the visible CUDA cards (without CUDA
    it raises, as `device.resolve_device` does); a list may repeat a device
    (D shards on one card or on the CPU)."""
    if devices is None:
        resolve_device()  # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n = n_devices or len(devs)
    dp = dp or n
    tp_ = n // dp
    if dp * tp_ != n:
        raise AssertionError("mesh axes must tile the device count")
    if n > len(devs):
        raise ValueError(f"{n} shards of {len(devs)} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(dp, tp_), ("proofs", "cols"))


def batch_commit_step(traces: torch.Tensor, rate_bits: int, cap_height: int,
                      mesh: Mesh | None = None):
    """The commitment core for a batch of wire traces (B, C, N): interpolate,
    coset-LDE, hash the leaf rows and build the Merkle caps. Returns (caps
    (B, 2^cap, 4), ldes (B, C, M)) on the traces' device.

    Without a mesh: one stacked kernel-3 iNTT and LDE and one kernel-2 forest
    (`fri/oracle.py::commit_batch`). With one: B split over "proofs", each
    proof shard's traces committed by `tp.commit_sharded` over its row of
    "cols" shards, the results gathered back in proof order."""
    b = traces.shape[0]
    if mesh is None:
        batches = fo.commit_batch(traces, rate_bits, cap_height, from_values=True)
        caps = torch.stack([o.tree.digests[-1] for o in batches])
        return caps, fo.stacked_lde(batches)
    dp = mesh.shape["proofs"]
    if b % dp:
        raise AssertionError("batch must tile the proofs axis")
    home = traces.device
    caps, ldes = [], []
    for p in range(dp):
        row = Mesh(mesh.shards("cols", p), ("cols",))
        for trace in traces[p * (b // dp) : (p + 1) * (b // dp)]:
            o = tp.commit_sharded(trace.to(row.devices[0]), row, rate_bits, cap_height,
                                  from_values=True)
            caps.append(o.tree.digests[-1].to(home))
            ldes.append(o.lde.to(home))
    return torch.stack(caps), torch.stack(ldes)


def sharded_batch_commit(mesh: Mesh, rate_bits: int = 3, cap_height: int = 1):
    """`batch_commit_step` bound to the mesh and the commit's parameters (the
    JAX package's jitted dp x tp step)."""
    def step(traces: torch.Tensor):
        return batch_commit_step(traces, rate_bits, cap_height, mesh)

    return step


def sharded_prove_batch(data, mesh: Mesh, pws: list, seed: int | None = None) -> list:
    """Prove K witnesses data-parallel over the mesh's "proofs" axis (the
    JAX package's shard_map of the vmapped fused prover).

    One `generate_witness_batch` from `default_rng(seed)` draws every
    witness and, for a ZK circuit, every proof's blinding rows and salts in
    turn, in the JAX package's order (`_batch_flat_inputs`); the traces, public
    inputs and salts are cut into dp contiguous groups and group g is proven
    by `prove_from_traces` on the device of proof shard g ("cols" index 0).
    Proofs come back in input order, each equal to `prove_batch`'s.

    The groups run in turn on the calling thread, not at once as under the
    JAX package's shard_map: each `prove_from_traces` waits on the host (the
    caps read back for the transcript, the proof bytes built) before the
    next group starts. Most of a group's time is Python between launches,
    which holds the GIL, so the groups on host threads of their own took
    longer than in turn, on four shards of one card and on four cards
    alike (`tools/bench_dp.py`, PERF.md); dp over several cards does not
    yet shorten a batch."""
    from ..plonk.builder import generate_witness_batch
    from ..plonk.prover import _check_config, prove_from_traces

    _check_config(data.config)
    k = len(pws)
    dp = mesh.shape["proofs"]
    if k % dp:
        raise AssertionError("batch must tile the proofs axis")
    traces, pis, salts = generate_witness_batch(data, pws, np.random.default_rng(seed))
    per = k // dp
    proofs = []
    for g, dev in enumerate(mesh.shards("proofs")):
        part = slice(g * per, (g + 1) * per)
        proofs += prove_from_traces(data, traces[part], pis[part], seed,
                                    None if salts is None else salts[part], device=dev)
    return proofs
