"""The port's device mesh against the JAX package's, on D shards on the CPU.

`parallel/mesh.py` (the mesh, dp proving, the commit core),
`parallel/collectives.py`, `parallel/tp.py` (the tensor-parallel commit)
and `poly/ntt.py::ntt_sharded` with kernel H's plain versions, the CPU
counterpart of the JAX package's virtual CPU devices: every shard a "cpu"
device, the collectives copies on the host.

The JAX package's sharded functions need their devices before jax is
imported (`--xla_force_host_platform_device_count=8`), so they run in
subprocesses, started together when this module starts (the JAX compiles
take about a minute each, the port's side meanwhile): its `ntt_sharded` at
D = 2, 4, 8 and n = 256, 1024 both ways; its `commit_sharded` of 24 x 256
values at D = 8, cap 4, plain and salted (`blinding`, `salt_seed`); and its
unsharded `batch_commit_step` (a plain jnp function) at (4, 8, 32), rate 3,
cap 1. The port's proofs over a mesh are held to the JAX package's committed
fixtures (the single-device proofs, which the sharded ones equal there,
tests/test_sharding.py). Field arithmetic: every comparison is exact.
"""

import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.parallel import mesh as jmesh
from qp_zk_circuits_tpu.poly import ntt as jntt
from qp_zk_circuits_tpu_torch import _cuda
from qp_zk_circuits_tpu_torch.field import gf_np as TF
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.field import random as frandom
from qp_zk_circuits_tpu_torch.fri import oracle as fo
from qp_zk_circuits_tpu_torch.fri import prover as tfri
from qp_zk_circuits_tpu_torch.fri.config import SALT_SIZE
from qp_zk_circuits_tpu_torch.hash import poseidon2 as tps
from qp_zk_circuits_tpu_torch.models import batch_commit_step, make_prover_mesh, sharded_batch_commit
from qp_zk_circuits_tpu_torch.parallel import collectives as col
from qp_zk_circuits_tpu_torch.parallel import tp
from qp_zk_circuits_tpu_torch.parallel.mesh import Mesh, sharded_prove_batch
from qp_zk_circuits_tpu_torch.plonk import builder as tbuilder
from qp_zk_circuits_tpu_torch.plonk import prover as tprover
from qp_zk_circuits_tpu_torch.plonk import transcript as tts
from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
from qp_zk_circuits_tpu_torch.poly import ntt
from qp_zk_circuits_tpu_torch.tools.dryrun_multichip import dryrun_multichip
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers
from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())
_spec = importlib.util.spec_from_file_location("make_leaf_fixture", FIXTURES / "make_leaf_fixture.py")
MK = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MK)

NTT_CASES = [(d, n, inv) for d in (2, 4, 8) for n in (256, 1024) for inv in (0, 1)]
COMMIT_SHAPE, COMMIT_SEED, SALT_SEED = (24, 256), 5, 11
CORE_SHAPE, CORE_SEED = (4, 8, 32), 9

#: the JAX side, one part a subprocess: argv = part, output .npz
JAX_SIDE = r"""
import functools, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from qp_zk_circuits_tpu.field import gf_np as F
from qp_zk_circuits_tpu.field import goldilocks as gl
from qp_zk_circuits_tpu.parallel.mesh import batch_commit_step
from qp_zk_circuits_tpu.parallel.tp import commit_sharded
from qp_zk_circuits_tpu.poly import ntt
part, path = sys.argv[1], sys.argv[2]
out = {}
if part == "ntt":
    for d in (2, 4, 8):
        mesh = jax.make_mesh((d,), ("cols",), devices=jax.devices()[:d])
        for n in (256, 1024):
            x = F.rand_felts((n,), np.random.default_rng(1000 * d + n))
            for inv in (0, 1):
                y = ntt.ntt_sharded(gl.from_u64(x), mesh, inverse=bool(inv))
                out[f"ntt_{d}_{n}_{inv}"] = gl.to_u64(y)
else:
    kw = dict(blinding=True, salt_seed=%(salt_seed)d) if part == "salted" else {}
    mesh = jax.make_mesh((8,), ("cols",), devices=jax.devices()[:8])
    vals = F.rand_felts(%(commit_shape)r, np.random.default_rng(%(commit_seed)d))
    o = commit_sharded(vals, mesh, rate_bits=3, cap_height=4, from_values=True, **kw)
    out["coeffs"], out["lde"] = gl.to_u64(o.coeffs_dev), gl.to_u64(o.lde)
    for i, lvl in enumerate(o.tree.levels):
        out[f"level{i}"] = np.asarray(lvl)
    if part == "plain":
        traces = F.rand_felts(%(core_shape)r, np.random.default_rng(%(core_seed)d))
        step = jax.jit(functools.partial(batch_commit_step, rate_bits=3, cap_height=1))
        caps, ldes = step(gl.from_u64(traces))
        out["core_caps"], out["core_ldes"] = gl.to_u64(caps), gl.to_u64(ldes)
np.savez(path, **out)
print("JAX SIDE OK", part)
""" % dict(salt_seed=SALT_SEED, commit_shape=COMMIT_SHAPE, commit_seed=COMMIT_SEED,
           core_shape=CORE_SHAPE, core_seed=CORE_SEED)
JAX_PARTS = ("ntt", "plain", "salted")
JAX_TIMEOUT = 180


class JaxSide:
    """The JAX subprocesses, started together; `result(part)` waits for one."""

    def __init__(self, tmp: Path):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        self.paths = {p: tmp / f"{p}.npz" for p in JAX_PARTS}
        self.procs = {p: subprocess.Popen([sys.executable, "-c", JAX_SIDE, p, str(path)],
                                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)
                      for p, path in self.paths.items()}
        self._done = {}

    def result(self, part: str) -> dict:
        if part not in self._done:
            out, err = self.procs[part].communicate(timeout=JAX_TIMEOUT)
            assert self.procs[part].returncode == 0 and "JAX SIDE OK" in out, err[-3000:]
            self._done[part] = dict(np.load(self.paths[part]))
        return self._done[part]

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    side = JaxSide(tmp_path_factory.mktemp("jax_side"))
    yield side
    side.stop()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small torch ops: one intra-op thread each
    keeps them fast while the JAX subprocesses compile beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(d: int) -> Mesh:
    return Mesh(["cpu"] * d, ("cols",))


def _fixture(name: str) -> bytes:
    blob = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(blob).hexdigest() == META[name]["sha256"]
    return blob


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_tiling_rule_is_the_reference_s():
    """A mesh whose axes do not tile the device count raises the JAX
    package's error class and message."""
    with pytest.raises(AssertionError) as ref:
        jmesh.make_prover_mesh(8, dp=3)
    with pytest.raises(AssertionError) as mine:
        make_prover_mesh(8, dp=3, devices=["cpu"] * 8)
    assert str(mine.value) == str(ref.value) == "mesh axes must tile the device count"


@pytest.mark.parametrize("n,dp,shape", [(8, None, {"proofs": 8, "cols": 1}),
                                        (8, 2, {"proofs": 2, "cols": 4}),
                                        (4, 4, {"proofs": 4, "cols": 1}),
                                        (6, 3, {"proofs": 3, "cols": 2})])
def test_mesh_axes_and_shards(n, dp, shape):
    mesh = make_prover_mesh(n, dp=dp, devices=["cpu"] * 8)
    assert mesh.axis_names == ("proofs", "cols") and mesh.shape == shape
    assert mesh.shards("cols") == [torch.device("cpu")] * shape["cols"]
    assert mesh.shards("proofs", shape["cols"] - 1) == [torch.device("cpu")] * shape["proofs"]


def test_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_prover_mesh()
    assert make_prover_mesh(2, devices=["cpu", "cpu"]).shape == {"proofs": 2, "cols": 1}


@pytest.mark.parametrize("split,concat", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_all_to_all_is_jax_tiled_order(split, concat):
    """Block j of shard i's split goes to shard j at position i of the
    concat axis, as tiled `lax.all_to_all` lays it out: against the global
    formula on (D, rows, cols) numbers."""
    d = 4
    blocks = [torch.arange(8 * 12).reshape(8, 12) + 1000 * i for i in range(d)]
    out = col.all_to_all(blocks, split, concat)
    for j, got in enumerate(out):
        want = torch.cat([b.chunk(d, dim=split)[j] for b in blocks], dim=concat)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# kernel H's plain versions


@pytest.mark.parametrize("d", [1, 2, 4, 8, 64])
def test_shard_deinterleave_plain(d):
    x = TF.rand_felts((d * 16,), np.random.default_rng(d))
    got = gl.to_u64(ntt.shard_deinterleave(gl.from_u64(x, "cpu"), d))
    assert np.array_equal(got, x.reshape(16, d).T)


@pytest.mark.parametrize("d", [1, 2, 4, 8, 64])
@pytest.mark.parametrize("inverse", [False, True])
def test_shard_cross_ntt_plain(d, inverse):
    """W[k1, t] = sum_n1 z[n1, t] w_D^(+-n1 k1) (1/D inverse): the JAX
    package's `ntt_np` over each column."""
    z = TF.rand_felts((d, 8), np.random.default_rng(100 + d))
    got = gl.to_u64(ntt.shard_cross_ntt(gl.from_u64(z, "cpu"), inverse))
    assert np.array_equal(got, jntt.ntt_np(z.T, inverse=inverse).T)


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("inverse", [False, True])
def test_shard_cross_ntt_plain_equals_jax_shard_body_dft(d, inverse):
    """Kernel H's plain DFT against the step it replaces: `_ntt_shard_body`'s
    length-D `ntt_j` over n1 of the transposed (L/D, D) slab, jitted on the
    CPU, for every shard count up to MAX_SHARDS."""
    import jax

    from qp_zk_circuits_tpu.field import goldilocks as jgl

    z = TF.rand_felts((d, 4), np.random.default_rng(200 + d))
    want = jgl.to_u64(jax.jit(lambda v: jntt.ntt_j(v, inverse=inverse))(jgl.from_u64(z.T))).T
    got = gl.to_u64(ntt.shard_cross_ntt(gl.from_u64(z, "cpu"), inverse))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("inverse", [False, True])
def test_cross_twiddles_drive_the_radix2_dft(d, inverse):
    """The card's DFT takes `_cross_twiddles` (w_D^j for j < D/2 and the
    output scale) into a decimation-in-frequency transform with its outputs
    in bit-reversed registers: that schedule, replayed on the host with the
    same constants, is the direct sum of the plain version."""
    roots, scale = ntt._cross_twiddles(d, inverse)
    bits = d.bit_length() - 1
    assert roots.dtype == np.uint64 and roots.size == max(d // 2, 1)
    assert int(TF.mul(np.uint64(scale), np.uint64(d if inverse else 1))) == 1
    assert roots[0] == 1
    if d >= 4:  # the powers of a primitive D-th root
        assert int(TF.pow_scalar(roots[1], d // 2)) == int(TF.P) - 1
        assert np.array_equal(roots, TF.powers(roots[1], d // 2))
    z = TF.rand_felts((d, 5), np.random.default_rng(300 + d))
    x = [z[n].copy() for n in range(d)]
    h = d // 2
    while h >= 1:
        for s in range(0, d, 2 * h):
            for j in range(h):
                a, b = x[s + j], x[s + j + h]
                x[s + j] = TF.add(a, b)
                diff = TF.sub(a, b)
                x[s + j + h] = TF.mul(diff, roots[j * (d // (2 * h))]) if j else diff
        h //= 2
    out = np.empty_like(z)
    for k in range(d):
        r = int(format(k, f"0{bits}b")[::-1], 2) if bits else 0
        out[r] = TF.mul(x[k], np.uint64(scale)) if scale != 1 else x[k]
    want = gl.to_u64(ntt.shard_cross_ntt_plain(gl.from_u64(z, "cpu"), inverse))
    assert np.array_equal(out, want)


def test_kernel_h_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="power of two up to 64"):
        ntt.shard_cross_ntt(torch.zeros((128, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="power of two up to 64"):
        ntt.shard_cross_ntt(torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="deinterleaves"):
        ntt.shard_deinterleave(torch.zeros(24, dtype=torch.int64), 8)
    with pytest.raises(AssertionError, match="need D | N/D"):
        ntt.ntt_sharded(torch.zeros(32, dtype=torch.int64), _cpu_mesh(8))


# ---------------------------------------------------------------------------
# every kernel wrapper launches with its operands' device current


class _GuardRecorder:
    """A stand-in `_cuda.on_device`, `_cuda.stream` and kernel library: each
    entry records the device that was current when it was called, and each
    stream request the device current then."""

    def __init__(self):
        self.current, self.launches, self.streams = None, [], []

    @contextlib.contextmanager
    def on_device(self, device):
        before, self.current = self.current, torch.device(device)
        try:
            yield
        finally:
            self.current = before

    def stream(self):
        self.streams.append(self.current)
        return 0

    def __getattr__(self, entry):
        if not entry.startswith("qzk_"):
            raise AttributeError(entry)

        def call(*args):
            self.launches.append((entry, self.current))
            return 0

        return call


META_DEVICE = torch.device("meta")


def _meta(*shape):
    return torch.zeros(shape, dtype=torch.int64, device=META_DEVICE)


def _guard_launch(kernel, data):
    """Call kernel `kernel`'s wrapper on operands of one device; returns
    that device. Meta tensors take a
    wrapper's CUDA branch with no card: they are neither CPU nor the
    circuit's device."""
    cfg = data.config
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    rec = _meta(1, tts.REC_WORDS)
    if kernel == "1":
        gl.mul(_meta(8), _meta(8))
    elif kernel == "2":
        tps.hash_rows(_meta(8, 5))
    elif kernel == "3":
        ntt.batched_ntt(_meta(2, 8), 3, shift=7)
    elif kernel == "A":
        npp = tprover.num_partial_products(cfg.num_routed_wires, cfg.max_quotient_degree_factor)
        tprover.quotient_evals_batch(data, _meta(1, cfg.num_wires, m),
                                     _meta(1, nc + nc * npp, m), rec)
    elif kernel == "B":
        tprover.compute_permutation_polys_batch(data, _meta(1, cfg.num_wires, data.n), rec)
    elif kernel == "C":
        oracle = types.SimpleNamespace(lde=_meta(3, 32))
        tfri.compute_composition_batch([[oracle]], (((0, 0), (0, 1), (0, 2)),), _meta(1, 3, 2),
                                       rec, 5, 1)
    elif kernel == "D":
        oracle = types.SimpleNamespace(coeffs=_meta(3, 16))
        fo.eval_openings_batch([[oracle]], rec, 0, 0)
    elif kernel == "E":
        tfri.fold_round_batch(_meta(1, 8, 4), rec, tts.REC_FRI_BETA, 1, 4, 0)
    elif kernel == "F":
        tfri.query_gather([tfri.GatherSource(_meta(8, 3), 7)], [1, 2])
    elif kernel == "G":
        frandom.rand_felts(1, 0, _meta(4, 2))
    elif kernel == "H-deinterleave":
        ntt.shard_deinterleave(_meta(16), 4)
    elif kernel == "H-cross":
        ntt.shard_cross_ntt(_meta(4, 4))
    elif kernel == "I":
        tts.transcript_segment(_meta(tts.TS_WORDS), 0, 0, [(_meta(4), _meta(4))],
                               [(_meta(2), 0)])
    elif kernel == "J":
        tts.grind_device(_meta(tts.TS_WORDS), 3, 8, _meta(2))
    return META_DEVICE


@pytest.mark.parametrize("kernel", ["1", "2", "3", "A", "B", "C", "D", "E", "F", "G",
                                    "H-deinterleave", "H-cross", "I", "J"])
def test_wrappers_launch_on_their_operands_device(small_zk, monkeypatch, kernel):
    """On a mesh across cards the current device is not the operands' by
    default: each wrapper's launches and stream requests happen under
    `_cuda.on_device` of its operands' device."""
    data, _ = small_zk
    rec = _GuardRecorder()
    monkeypatch.setattr(_cuda, "on_device", rec.on_device)
    monkeypatch.setattr(_cuda, "stream", rec.stream)
    monkeypatch.setattr(_cuda, "lib", lambda: rec)
    monkeypatch.setattr(_cuda, "require_cuda_int64", lambda *tensors: None)
    for mod in (tps, tprover):
        monkeypatch.setattr(mod, "_kernel_lib", lambda index: rec)
    monkeypatch.setattr(tts, "_transcript_lib", lambda index: rec)
    # kernel F's pinned host buffer and its stream's synchronize
    monkeypatch.setitem(tfri._pinned, (1, 2, 3), torch.zeros((1, 2, 3), dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(synchronize=lambda: None))
    for fn in (gl.mul, tps.hash_rows, ntt.batched_ntt, tprover.quotient_evals_batch,
               tprover.compute_permutation_polys_batch, tfri.compute_composition_batch,
               fo.eval_openings_batch, tfri.fold_round_batch,
               tfri.query_gather, frandom.rand_felts, ntt.shard_deinterleave,
               ntt.shard_cross_ntt, tts.transcript_segment, tts.grind_device):
        if hasattr(fn, "launches"):
            monkeypatch.setattr(fn, "launches", fn.launches)
    try:
        device = _guard_launch(kernel, data)
    finally:
        for cache in data.__dict__.values():
            if isinstance(cache, dict):
                cache.pop(META_DEVICE, None)
    assert rec.launches and rec.streams
    assert [d for _, d in rec.launches] == [device] * len(rec.launches), rec.launches
    assert rec.streams == [device] * len(rec.streams)


# ---------------------------------------------------------------------------
# the tensor-parallel commit on its edges, against the single-device commit


@pytest.mark.parametrize("d,c,n,cap,salted", [
    (8, 20, 32, 1, True),    # ragged columns, salt, the top levels above the shards
    (4, 7, 16, 0, False),    # cap 0, pad columns
    (8, 3, 16, 7, True),     # fewer columns than shards, the cap at the leaves
    (2, 5, 8, 2, False),
])
def test_commit_sharded_equals_commit(d, c, n, cap, salted):
    rng = np.random.default_rng(d * c)
    vals = TF.rand_felts((c, n), rng)
    salt = TF.rand_felts((n << 3, SALT_SIZE), rng) if salted else None
    got = tp.commit_sharded(vals, _cpu_mesh(d), 3, cap, from_values=True, salt=salt)
    want = fo.commit(vals, 3, cap, "cpu", from_values=True, salt=salt)
    assert torch.equal(got.coeffs, want.coeffs) and torch.equal(got.lde, want.lde)
    assert [g.shape for g in got.tree.digests] == [w.shape for w in want.tree.digests]
    assert all(torch.equal(g, w) for g, w in zip(got.tree.digests, want.tree.digests))
    assert np.array_equal(got.cap, want.cap) and got.blinding == salted
    # one buffer, levels one after another, as kernel F reads the tree
    first = got.tree.digests[0]
    assert got.tree.digests[-1].data_ptr() == first.data_ptr() + 8 * 4 * sum(
        lvl.shape[0] for lvl in got.tree.digests[:-1])


def test_commit_sharded_refuses_a_short_axis():
    with pytest.raises(AssertionError, match="need D | M/D"):
        tp.commit_sharded(np.zeros((4, 2), dtype=np.uint64), _cpu_mesh(8), 0, 0)


# ---------------------------------------------------------------------------
# proofs over a mesh against the JAX fixtures


@pytest.fixture(scope="module")
def small_zk():
    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cpu")

    def pws(which):
        out = []
        for xv, yv in which:
            pw = tbuilder.PartialWitness()
            pw.set_target(x, xv)
            pw.set_target(y, yv)
            out.append(pw)
        return out

    return data, pws


def test_small_zk_tp_proof_equals_fixture(small_zk):
    """The ZK small circuit at D = 8 in host rng: 139 and 20 columns ragged
    over 8 shards, the salt rows, the JAX package's single-device bytes."""
    data, pws = small_zk
    proof = tprover.prove(data, pws(MK.ZK_BATCH_WITNESSES[:1])[0], seed=MK.ZK_SEED,
                          rng_mode="host", mesh=_cpu_mesh(8))
    assert proof_to_bytes(proof) == _fixture(MK.ZK_SMALL_FIXTURE)


def test_small_zk_tp_device_rng_equals_single_device(small_zk):
    """Device rng: the salts drawn once on the home device and given to the
    shards, so the proof equals the single-device device-rng proof of the
    same seed."""
    data, pws = small_zk
    pw = pws(MK.ZK_BATCH_WITNESSES[:1])
    mine = tprover.prove(data, pw[0], seed=3, rng_mode="device", mesh=_cpu_mesh(4))
    single = tprover.prove(data, pws(MK.ZK_BATCH_WITNESSES[:1])[0], seed=3, rng_mode="device")
    assert proof_to_bytes(mine) == proof_to_bytes(single)


def test_leaf_tp_proof_equals_fixture():
    """The leaf (135 wires, cap 4) at D = 4: the committed JAX proof."""
    prover = WormholeProver(device="cpu")
    proof = prover.prove_inputs(thelpers.test_inputs_0(), seed=0, mesh=_cpu_mesh(4))
    assert proof_to_bytes(proof) == _fixture("leaf_proof_inputs0.bin")


def test_sharded_prove_batch_equals_zk_batch_fixtures(small_zk):
    """K = 3 ZK proofs over dp = 3: one rng for the batch, each group on its
    shard; each proof the JAX package's batch fixture. K = 4 must tile."""
    data, pws = small_zk
    mesh = make_prover_mesh(3, dp=3, devices=["cpu"] * 3)
    proofs = sharded_prove_batch(data, mesh, pws(MK.ZK_BATCH_WITNESSES), seed=MK.ZK_SEED)
    assert [proof_to_bytes(p) for p in proofs] == [_fixture(f) for f in MK.ZK_BATCH_FIXTURES]
    with pytest.raises(AssertionError, match="batch must tile the proofs axis"):
        sharded_prove_batch(data, mesh, pws(MK.ZK_BATCH_WITNESSES + MK.ZK_BATCH_WITNESSES[:1]))


def test_sharded_prove_batch_k4_over_dp2_equals_prove_batch(small_zk, monkeypatch):
    """K = 4 over dp = 2: one `prove_from_traces` a group, in input order,
    each on its proof shard's device; the proofs equal `prove_batch`'s of
    the same seed, the first three the JAX package's K = 3 batch fixtures
    (one rng for the batch, each proof drawing in turn)."""
    data, pws = small_zk
    witnesses = MK.ZK_BATCH_WITNESSES + MK.ZK_BATCH_WITNESSES[1:2]
    calls = []
    real = tprover.prove_from_traces

    def spy(*args, **kwargs):
        calls.append((len(args[1]), kwargs.get("device")))
        return real(*args, **kwargs)

    monkeypatch.setattr(tprover, "prove_from_traces", spy)
    mesh = make_prover_mesh(2, dp=2, devices=["cpu"] * 2)
    proofs = [proof_to_bytes(p) for p in sharded_prove_batch(data, mesh, pws(witnesses),
                                                             seed=MK.ZK_SEED)]
    assert calls == [(2, d) for d in mesh.shards("proofs")]
    assert proofs[:3] == [_fixture(f) for f in MK.ZK_BATCH_FIXTURES]
    assert proofs == [proof_to_bytes(p) for p in tprover.prove_batch(data, pws(witnesses),
                                                                     seed=MK.ZK_SEED)]


def test_sharded_prove_batch_raises_a_groups_exception(small_zk, monkeypatch):
    """A group that fails raises in the caller: no group is dropped or
    retried, and none after it runs."""
    data, pws = small_zk
    calls = []

    def fail_second(data, traces, pis, seed=None, salts=None, device=None):
        calls.append(device)
        if len(calls) == 2:
            raise RuntimeError("group failed")
        return [None] * len(traces)

    monkeypatch.setattr(tprover, "prove_from_traces", fail_second)
    mesh = make_prover_mesh(3, dp=3, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="group failed"):
        sharded_prove_batch(data, mesh, pws(MK.ZK_BATCH_WITNESSES), seed=MK.ZK_SEED)
    assert len(calls) == 2


def test_warmup_fills_every_shard_device(small_zk, monkeypatch):
    data, pws = small_zk
    mesh = _cpu_mesh(2)
    seen = []
    monkeypatch.setattr(tprover, "_prove_drawn", lambda *args: seen.append(args))
    tprover.warmup(data, pws(MK.ZK_BATCH_WITNESSES[:1])[0], "host", mesh=mesh)
    assert seen and seen[0][-1] is mesh
    for dev in mesh.unique_devices():
        assert dev in data.__dict__["_torch_tables"] and dev in data.__dict__["_torch_routing"]
        assert tprover.device_constants(data, dev) is data.constants_oracle


def test_dryrun_multichip_on_two_cpu_shards():
    assert dryrun_multichip(2, ["cpu", "cpu"]).startswith("dryrun_multichip OK on 2 shards")


# ---------------------------------------------------------------------------
# against the JAX package's sharded functions (the subprocesses)


@pytest.mark.parametrize("d,n,inv", NTT_CASES)
def test_ntt_sharded_equals_jax(jax_side, d, n, inv):
    x = TF.rand_felts((n,), np.random.default_rng(1000 * d + n))
    blocks = ntt.ntt_sharded(gl.from_u64(x, "cpu"), _cpu_mesh(d), inverse=bool(inv))
    got = gl.to_u64(torch.cat(blocks))
    assert np.array_equal(got, jax_side.result("ntt")[f"ntt_{d}_{n}_{inv}"])
    assert np.array_equal(got, jntt.ntt_np(x, inverse=bool(inv)))


@pytest.mark.parametrize("part", ["plain", "salted"])
def test_commit_sharded_equals_jax(jax_side, part):
    vals = TF.rand_felts(COMMIT_SHAPE, np.random.default_rng(COMMIT_SEED))
    m = COMMIT_SHAPE[1] << 3
    salt = (JF.rand_felts((m, SALT_SIZE), np.random.default_rng(SALT_SEED))
            if part == "salted" else None)
    got = tp.commit_sharded(vals, _cpu_mesh(8), 3, 4, from_values=True, salt=salt)
    want = jax_side.result(part)
    assert np.array_equal(gl.to_u64(got.coeffs), want["coeffs"])
    assert np.array_equal(gl.to_u64(got.lde), want["lde"])
    levels = sorted((k for k in want if k.startswith("level")), key=lambda k: int(k[5:]))
    assert len(levels) == len(got.tree.digests)
    for key, lvl in zip(levels, got.tree.digests):
        assert np.array_equal(gl.to_u64(lvl), want[key]), key
    assert np.array_equal(got.cap, want[levels[-1]])


def test_batch_commit_step_equals_jax(jax_side):
    """The commit core over a (2, 2) mesh against the JAX package's
    unsharded `batch_commit_step`."""
    traces = gl.from_u64(TF.rand_felts(CORE_SHAPE, np.random.default_rng(CORE_SEED)), "cpu")
    mesh = make_prover_mesh(4, dp=2, devices=["cpu"] * 4)
    caps, ldes = sharded_batch_commit(mesh, rate_bits=3, cap_height=1)(traces)
    want = jax_side.result("plain")
    assert caps.shape == (4, 2, 4) and ldes.shape == (4, 8, 256)
    assert np.array_equal(gl.to_u64(caps), want["core_caps"])
    assert np.array_equal(gl.to_u64(ldes), want["core_ldes"])
    single_caps, single_ldes = batch_commit_step(traces, 3, 1)
    assert torch.equal(caps, single_caps) and torch.equal(ldes, single_ldes)


# ---------------------------------------------------------------------------
# the card


@pytest.mark.gpu
def test_shard_cross_ntt_edges_on_card():
    """Kernel H's DFT at every shard count, both ways, on slabs of 1, 2, 3
    and 2^12 columns (one column a thread, a pair, one odd, many) and on
    a slab that starts one felt past 16-byte alignment, against the plain
    version; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    for d in (1, 2, 4, 8, 16, 32, 64):
        for cols in (1, 2, 3, 1 << 12):
            buf = gl.from_u64(TF.rand_felts((d * cols + 1,), rng), "cuda")
            for z in (buf[: d * cols].view(d, cols), buf[1:].view(d, cols)):
                for inverse in (False, True):
                    before = ntt.shard_cross_ntt.launches
                    got = ntt.shard_cross_ntt(z, inverse)
                    assert ntt.shard_cross_ntt.launches == before + 1
                    assert torch.equal(got.cpu(), ntt.shard_cross_ntt_plain(z.cpu(), inverse))


@pytest.mark.gpu
def test_mesh_kernels_on_card():
    """Kernel H against its plain versions, the sharded NTT against kernel
    3's single NTT and the tp commit against the single commit, on four
    shards of card 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    for d in (1, 2, 4, 8, 64):
        x = gl.from_u64(TF.rand_felts((d * 64,), rng), "cuda")
        assert torch.equal(ntt.shard_deinterleave(x, d).cpu(),
                           ntt.shard_deinterleave_plain(x.cpu(), d))
        for inverse in (False, True):
            z = x.view(d, 64)
            assert torch.equal(ntt.shard_cross_ntt(z, inverse).cpu(),
                               ntt.shard_cross_ntt_plain(z.cpu(), inverse))
    mesh = Mesh(["cuda:0"] * 4, ("cols",))
    poly = gl.from_u64(TF.rand_felts((1 << 16,), rng), "cuda")
    for inverse in (False, True):
        got = torch.cat(ntt.ntt_sharded(poly, mesh, inverse=inverse))
        assert torch.equal(got, ntt.ntt(poly, inverse=inverse))
    vals = TF.rand_felts((135, 256), rng)
    salt = TF.rand_felts((2048, SALT_SIZE), rng)
    got = tp.commit_sharded(vals, mesh, 3, 4, from_values=True, salt=salt)
    want = fo.commit(vals, 3, 4, "cuda", from_values=True, salt=salt)
    assert torch.equal(got.lde, want.lde) and np.array_equal(got.cap, want.cap)
    assert all(torch.equal(g, w) for g, w in zip(got.tree.digests, want.tree.digests))


@pytest.mark.gpu
def test_dp_groups_of_one_shape_on_card():
    """Two groups of one shape on D = 2 shards of one card (kernel F's
    pinned buffer of that shape reused by the second group): the proofs
    `prove_batch`'s bytes and accepted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from qp_zk_circuits_tpu_torch.plonk.verifier import verify

    b, x, y = MK.small_real_circuit("qp_zk_circuits_tpu_torch", zk=True)
    data = b.build(device="cuda")

    def pws():
        out = []
        for xv, yv in MK.ZK_BATCH_WITNESSES + MK.ZK_BATCH_WITNESSES[1:2]:
            pw = tbuilder.PartialWitness()
            pw.set_target(x, xv)
            pw.set_target(y, yv)
            out.append(pw)
        return out

    mesh = make_prover_mesh(2, dp=2, devices=["cuda:0"] * 2)
    want = [proof_to_bytes(p) for p in tprover.prove_batch(data, pws(), seed=MK.ZK_SEED)]
    for _ in range(3):
        proofs = sharded_prove_batch(data, mesh, pws(), seed=MK.ZK_SEED)
        assert [proof_to_bytes(p) for p in proofs] == want
        for p in proofs:
            verify(data, p)
