"""The port's Wormhole leaf prover at full width against the JAX package.

The leaf circuit (135 wires, 80 routed, degree_bits 8, 28 queries, 16 PoW
bits) is built by the port on the CPU (the plain versions of the kernels) and
proven on `test_inputs_0()`; the proof must equal the JAX package's, committed
by tests/torch_fixtures/make_leaf_fixture.py. The reference side here is
host-only (shape-only build, numpy fixtures), so no JAX graph is compiled.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.wormhole import test_helpers as jhelpers
from qp_zk_circuits_tpu.wormhole.leaf_circuit import WormholeCircuit as JWormholeCircuit
from qp_zk_circuits_tpu_torch import interop
from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
from qp_zk_circuits_tpu_torch.wormhole import test_helpers as thelpers
from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "torch_fixtures"
META = json.loads((FIXTURES / "fixtures.json").read_text())["leaf_proof_inputs0.bin"]
REF_PROOF = (FIXTURES / "leaf_proof_inputs0.bin").read_bytes()


@pytest.fixture(scope="module")
def cpu_prover():
    return WormholeProver(device="cpu")


def test_fixture_is_the_committed_one():
    assert len(REF_PROOF) == META["len"]
    assert hashlib.sha256(REF_PROOF).hexdigest() == META["sha256"]


def test_leaf_circuit_data_equals_reference(cpu_prover):
    data = cpu_prover.data
    cfg = data.config
    assert (cfg.num_wires, cfg.num_routed_wires, data.degree_bits) == (135, 80, 8)
    assert (cfg.fri_config.num_query_rounds, cfg.fri_config.proof_of_work_bits) == (28, 16)
    ref = interop.arrays_of(JWormholeCircuit().build(shape_only=True))
    mine = interop.arrays_of(data)
    for key in ref:
        assert np.array_equal(mine[key], ref[key]), key
    assert data.constants_oracle.cap.tolist() == META["constants_cap"]
    assert data.circuit_digest.tolist() == META["circuit_digest"]


def test_leaf_proof_equals_fixture(cpu_prover):
    blob = proof_to_bytes(cpu_prover.prove_inputs(thelpers.test_inputs_0(), seed=0))
    assert blob == REF_PROOF


def test_fixture_inputs_equal_reference():
    for mine, ref in zip(
        [thelpers.test_inputs_0()] + list(thelpers.two_real_leaves_same_block()),
        [jhelpers.test_inputs_0()] + list(jhelpers.two_real_leaves_same_block()),
    ):
        assert mine.public.to_felts().tolist() == ref.public.to_felts().tolist()
        assert mine.private.zk_tree_root == ref.private.zk_tree_root
        assert mine.private.siblings == ref.private.siblings


def test_prover_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        WormholeProver()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every port module (the recursion gadgets, the aggregation
    layers, the pool and the aggregation service, the mesh and the tools
    among them),
    and chip_smoke.py with the port
    modules it loads and the aggregation fixtures' module it reads its seeds
    from, leaves jax and qp_zk_circuits_tpu out of sys.modules."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import qp_zk_circuits_tpu_torch as pkg
names = [info.name for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
want = {{pkg.__name__ + "." + m for m in (
    "recursion.ext_gadgets", "recursion.challenger_gadget", "recursion.verifier_gadget",
    "wormhole.dummy_proof", "wormhole.fake_leaf", "wormhole.private_batch",
    "wormhole.public_batch", "wormhole.artifacts", "wormhole.pool",
    "wormhole.aggregator_service", "models", "tools.profile_agg", "parallel.mesh",
    "parallel.collectives", "parallel.tp", "tools.dryrun_multichip")}}
assert want <= set(names), sorted(want - set(names))
import chip_smoke
chip_smoke.kernel_table("cpu")
chip_smoke._agg_fixtures().test_configs(pkg)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "qp_zk_circuits_tpu"
             or m.startswith("qp_zk_circuits_tpu."))
print(bad)
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.gpu
def test_leaf_proof_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    prover = WormholeProver(device="cuda")
    assert proof_to_bytes(prover.prove_inputs(thelpers.test_inputs_0(), seed=0)) == REF_PROOF
