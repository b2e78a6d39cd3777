"""The port's host tools against the JAX package's (CPU, seconds).

Six modules of `qp_zk_circuits_tpu_torch/` held to their JAX counterparts:
`utils/transfer_proof.py` (the cases of
tests/test_serialization_inputs.py::TestTransferProofJson through both
packages: outcomes, exception classes, messages and attribute sets),
`tools/circuit_builder_cli.py` (the same argument lists accepted and
refused), `tools/gate_profiler.py` and `tools/profile_circuits.py` (the leaf
profiles and tests/test_profiles.py's security grid equal to the JAX
package's dicts; the private batch's scaling against that test's pins; the
fake leaf data against the shape-only leaf), `tools/memprof.py` (the
query-round rebalance and the weakening refusal as the JAX package's; a CPU
phase has a null device peak) and `tools/sweep_shapes.py` (the estimate and
one row of each sweep equal to the JAX package's; no TPU figure and no
anchor but the port's own memprof; its own report path).

The JAX side's circuit builds run in one subprocess started with the module,
beside the port's: a shape-only private batch of N = 2 takes 7-8 s in either
package on the CPU test host.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qp_zk_circuits_tpu.tools import circuit_builder_cli as jcli
from qp_zk_circuits_tpu.tools import memprof as jmemprof
from qp_zk_circuits_tpu.utils import transfer_proof as jtp
from qp_zk_circuits_tpu_torch.tools import circuit_builder_cli as tcli
from qp_zk_circuits_tpu_torch.tools import memprof as tmemprof
from qp_zk_circuits_tpu_torch.tools import profile_circuits as tpc
from qp_zk_circuits_tpu_torch.tools import sweep_shapes as tsweep
from qp_zk_circuits_tpu_torch.utils import transfer_proof as ttp
from qp_zk_circuits_tpu_torch.utils.config_policy import (
    wormhole_leaf_circuit_config,
    wormhole_private_batch_circuit_config,
)

ROOT = Path(__file__).resolve().parents[1]

#: tests/test_profiles.py::test_security_tradeoffs_leaf_degree_flat's grid
GRID = [
    ("Standard ZK (100-bit)", 28, 16, 100),
    ("76-bit", 20, 16, 76),
    ("80-bit (20q + 20pow)", 20, 20, 80),
]

#: the JAX side: the leaf profiles, the grid, the canonical N = 2 private
#: batch's sweep rows (each sweep's canonical value: `_pb_shape` of that
#: value builds the canonical config, asserted, so `_row` of the one build
#: is the sweep's row), `estimate_device_mb` of both leaf profiles, and the
#: exit code of memprof's weakening refusal; one JSON line
JAX_SIDE = r"""
import json, sys
from dataclasses import replace
from qp_zk_circuits_tpu.tools import memprof, profile_circuits as pc, sweep_shapes as sw
from qp_zk_circuits_tpu.utils.config_policy import (
    wormhole_leaf_circuit_config, wormhole_private_batch_circuit_config)
grid = [tuple(g) for g in json.loads(sys.argv[1])]
cfg = wormhole_private_batch_circuit_config()
for knob, value in (("num_routed_wires", 60), ("num_wires", 135),
                    ("max_quotient_degree_factor", 8), ("zero_knowledge", True)):
    assert replace(cfg, **{knob: value}) == cfg
canonical = sw._pb_shape()
out = {
    "profile": pc.wormhole_circuit_profile(),
    "security": pc.security_tradeoffs(grid),
    "rows": {"routed_wires": sw._row(canonical, 60), "num_wires": sw._row(canonical, 135),
             "qdf": sw._row(canonical, 8),
             "zk_mode": sw._row(canonical, "rowblinding (production)")},
    "estimate_leaf": {
        "zk": sw.estimate_device_mb(pc._leaf_shape(wormhole_private_batch_circuit_config())),
        "no_zk": sw.estimate_device_mb(pc._leaf_shape(wormhole_leaf_circuit_config()))},
    "refusal": memprof.main(["--rate-bits", "-1"]),
}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """Start the JAX side first; `side()` waits for its JSON."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, json.dumps(GRID)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def side() -> dict:
        if not done:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done

    yield side
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _json(value):
    """A value as the JAX side's JSON line gives it back."""
    return json.loads(json.dumps(value))


# ---------------------------------------------------------------------------
# utils/transfer_proof.py


def _doc(tp, case: str):
    base = {"transfer_count": 1, "state_root": "00", "storage_proof": ["00"], "indices": [0]}
    node = "a" * 4096
    docs = {
        "minimal": '{"transfer_count":1,"state_root":"00","storage_proof":["00"],"indices":[0]}',
        "bytes": b'{"transfer_count":7,"state_root":"ab","storage_proof":[],"indices":[1,2]}',
        "oversized": '{"junk":"' + "a" * tp.MAX_TRANSFER_PROOF_JSON_BYTES + '"}',
        "state_root": {**base, "state_root": "f" * (tp.MAX_STATE_ROOT_HEX_LEN + 1)},
        "state_root_type": {**base, "state_root": 5},
        "nodes": {**base, "storage_proof": ["00"] * (tp.MAX_STORAGE_PROOF_NODES + 1)},
        "node_type": {**base, "storage_proof": ["00", 1]},
        "node_len": {**base, "storage_proof": ["a" * (tp.MAX_STORAGE_PROOF_NODE_HEX_LEN + 1)]},
        "storage_type": {**base, "storage_proof": "00"},
        "entries": {**base, "indices": [0] * (tp.MAX_MERKLE_INDICES + 1)},
        "indices_type": {**base, "indices": {"0": 1}},
        "negative_count": {**base, "transfer_count": -1},
        "big_count": {**base, "transfer_count": 1 << 64},
        "float_count": {**base, "transfer_count": 1.5},
        "bool_count": {**base, "transfer_count": True},
        "negative_index": {**base, "indices": [-1]},
        "bool_index": {**base, "indices": [True]},
        "total_bytes": {**base, "storage_proof": [node] * (
            tp.MAX_STORAGE_PROOF_HEX_BYTES // 4096 + 1)},
        "missing": '{"transfer_count": 1}',
        "not_object": "[1, 2]",
        "not_json": "not json",
        "bad_utf8": b'{"transfer_count": "\xff"}',
    }
    doc = docs[case]
    return doc if isinstance(doc, (str, bytes)) else json.dumps(doc)


TRANSFER_CASES = ["minimal", "bytes", "oversized", "state_root", "state_root_type", "nodes",
                  "node_type", "node_len", "storage_type", "entries", "indices_type",
                  "negative_count", "big_count", "float_count", "bool_count", "negative_index",
                  "bool_index", "total_bytes", "missing", "not_object", "not_json", "bad_utf8"]


def _outcome(tp, case: str):
    try:
        doc = tp.TransferProofJson.from_json_str(_doc(tp, case))
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return ("raise", [c.__name__ for c in type(e).__mro__], str(e))
    doc.validate()
    return ("ok", doc.transfer_count, doc.state_root, doc.storage_proof, doc.indices)


@pytest.mark.parametrize("case", TRANSFER_CASES)
def test_transfer_proof_outcomes_equal_jax(case):
    """Each document (TestTransferProofJson's, and the type checks and
    per-node cap it does not reach): the same proof or the same exception
    class and message from both packages."""
    mine, ref = _outcome(ttp, case), _outcome(jtp, case)
    assert mine == ref
    assert (mine[0] == "ok") == (case in ("minimal", "bytes"))


def test_transfer_proof_surface_equals_jax():
    """The caps, the error class and the document's attributes are the JAX
    package's, and the only parse path is `from_json_str`: no generic
    from_dict / from_json / parse hook."""
    for name in ("MAX_STORAGE_PROOF_NODES", "MAX_STORAGE_PROOF_NODE_HEX_LEN",
                 "MAX_STORAGE_PROOF_HEX_BYTES", "MAX_MERKLE_INDICES", "MAX_STATE_ROOT_HEX_LEN",
                 "MAX_TRANSFER_PROOF_JSON_BYTES"):
        assert getattr(ttp, name) == getattr(jtp, name), name
    assert issubclass(ttp.TransferProofError, ValueError)

    def surface(tp):
        return sorted(a for a in dir(tp.TransferProofJson) if not a.startswith("__"))

    assert surface(ttp) == surface(jtp)
    for hook in ("from_dict", "from_json", "parse"):
        assert not hasattr(ttp.TransferProofJson, hook)
    direct = ttp.TransferProofJson(1, "f" * 65, [], [])
    with pytest.raises(ttp.TransferProofError, match="state_root exceeds 64"):
        direct.validate()


# ---------------------------------------------------------------------------
# tools/circuit_builder_cli.py

CLI_PARSE = [
    ["--output", "/tmp/x", "--num-leaf-proofs", "4"],
    ["--output", "/tmp/x"],
    ["--output", "/tmp/x", "--num-private-batch-proofs", "3", "--include-aggregation",
     "--skip-prover"],
    [],
    ["--num-leaf-proofs", "4"],
    ["--output", "/tmp/x", "--num-leaf-proofs", "four"],
    ["--output", "/tmp/x", "--bogus"],
]


def _parse(cli, argv):
    try:
        args = vars(cli.build_parser().parse_args(argv))
    except SystemExit as e:
        return ("refused", e.code)
    args.pop("device", None)
    return ("accepted", args)


@pytest.mark.parametrize("argv", CLI_PARSE, ids=lambda a: " ".join(a) or "none")
def test_cli_parser_equals_jax(argv, capsys):
    """tests/test_pool_service.py::TestMemprofHelpers::test_cli_definition's
    cases and their neighbours: the same arguments accepted with the same
    values, the same refused."""
    assert _parse(tcli, argv) == _parse(jcli, argv)
    capsys.readouterr()


def test_cli_device_flag_defaults_to_the_card():
    args = tcli.build_parser().parse_args(["--output", "/tmp/x"])
    assert args.device == "cuda"
    assert tcli.build_parser().parse_args(["--output", "/tmp/x", "--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--output", "/tmp/x", "--device", "nowhere"])


@pytest.mark.parametrize("argv", [["--num-leaf-proofs", "0"], ["--num-leaf-proofs", "65"],
                                  ["--num-private-batch-proofs", "0"]])
def test_cli_refuses_out_of_range_counts_like_jax(argv, tmp_path, capsys):
    """Out-of-range proof counts pass the parser and are refused before
    any build, with the JAX package's exit code and error line; nothing is
    written."""
    codes, errors = [], []
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit) as e:
            cli.main(["--output", str(tmp_path / "bins"), *argv])
        codes.append(e.value.code)
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert codes == [2, 2]
    assert errors[0] == errors[1]
    assert not (tmp_path / "bins").exists()


def test_cli_refuses_the_card_without_cuda(tmp_path, capsys):
    """No quiet fall-back to the CPU: `--device cuda` without CUDA stops
    before any build."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(SystemExit) as e:
        tcli.main(["--output", str(tmp_path / "bins"), "--num-leaf-proofs", "2"])
    assert e.value.code == 2 and "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "bins").exists()


# ---------------------------------------------------------------------------
# tools/gate_profiler.py, tools/profile_circuits.py


def test_aggregation_scaling_holds_the_jax_pins():
    """tests/test_profiles.py::test_aggregation_scaling_shape's pins at N = 2
    (the JAX side is not run: its (2, 4) takes 14 s on the CPU)."""
    (row,) = tpc.aggregation_scaling((2,))
    assert row["num_public_inputs"] == 21 * 2 + 8
    assert row["degree_bits"] == 14 and row["gates"] == 1 << 14
    assert row["rows_used"] <= 1 << 14


def test_leaf_profiles_equal_jax(jax_side):
    """`wormhole_circuit_profile` (gate_profiler's `circuit_metrics` of the
    ZK and non-ZK leaf) equals the JAX package's dicts, and holds
    tests/test_profiles.py's pins."""
    mine = tpc.wormhole_circuit_profile()
    assert _json(mine) == jax_side()["profile"]
    assert mine["no_zk"]["degree_bits"] == 8 and mine["zk"]["degree_bits"] == 9
    assert mine["zk"]["num_public_inputs"] == mine["no_zk"]["num_public_inputs"] == 21
    assert mine["zk"]["num_wires"] == 135 and mine["zk"]["num_routed_wires"] == 60


def test_security_tradeoffs_equal_jax(jax_side):
    rows = tpc.security_tradeoffs(GRID)
    assert _json(rows) == jax_side()["security"]
    assert len({r["degree_bits"] for r in rows}) == 1
    for r in rows:
        assert r["security_bits"] == r["num_query_rounds"] * 3 + r["proof_of_work_bits"]


def test_fake_leaf_verifier_data_is_shape_faithful():
    from qp_zk_circuits_tpu_torch.wormhole.leaf_circuit import WormholeCircuit

    fake = tpc.fake_leaf_verifier_data()
    real = WormholeCircuit(wormhole_leaf_circuit_config()).build(shape_only=True)
    assert fake.degree_bits == real.degree_bits
    assert fake.num_selectors == real.num_selectors
    assert fake.num_const_cols == real.const_cols.shape[0]
    assert [g.key() for g in fake.gate_types] == [g.key() for g in real.gate_types]
    assert fake.num_public_inputs == len(real.public_input_targets)
    flat = [int(x) for x in fake.constants_cap.ravel()]
    assert len(set(flat)) == len(flat)


def test_gate_profiler_checkpoints():
    from qp_zk_circuits_tpu_torch.plonk.builder import CircuitBuilder
    from qp_zk_circuits_tpu_torch.tools.gate_profiler import GateProfiler

    b = CircuitBuilder(wormhole_leaf_circuit_config())
    start = b.num_gates()
    prof = GateProfiler(b)
    x, y = b.add_virtual_target(), b.add_virtual_target()
    for _ in range(40):
        x = b.mul(x, y)
    first = prof.checkpoint("forty products")
    assert first == b.num_gates() - start > 0 and prof.checkpoint("nothing") == 0
    assert prof.checkpoints == [("forty products", first), ("nothing", 0)]
    assert prof.report().splitlines()[-1].split() == ["total", str(b.num_gates())]


# ---------------------------------------------------------------------------
# tools/memprof.py


def test_memprof_rebalance_and_refusal_equal_jax(jax_side):
    for rate, pow_bits, rounds in ((3, 16, 28), (4, 16, 21)):
        assert tmemprof.rebalance_query_rounds(rate, pow_bits) == rounds
        assert jmemprof.rebalance_query_rounds(rate, pow_bits) == rounds
    assert tmemprof.SECURITY_FLOOR_BITS == jmemprof.SECURITY_FLOOR_BITS == 100
    # a rate of -1 is the one input the rebalance cannot lift to the floor
    assert tmemprof.main(["--rate-bits", "-1"]) == jax_side()["refusal"] == 2


def test_memprof_cpu_phase_has_a_null_device_peak():
    prof = tmemprof.Profiler("cpu")
    with prof.phase("tiny"):
        sum(range(1000))
    (phase,) = prof.phases
    assert phase.device_peak_mb is None and phase.peak_mb > 0 and phase.wall_secs >= 0
    assert prof.device_peak_mb is None
    rec = tmemprof.json_record(prof, 2, True)
    assert rec["source"] == tmemprof.SOURCE and rec["card"] is None
    assert rec["device_peak_mb"] is None and rec["phases"]["tiny"][2] is None
    assert '"device_peak_mb": null' in json.dumps(rec)
    assert tmemprof.Profiler().device is None
    assert prof.report().splitlines()[2].split()[-1] == "-"


def test_memprof_refuses_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    assert tmemprof.main(["--canonical"]) == 2


# ---------------------------------------------------------------------------
# tools/sweep_shapes.py


def test_estimate_device_mb_equals_jax(jax_side):
    from qp_zk_circuits_tpu_torch.tools.profile_circuits import _leaf_shape

    want = jax_side()["estimate_leaf"]
    assert tsweep.estimate_device_mb(_leaf_shape(wormhole_private_batch_circuit_config())) == \
        want["zk"]
    assert tsweep.estimate_device_mb(_leaf_shape(wormhole_leaf_circuit_config())) == want["no_zk"]


def test_sweep_rows_equal_jax(jax_side):
    """One row of each sweep, at its canonical value on the N = 2 private
    batch (one shape-only build, shared with the scaling's N = 2), equal to
    the JAX package's."""
    want = jax_side()["rows"]
    assert _json(tsweep.sweep_routed_wires((60,))) == [want["routed_wires"]]
    assert _json(tsweep.sweep_num_wires((135,))) == [want["num_wires"]]
    assert _json(tsweep.sweep_qdf((8,))) == [want["qdf"]]
    assert _json(tsweep.sweep_zk_mode((True,))) == [want["zk_mode"]]


def test_sweep_report_shows_no_tpu_figure(tmp_path, monkeypatch):
    """Without an anchor the report says it has none and names no TPU; a
    file that is not the port's memprof line (the TPU's AGG_BENCH.json) is
    refused as an anchor; a memprof line is shown with its card; the
    default path is not the JAX tool's report."""
    assert tsweep.build_parser().get_default("out") == "docs/sweep-results/report_torch.md"
    assert tsweep.DEFAULT_OUT != "docs/sweep-results/report.md"
    canonical = tsweep._pb_shape()
    gadget = {"leaf_config": "x", "num_query_rounds": 28, "security_bits": 100,
              "pb_degree_bits": canonical.degree_bits, "pb_rows_used": canonical.num_rows_used}
    monkeypatch.setattr(tsweep, "gadget_cost_vs_leaf_fri", lambda grid=None: [gadget, gadget])
    monkeypatch.setattr(tsweep, "security_tradeoffs", lambda grid=None: tpc.security_tradeoffs(
        GRID[:1]))
    # every knob value and batch size stands in for the canonical N = 2
    # shape: the report's text in seconds, not the sweep's minutes of builds
    monkeypatch.setattr(tsweep, "_pb_shape", lambda **knobs: canonical)
    monkeypatch.setattr(tsweep, "aggregation_scaling", lambda ns: [
        {"num_leaves": n, "degree_bits": canonical.degree_bits,
         "rows_used": canonical.num_rows_used, "num_public_inputs": 21 * n + 8} for n in ns])
    text = tsweep.generate_report(str(tmp_path / "report.md"))
    assert "No measured anchors" in text and "TPU" not in text
    assert (tmp_path / "report.md").read_text() == text

    with pytest.raises(ValueError, match="not a JSON line of qp_zk_circuits_tpu_torch"):
        tsweep.load_anchor(str(ROOT / "AGG_BENCH.json"))
    prof = tmemprof.Profiler("cpu")
    with prof.phase("commit + prove private batch"):
        pass
    line = tmp_path / "memprof.json"
    line.write_text("table\n" + json.dumps(tmemprof.json_record(prof, 2, True)) + "\n")
    anchor = tsweep.load_anchor(str(line))
    section = "\n".join(tsweep.anchors_section({"run": anchor}))
    assert "Card: none (CPU run)" in section and "null (not a CUDA run)" in section
    assert "TPU" not in section
    anchor["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert "Card: NVIDIA H100 80GB HBM3, 700.00 W." in tsweep.anchors_section({"run": anchor})
