"""The fused prover: a whole proof with one upload and one download.

The counterpart of the JAX package's plonk/prover_fused.py (its single-proof
path, `prove_fused`, the JAX package's default prover for circuits of
degree 2^11 and below and for every circuit `warmup_fused` has warmed;
plonk/prover.py::prove dispatches alike). There the post-witness pipeline
is one XLA graph; here it is the same kernels as the staged prover, in the
same order on one CUDA stream, with nothing read back to the host in
between:

  1. the distinct witness values (or, for a host-rng ZK proof, the dense
     trace and the salts) and a fresh transcript go up in ONE host->device
     copy (`_upload`), the public-input hash in its challenge record;
  2. the trace is scattered on the card from `witness_scatter_tables`
     (index_select / index_put_), kernel G drawing the blinding rows and
     salts in device-rng mode;
  3. the three commits (kernels 3 and 2), kernel B and kernel A, each commit
     followed by a kernel-I segment (csrc/transcript.cu) that observes its
     cap straight from the tree's buffer and writes the betas, gammas,
     alphas and zeta into the proof's challenge record, where kernels A-E
     read them (plonk/transcript.py REC_*);
  4. kernel D writes the openings into the packed output, kernel I absorbs
     them there;
  5. FRI's commit phase (fri/prover.py::fri_commit_phase_fused): kernel C,
     each round's tree, cap absorbed and beta drawn on the card, kernel E's
     fold, the final iNTT into the packed output, absorbed there;
  6. its query phase (fri_query_phase_fused): kernel J grinds from the
     transcript's state; kernel I observes the witness and draws the 28
     query indices;
  7. kernel F gathers every query's rows and paths by those indices into
     the packed output;
  8. the packed output comes back in ONE device->host copy (`_download`),
     and `_unpack_proof` builds the `Proof`, checking the final
     polynomial's degree and the grind's witness there.

The proof's bytes equal the staged prover's (and the JAX package's, ZK in
host-rng mode); a device-rng proof draws kernel G's streams as the staged
device-rng proof does, so the two are equal too. On a CPU circuit every
kernel's plain version runs instead, the same schedule.

Not here (ROADMAP.md): the batch and stream forms (`prove_batch` and
`prove_stream` stay staged), the fused graph on a mesh (`prove(mesh=)`
stays staged), CUDA-graph capture of the launch sequence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..field import gf_np as F
from ..field import goldilocks as gl
from ..field import random as frandom
from ..fri import oracle as fo
from ..fri import prover as fri
from ..fri.config import SALT_SIZE
from ..fri.prover import FriProof
from ..hash import poseidon2 as ps
from . import prover as sp
from . import transcript as ts
from .builder import CircuitData, PartialWitness, flat_input, flat_values, witness_scatter_tables
from .proof import Proof, fri_instance, zs_pp_layout

#: the upload's head: the transcript state, kernel J's two words, and the
#: challenge record, before the witness payload
HEAD_TS = 0
HEAD_GRIND = ts.TS_WORDS
HEAD_REC = HEAD_GRIND + 4
HEAD_WORDS = HEAD_REC + ts.REC_WORDS


class _Packer:
    """The packed output's layout: named (shape) parts one after another."""

    def __init__(self):
        self.layout: list[tuple[str, tuple, int]] = []
        self.size = 0

    def add(self, name: str, shape: tuple) -> None:
        self.layout.append((name, tuple(shape), self.size))
        self.size += int(np.prod(shape))

    def views(self, flat) -> dict:
        """Each part as a view of `flat` (a device tensor or a host array)."""
        return {name: flat[at : at + int(np.prod(shape))].reshape(shape)
                for name, shape, at in self.layout}


class _Unpacker:
    def __init__(self, flat_u64: np.ndarray, packer: _Packer):
        self.by_name = packer.views(flat_u64)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.by_name[name]


@dataclass
class FusedBundle:
    """What a circuit's fused proofs share, made once on its device (the
    JAX package's `_build_fused` bundle, prover_fused.py:441-476): the
    preprocessing oracle and kernel A's and B's tables (`prover.py`'s
    caches), the circuit digest, the scatter tables, the FRI schedule and
    the packed output's layout."""

    device: torch.device
    digest: torch.Tensor
    cell_flat: torch.Tensor
    cell_slot: torch.Tensor
    n_slots: int
    polys: tuple
    schedule: tuple
    packer: _Packer
    staging: dict = field(default_factory=dict)  # pinned host buffers by (way, words)

    def pinned(self, way: str, words: int) -> torch.Tensor:
        """The circuit's pinned host buffer of `words` int64 for one
        direction of its transfers, made at first use. One at a time: a
        proof's upload is done by its download, which ends in a
        synchronize, before the next proof writes the buffer (two proofs of
        one circuit at once on host threads would need one each)."""
        key = (way, words)
        if key not in self.staging:
            self.staging[key] = torch.empty(words, dtype=torch.int64, pin_memory=True)
        return self.staging[key]


def _cap_height(cap_h: int, log_rows: int) -> int:
    return min(cap_h, log_rows)


def fused_bundle(data: CircuitData) -> FusedBundle:
    """The circuit's bundle, built at its first fused proof or by
    `prover.warmup` (which makes `prove` take the fused path for any
    degree)."""
    bundle = data.__dict__.get("_torch_fused")
    if bundle is not None:
        return bundle
    cfg = data.config
    fcfg = cfg.fri_config
    sp._check_config(cfg)
    dev = torch.device(data.device)
    consts = sp.device_constants(data, dev)
    sp._quotient_tables(data, dev)
    sp._routing_tables(data, dev)
    _, _, cell_flat, cell_slot = witness_scatter_tables(data)
    schedule = tuple(fcfg.reduction_strategy.schedule(data.degree_bits))
    if len(schedule) > ts.MAX_FRI_ROUNDS:
        raise ValueError(f"{len(schedule)} FRI rounds: a challenge record holds "
                         f"{ts.MAX_FRI_ROUNDS} betas")
    nz, npp_total = zs_pp_layout(cfg)
    nq = cfg.num_challenges * cfg.max_quotient_degree_factor
    salt = SALT_SIZE if cfg.zero_knowledge else 0
    lde_bits = data.degree_bits + cfg.rate_bits
    cap_h = fcfg.cap_height
    oracle_rows = [consts.lde.shape[0], cfg.num_wires + salt, nz + npp_total + salt, nq + salt]
    width = sum(oracle_rows) + 4 * len(oracle_rows) * (lde_bits - _cap_height(cap_h, lde_bits))
    pk = _Packer()
    for name in ("wires_cap", "zs_pp_cap", "quotient_cap"):
        pk.add(name, (1 << _cap_height(cap_h, lde_bits), 4))
    pk.add("openings", (consts.coeffs.shape[0] + cfg.num_wires + nz + npp_total + nq + nz, 2))
    log_m = lde_bits
    for r, a_bits in enumerate(schedule):
        h = _cap_height(cap_h, log_m - a_bits)
        pk.add(f"fri_cap_{r}", (1 << h, 4))
        width += (2 << a_bits) + 4 * (log_m - a_bits - h)
        log_m -= a_bits
    pk.add("final_poly", (2, 1 << log_m))
    pk.add("pow", (2,))
    pk.add("query_indices", (fcfg.num_query_rounds,))
    pk.add("query_rows", (fcfg.num_query_rounds, width))
    bundle = FusedBundle(
        device=dev,
        digest=gl.from_u64(np.asarray(data.circuit_digest, dtype=np.uint64), dev),
        cell_flat=torch.as_tensor(cell_flat.astype(np.int64), device=dev),
        cell_slot=torch.as_tensor(cell_slot.astype(np.int64), device=dev),
        n_slots=len(witness_scatter_tables(data)[0]),
        polys=tuple(b.polys for b in fri_instance(data, (0, 0), (0, 0)).batches),
        schedule=schedule, packer=pk)
    data.__dict__["_torch_fused"] = bundle
    return bundle


def _upload(flat: np.ndarray, b: FusedBundle) -> torch.Tensor:
    """The proof's one host->device copy: `flat` as int64 on the bundle's
    device, through its pinned buffer (a CPU bundle takes `flat` itself)."""
    src = torch.from_numpy(flat.view(np.int64))
    if b.device.type == "cpu":
        return src
    staging = b.pinned("in", src.numel())
    staging.copy_(src)
    return staging.to(b.device, non_blocking=True)


def _download(out: torch.Tensor, b: FusedBundle) -> np.ndarray:
    """The proof's one device->host copy: the packed output as uint64,
    through the bundle's pinned buffer, after a synchronize of the stream."""
    if out.device.type == "cpu":
        return out.numpy().view(np.uint64)
    host = b.pinned("out", out.numel())
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host.numpy().view(np.uint64).copy()


def _pack_input(data, pw, rng, device_rng: bool) -> tuple[np.ndarray, np.ndarray, int | None]:
    """The upload (head and payload), the public inputs, and the device
    key of a device-rng proof."""
    cfg = data.config
    key = None
    if cfg.zero_knowledge and not device_rng:
        trace, salts, pis = flat_input(data, pw, rng)
        payload = [trace.ravel(), salts.ravel()]
    else:
        vals, pis = flat_values(data, pw)
        payload = [vals]
        if cfg.zero_knowledge:
            key = int(rng.integers(0, 2**63))
    flat = np.zeros(HEAD_WORDS + sum(p.size for p in payload), dtype=np.uint64)
    if cfg.fri_config.proof_of_work_bits:
        flat[HEAD_GRIND + 1] = np.uint64(2**64 - 1)  # no witness yet
    flat[HEAD_REC + ts.REC_PI : HEAD_REC + ts.REC_PI + 4] = ps.hash_no_pad(pis)
    np.concatenate(payload, out=flat[HEAD_WORDS:])
    return flat, pis, key


def _prove_on_device(data, b: FusedBundle, up: torch.Tensor, key: int | None):
    """Every device step of a proof from its upload `up`: returns the packed
    output (on the device) and what unpacking needs (the oracles and the FRI
    layers, for the query rows' widths)."""
    cfg = data.config
    fcfg = cfg.fri_config
    dev = b.device
    nw, n, nc = cfg.num_wires, data.n, cfg.num_challenges
    rate_bits, cap_h = cfg.rate_bits, fcfg.cap_height
    m = n << rate_bits
    rec = up[HEAD_REC : HEAD_REC + ts.REC_WORDS]
    out = torch.empty(b.packer.size, dtype=torch.int64, device=dev)
    o = b.packer.views(out)
    payload = up[HEAD_WORDS:]

    # the trace, scattered on the card (or uploaded dense, host-rng ZK)
    if cfg.zero_knowledge and key is None:
        trace = payload[: nw * n].view(nw, n)
        salts = list(payload[nw * n :].view(3, SALT_SIZE, m))
    else:
        flat = torch.zeros(nw * n, dtype=torch.int64, device=dev)
        flat.index_put_((b.cell_flat,), payload[: b.n_slots].index_select(0, b.cell_slot))
        trace = flat.view(nw, n)
        salts = [None] * 3
        if key is not None:
            frandom.rand_felts(key, 0, trace[:, data.num_rows_used :])
            salts = [frandom.Draw(key, 1 + i) for i in range(3)]

    ch = ts.DeviceChallenger(up[HEAD_TS : HEAD_TS + ts.TS_WORDS])

    def commit(values, salt, from_values):
        return fo.commit(values, rate_bits, cap_h, from_values=from_values, salt=salt,
                         host_cap=False)

    wires_o = commit(trace, salts[0], True)
    ch.segment(observe=[(b.digest, None), (rec[ts.REC_PI : ts.REC_PI + 4], None),
                        (wires_o.tree.digests[-1], o["wires_cap"].view(-1))],
               squeeze=[(rec[ts.REC_BETA : ts.REC_BETA + nc], 0),
                        (rec[ts.REC_GAMMA : ts.REC_GAMMA + nc], 0)])
    zpp = sp.compute_permutation_polys(data, trace, rec)
    zs_pp_o = commit(zpp, salts[1], True)
    ch.segment(observe=[(zs_pp_o.tree.digests[-1], o["zs_pp_cap"].view(-1))],
               squeeze=[(rec[ts.REC_ALPHA : ts.REC_ALPHA + nc], 0)])
    t_chunks = sp.compute_quotient(data, wires_o.poly_lde, zs_pp_o.poly_lde, rec)
    quotient_o = commit(t_chunks, salts[2], False)
    ch.segment(observe=[(quotient_o.tree.digests[-1], o["quotient_cap"].view(-1))],
               squeeze=[(rec[ts.REC_ZETA : ts.REC_ZETA + 2], 0)],
               scale=(rec[ts.REC_ZETA_NEXT : ts.REC_ZETA_NEXT + 2],
                      int(F.primitive_root_of_unity(data.degree_bits))))

    # openings, into the packed output, absorbed from there
    oracles = [sp.device_constants(data, dev), wires_o, zs_pp_o, quotient_o]
    nz, _ = zs_pp_layout(cfg)
    fo.eval_openings(oracles, rec, next_oracle=2, next_count=nz, out=o["openings"])
    ch.segment(observe=[(o["openings"], None)],
               squeeze=[(rec[ts.REC_FRI_ALPHA : ts.REC_FRI_ALPHA + 2], 0)])

    # FRI: the commit phase, the grind, the queries
    layers = fri.fri_commit_phase_fused(
        oracles, b.polys, o["openings"], rec, ch, fcfg, data.degree_bits,
        [o[f"fri_cap_{r}"] for r in range(len(b.schedule))], o["final_poly"])
    fri.fri_query_phase_fused(oracles, layers, ch, fcfg, data.degree_bits,
                              up[HEAD_GRIND : HEAD_GRIND + 2], o["pow"], o["query_indices"],
                              o["query_rows"])
    return out, oracles, layers


def _unpack_proof(data, flat_out: np.ndarray, b: FusedBundle, pis, oracles, layers) -> Proof:
    """Rebuild the Proof from the packed output, checking what the device
    could not refuse: the final polynomial's degree bound and the grind's
    witness and response."""
    cfg = data.config
    fcfg = cfg.fri_config
    u = _Unpacker(flat_out, b.packer)
    pow_bits = fcfg.proof_of_work_bits
    witness, response = u["pow"]
    if pow_bits and witness == np.uint64(2**64 - 1):
        raise RuntimeError(f"the PoW grind found no witness below {ts.grind_limit(pow_bits)}")
    if int(response) >= 1 << (64 - pow_bits):
        raise AssertionError("PoW response above the grind threshold")
    final_poly = fri._final_poly(np.ascontiguousarray(u["final_poly"].T), fcfg, data.degree_bits)
    nz, _ = zs_pp_layout(cfg)
    parts, zs_next = fo.split_openings(u["openings"], oracles, nz)
    fri_proof = FriProof(
        commit_caps=[u[f"fri_cap_{r}"] for r in range(len(b.schedule))],
        final_poly=final_poly, pow_witness=np.uint64(witness),
        query_rounds=fri._query_rounds(u["query_rows"], oracles, layers))
    return Proof(wires_cap=u["wires_cap"], zs_pp_cap=u["zs_pp_cap"],
                 quotient_cap=u["quotient_cap"], openings=sp._opening_set(data, parts, zs_next),
                 fri_proof=fri_proof, public_inputs=pis)


def prove_fused(data: CircuitData, pw: PartialWitness, seed: int | None = None,
                rng_mode: str = "auto") -> Proof:
    """Prove with one upload and one download (the JAX package's
    `prove_fused`). A ZK circuit draws from `np.random.default_rng(seed)`:
    in "host" mode the blinding rows and salts (`builder.flat_input`, the
    staged prover's draws, so the same bytes); in "device" mode one key,
    from which kernel G draws them on the card (the staged device-rng
    proof's streams, so its bytes); "auto" is the mode `warmup` warmed for,
    else "host". `data.__dict__["_last_prove_timings"]` holds the proof's
    host split under the JAX package's keys."""
    if rng_mode not in sp.RNG_MODES:
        raise ValueError(f"rng_mode {rng_mode!r}, expected one of {sp.RNG_MODES}")
    cfg = data.config
    device_rng = cfg.zero_knowledge and sp.warm_rng_mode(data, rng_mode) == "device"
    b = fused_bundle(data)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    flat, pis, key = _pack_input(data, pw, rng, device_rng)
    t1 = time.perf_counter()
    up = _upload(flat, b)
    t2 = time.perf_counter()
    out, oracles, layers = _prove_on_device(data, b, up, key)
    t3 = time.perf_counter()
    flat_out = _download(out, b)
    t4 = time.perf_counter()
    proof = _unpack_proof(data, flat_out, b, pis, oracles, layers)
    data.__dict__["_last_prove_timings"] = {
        "witness_pack_s": round(t1 - t0, 4),
        "device_roundtrip_s": round(t4 - t1, 4),
        "upload_s": round(t2 - t1, 4),
        "dispatch_s": round(t3 - t2, 4),
        "execute_fetch_s": round(t4 - t3, 4),
        "unpack_s": round(time.perf_counter() - t4, 4),
        "flat_in_mb": round(flat.nbytes / 1e6, 1),
        "flat_out_mb": round(flat_out.nbytes / 1e6, 1),
        "rng_mode": "device" if device_rng else "host",
    }
    return proof
