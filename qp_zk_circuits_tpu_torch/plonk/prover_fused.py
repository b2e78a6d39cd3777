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

`prove_fused_batch` is the JAX package's vmapped form (prover_fused.py:973,
`jax.vmap(fused_jit)` at :1007): K proofs of one circuit in one upload and
one download. The K uploads are the rows of one (K, HEAD_WORDS + payload)
block, so each proof's state, grind words and challenge record are views a
row apart; the packed output is part-major, all K wires caps, then all K
zs_pp caps, and so on, so each part is one contiguous (K, ...) block. The
same stages run a stage for all K: a forest a commit and a FRI round with
its caps left on the device, kernels A-F a launch a group of
PROOFS_PER_LAUNCH proofs, kernel I one launch a segment for all K
transcripts (`transcript.DeviceChallengerBatch`) and kernel J one launch
for all K grinds, each stopping at its own witness. The non-ZK batch
uploads only the distinct witness values and the card scatters them into
the (K, num_wires, n) traces; a ZK batch is host-rng (its dense traces and
salts), as the JAX package's batch is. `prove_fused_stream` (:1018)
pipelines chunks of a batch: chunk i's device work is enqueued, chunk i+1
is built and uploaded (the witness work on the host while the card
proves), then chunk i is downloaded and unpacked; two pinned upload slots
alternate, so an upload never overwrites one a copy may still read.

Not here (ROADMAP.md): the fused graph on a mesh (`prove(mesh=)` and
`sharded_prove_batch` stay staged), CUDA-graph capture of the launch
sequence.
"""

from __future__ import annotations

import itertools
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
from ..hash import merkle
from ..hash import poseidon2 as ps
from . import prover as sp
from . import transcript as ts
from .builder import (
    CircuitData,
    PartialWitness,
    flat_input,
    flat_input_batch,
    flat_values,
    flat_values_batch,
    witness_scatter_tables,
)
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

    def views(self, flat, count: int | None = None) -> dict:
        """Each part as a view of `flat` (a device tensor or a host array);
        with `count`, of a batch's part-major output: part p of all `count`
        proofs, one (count, *shape) block after another."""
        if count is None:
            return {name: flat[at : at + int(np.prod(shape))].reshape(shape)
                    for name, shape, at in self.layout}
        return {name: flat[count * at : count * (at + int(np.prod(shape)))].reshape(
            (count,) + shape) for name, shape, at in self.layout}


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
    staging: dict = field(default_factory=dict)  # pinned host buffers by (way, words, slot)

    def pinned(self, way: str, words: int, slot: int = 0) -> torch.Tensor:
        """The circuit's pinned host buffer of `words` int64 for one
        direction of its transfers, made at first use. One at a time: a
        proof's upload is done by its download, which ends in a
        synchronize, before the next proof writes the buffer (two proofs of
        one circuit at once on host threads would need one each). A stream
        alternates two upload `slot`s: chunk i+1 uploads while chunk i's
        copy may still read its own."""
        key = (way, words, slot)
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


def _upload(flat: np.ndarray, b: FusedBundle, slot: int = 0) -> torch.Tensor:
    """The proof's (or batch's) one host->device copy: `flat` as int64 of
    its shape on the bundle's device, through its pinned buffer of `slot`
    (a CPU bundle takes `flat` itself)."""
    src = torch.from_numpy(flat.view(np.int64))
    if b.device.type == "cpu":
        return src
    staging = b.pinned("in", src.numel(), slot)
    staging.copy_(src.reshape(-1))
    return staging.to(b.device, non_blocking=True).view(src.shape)


def _download(out: torch.Tensor, b: FusedBundle) -> np.ndarray:
    """The proof's one device->host copy: the packed output as uint64,
    through the bundle's pinned buffer, after a synchronize of the stream."""
    if out.device.type == "cpu":
        return out.numpy().view(np.uint64)
    host = b.pinned("out", out.numel())
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host.numpy().view(np.uint64).copy()


def _head(data, flat: np.ndarray, pi_hash: np.ndarray) -> None:
    """Write the upload's head into `flat` (HEAD_WORDS + payload,), or each
    row of a batch's (K, HEAD_WORDS + payload): a fresh transcript, kernel
    J's (next, best) = (0, 2^64 - 1) where the circuit grinds, the PI hash
    (4,) or hashes (K, 4) in the challenge record."""
    if data.config.fri_config.proof_of_work_bits:
        flat[..., HEAD_GRIND + 1] = np.uint64(2**64 - 1)  # no witness yet
    flat[..., HEAD_REC + ts.REC_PI : HEAD_REC + ts.REC_PI + 4] = pi_hash


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
    _head(data, flat, ps.hash_no_pad(pis))
    np.concatenate(payload, out=flat[HEAD_WORDS:])
    return flat, pis, key


def _pack_batch(data, pws: list, rng) -> tuple[np.ndarray, np.ndarray]:
    """A batch's upload (K, HEAD_WORDS + payload), a proof a row, and the
    public inputs (K, num_pis): the distinct witness values of a non-ZK
    circuit (`flat_values_batch`, one tape call), or a ZK circuit's dense
    traces and salts drawn in turn from `rng` (`flat_input_batch`, host
    rng: the JAX package's batch draws so)."""
    k = len(pws)
    if data.config.zero_knowledge:
        traces, salts, pis = flat_input_batch(data, pws, rng)
        payload = [traces.reshape(k, -1), salts.reshape(k, -1)]
    else:
        vals, pis = flat_values_batch(data, pws)
        payload = [vals]
    flat = np.zeros((k, HEAD_WORDS + sum(p.shape[1] for p in payload)), dtype=np.uint64)
    _head(data, flat, np.stack([ps.hash_no_pad(p) for p in pis]))
    np.concatenate(payload, axis=1, out=flat[:, HEAD_WORDS:])
    return flat, pis


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


def _prove_on_device_batch(data, b: FusedBundle, up: torch.Tensor):
    """`_prove_on_device` for K proofs from their upload rows `up` (K,
    HEAD_WORDS + payload), in the single proof's stage order, each stage for
    all K: returns the part-major packed output (on the device), each
    proof's oracles and its FRI layers."""
    cfg = data.config
    fcfg = cfg.fri_config
    dev = b.device
    k = up.shape[0]
    nw, n, nc = cfg.num_wires, data.n, cfg.num_challenges
    rate_bits, cap_h = cfg.rate_bits, fcfg.cap_height
    m = n << rate_bits
    rec = up[:, HEAD_REC : HEAD_REC + ts.REC_WORDS]
    out = torch.empty(k * b.packer.size, dtype=torch.int64, device=dev)
    o = b.packer.views(out, k)
    payload = up[:, HEAD_WORDS:]

    # the traces, scattered on the card (or uploaded dense, host-rng ZK)
    if cfg.zero_knowledge:
        traces = payload[:, : nw * n].reshape(k, nw, n)
        salts = [payload[:, nw * n + i * SALT_SIZE * m : nw * n + (i + 1) * SALT_SIZE * m].reshape(
            k, SALT_SIZE, m) for i in range(3)]
    else:
        flat = torch.zeros((k, nw * n), dtype=torch.int64, device=dev)
        flat[:, b.cell_flat] = payload[:, : b.n_slots].index_select(1, b.cell_slot)
        traces = flat.view(k, nw, n)
        salts = [None] * 3

    ch = ts.DeviceChallengerBatch(up[:, HEAD_TS : HEAD_TS + ts.TS_WORDS])

    def commit(values, salt, from_values):
        return fo.commit_batch(values, rate_bits, cap_h, from_values=from_values, salts=salt,
                               host_cap=False)

    def caps(batches):
        return merkle.forest_caps([x.tree for x in batches])

    wires = commit(traces, salts[0], True)
    ch.segment(observe=[(b.digest.expand(k, -1), None), (rec[:, ts.REC_PI : ts.REC_PI + 4], None),
                        (caps(wires), o["wires_cap"].view(k, -1))],
               squeeze=[(rec[:, ts.REC_BETA : ts.REC_BETA + nc], 0),
                        (rec[:, ts.REC_GAMMA : ts.REC_GAMMA + nc], 0)])
    zpp = sp.compute_permutation_polys_batch(data, traces, rec)
    zs_pp = commit(zpp, salts[1], True)
    ch.segment(observe=[(caps(zs_pp), o["zs_pp_cap"].view(k, -1))],
               squeeze=[(rec[:, ts.REC_ALPHA : ts.REC_ALPHA + nc], 0)])
    t_chunks = sp.compute_quotient_batch(data, fo.stacked_lde(wires), fo.stacked_lde(zs_pp), rec)
    quotient = commit(t_chunks, salts[2], False)
    ch.segment(observe=[(caps(quotient), o["quotient_cap"].view(k, -1))],
               squeeze=[(rec[:, ts.REC_ZETA : ts.REC_ZETA + 2], 0)],
               scale=(rec[:, ts.REC_ZETA_NEXT : ts.REC_ZETA_NEXT + 2],
                      int(F.primitive_root_of_unity(data.degree_bits))))

    # openings, into the packed output, absorbed from there
    consts = sp.device_constants(data, dev)
    oracles_k = [[consts, w, z, q] for w, z, q in zip(wires, zs_pp, quotient)]
    nz, _ = zs_pp_layout(cfg)
    fo.eval_openings_batch(oracles_k, rec, next_oracle=2, next_count=nz, out=o["openings"])
    ch.segment(observe=[(o["openings"], None)],
               squeeze=[(rec[:, ts.REC_FRI_ALPHA : ts.REC_FRI_ALPHA + 2], 0)])

    # FRI: the commit phase, the grinds, the queries
    rounds = fri.fri_commit_phase_fused_batch(
        oracles_k, b.polys, o["openings"], rec, ch, fcfg, data.degree_bits,
        [o[f"fri_cap_{r}"].view(k, -1) for r in range(len(b.schedule))], o["final_poly"])
    layers_k = fri.fri_query_phase_fused_batch(
        oracles_k, rounds, ch, fcfg, data.degree_bits, up[:, HEAD_GRIND : HEAD_GRIND + 2],
        o["pow"], o["query_indices"], o["query_rows"])
    return out, oracles_k, layers_k


def _unpack_proof(data, u: dict, b: FusedBundle, pis, oracles, layers) -> Proof:
    """Rebuild the Proof from its parts of the packed output (`_Packer.
    views`, host arrays), checking what the device could not refuse: the
    final polynomial's degree bound and the grind's witness and response."""
    cfg = data.config
    fcfg = cfg.fri_config
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
    proof = _unpack_proof(data, b.packer.views(flat_out), b, pis, oracles, layers)
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


def _unpack_batch(data, flat_out: np.ndarray, b: FusedBundle, pis, oracles_k, layers_k) -> list:
    """Each proof of a batch's part-major packed output: row i of every part."""
    parts = b.packer.views(flat_out, len(oracles_k))
    return [_unpack_proof(data, {name: v[i] for name, v in parts.items()}, b, pis[i], oracles_k[i],
                          layers_k[i]) for i in range(len(oracles_k))]


def _batch_timings(splits: list, flat_in, flat_out, proofs: int, **extra) -> dict:
    """The JAX package's split keys from each chunk's seconds (witness and
    pack, upload, dispatch, execute and fetch, unpack), summed over a
    stream's chunks."""
    pack, up, dispatch, fetch, unpack = (sum(s[i] for s in splits) for i in range(5))
    return {"witness_pack_s": round(pack, 4), "device_roundtrip_s": round(up + dispatch + fetch, 4),
            "upload_s": round(up, 4), "dispatch_s": round(dispatch, 4),
            "execute_fetch_s": round(fetch, 4), "unpack_s": round(unpack, 4),
            "flat_in_mb": round(flat_in.nbytes / 1e6, 1),
            "flat_out_mb": round(flat_out.nbytes / 1e6, 1), "rng_mode": "host",
            "proofs": proofs, **extra}


def prove_fused_batch(data: CircuitData, pws: list, seed: int | None = None) -> list[Proof]:
    """Prove K witnesses of one circuit in one upload and one download (the
    JAX package's `prove_fused_batch`, its fused graph vmapped over the
    proofs): each stage once for all K (`_prove_on_device_batch`). A ZK
    circuit draws host-rng, as the JAX package's batch does, whatever mode
    `warmup` warmed for: one `default_rng(seed)` for the batch, each proof
    in turn drawing its blinding rows and salts, so proof 0 equals the
    single host-rng proof of the seed; a non-ZK proof draws nothing and
    equals the single proof of its witness. `data.__dict__
    ["_last_prove_timings"]` holds the batch's host split under the JAX
    package's keys."""
    sp._check_config(data.config)
    if not pws:
        return []
    b = fused_bundle(data)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    flat, pis = _pack_batch(data, pws, rng)
    t1 = time.perf_counter()
    up = _upload(flat, b)
    t2 = time.perf_counter()
    out, oracles_k, layers_k = _prove_on_device_batch(data, b, up)
    t3 = time.perf_counter()
    flat_out = _download(out, b)
    t4 = time.perf_counter()
    proofs = _unpack_batch(data, flat_out, b, pis, oracles_k, layers_k)
    data.__dict__["_last_prove_timings"] = _batch_timings(
        [(t1 - t0, t2 - t1, t3 - t2, t4 - t3, time.perf_counter() - t4)], flat, flat_out, len(pws))
    return proofs


def prove_fused_stream(data: CircuitData, pws, batch: int, seed: int | None = None,
                       total: int | None = None) -> list[Proof]:
    """Prove an iterable of PartialWitnesses (a list, or a generator that
    fills them on demand) in chunks of `batch` (the JAX package's
    `prove_fused_stream`): chunk i's device work is enqueued, then chunk
    i+1's witnesses are built and uploaded while the card proves chunk i,
    then chunk i is downloaded and unpacked; the uploads alternate two
    pinned slots. The stream's length must tile `batch`: checked against
    `total` (or a list's length) first, else when the last chunk comes up
    short. An exception in the witness source reaches the caller. Proofs
    come back in input order; a ZK stream draws as one batch would
    (`prove_fused_batch`): one `default_rng(seed)`, each proof in turn."""
    sp._check_config(data.config)
    if batch < 1:
        raise ValueError(f"batch {batch}: a chunk holds at least one proof")
    if total is None and hasattr(pws, "__len__"):
        total = len(pws)
    if total is not None:
        assert total % batch == 0, "stream length must tile the batch size"
    b = fused_bundle(data)
    rng = np.random.default_rng(seed)
    it = iter(pws)

    def next_chunk(slot: int):
        """The next chunk packed and uploaded into `slot`, with its pack and
        upload seconds."""
        t0 = time.perf_counter()
        chunk = list(itertools.islice(it, batch))
        if not chunk:
            return None
        assert len(chunk) == batch, "stream length must tile the batch size"
        flat, pis = _pack_batch(data, chunk, rng)
        t1 = time.perf_counter()
        return flat, pis, _upload(flat, b, slot), [t1 - t0, time.perf_counter() - t1]

    proofs: list[Proof] = []
    stages = []
    ready, slot = next_chunk(0), 0
    while ready is not None:
        flat, pis, up, split = ready
        t = time.perf_counter()
        out, oracles_k, layers_k = _prove_on_device_batch(data, b, up)
        split.append(time.perf_counter() - t)
        slot ^= 1
        ready = next_chunk(slot)  # the host's work while the card proves this chunk
        t = time.perf_counter()
        flat_out = _download(out, b)
        split.append(time.perf_counter() - t)
        t = time.perf_counter()
        proofs += _unpack_batch(data, flat_out, b, pis, oracles_k, layers_k)
        split.append(time.perf_counter() - t)
        stages.append(split)
    if stages:
        data.__dict__["_last_prove_timings"] = _batch_timings(
            stages, flat, flat_out, len(proofs), chunks=len(stages),
            chunk_s=[[round(x, 4) for x in split] for split in stages])
    return proofs
