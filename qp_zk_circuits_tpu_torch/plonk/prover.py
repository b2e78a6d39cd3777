"""PLONK prover: trace -> commitments -> permutation argument -> quotient -> FRI.

`prove` dispatches as the JAX package's does: the fused prover
(plonk/prover_fused.py: one upload, the transcript and the grind on the
card, one download) at degree_bits <= FUSED_DEGREE_BITS_MAX or once
`warmup_fused` has run, else `prove_staged`. Below: the staged order of the
JAX package's `plonk/prover.py::prove_staged`, step
for step, with the device work on the port's kernels: field elementwise,
Poseidon2, NTT, and the fused kernels A (the quotient's vanishing
evaluation, csrc/quotient.cu) and B (the permutation argument,
csrc/permutation.cu):

  * trace interpolation, LDEs, Merkle levels, the permutation argument, the
    constraint/quotient evaluation, openings and the FRI folds run on the
    device of the circuit's preprocessing oracle;
  * witness generation, the Fiat-Shamir transcript (between launches),
    host tables of domain points and proof assembly stay on the host; the
    kernels read the challenges from a record on the device (`host_records`,
    one upload a kernel), the one form of each wrapper, which the fused
    prover's transcript fills on the card.

For non-ZK circuits the proof bytes equal the JAX package's `prove` (and its
staged and fused provers, which are pinned equal to each other). For ZK
circuits (row blinding and salted oracles) they do too in host-rng mode, for
the same seed, in the single proof, the batch and the stream; device-rng
proofs draw the blinding rows and salts with kernel G (field/random.py) and
are valid, not byte-equal.

`verify_vanishing_at_zeta` is the verifier's host check of the same
constraint list at zeta (`vanishing.py::eval_constraints` in `HostExtAlg`),
so prover and verifier share one constraint evaluation.
"""

from __future__ import annotations

import functools
import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import _cuda
from .. import native as nat
from ..field import extension as ext
from ..field import gf_np as F
from ..field import goldilocks as gl
from ..field import random as frandom
from ..fri import oracle as fo
from ..fri.prover import fri_commit_phase_batch, fri_prove, fri_query_phase_batch
from ..hash import merkle
from ..hash import poseidon2 as ps
from ..parallel import tp
from ..poly import ntt
from . import constraint_tape
from . import transcript as ts
from .builder import (
    CircuitData,
    PartialWitness,
    coset_shifts,
    generate_witness_batch,
    witness_root_values,
    witness_trace,
    zk_draws,
)
from .gates import (
    GATE_TYPE_IDS,
    PERMUTATION_TYPE_ID,
    DeviceBatchCtx,
    HostExtCtx,
    Poseidon2Gate,
    gate_descriptor,
)
from .proof import OpeningSet, Proof, fri_instance, zs_pp_layout
from .vanishing import HostExtAlg, eval_constraints, num_partial_products, permutation_chunks


#: kernel A keeps one accumulator a challenge in registers; both kernels
#: read their challenges from a record on the card (transcript.REC_*)
MAX_CHALLENGES = 4
#: kernels A and B take at most this many proofs a launch (as C-F do)
PROOFS_PER_LAUNCH = _cuda.PROOFS_PER_LAUNCH
#: kernel B keeps a row's chunk products in registers
MAX_CHUNKS = 16
#: kernel B's rows a block (csrc/permutation.cu TILE): one Fermat inverse a
#: tile and challenge, and a second launch above one tile
PERMUTATION_TILE = 256
#: kernel B's second launch multiplies, in each tile's block, the products of
#: the tiles before it: its work grows as (n / PERMUTATION_TILE)^2, and at
#: 2^20 rows it is still a few percent of the first launch's
MAX_PERMUTATION_ROWS = 1 << 20
#: a kernel-A descriptor row: type, p0, p1, p2, selector row, first
#: constraint index, threads a point, first block
DESC_WIDTH = 8
#: kernel A's threads a block (csrc/quotient.cu THREADS)
QUOTIENT_THREADS = 128
#: kernel A's threads a point by group type: the Poseidon2 gate's lane-split
#: form takes a quad (it needs four), a permutation row spreads its chunks
#: over four; the other gate types take one
QUOTIENT_LANES = {GATE_TYPE_IDS[Poseidon2Gate]: 4, PERMUTATION_TYPE_ID: 4}
#: kernel A's blocks a group at most: past it a block loops over tiles of
#: points, so it forms its alpha-power table once for many tiles
QUOTIENT_GROUP_BLOCKS = 1024


def _prefix_prod_inclusive(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix field product along dim 0 (log-doubling)."""
    out = a
    shift = 1
    n = out.shape[0]
    while shift < n:
        out = torch.cat([out[:shift], gl.mul(out[shift:], out[:-shift])])
        shift *= 2
    return out


def _group_blocks(lanes: int, m: int) -> int:
    """Kernel A's blocks for a group of `lanes` threads a point over m points."""
    return min(-(-m * lanes // QUOTIENT_THREADS), QUOTIENT_GROUP_BLOCKS)


def quotient_descriptors(data: CircuitData) -> tuple[np.ndarray, int]:
    """Kernel A's descriptor table (G, DESC_WIDTH) int32 and the total
    constraint count K. One row per gate type (its constraints are masked by
    selector row nconst + s), then one row per challenge for its boundary and
    permutation transitions; column 5 is the row's first index in the
    canonical constraint list of `vanishing.eval_constraints`, column 6 its
    threads a point (QUOTIENT_LANES) and column 7 its first block."""
    cfg = data.config
    m = data.n << cfg.rate_bits
    nconst = data.const_cols.shape[0]
    nchunks = len(permutation_chunks(cfg.num_routed_wires, cfg.max_quotient_degree_factor))
    # (type, p0, p1, p2, selector row, constraint count) a group
    groups = [(*gate_descriptor(gate), nconst + s, gate.num_constraints)
              for s, gate in enumerate(data.gate_types)]
    groups += [(PERMUTATION_TYPE_ID, c, 0, 0, -1, 1 + nchunks) for c in range(cfg.num_challenges)]
    rows, k, block = [], 0, 0
    for *head, count in groups:
        lanes = QUOTIENT_LANES.get(head[0], 1)
        rows.append([*head, k, lanes, block])
        k += count
        block += _group_blocks(lanes, m)
    return np.array(rows, dtype=np.int32).reshape(-1, DESC_WIDTH), k


def _cached(data: CircuitData, dev, key: str, make) -> dict:
    """make(dev) once per circuit and device, kept on the circuit data."""
    dev = torch.device(dev)
    per_device = data.__dict__.setdefault(key, {})
    if dev not in per_device:
        per_device[dev] = make(dev)
    return per_device[dev]


def device_constants(data: CircuitData, dev) -> fo.PolynomialBatch:
    """The circuit's preprocessing oracle on device `dev`: the one committed
    at build time on its own device, a copy (coefficients, LDE, tree) on any
    other, made once (a data-parallel shard proves on its own card)."""
    home = data.constants_oracle
    dev = torch.device(dev)
    if dev.type == home.lde.device.type and dev.index in (None, home.lde.device.index):
        return home

    def copy(d):
        tree = home.tree
        digests = torch.cat(tree.digests).to(d).split([lvl.shape[0] for lvl in tree.digests])
        return fo.PolynomialBatch(
            coeffs=home.coeffs.to(d), lde=home.lde.to(d),
            tree=merkle.MerkleTree(digests=list(digests), cap=tree.cap,
                                   cap_height=tree.cap_height),
            degree_bits=home.degree_bits, rate_bits=home.rate_bits, blinding=home.blinding)

    return _cached(data, dev, "_torch_constants", copy)


def _routing_tables(data: CircuitData, dev) -> dict:
    """Kernel B's per-circuit tables on device `dev`."""
    return _cached(data, dev, "_torch_routing", lambda d: {
        "id_coords": gl.from_u64(data.id_coords, d),
        "sigma_vals": gl.from_u64(data.sigma_vals, d),
    })


def _quotient_tables(data: CircuitData, dev) -> dict:
    """Kernel A's per-circuit tables on device `dev`."""
    return _cached(data, dev, "_torch_tables", lambda d: _build_quotient_tables(data, d))


def _build_quotient_tables(data: CircuitData, dev) -> dict:
    cfg = data.config
    m = data.n << cfg.rate_bits
    xs = F.mul(
        F.powers_table(F.primitive_root_of_unity(data.degree_bits + cfg.rate_bits), m),
        F.MULTIPLICATIVE_GROUP_GENERATOR,
    )
    l1, inv_zh = _l1_and_inv_zh(data, xs)
    desc, k_total = quotient_descriptors(data)
    counts = np.diff(np.append(desc[:, 5], k_total))
    return {
        "xs": gl.from_u64(xs, dev),
        "l1": gl.from_u64(l1, dev),
        "inv_zh": gl.from_u64(inv_zh, dev),
        "ks": gl.from_u64(np.asarray(coset_shifts(cfg.num_routed_wires), dtype=np.uint64), dev),
        "desc": torch.as_tensor(desc, device=dev),
        "num_constraints": k_total,
        "blocks": int(desc[-1, 7]) + _group_blocks(int(desc[-1, 6]), m),
        "max_count": int(counts.max()),
    }


def _l1_and_inv_zh(data: CircuitData, xs: np.ndarray):
    """L_1(x) = (x^n - 1) / (n (x - 1)) and 1/Z_H(x) over the LDE coset."""
    n = data.n
    xn = F.pow_scalar(xs, n)
    zh = F.sub(xn, np.uint64(1))
    inv_zh = F.inv(zh)
    denom = F.mul(np.uint64(n), F.sub(xs, np.uint64(1)))
    l1 = F.mul(zh, F.inv(denom))
    return l1, inv_zh


@functools.cache
def _kernel_lib(index: int | None):
    """The kernel library with kernel A's Poseidon2 constants uploaded to CUDA
    device `index`: `__constant__` memory is per device, so each device gets
    its own upload."""
    lib = _cuda.lib()
    ext_rcs, int_rcs, diag = (
        np.ascontiguousarray(a, dtype=np.uint64)
        for a in (ps.external_round_constants(), ps.internal_round_constants(), ps.internal_diag())
    )
    with _cuda.on_device(torch.device("cuda", index)):
        err = lib.qzk_quotient_set_constants(
            ext_rcs.ctypes.data, int_rcs.ctypes.data, diag.ctypes.data
        )
    _cuda.check(err, "qzk_quotient_set_constants")
    return lib


# ---------------------------------------------------------------------------
# the permutation argument (kernel B)


def _permutation_limits(data: CircuitData, trace: torch.Tensor) -> None:
    cfg = data.config
    nchunks = len(permutation_chunks(cfg.num_routed_wires, cfg.max_quotient_degree_factor))
    if trace.dim() != 2 or trace.shape[0] < cfg.num_routed_wires or trace.shape[1] != data.n:
        raise ValueError(f"trace {tuple(trace.shape)} does not fit the circuit")
    if data.n > MAX_PERMUTATION_ROWS:
        raise ValueError(f"{data.n} rows: kernel B takes at most {MAX_PERMUTATION_ROWS}")
    if not 1 <= cfg.num_challenges <= MAX_CHALLENGES or nchunks > MAX_CHUNKS:
        raise ValueError(
            f"{cfg.num_challenges} challenges and {nchunks} permutation chunks: "
            f"kernel B takes at most {MAX_CHALLENGES} and {MAX_CHUNKS}"
        )


def host_records(dev, count: int, nc: int, **named) -> torch.Tensor:
    """`count` challenge records (count, REC_WORDS) on `dev` in one copy
    (transcript.challenge_records) from host values by kind: alphas, betas,
    gammas (count, nc) and pis (count, 4). The staged prover's records, and
    the batch wrappers'."""
    slots = {"alphas": (ts.REC_ALPHA, nc), "betas": (ts.REC_BETA, nc),
             "gammas": (ts.REC_GAMMA, nc), "pis": (ts.REC_PI, 4)}
    return ts.challenge_records(dev, count, {
        slots[k][0]: _host_felts(v, slots[k][1]).reshape(count, -1) for k, v in named.items()})


def compute_permutation_polys_plain(data: CircuitData, trace: torch.Tensor, rec: torch.Tensor):
    """Plain torch version of `compute_permutation_polys` (same arguments)."""
    _permutation_limits(data, trace)
    cfg = data.config
    nr = cfg.num_routed_wires
    qdf = cfg.max_quotient_degree_factor
    chunks = permutation_chunks(nr, qdf)
    npp = num_partial_products(nr, qdf)
    dev = trace.device
    tab = _routing_tables(data, dev)
    wires = trace[:nr]  # (nr, n)
    zs, pps = [], []
    for c in range(cfg.num_challenges):
        beta, gamma = rec[ts.REC_BETA + c], rec[ts.REC_GAMMA + c]
        num = gl.add(gl.add(wires, gl.mul(beta, tab["id_coords"])), gamma)
        den = gl.add(gl.add(wires, gl.mul(beta, tab["sigma_vals"])), gamma)
        cn = torch.stack([gl.prod_tree(num[ch[0] : ch[-1] + 1], 0) for ch in chunks])
        cd = torch.stack([gl.prod_tree(den[ch[0] : ch[-1] + 1], 0) for ch in chunks])
        ratios = gl.mul(cn, gl.inv(cd))  # (nchunks, n)
        z_incl = _prefix_prod_inclusive(gl.prod_tree(ratios, 0))
        z = torch.cat([torch.ones(1, dtype=torch.int64, device=dev), z_incl[:-1]])
        zs.append(z)
        # pp_j = Z * prod_{t<=j} ratios_t  for j < npp
        run = z
        for j in range(npp):
            run = gl.mul(run, ratios[j])
            pps.append(run)
    return torch.stack(zs + pps)


def compute_permutation_polys(data: CircuitData, trace: torch.Tensor, rec: torch.Tensor):
    """Z and partial-product columns per challenge -> (num_cols, n) on the
    trace's device: [Z_0, Z_1, ..., pp_0_*, pp_1_*, ...], the betas and
    gammas read from the challenge record `rec` (REC_WORDS,) on the trace's
    device (the fused prover's transcript writes them there, the staged
    prover uploads its host values: `host_records`).

    On a CUDA trace: kernel B (csrc/permutation.cu), one launch up to
    PERMUTATION_TILE rows and two above. On a CPU trace: the plain version.
    n is at most MAX_PERMUTATION_ROWS on every device."""
    _permutation_limits(data, trace)
    if trace.device.type == "cpu":
        return compute_permutation_polys_plain(data, trace, rec)
    _cuda.require_cuda_int64(trace, rec)
    return _launch_permutation(data, trace, rec)


def _launch_permutation(data: CircuitData, trace: torch.Tensor, rec: torch.Tensor):
    out, launches = _permutation_rec_launches(data, trace.unsqueeze(0), rec.unsqueeze(0))
    compute_permutation_polys.launches += launches
    return out[0]


def compute_permutation_polys_batch_plain(data: CircuitData, traces: torch.Tensor,
                                          rec: torch.Tensor):
    """Plain torch version of `compute_permutation_polys_batch` (same
    arguments): `compute_permutation_polys_plain` a proof, stacked."""
    _batch_limits(traces, rec)
    return torch.stack([compute_permutation_polys_plain(data, t, r) for t, r in zip(traces, rec)])


def compute_permutation_polys_batch(data: CircuitData, traces: torch.Tensor, rec: torch.Tensor):
    """`compute_permutation_polys` for K proofs of the circuit: traces (K,
    num_wires, n), proof i's betas and gammas in record rec[i] of rec (K,
    REC_WORDS) on the traces' device, the rows any stride apart (the fused
    batch's transcripts write them there; the staged batch uploads its host
    values, `host_records`) -> (K, num_cols, n).

    On CUDA traces: kernel B with a proof axis, at most PROOFS_PER_LAUNCH
    proofs a call (each a launch up to PERMUTATION_TILE rows, two above); the
    routing tables are the circuit's, read by every proof. On CPU traces:
    the plain version."""
    _batch_limits(traces, rec)
    _permutation_limits(data, traces[0])
    if traces.device.type == "cpu":
        return compute_permutation_polys_batch_plain(data, traces, rec)
    _cuda.require_cuda_int64(traces, rec)
    out, launches = _permutation_rec_launches(data, traces, rec)
    compute_permutation_polys_batch.launches += launches
    return out


def _batch_limits(stack: torch.Tensor, *per_proof) -> None:
    if stack.dim() != 3 or stack.shape[0] < 1:
        raise ValueError(f"a batch takes a (K, rows, n) stack, got {tuple(stack.shape)}")
    if any(len(v) != stack.shape[0] for v in per_proof):
        raise ValueError(f"{stack.shape[0]} proofs and challenge sets of other lengths")


_groups = _cuda.proof_groups


def _permutation_rec_launches(data: CircuitData, traces: torch.Tensor, rec: torch.Tensor):
    """Kernel B over the (K, num_wires, n) traces, proof i's challenges in
    record rec[i] on the device: (out (K, num_cols, n), launches)."""
    cfg = data.config
    nr, nc = cfg.num_routed_wires, cfg.num_challenges
    npp = num_partial_products(nr, cfg.max_quotient_degree_factor)
    k, dev = traces.shape[0], traces.device
    tab = _routing_tables(data, dev)
    traces = traces.contiguous()
    out = torch.empty((k, nc + nc * npp, data.n), dtype=torch.int64, device=dev)
    tiles = -(-data.n // PERMUTATION_TILE)
    tile_prod = torch.empty((k, nc, tiles), dtype=torch.int64, device=dev)
    launches = 0
    for g0, g1 in _groups(k):
        with _cuda.on_device(dev):
            err = _cuda.lib().qzk_permutation(
                traces[g0].data_ptr(), traces.stride(0), tab["id_coords"].data_ptr(),
                tab["sigma_vals"].data_ptr(), rec[g0].data_ptr(), rec.stride(0),
                out[g0].data_ptr(), tile_prod[g0].data_ptr(), g1 - g0, data.n, nr,
                cfg.max_quotient_degree_factor, nc, _cuda.stream(),
            )
        _cuda.check(err, "qzk_permutation")
        launches += 1 if tiles == 1 else 2
    return out, launches


def _host_felts(values, count: int) -> np.ndarray:
    """The first `count` felts of each row of `values` as a contiguous
    (rows, count) uint64 array."""
    arr = np.asarray(values, dtype=np.uint64)
    return np.ascontiguousarray(arr.reshape(-1, arr.shape[-1])[:, :count])


compute_permutation_polys.launches = 0
compute_permutation_polys_batch.launches = 0


# ---------------------------------------------------------------------------
# the quotient (kernel A)


def _quotient_operands(data: CircuitData, wires_lde, zs_pp_lde):
    """The constants/selectors/sigmas LDE on the operands' device, after
    checking every operand's shape."""
    cfg = data.config
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    npp = num_partial_products(cfg.num_routed_wires, cfg.max_quotient_degree_factor)
    consts_lde = device_constants(data, wires_lde.device).lde
    nconst = data.const_cols.shape[0]
    want = (
        (wires_lde, cfg.num_wires),
        (consts_lde, nconst + data.num_selectors + cfg.num_routed_wires),
        (zs_pp_lde, nc + nc * npp),
    )
    for t, rows in want:
        if t.dim() != 2 or t.shape[0] < rows or t.shape[1] != m:
            raise ValueError(f"LDE operand {tuple(t.shape)}, expected ({rows}, {m})")
    if not 1 <= nc <= MAX_CHALLENGES:
        raise ValueError(f"{nc} challenges: kernel A takes at most {MAX_CHALLENGES}")
    return consts_lde


def quotient_evals_plain(data, wires_lde, zs_pp_lde, rec):
    """Plain torch version of `quotient_evals` (same arguments)."""
    consts_lde = _quotient_operands(data, wires_lde, zs_pp_lde)
    cfg = data.config
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    qdf = cfg.max_quotient_degree_factor
    npp = num_partial_products(nr, qdf)
    rate = 1 << cfg.rate_bits
    m = data.n * rate
    nconst = data.const_cols.shape[0]
    nsel = data.num_selectors
    dev = wires_lde.device
    tab = _quotient_tables(data, dev)

    ctx = DeviceBatchCtx(
        wires_lde[: cfg.num_wires],
        [consts_lde[k] for k in range(nconst)],
        rec[ts.REC_PI : ts.REC_PI + 4],
    )
    # gate constraints, selector-masked, stacked (K_gates, m)
    parts = []
    for s, gate in enumerate(data.gate_types):
        if gate.num_constraints:  # a Noop row has none to stack
            parts.append(gl.mul(gate.eval_batched(ctx), consts_lde[nconst + s]))

    # permutation constraints, per challenge
    routed = wires_lde[:nr]  # (nr, m)
    sigma = consts_lde[nconst + nsel : nconst + nsel + nr]
    ids_lde = gl.mul(tab["ks"].unsqueeze(1), tab["xs"])  # k_i * x
    # the final chunk may be ragged (routed % qdf != 0): pad its factors
    # with multiplicative ones so the segment products match the chunks
    nchunks = -(-nr // qdf)
    pad = nchunks * qdf - nr
    ones_pad = torch.ones((pad, m), dtype=torch.int64, device=dev)
    one = gl.felt(1, dev)
    for c in range(nc):
        beta, gamma = rec[ts.REC_BETA + c], rec[ts.REC_GAMMA + c]
        z = zs_pp_lde[c]
        z_next = torch.roll(z, -rate, dims=0)
        num = gl.add(gl.add(routed, gl.mul(beta, ids_lde)), gamma)
        den = gl.add(gl.add(routed, gl.mul(beta, sigma)), gamma)
        cn = gl.prod_tree(torch.cat([num, ones_pad]).reshape(nchunks, qdf, m), 1)
        cd = gl.prod_tree(torch.cat([den, ones_pad]).reshape(nchunks, qdf, m), 1)
        pp_rows = [zs_pp_lde[nc + c * npp + j] for j in range(npp)]
        prevs = torch.stack([z] + pp_rows)  # (nchunks, m)
        nxts = torch.stack(pp_rows + [z_next])
        rel = gl.sub(gl.mul(nxts, cd), gl.mul(prevs, cn))
        parts.append(gl.mul(tab["l1"], gl.sub(z, one)).unsqueeze(0))
        parts.append(rel)

    all_cons = torch.cat(parts, dim=0)  # (K, m)
    k_total = all_cons.shape[0]
    out = []
    for c in range(nc):
        apows = gl.powers(rec[ts.REC_ALPHA + c], k_total).unsqueeze(1)
        out.append(gl.mul(gl.sum_tree(gl.mul(all_cons, apows), 0), tab["inv_zh"]))
    return torch.stack(out)


def quotient_evals(data, wires_lde, zs_pp_lde, rec):
    """The quotient's values over the LDE coset, (nc, m), before the iNTT:
    out_c(x) = (1/Z_H(x)) sum_k alpha_c^k C_k(x) over the canonical
    constraint list (gate constraints masked by selectors, then per
    challenge L1 * (Z - 1) and the permutation transitions). The alphas,
    betas, gammas and PI hash are read from the challenge record `rec`
    (REC_WORDS,) on the operands' device (`compute_permutation_polys`).

    The constants, selectors and sigmas come from the circuit's preprocessing
    oracle. On CUDA operands: kernel A (csrc/quotient.cu), two launches. On
    CPU operands: the plain version."""
    consts_lde = _quotient_operands(data, wires_lde, zs_pp_lde)
    if wires_lde.device.type == "cpu":
        return quotient_evals_plain(data, wires_lde, zs_pp_lde, rec)
    _cuda.require_cuda_int64(wires_lde, consts_lde, zs_pp_lde, rec)
    return _launch_quotient(data, wires_lde, zs_pp_lde, rec, consts_lde)


def _launch_quotient(data, wires_lde, zs_pp_lde, rec, consts_lde):
    out, launches = _quotient_rec_launches(
        data, wires_lde.unsqueeze(0), zs_pp_lde.unsqueeze(0), rec.unsqueeze(0), consts_lde)
    quotient_evals.launches += launches
    return out[0]


def quotient_evals_batch_plain(data, wires_ldes, zs_pp_ldes, rec):
    """Plain torch version of `quotient_evals_batch` (same arguments):
    `quotient_evals_plain` a proof, stacked."""
    _batch_limits(wires_ldes, zs_pp_ldes, rec)
    return torch.stack([quotient_evals_plain(data, *args) for args in zip(
        wires_ldes, zs_pp_ldes, rec)])


def quotient_evals_batch(data, wires_ldes, zs_pp_ldes, rec):
    """`quotient_evals` for K proofs of the circuit: wires_ldes (K,
    num_wires, m), zs_pp_ldes (K, num_cols, m), proof i's alphas, betas,
    gammas and PI hash in record rec[i] of rec (K, REC_WORDS) on the
    operands' device (the fused batch's transcripts write them there; the
    staged batch uploads its host values, `host_records`) -> (K, nc, m).

    On CUDA operands: kernel A with a proof axis, two launches for at most
    PROOFS_PER_LAUNCH proofs; the constants, selectors, sigmas and domain
    tables are the circuit's, read by every proof. On CPU operands: the
    plain version."""
    _batch_limits(wires_ldes, zs_pp_ldes, rec)
    consts_lde = _quotient_operands(data, wires_ldes[0], zs_pp_ldes[0])
    if wires_ldes.device.type == "cpu":
        return quotient_evals_batch_plain(data, wires_ldes, zs_pp_ldes, rec)
    _cuda.require_cuda_int64(wires_ldes, consts_lde, zs_pp_ldes, rec)
    out, launches = _quotient_rec_launches(data, wires_ldes, zs_pp_ldes, rec, consts_lde)
    quotient_evals_batch.launches += launches
    return out


def _quotient_rec_launches(data, wires_ldes, zs_pp_ldes, rec, consts_lde):
    """Kernel A over (K, rows, m) stacks, proof i's challenges in record
    rec[i] on the device: (out (K, nc, m), launches)."""
    cfg = data.config
    nc = cfg.num_challenges
    m = data.n << cfg.rate_bits
    k, dev = wires_ldes.shape[0], wires_ldes.device
    tab = _quotient_tables(data, dev)
    wires_ldes, consts_lde, zs_pp_ldes = (
        t.contiguous() for t in (wires_ldes, consts_lde, zs_pp_ldes))
    groups = tab["desc"].shape[0]
    partial = torch.empty((k, groups, nc, m), dtype=torch.int64, device=dev)
    out = torch.empty((k, nc, m), dtype=torch.int64, device=dev)
    lib = _kernel_lib(dev.index)
    launches = 0
    # the launch, its stream and the constants it reads are the operands' device's
    with _cuda.on_device(dev):
        for g0, g1 in _groups(k):
            err = lib.qzk_quotient(
                wires_ldes[g0].data_ptr(), wires_ldes.stride(0), consts_lde.data_ptr(),
                zs_pp_ldes[g0].data_ptr(), zs_pp_ldes.stride(0), tab["xs"].data_ptr(),
                tab["l1"].data_ptr(), tab["inv_zh"].data_ptr(), tab["ks"].data_ptr(),
                tab["desc"].data_ptr(), partial[g0].data_ptr(), out[g0].data_ptr(),
                rec[g0].data_ptr(), rec.stride(0), g1 - g0, groups, tab["blocks"], m, 1 << cfg.rate_bits,
                cfg.num_routed_wires, cfg.max_quotient_degree_factor,
                num_partial_products(cfg.num_routed_wires, cfg.max_quotient_degree_factor), nc,
                data.const_cols.shape[0], data.num_selectors, tab["num_constraints"],
                tab["max_count"], _cuda.stream(),
            )
            _cuda.check(err, "qzk_quotient")
            launches += 2
    return out, launches


quotient_evals.launches = 0
quotient_evals_batch.launches = 0


def compute_quotient(data, wires_lde, zs_pp_lde, rec):
    """Quotient chunks (nc * qdf, n) in coefficient form (the JAX package's
    `quotient_run`): `quotient_evals` over the LDE coset (its challenges in
    the record `rec` on the device), then one kernel-3 coset iNTT of all nc
    rows with the g^-i unshift folded in."""
    cfg = data.config
    evals = quotient_evals(data, wires_lde, zs_pp_lde, rec)
    # (nc, m) -> (nc * qdf, n): qdf == rate
    return ntt.coset_intt(evals).reshape(cfg.num_challenges << cfg.rate_bits, data.n)


#: where a ZK proof's blinding rows and salts are drawn (`prove`)
RNG_MODES = ("auto", "host", "device")

#: circuits up to this degree take the fused prover by default, larger ones
#: the staged one until `warmup` (the JAX package's FUSED_DEGREE_BITS_MAX)
FUSED_DEGREE_BITS_MAX = 11


def uses_fused(data: CircuitData) -> bool:
    """Whether `prove` takes the fused prover for `data` (without a mesh):
    the JAX package's rule (plonk/prover.py:310-319). QZKT_STAGED_PROVER=1
    forces the staged prover, QZKT_FORCE_FUSED=1 the fused one; else a
    circuit of degree_bits at most FUSED_DEGREE_BITS_MAX, or one whose
    fused bundle exists (`warmup`, or an earlier fused proof)."""
    if os.environ.get("QZKT_STAGED_PROVER"):
        return False
    return (data.degree_bits <= FUSED_DEGREE_BITS_MAX or bool(os.environ.get("QZKT_FORCE_FUSED"))
            or "_torch_fused" in data.__dict__)


def prove(data: CircuitData, pw: PartialWitness, seed: int | None = None,
          rng_mode: str = "auto", mesh=None) -> Proof:
    """Prove on the device of `data` (see `CircuitBuilder.build`), as the
    JAX package's `prove` does: the fused prover (plonk/prover_fused.py, one
    upload and one download a proof) when `uses_fused(data)`, else
    `prove_staged`. With a `mesh`, `prove_staged` (its tensor-parallel
    commits; the fused graph on a mesh is not ported). rng_mode "device" on
    the staged path without a mesh raises, as in the JAX package: the
    caller asked for what that path does not draw there. The bytes of the
    two paths are equal (ZK: in either rng mode, for the same seed)."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"rng_mode {rng_mode!r}, expected one of {RNG_MODES}")
    if mesh is None and uses_fused(data):
        from .prover_fused import prove_fused

        return prove_fused(data, pw, seed, warm_rng_mode(data, rng_mode))
    if rng_mode == "device" and mesh is None:
        raise ValueError(
            "rng_mode='device' requires the fused prover, but the staged prover was selected "
            "(large circuit or QZKT_STAGED_PROVER=1); pass rng_mode='host'/'auto' or force "
            "fused (QZKT_FORCE_FUSED=1)")
    return prove_staged(data, pw, seed, rng_mode, mesh)


def prove_staged(data: CircuitData, pw: PartialWitness, seed: int | None = None,
                 rng_mode: str = "auto", mesh=None) -> Proof:
    """The staged prover (the JAX package's `prove_staged`): witness
    generation on the host, then `prove_from_trace`, the transcript on the
    host between launches.

    A ZK circuit's randomness comes from `np.random.default_rng(seed)`:
    with rng_mode "host" the blinding rows and the three salts are drawn on
    the host (`builder.zk_draws`), and the bytes equal the JAX package's
    proof of the same seed; with "device" one key is drawn from that rng
    (`rng.integers(0, 2**63)`, prover_fused.py:1116) and kernel G draws them
    on the card: a valid proof, not byte-equal to the host mode's. "auto"
    is "host" until `warmup(data)` has run, and then the mode it was warmed
    for ("device" by default), as the JAX package's `prove` takes "device"
    once `warmup_fused` has built its device-rng graph: pass the mode
    explicitly when the bytes must be reproducible. A non-ZK proof draws
    nothing, whatever the mode.

    With a `mesh` (parallel/mesh.py), the three oracle commits run
    tensor-parallel over its "cols" axis (`prove_from_trace`): the same
    bytes as without."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"rng_mode {rng_mode!r}, expected one of {RNG_MODES}")
    trace, pis = witness_trace(data, pw)
    return _prove_drawn(data, trace, pis, seed, warm_rng_mode(data, rng_mode), mesh)


def warm_rng_mode(data: CircuitData, rng_mode: str) -> str:
    """`rng_mode` with "auto" resolved: the mode `warmup` warmed `data` for,
    else "host"."""
    return data.__dict__.get("_warm_rng_mode", "host") if rng_mode == "auto" else rng_mode


def _prove_drawn(data: CircuitData, trace: np.ndarray, pis: np.ndarray, seed, rng_mode: str,
                 mesh=None):
    """`prove_from_trace` after a ZK proof's draws in `rng_mode` ("host" or
    "device") from `default_rng(seed)`."""
    if not data.config.zero_knowledge:
        return prove_from_trace(data, trace, pis, seed, mesh=mesh)
    rng = np.random.default_rng(seed)
    if rng_mode == "device":
        return prove_from_trace(data, trace, pis, seed, device_key=int(rng.integers(0, 2**63)),
                                mesh=mesh)
    blind, salts = zk_draws(data, rng)
    trace[:, data.num_rows_used :] = blind
    return prove_from_trace(data, trace, pis, seed, salts=salts, mesh=mesh)


def warmup(data: CircuitData, pw: PartialWitness, rng_mode: str = "device", mesh=None) -> None:
    """Make `data`'s next proofs steady-state and flip `prove` onto the fused
    prover for it (the JAX package's `warmup_fused`, plonk/prover.py:212;
    there is no graph to compile here):

      * build the circuit's fused bundle (`prover_fused.fused_bundle`: the
        preprocessing oracle, kernels A's and B's per-circuit tables, the
        scatter tables, the packed output's layout) on its device, after
        which `prove` takes the fused prover whatever the degree;
      * record the circuit's witness program from `pw` (the Python
        replay) and lower it to its C tape (plonk/witness_tape.py), so later
        witnesses of the same seed keyset run the tape;
      * make one throw-away fused proof of `pw` in `rng_mode`, which loads
        the kernel library and launches every kernel of the path;
      * mark `data` so that `prove(..., rng_mode="auto")` takes `rng_mode`
        ("device" or "host") from then on.

    With a `mesh`, the tables and the preprocessing oracle are also made on
    every device of the mesh (`device_constants`; a data-parallel shard
    proves on its own) and the throw-away proof runs through the mesh
    (`prove_staged(..., mesh=mesh)`)."""
    from .prover_fused import fused_bundle, prove_fused

    if rng_mode not in ("host", "device"):
        raise ValueError(f"rng_mode {rng_mode!r}: warm up for 'host' or 'device'")
    _check_config(data.config)
    fused_bundle(data)
    for dev in [] if mesh is None else mesh.unique_devices():
        device_constants(data, dev)
        _quotient_tables(data, dev)
        _routing_tables(data, dev)
    witness_root_values(data, pw)  # records the program if it is new
    witness_root_values(data, pw)  # the tape's first run, which lowers it
    if mesh is None:
        prove_fused(data, pw, 0, rng_mode)
    else:
        trace, pis = witness_trace(data, pw)
        _prove_drawn(data, trace, pis, 0, rng_mode, mesh)
    data.__dict__["_warm_rng_mode"] = rng_mode


#: the JAX package's name for `warmup`
warmup_fused = warmup


def _check_config(cfg) -> None:
    if cfg.max_quotient_degree_factor != 1 << cfg.rate_bits:
        raise ValueError(
            "quotient evaluation reuses the rate-blowup LDE domain; qdf must equal 2^rate_bits"
        )


def _zeta_next(data: CircuitData, zeta) -> np.ndarray:
    """g * zeta, g the generator of the trace domain."""
    g_n = F.primitive_root_of_unity(data.degree_bits)
    return ext.scalar_mul(np.asarray(zeta, dtype=np.uint64).reshape(1, 2), g_n)[0]


def _open(data: CircuitData, oracles: list, zeta) -> tuple[OpeningSet, np.ndarray]:
    """All oracles at zeta (+ the Z columns at g*zeta), one kernel-D call and
    one transfer: the opening set and zeta_next."""
    zeta_next = _zeta_next(data, zeta)
    nz, _ = zs_pp_layout(data.config)
    values = fo.eval_openings(oracles, fo.point_records(data.device, [zeta], [zeta_next])[0],
                              next_oracle=2, next_count=nz)
    opened = fo.split_openings(gl.to_u64(values), oracles, nz)
    return _opening_set(data, *opened), zeta_next


def _open_batch(data: CircuitData, oracles_k: list, zetas) -> list[tuple[OpeningSet, np.ndarray]]:
    """`_open` for K proofs: one kernel-D call (a launch a group of
    PROOFS_PER_LAUNCH proofs) and one transfer for the batch."""
    zeta_nexts = [_zeta_next(data, zeta) for zeta in zetas]
    nz, _ = zs_pp_layout(data.config)
    rec = fo.point_records(oracles_k[0][0].coeffs.device, zetas, zeta_nexts)
    values = fo.eval_openings_batch(oracles_k, rec, next_oracle=2, next_count=nz)
    return [(_opening_set(data, *fo.split_openings(v, o, nz)), zn)
            for v, o, zn in zip(gl.to_u64(values), oracles_k, zeta_nexts)]


def _opening_set(data: CircuitData, parts, zs_next_open) -> OpeningSet:
    """The opening set of the four oracles' values at zeta and the Z
    columns' at g * zeta."""
    consts_open, wires_open, zpp_open, quot_open = parts
    nconst = data.const_cols.shape[0]
    nsel = data.num_selectors
    nz, _ = zs_pp_layout(data.config)
    return OpeningSet(
        constants=consts_open[:nconst],
        selectors=consts_open[nconst : nconst + nsel],
        sigmas=consts_open[nconst + nsel :],
        wires=wires_open,
        zs=zpp_open[:nz],
        zs_next=zs_next_open,
        pps=zpp_open[nz:],
        quotient=quot_open,
    )


def _salt_args(cfg, salts, device_key) -> list:
    """The three commits' `salt` arguments: host salts (3, M, SALT_SIZE), or
    kernel G's streams 1-3 of the device key; None for a non-ZK circuit."""
    if not cfg.zero_knowledge:
        if salts is not None or device_key is not None:
            raise ValueError("a non-ZK circuit takes no salts and no device key")
        return [None] * 3
    if (salts is None) == (device_key is None):
        raise ValueError("a ZK proof takes its host salts or a device key, one of them")
    if device_key is not None:
        return [frandom.Draw(device_key, 1 + i) for i in range(3)]
    return list(salts)


def prove_from_trace(
    data: CircuitData, trace: np.ndarray, pis: np.ndarray, seed: int | None = None,
    salts=None, device_key: int | None = None, mesh=None,
) -> Proof:
    """Prove from a witness trace (num_wires, n) and its public inputs.

    A non-ZK proof draws no randomness, so `seed` does not change it (it is
    accepted for the reference's signature). A ZK proof takes either its
    host draws (`builder.zk_draws`): the trace with its blinding rows and
    `salts` (3, M, SALT_SIZE) for the wires, zs_pp and quotient oracles; or
    a `device_key`, and then kernel G writes the blinding rows (stream 0)
    over the trace's rows past `num_rows_used` and each oracle's salt rows
    (streams 1-3) on the card: four launches.

    With a `mesh`, the wires, zs_pp and quotient commits run tensor-parallel
    over its "cols" axis (`parallel/tp.py::commit_sharded`: the JAX
    package's `prove_staged(mesh=)` and `_build_fused(mesh=)`, one program
    here) and return their oracles on the circuit's device, where every
    other stage runs; the salts are drawn as without a mesh, so the bytes
    are the same."""
    cfg = data.config
    _check_config(cfg)
    salt_args = _salt_args(cfg, salts, device_key)
    dev = data.device
    rate_bits = cfg.rate_bits
    cap_h = cfg.fri_config.cap_height
    if mesh is None:
        commit = fo.commit
    else:
        def commit(values, rate_bits, cap_height, from_values=False, salt=None):
            return tp.commit_sharded(values, mesh, rate_bits, cap_height,
                                     from_values=from_values, salt=salt)

    # 1. witness
    pi_hash = ps.hash_no_pad(pis)
    trace_d = gl.from_u64(trace, dev)
    if device_key is not None:
        frandom.rand_felts(device_key, 0, trace_d[:, data.num_rows_used :])

    # 2. wires commitment
    wires_o = commit(trace_d, rate_bits, cap_h, from_values=True, salt=salt_args[0])
    ch = ts.Challenger()
    ch.observe_many(data.circuit_digest)
    ch.observe_many(pi_hash)
    ch.observe_cap(wires_o.cap)
    betas = ch.challenge_many(cfg.num_challenges)
    gammas = ch.challenge_many(cfg.num_challenges)

    # 3. permutation argument
    nc = cfg.num_challenges
    zpp = compute_permutation_polys(data, trace_d, host_records(dev, 1, nc, betas=betas,
                                                                gammas=gammas)[0])
    zs_pp_o = commit(zpp, rate_bits, cap_h, from_values=True, salt=salt_args[1])
    ch.observe_cap(zs_pp_o.cap)
    alphas = ch.challenge_many(cfg.num_challenges)

    # 4. quotient
    t_chunks = compute_quotient(data, wires_o.poly_lde, zs_pp_o.poly_lde, host_records(
        dev, 1, nc, alphas=alphas, betas=betas, gammas=gammas, pis=pi_hash)[0])
    quotient_o = commit(t_chunks, rate_bits, cap_h, salt=salt_args[2])
    ch.observe_cap(quotient_o.cap)
    zeta = ch.challenge_ext()

    # 5. openings — all oracles at zeta (+ Z cols at g*zeta), one transfer
    oracles = [device_constants(data, dev), wires_o, zs_pp_o, quotient_o]
    openings, zeta_next = _open(data, oracles, zeta)
    openings.observe_into(ch)

    # 6. FRI
    instance = fri_instance(data, zeta, zeta_next)
    fri_openings = [openings.batch_zeta(), openings.batch_zeta_next()]
    fri_proof = fri_prove(oracles, instance, fri_openings, ch, cfg.fri_config, data.degree_bits)
    return Proof(
        wires_cap=wires_o.cap,
        zs_pp_cap=zs_pp_o.cap,
        quotient_cap=quotient_o.cap,
        openings=openings,
        fri_proof=fri_proof,
        public_inputs=pis,
    )


# ---------------------------------------------------------------------------
# batches and streams of proofs


def prove_batch(data: CircuitData, pws: list, seed: int | None = None) -> list[Proof]:
    """Prove K witnesses of one circuit together, as the JAX package's
    `prove_batch` does (plonk/prover.py:332): the fused batch
    (prover_fused.py::prove_fused_batch, one upload and one download for
    all K) unless QZKT_STAGED_PROVER is set, then the staged batch
    (`generate_witness_batch` by one tape call, then `prove_from_traces`).
    Proofs come back in input order. A non-ZK proof draws nothing, and each
    proof's bytes equal the single proof's of the same witness, on either
    path. A ZK batch draws host-rng on either path, as the JAX package's
    default (fused) batch does: one `default_rng(seed)` for the batch, each
    proof in turn drawing its blinding rows and its three salts, so proof 0
    equals the single proof of the same seed. (The JAX package's staged
    fallback seeds each ZK proof anew from that rng, so its ZK bytes differ
    there; its non-ZK bytes are the same.)"""
    _check_config(data.config)
    if not pws:
        return []
    if not os.environ.get("QZKT_STAGED_PROVER"):
        from .prover_fused import prove_fused_batch

        return prove_fused_batch(data, pws, seed)
    traces, pis, salts = generate_witness_batch(data, pws, np.random.default_rng(seed))
    return prove_from_traces(data, traces, pis, seed, salts)


def prove_stream(data: CircuitData, pws, batch: int, seed: int | None = None,
                 total: int | None = None) -> list[Proof]:
    """Prove an iterable of PartialWitnesses (a list, or a generator that
    fills them on demand) in chunks of `batch`: the fused stream
    (prover_fused.py::prove_fused_stream, the JAX package's, which
    overlaps chunk i+1's witnesses and upload with chunk i's device work)
    unless QZKT_STAGED_PROVER is set, then the staged stream, where a
    worker thread generates chunk i+1's witnesses while this thread proves
    chunk i with `prove_from_traces`. The stream's length must tile
    `batch`: checked against `total` first when it is given, else when the
    last chunk comes up short. An exception in the witness source reaches
    the caller. Proofs come back in input order. A ZK stream draws as one
    batch would (`prove_batch`): one `default_rng(seed)` for the stream,
    each proof in turn."""
    _check_config(data.config)
    if batch < 1:
        raise ValueError(f"batch {batch}: a chunk holds at least one proof")
    if total is not None:
        assert total % batch == 0, "stream length must tile the batch size"
    if not os.environ.get("QZKT_STAGED_PROVER"):
        from .prover_fused import prove_fused_stream

        return prove_fused_stream(data, pws, batch, seed, total)
    it = iter(pws)
    rng = np.random.default_rng(seed)

    def next_chunk():
        chunk = list(itertools.islice(it, batch))
        if not chunk:
            return None
        assert len(chunk) == batch, "stream length must tile the batch size"
        return generate_witness_batch(data, chunk, rng)

    proofs: list[Proof] = []
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="qzk-witness") as pool:
        pending = pool.submit(next_chunk)
        while (ready := pending.result()) is not None:
            pending = pool.submit(next_chunk)
            traces, pis, salts = ready
            proofs += prove_from_traces(data, traces, pis, seed, salts)
    return proofs


def compute_quotient_batch(data, wires_ldes, zs_pp_ldes, rec):
    """`compute_quotient` for K proofs, proof i's challenges in record
    rec[i] of rec (K, REC_WORDS) on the device: (K, nc * qdf, n) chunks in
    coefficient form, from `quotient_evals_batch` and one kernel-3 coset
    iNTT of all K nc rows."""
    cfg = data.config
    evals = quotient_evals_batch(data, wires_ldes, zs_pp_ldes, rec)
    return ntt.coset_intt(evals).reshape(evals.shape[0], cfg.num_challenges << cfg.rate_bits,
                                         data.n)


def _caps(batches) -> np.ndarray:
    return np.stack([b.cap.ravel() for b in batches])


def prove_from_traces(data: CircuitData, traces: np.ndarray, pis: np.ndarray,
                      seed: int | None = None, salts=None, device=None) -> list[Proof]:
    """Prove K witness traces (K, num_wires, n) of one circuit with their
    public inputs (K, num_pis), a stage at a time for all K, in the order of
    `prove_from_trace`:

      * one stacked kernel-3 iNTT and LDE and one kernel-2 forest a commit
        (`fo.commit_batch`): the wires, the Z and partial products, the
        quotient chunks;
      * the K transcripts in lockstep (`ts.ChallengerBatch`, one C call a
        step);
      * kernels B and A with a proof axis (`compute_permutation_polys_batch`,
        `quotient_evals_batch`), the host challenges uploaded into K records
        (`host_records`, one copy a kernel);
      * the openings, one kernel-D call for the batch;
      * FRI with the transcripts in lockstep: its commit phase (kernels C
        and E with a proof axis, a forest a round, one stacked final iNTT),
        one grind for all K (`ts.grind_pow_batch`), then the queries (kernel
        F with a proof axis), each kernel once a group of PROOFS_PER_LAUNCH
        proofs (`fri_commit_phase_batch`, `fri_query_phase_batch`).

    A ZK batch takes its traces with their blinding rows and `salts` (K, 3,
    M, SALT_SIZE), each commit's salts uploaded in one copy into the salt
    rows of its (K, C + SALT_SIZE, M) buffer. Each proof's bytes equal
    `prove_from_trace`'s with the same draws.

    `device`: where the batch runs, the circuit's device by default (a
    data-parallel shard's card, `parallel/mesh.py::sharded_prove_batch`;
    the preprocessing oracle and the kernels' tables are made there once)."""
    cfg = data.config
    _check_config(cfg)
    if cfg.zero_knowledge != (salts is not None):
        raise ValueError("a ZK batch takes its host salts, a non-ZK batch none")
    commit_salts = [None] * 3 if salts is None else [
        np.asarray(salts, dtype=np.uint64)[:, j] for j in range(3)]
    traces = np.asarray(traces, dtype=np.uint64)
    k = traces.shape[0]
    dev = data.device if device is None else device
    rate_bits, cap_h, nc = cfg.rate_bits, cfg.fri_config.cap_height, cfg.num_challenges

    # 1. witnesses
    pi_hashes = np.stack([ps.hash_no_pad(p) for p in pis])
    traces_d = gl.from_u64(traces, dev)

    # 2. wires commitments
    wires_os = fo.commit_batch(traces_d, rate_bits, cap_h, from_values=True, salts=commit_salts[0])
    ch = ts.ChallengerBatch(k)
    ch.observe_many(np.tile(np.asarray(data.circuit_digest, dtype=np.uint64), (k, 1)))
    ch.observe_many(pi_hashes)
    ch.observe_many(_caps(wires_os))
    betas = ch.challenge_many(nc)
    gammas = ch.challenge_many(nc)

    # 3. permutation arguments
    zpp = compute_permutation_polys_batch(data, traces_d, host_records(
        dev, k, nc, betas=betas, gammas=gammas))
    zs_pp_os = fo.commit_batch(zpp, rate_bits, cap_h, from_values=True, salts=commit_salts[1])
    ch.observe_many(_caps(zs_pp_os))
    alphas = ch.challenge_many(nc)

    # 4. quotients
    t_chunks = compute_quotient_batch(data, fo.stacked_lde(wires_os), fo.stacked_lde(zs_pp_os),
                                      host_records(dev, k, nc, alphas=alphas, betas=betas,
                                                   gammas=gammas, pis=pi_hashes))
    quotient_os = fo.commit_batch(t_chunks, rate_bits, cap_h, salts=commit_salts[2])
    ch.observe_many(_caps(quotient_os))
    zetas = ch.challenge_ext()

    # 5. openings, one kernel-D call for the batch
    consts = device_constants(data, dev)
    oracles = [[consts, w, z, q] for w, z, q in zip(wires_os, zs_pp_os, quotient_os)]
    opened = _open_batch(data, oracles, zetas)
    ch.observe_many(np.stack([o.batch_zeta().ravel() for o, _ in opened]))
    ch.observe_many(np.stack([o.batch_zeta_next().ravel() for o, _ in opened]))

    # 6. FRI, the transcripts in lockstep: each phase for all K before the next
    fcfg = cfg.fri_config
    instances = [fri_instance(data, zeta, zeta_next) for zeta, (_, zeta_next) in zip(zetas, opened)]
    fri_openings = [[op.batch_zeta(), op.batch_zeta_next()] for op, _ in opened]
    commitments = fri_commit_phase_batch(oracles, instances, fri_openings, ch, fcfg,
                                         data.degree_bits)
    witnesses = ts.grind_pow_batch(ch, fcfg.proof_of_work_bits, dev)
    fri_proofs = fri_query_phase_batch(oracles, commitments, witnesses, ch, fcfg,
                                       data.degree_bits)
    return [
        Proof(wires_cap=w.cap, zs_pp_cap=z.cap, quotient_cap=q.cap, openings=op,
              fri_proof=fp, public_inputs=p)
        for w, z, q, (op, _), fp, p in zip(
            wires_os, zs_pp_os, quotient_os, opened, fri_proofs, pis)
    ]


def _zh_l1(data, zeta) -> tuple:
    """(zeta^n, Z_H(zeta), L_1(zeta)) as extension pairs."""
    zeta_t = ext.pair(zeta)
    one = (1, 0)
    zeta_n, base, e = one, zeta_t, data.n
    while e:
        if e & 1:
            zeta_n = ext.mul(zeta_n, base)
        base = ext.mul(base, base)
        e >>= 1
    zh = ext.sub(zeta_n, one)
    l1 = ext.mul(zh, ext.inv(ext.scalar_mul(ext.sub(zeta_t, one), data.n)))
    return zeta_n, zh, l1


def _zh_times_t(data, openings: OpeningSet, c: int, zeta_n, zh) -> tuple:
    """Z_H(zeta) * t_c(zeta), t_c(zeta) = sum_j zeta^{n j} t_{c,j}(zeta)."""
    qdf = data.config.max_quotient_degree_factor
    t = (0, 0)
    zpow = (1, 0)
    for j in range(qdf):
        t = ext.add(t, ext.mul(zpow, ext.pair(openings.quotient[c * qdf + j])))
        zpow = ext.mul(zpow, zeta_n)
    return ext.mul(zh, t)


def verify_vanishing_at_zeta(data, openings: OpeningSet, pi_hash, alphas, betas, gammas, zeta):
    """Host check: alpha-combined constraints at zeta == Z_H(zeta)*t(zeta).

    The circuit's constraint tape (plonk/constraint_tape.py, recorded from
    the shared definitions at a circuit's first verify) evaluated in one
    call into the C library. `_verify_vanishing_pure` walks the definitions
    in Python and is the tests' oracle."""
    cfg = data.config
    nr = cfg.num_routed_wires
    tape = constraint_tape.get_tape(data)
    s = tape.slices
    inp = np.zeros((s["_total"][1], 2), dtype=np.uint64)

    def put(name, arr):
        st, cnt = s[name]
        a = np.asarray(arr, dtype=np.uint64).reshape(cnt, -1)
        if a.shape[1] == 1:  # base-field scalars embed as (v, 0)
            inp[st : st + cnt, 0] = a[:, 0]
        else:
            inp[st : st + cnt] = a

    put("wires", openings.wires)
    put("constants", openings.constants)
    put("selectors", openings.selectors)
    put("sigmas", openings.sigmas)
    put("zs", openings.zs)
    put("zs_next", openings.zs_next)
    put("pps", openings.pps)
    ks = np.asarray(coset_shifts(nr), dtype=np.uint64)
    put("id_coords", np.stack([F.mul(ks, np.uint64(zeta[0])), F.mul(ks, np.uint64(zeta[1]))], -1))
    zeta_n, zh, l1 = _zh_l1(data, zeta)
    put("l1", np.array([l1], dtype=np.uint64))
    put("betas", betas)
    put("gammas", gammas)
    put("alphas", alphas)
    put("pi_hash", np.asarray(pi_hash, dtype=np.uint64)[:4])
    acc = nat.eval_tape(tape, inp)  # (num_challenges, 2)
    return all((int(acc[c, 0]), int(acc[c, 1])) == _zh_times_t(data, openings, c, zeta_n, zh)
               for c in range(cfg.num_challenges))


def _verify_vanishing_pure(data, openings: OpeningSet, pi_hash, alphas, betas, gammas, zeta):
    """verify_vanishing_at_zeta walking the shared constraint definitions in
    Python ints (the tests' oracle)."""
    cfg = data.config
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    alg = HostExtAlg()
    # scalar host verification runs in the (int, int) tuple domain — pure
    # Python-int arithmetic through the SAME shared ext ops / constraint
    # definitions as the prover's
    tp = ext.pair
    wires = [tp(openings.wires[i]) for i in range(cfg.num_wires)]
    constants_vals = [tp(openings.constants[k]) for k in range(openings.constants.shape[0])]
    selector_vals = [tp(openings.selectors[s]) for s in range(data.num_selectors)]
    sigma_vals = [tp(openings.sigmas[i]) for i in range(nr)]
    zs = [tp(openings.zs[c]) for c in range(nc)]
    zs_next = [tp(openings.zs_next[c]) for c in range(nc)]
    npp = num_partial_products(nr, cfg.max_quotient_degree_factor)
    pps = [[tp(openings.pps[c * npp + j]) for j in range(npp)] for c in range(nc)]
    zeta_t = tp(zeta)
    id_coords = [ext.scalar_mul(zeta_t, int(k)) for k in coset_shifts(nr)]
    one = (1, 0)
    zeta_n, zh, l1 = _zh_l1(data, zeta)
    ctx = HostExtCtx(wires, constants_vals, [(int(pi_hash[i]), 0) for i in range(4)])
    betas_e = [(int(b), 0) for b in betas]
    gammas_e = [(int(g), 0) for g in gammas]
    constraints = eval_constraints(
        ctx, data, wires, constants_vals, selector_vals, sigma_vals,
        zs, zs_next, pps, id_coords, l1, betas_e, gammas_e, alg,
    )
    ok = True
    for c in range(nc):
        acc = (0, 0)
        apow = one
        alpha_e = (int(alphas[c]), 0)
        for cons in constraints:
            acc = ext.add(acc, ext.mul(apow, cons))
            apow = ext.mul(apow, alpha_e)
        if acc != _zh_times_t(data, openings, c, zeta_n, zh):
            ok = False
    return ok
