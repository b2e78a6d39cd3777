#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (qp_zk_circuits_tpu_torch) on one GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA card,
nvcc (CUDA toolkit) and no network, and imports nothing of JAX or of the JAX
package. Phases, each printing one line:

  1. device — torch/CUDA versions and `nvidia-smi` name + power limit;
  2. build — compiles csrc/*.cu with nvcc for sm_90a (one process a source);
     then host — builds the host library (native/*.c, the system C
     compiler; its seconds and flags printed) and holds each of its
     functions against its Python form on this host, bit-exact, at the
     leaf's shapes: a transcript duplex, a Poseidon2 gate row, the sponge
     over each oracle's row and a FRI leaf, a 2-to-1, a Merkle path of the
     leaf's depth, an absorb of the openings, the leaf's witness (the tape
     against the Python replay), and the leaf fixture's vanishing check and
     FRI query rounds, accepted and, with a FRI leaf value changed,
     rejected alike; C and Python times on the host clock; then the batch
     path's host calls, 16 at once against 16 single calls, bit-exact and
     both timed: the transcripts' absorb of the openings and duplex, and the
     leaf's witness tape over 16 witnesses;
  3. kernels — each kernel against its plain PyTorch version, bit-exact, at
     the shapes of the leaf prover, plus the field edge vectors (the fused
     kernels A-F against their plain versions run on CPU copies of the same
     inputs, so no kernel is on the reference side); median wrapper times over
     CUDA-event-timed runs, each kernel's device-only time (its library
     launches replayed in a CUDA graph, `tools/timing.py::device_ms`), and
     each kernel's bound; kernel 2's permutation (one thread a state), row
     hash and 2-to-1 (lane-split) at batches that are not a multiple of a
     block, and its tree at the four trees of a leaf proof and at the plans'
     edges; kernels A and B with 1, 2 and 4 challenges and with 60 routed
     wires (a ragged last chunk), B also over four tiles with zero
     denominators on both sides of a tile boundary; kernel 3 at the leaf
     proof's NTT shapes and in all four modes (forward, inverse, LDE with
     the coset shift, inverse with the unshift) at 2^12 (one pass) and
     2^13, 2^14 (two passes); kernel D also with no row at g * zeta, at
     n = 1, 32 and 2^12 (two launches), with one-row segments and row
     counts off its tiles; kernel E at every arity into natural order and
     into leaves of arity 2^4, with fewer rows than a block and above its
     spread limit; kernel F at the leaf's 10 segments (a Merkle path a
     tree) and 37 (a level a segment), with indices 0 and m - 1, at its
     plan's largest (128 segments, one of width 1, 128
     queries, a packed row of 382 values, not a multiple of a warp), at a
     packed row of 1,200 values (wider than a block: threads stride), into
     pinned host memory, and one segment and one query over the plan, which
     must raise; and the batch path's kernels with a proof axis, at K = 16
     and at K = 17 (kernels A and B's cap of 16 proofs a launch, plus one):
     kernel 2's forest (sixteen 2048 x 135 LDEs read in place, against the
     plain version on the card), A and B (the leaf's shapes, each proof its
     own challenges, against their plain versions on CPU copies), and the
     FRI tail's C, D, E and F (the leaf's oracles, the constants shared,
     each proof its own points, alpha, beta and 28 query indices; F's plan
     of 16 proofs one launch), each timed at K = 16 beside K times a proof's
     bound, C-F also beside 16 single calls (wrapper and device ms); kernel G (Philox
     felts, csrc/random.cu) at the ZK leaf's draws (the blinding rows
     135 x 252 written in place through a strided view of the trace, and
     the three salts' 4 x 4096 rows) and at an odd count (3 x 1001),
     against its plain version on CPU copies, with torch.randint of the
     same count timed beside it (another stream: no library computes this
     function); kernel 2's tree also at the ZK leaf's salted widths (4096 x
     139 and 4096 x 20) and kernel F at the ZK leaf's salted rows (139, 20
     and 20 values);
  4. aggregation tree — the Merkle tree at 2^19 x 135: 256 sampled nodes of
     every level against the plain hashes of their inputs, its time beside
     the per-level form's (hash_rows, then one two_to_one launch a level);
  5. aggregation NTT — kernel 3 at the private batch's shapes: the LDE
     135 x 2^16 -> 2^19 (8 columns in full against the plain version on the
     card), the round trip intt(ntt(x)) == x on 135 x 2^16, the coset iNTT
     2 x 2^19 in full, each beside its bound;
  6. aggregation fused — kernels A and B at the private batch's degree 16
     (the leaf's config and gates, random tables): B at n = 2^16 against its
     plain version on CPU copies, A at m = 2^19 against its plain version
     run on the card, and C at m = 2^19 (the leaf's oracles and opening
     instance) against its plain version run on the card, all in full, each
     beside its bound;
  7. aggregation FRI tail — kernels D, E and F at degree 16: D on 264 rows
     of 2^16 coefficients, E's three rounds of schedule(16) in sequence
     (from m = 2^19), each against its plain version run on the card in
     full, and F's 28-query gather at m = 2^19 with the three rounds (14
     segments, a Merkle path a tree; 89 with a segment a level) into pinned
     host memory, each beside its bound;
  8. main path — WormholeProver(device="cuda") on test_inputs_0(), through the
     staged prover (`plonk/prover.py::prove_staged`): build, then
     prove_inputs(seed=0) cold and warm; the proof bytes must equal the
     committed fixture (length and SHA-256), every kernel of the path must
     have been launched during the cold proof, within its launch limits
     (NTT at most seven, quotient and permutation argument at most two
     each, composition at most two (one since it forms its scalars itself),
     openings one, one fold a FRI round, one query gather, one tree call
     of at most two launches a commit and a FRI round, no per-level
     two_to_one), and kernel 1 (off the path since the FRI tail got its own
     kernels) at most five times; that the cold proof ran no witness tape
     and the warm proof's witness came from one tape run, and that the
     warm proof's transcript duplexes and absorbs went through the host
     library; the witness and transcript times of a stage-timed proof;
     then the path's close on the host: the port's WormholeVerifier
     accepts the cold and the warm proof, each through the compiled FRI
     query rounds and constraint tape (one verify's split printed), the
     verifier.bin / common.bin pair built from the card's circuit data
     hashes to the keccak pins and loads with the pins enforced, the loaded
     verifier accepts the warm proof, and copies with one FRI query leaf
     value or one public input changed are rejected; the host verify time
     is printed beside the card;
  9. batch — WormholeProver(device="cuda") on the two real spends of
     two_real_leaves_same_block(), alternating: prove_inputs_batch of 16
     (cold, then warm), of 1, 4, 17 and 33 (kernel F's groups of 16, 16
     and 1), and prove_inputs_stream of 48 in
     chunks of 16 from a generator, each run with the counts set to 0 just
     before it and read just after: every proof equals its committed JAX
     fixture (the single proof's bytes) and the port's verifier accepts it,
     and every stage stays within its launch limits for the batch
     (`_batch_limits`: one stacked kernel-3 call a commit and one for the
     final polynomials, one forest call a commit and a FRI round, A-F once
     a group of 16 (E a round), the grind one permute launch a sweep for
     all proofs); the K = 16 batch's library launches (at most 30) and a
     single proof's library and device launches (61: the 55 before the
     challenge records, and their 6 uploads) printed; the batch
     rows of the JSON line take their launches from the warm batch; then
     per-proof ms of K = 1, 4, 16 and 17 batches and of a single proof;
 10. zk — WormholeProver(wormhole_private_batch_circuit_config(),
     device="cuda") (the private batch's ZK config on the leaf circuit,
     degree 9): build, then prove_inputs(test_inputs_0(), seed=7) cold and
     warm in host-rng mode, each equal to the committed JAX fixture, within
     the single proof's launch limits and with kernel G not launched; a
     device-rng proof (plonk.prover.prove_staged(..., rng_mode="device")): kernel
     G at most four launches, the proof accepted, not equal to the host
     one; a K = 16 ZK batch and a 48-leaf ZK stream in chunks of 16 of the
     two real spends, alternating: proof 0 equal to the single proof of
     the same seed, every proof accepted, within the batch's launch limits
     and no kernel G; a copy with one salt felt of an opened row changed
     is rejected; the warm ms of both modes and of a batch proof, the
     device busy share and the launches, beside the card; and kernel G at
     the private batch's degree-16 draws (the blinding rows 135 x (2^16 -
     64), the salts 3 x 4 x 2^19) against its plain version run on the
     card, bit-exact, timed beside its bound;
 11. recursion — tests/test_recursion.py's outer circuit (verifying a proof
     of z = x * y, degree 11, two FRI rounds) built on the card: its
     verifier data, the inner proof and the outer proof equal the JAX
     fixtures (tests/torch_fixtures/make_agg_fixture.py), the second outer
     witness runs on the compiled tape, the outer proof is accepted;
 12. aggregation — at the aggregation test profile (N = 2, reduced FRI): the
     private and public batch circuits' verifier data and their proofs
     (host rng) equal the JAX fixtures, and a fake leaf's proof is refused
     at admission (by its proof's shape); the artifact set (`generate_all_circuit_binaries`, both
     provers' `new_from_binaries_dir`, a flipped byte refused); then at the
     canonical configs: the leaves and the dummy leaf, the N = 2 private
     batch (degree 14) built, its verifier data and its cold and warm
     host-rng proofs equal the JAX package's, the warm one's witness on the
     tape; `warm_start` and a device-rng proof (every kernel of the path
     and kernel G launched, accepted, a tampered copy rejected), kernel A
     on that proof's own descriptor table and LDEs against its plain
     version on the card, every point; the public batch (m = 2, degree 15)
     over [that batch, a dummy private batch], cold and warm on the tape,
     verified; for each warm proof its seconds, library and device
     launches, the busy share and verify ms;
 13. fused — the JAX package's default path, the fused prover
     (plonk/prover_fused.py), through `prove`'s own dispatch (every other
     phase runs with QZKT_STAGED_PROVER=1, set in `main`: their checks are
     the staged prover's internals): a fresh WormholeProver(device="cuda")
     proves test_inputs_0() cold and warm, byte-equal to the fixture, with
     one upload and one download a proof (the transfer helpers' calls, and
     torch.profiler's host<->device copies of a warm proof: one each way),
     every kernel of the path launched (kernels I and J among them, the
     staged grind's permute not), the library launches printed; the ZK leaf
     of [zk] in host rng (its fixture) and device rng (accepted, equal to
     the staged device-rng proof of the seed); warm fused and staged leaf
     proofs in turns, their ms, the fused proof's busy share and host split
     (`_last_prove_timings`) beside the card; `[fused batch]`, the JAX
     package's default batch and stream (plonk/prover_fused.py::
     prove_fused_batch, prove_fused_stream) through `prove_batch`'s and
     `prove_stream`'s dispatch: the two real spends at K = 1, 4, 16, 17, 33
     and a 48-stream in chunks of 16, each proof its fixture and accepted,
     one upload and one download a batch (a chunk), the fused batch's
     launch limits (kernel I once a segment and kernel J once a batch for
     all K), a K = 4 host-rng ZK leaf batch equal to the staged batch of
     its seed, ms a proof of the fused batch, the stream, the staged batch
     and the single fused proof in turns; then the canonical N = 2
     private batch of [aggregation] after warmup_fused(..., rng_mode="host")
     in host rng, byte-equal to canonical_private_batch.bin, beside the
     staged proof's seconds. Kernels I (csrc/transcript.cu, the leaf's
     whole transcript schedule) and J (a 16-bit grind, and one stopped at
     its limit) and their batch forms (the leaf's schedule over 16 and 17
     transcripts, 16 and 17 grinds at 16 bits, one witness past 2^17, and
     a limit between the witnesses) are held to their plain versions in
     the kernel phase;
 14. service — the miner's path at the canonical sizes on those circuits:
     four real spends of one block proven as one fused batch (K = 4), folded into
     two private batches, `PublicBatchAggregator.from_binaries_dir` over
     their artifact set (warm start; an `aot/` subdirectory left inert),
     both pushed into one bucket (a verify each), a duplicate and a dummy
     refused, the bucket aggregated into a public batch, verified and bound
     to the service's address, refused under another; each step's seconds;
 15. mesh — the device mesh on D shards of the one card (parallel/mesh.py,
     the counterpart of the JAX package's virtual devices), on the circuits
     of [main], [zk] and [aggregation], each run with the counts at 0: the
     leaf's three commits tensor-parallel at D = 2, 4, 8 (byte-equal to the
     fixture, accepted, kernel 3's and the trees' launches at most D times
     the single proof's, the rest equal); the ZK leaf at D = 4 in host rng
     (the fixture) and device rng (the single-card device-rng proof of its
     seed, accepted); the canonical N = 2 private batch at D = 4, host rng
     (the JAX fixture); `sharded_prove_batch` of 16 leaves over a (4, 1)
     mesh (each the fixture and prove_batch's); `ntt_sharded` at 2^20 and
     2^24 over D = 2, 4, 8 both ways (kernel 3's single NTT, the round
     trip), timed; `sharded_batch_commit` on (16, 135, 256) over (2, 2)
     (`commit_batch`); `tools/dryrun_multichip.py` on 4 shards, whose run
     gives kernel H's two rows (csrc/shard.cu, checked in the kernel phase
     at every shard's block of those NTTs) their launches; with two cards
     or more, one shard a card (the leaf, the device-rng ZK leaf, a dp
     batch, the 2^24 NTT, the dryrun), else a line that says that part did
     not run;
 16. tools — the port's host tools as a user runs them, each in a process of
     its own: `tools/memprof.py --canonical --num-leaf-proofs 2 --json`
     (each phase's seconds, RSS peak and the card's allocation peak),
     `tools/circuit_builder_cli.py` into a temporary directory (the leaf's
     artifacts, loaded back with their pins, the dummy proof accepted), and
     in this process the sweep report's anchors section
     (`tools/sweep_shapes.py`) from that memprof output (the card named, the
     device peak beside the estimate, no TPU figure).

Then one JSON line with every kernel's numbers, and last the result line
{"ok": true, "device": {...}}. Any failure raises: the exit code is non-zero
and the result line is not printed.
"""

from __future__ import annotations

import functools
import gc
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "torch_fixtures" / "leaf_proof_inputs0.bin"
FIXTURE_META = ROOT / "tests" / "torch_fixtures" / "fixtures.json"
ZK_FIXTURE = ROOT / "tests" / "torch_fixtures" / "leaf_zk_proof_inputs0.bin"
ZK_SEED = 7

# H100 SXM peaks: HBM 3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
# cores = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz. Hopper has 64 INT32
# lanes an SM, so the 32-bit integer peak is 132 x 64 x 1.98 GHz = 16.7 T op/s.
HBM_BYTES_PER_S = 3.35e12
# the card's host link, PCIe Gen5 x16: 128 GB/s both ways (NVIDIA's H100 SXM
# data sheet), 64 GB/s each way; kernel F writes its rows across it
HOST_LINK_BYTES_PER_S = 64e9
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
# the dependent field multiplies of one permutation, the least the function
# needs: an S-box is 3 deep (x^2; x^3 and x^4 from it; x^7), the 8 external
# rounds' 12 S-boxes side by side, and each of the 22 internal rounds adds
# its multiply-and-reduce after its one S-box. A dependent multiply takes 71
# SM cycles on an NVIDIA H100 80GB HBM3, 700.00 W (tools/field_latency.py,
# PERF.md), at the 1.98 GHz of INT32_OPS_PER_S. Kernel I's bound: its
# permutations in series, each this chain
PERM_CHAIN = 8 * 3 + 22 * 4
MUL_LATENCY_CYCLES = 71
SM_CLOCK_HZ = 1.98e9
# multiplies of one Fermat inverse a^(p-2): 64 squarings and one multiply
# per set bit of p - 2
INV_MULS = 64 + bin((1 << 64) - (1 << 32) - 1).count("1")
# integer instructions of one Philox4x64-10 block (kernel G, two felts), by
# the pipe that runs them. Round 1 multiplies the counter (b, 0, 0, 0), b
# below 2^32 (the kernel's indices are 32-bit): one half-width product of
# two 32x32->64 partials; round 2's M0 * key is the same for every block of
# a launch; the other 17 64x64->128 products take four partials each
# (IMAD.WIDE, which Hopper runs on its FMA pipe) and a carry add (either
# pipe). On the ALU pipe: the xors (a LOP3 a 32-bit half: one in round 1,
# four in round 2, eight in each of rounds 3-10) and the two felts' selects
# (a 64-bit compare of each word, a 64-bit subtract and a select: 8 a
# felt). The key schedule is the same for every block. `[rand 2^16]` prints
# the compiled count from `tools/sass_mix.py` (the first form, one thread
# a block and a division a felt: 79 IMAD.WIDE(.X), 20 IMAD.X and 42 LOP3
# among the 318 instructions of its loop). The bound takes IMAD.WIDE at the pipe's full rate; the H100 issues
# it at about half of that (`tools/int_rate.py`; PERF.md has the reading).
PHILOX_BLOCK_IMAD = 2 + 17 * 4
PHILOX_BLOCK_ALU = 1 + 4 + 8 * 4 + 2 * 8
PHILOX_BLOCK_EITHER = 17
# The FMA and ALU pipes each take 64 lanes an SM a clock, at the same time,
# and 128 lanes an SM are dispatched a clock: a block takes at least the busier
# pipe's instructions (the carries placed where they balance) or half of
# all, in INT32_OPS_PER_S slots
PHILOX_BLOCK_OPS = max(PHILOX_BLOCK_IMAD, PHILOX_BLOCK_ALU,
                       (PHILOX_BLOCK_IMAD + PHILOX_BLOCK_ALU + PHILOX_BLOCK_EITHER) / 2)

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
    for tid, p0, p1, _p2, sel, *_ in desc.tolist():
        m, a = per_row[tid](p0, p1)
        muls, adds = muls + m, adds + a
        if sel >= 0 and (m or a):  # the selector masks each challenge's gate sum
            muls += nc
    muls += nc * k_total + nc  # alpha terms, 1/Z_H
    adds += nc * k_total  # alpha sums
    return muls, adds


def fri_field_ops(m: int, terms: int, batches: int) -> tuple[int, int]:
    """Field multiplies and adds of kernel C's function over m points: two
    of each a term and point (alpha^k times a base value, then the sum); a
    batch's c_b and x - z subtractions, the norm, three multiplies a point of
    a batch inverse, the conjugate times the norm's inverse, the extension
    product and the sum over batches; one Fermat inverse per batch; and once,
    alpha^k and alpha^k y_k (two extension products a term) and their sums."""
    per_point_muls = 2 * terms + batches * (3 + 3 + 2 + 5)
    per_point_adds = 2 * terms + batches * (2 + 1 + 1 + 2 + 2)
    return (m * per_point_muls + batches * INV_MULS + terms * 2 * 5,
            m * per_point_adds + terms * (2 * 2 + 2))


def openings_work(rows: int, out_rows: int, n: int) -> tuple[int, int]:
    """Kernel D's bytes and integer operations: each of the `rows`
    coefficient rows of n read once (the g * zeta rows are rows of an oracle
    read at zeta), the (out_rows, 2) result written; two multiplies and two
    adds a coefficient of each output row; the powers of the two points, one
    extension product each."""
    return ((rows * n + 2 * out_rows) * 8,
            out_rows * n * 2 * (OPS_MUL + OPS_ADD) + 2 * n * (5 * OPS_MUL + 2 * OPS_ADD))


def fold_work(m: int, a_bits: int) -> tuple[int, int]:
    """Kernel E's bytes and integer operations for a round of arity 2^a over
    m values: the layer read, the m' = m >> a folded values written; a binary
    fold is e + o, e - o, the twiddle, beta, the sum and the halving (nine
    multiplies, eight adds), m - m' outputs over the a folds. No twiddle
    table: the function needs none."""
    mp = m >> a_bits
    return (2 * m + 2 * mp) * 8, (m - mp) * (9 * OPS_MUL + 8 * OPS_ADD)


def gather_work(queries: int, width: int) -> tuple[int, int, int]:
    """Kernel F's bytes: each query's packed row of `width` values read from
    the card's memory and written across the host link into pinned host
    memory (the query indices ride in the kernel's parameters)."""
    return queries * width * 8, 0, queries * width * 8


def rand_felts_work(count: int) -> tuple[int, int]:
    """Kernel G's bytes and integer operations for `count` felts: each felt
    written once (nothing is read), a Philox block a pair at the busier
    pipe's count (`PHILOX_BLOCK_OPS`)."""
    return count * 8, -(-count // 2) * PHILOX_BLOCK_OPS


def leaf_oracle_rows(data) -> list[int]:
    """Row counts of the leaf's four committed oracles: constants and
    sigmas, wires, Z and partial products, quotient chunks."""
    cfg = data.config
    nc, qdf = cfg.num_challenges, cfg.max_quotient_degree_factor
    npp = -(-cfg.num_routed_wires // qdf) - 1
    return [data.constants_oracle.lde.shape[0], cfg.num_wires, nc + nc * npp, nc * qdf]


def fri_rounds(data, degree_bits: int) -> list[tuple[int, int, int]]:
    """(log m, arity bits, next arity bits) of each FRI round of a proof of
    2^degree_bits rows with `data`'s config (next 0 after the last: natural
    order)."""
    cfg = data.config
    schedule = cfg.fri_config.reduction_strategy.schedule(degree_bits)
    out, bits = [], degree_bits + cfg.rate_bits
    for r, a in enumerate(schedule):
        out.append((bits, a, schedule[r + 1] if r + 1 < len(schedule) else 0))
        bits -= a
    return out


def tree_perms(rows: int, cols: int, cap: int) -> int:
    """Permutations of a Merkle tree: ceil(cols / 8) a row (none when the rows
    are at most a digest wide), and one a node above the leaves, down to the
    cap of 2^cap."""
    per_row = 0 if cols <= 4 else -(-cols // 8)
    return rows * per_row + rows - (1 << cap)


def ntt_work(cols: int, n_in: int, log_n: int, shift: bool = False,
             inverse: bool = False, out_shift: bool = False) -> tuple[int, int]:
    """Kernel 3's bytes and integer operations for C columns of n_in inputs
    to N = 2^log_n points: each input read and each output written once; a
    butterfly (a multiply, an add, a sub) for each of N / 2 pairs in each
    stage that combines nonzero values (log N - r stages when the inputs
    past N >> r are zero padding: the first r stages only copy); the shift's
    multiply an input and the scale's or unshift's an output."""
    n = 1 << log_n
    stages = min(log_n, (n_in - 1).bit_length())
    muls = (n // 2) * stages + (n_in if shift else 0) + (n if inverse or out_shift else 0)
    adds = (n // 2) * stages * 2
    return cols * (n_in + n) * 8, cols * (muls * OPS_MUL + adds * OPS_ADD)


def _sum_work(parts) -> tuple[int, int, int]:
    """(bytes, operations, host-link bytes) summed over works of two or
    three entries."""
    return tuple(sum((*w, 0)[i] for w in parts) for i in range(3))


def tree_work(rows: int, cols: int, cap: int) -> tuple[int, int]:
    """Kernel 2's tree of `rows` leaf rows of `cols` felts to a cap of
    2^cap: the rows read once, every digest from the leaves' to the cap's
    written once, `tree_perms` permutations."""
    nodes = sum(rows >> lvl for lvl in range(rows.bit_length() - cap))
    return ((rows * cols + nodes * 4) * 8,
            tree_perms(rows, cols, cap) * (PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD))


def commit_work(cols: int, n: int, rate_bits: int, cap: int,
                from_values: bool) -> tuple[int, int, int]:
    """An oracle commit of C polynomials of n values (or coefficients): the
    iNTT from values, the coset LDE to n << rate_bits, the tree
    (`ntt_work`, `tree_work`)."""
    log_n = n.bit_length() - 1
    parts = [ntt_work(cols, n, log_n + rate_bits, shift=True),
             tree_work(n << rate_bits, cols, cap)]
    if from_values:
        parts.append(ntt_work(cols, n, log_n, inverse=True))
    return _sum_work(parts)


def leaf_commits_work(data) -> tuple[int, int, int]:
    """A leaf proof's three commits: wires and Z with the partial products
    from values, the quotient chunks from coefficients (the
    preprocessed oracle is the circuit's)."""
    cfg = data.config
    _, wires, zpp, quot = leaf_oracle_rows(data)
    cap = cfg.fri_config.cap_height
    return _sum_work([commit_work(wires, data.n, cfg.rate_bits, cap, True),
                      commit_work(zpp, data.n, cfg.rate_bits, cap, True),
                      commit_work(quot, data.n, cfg.rate_bits, cap, False)])


def leaf_proof_work(data, pow_witness) -> tuple[int, int, int]:
    """The device work of one leaf proof, kernel by kernel at its shapes:
    the commits, kernel B, kernel A, the quotient's coset iNTT, kernel D's
    openings, kernel C's composition, each FRI round's tree and fold, the
    final polynomial's iNTT, the grind's pow_witness + 1 permutations (the
    lowest passing witness: the candidates this proof needed) and kernel
    F's rows to the host."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk.proof import fri_instance

    cfg = data.config
    nc, cap = cfg.num_challenges, cfg.fri_config.cap_height
    m = data.n << cfg.rate_bits
    lde_bits = data.degree_bits + cfg.rate_bits
    rows = sum(leaf_oracle_rows(data))
    point = np.array([3, 5], dtype=np.uint64)  # the shapes only
    parts = [leaf_commits_work(data), _permutation_work(data), _quotient_work(data),
             ntt_work(nc, m, lde_bits, inverse=True, out_shift=True),
             openings_work(rows, rows + nc, data.n),
             _composition_work(fri_instance(data, point, point), m)]
    width = rows + 4 * (lde_bits - cap) * 4
    final_bits = lde_bits
    for log_m, a, _ in fri_rounds(data, data.degree_bits):
        cap_r = min(cap, log_m - a)
        parts += [tree_work(1 << (log_m - a), 2 << a, cap_r), fold_work(1 << log_m, a)]
        width += (2 << a) + (log_m - a - cap_r) * 4
        final_bits -= a
    grind = int(pow_witness) + 1
    parts += [ntt_work(2, 1 << final_bits, final_bits, inverse=True, out_shift=True),
              (2 * grind * 12 * 8, grind * (PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD)),
              gather_work(cfg.fri_config.num_query_rounds, width)]
    return _sum_work(parts)


def _bound(work) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of (bytes, integer operations[,
    bytes across the host link]): the bytes' time is the larger of the
    card's memory's and the host link's."""
    work_bytes, ops, host_bytes = (*work, 0)[:3]
    moved = max(work_bytes / HBM_BYTES_PER_S, host_bytes / HOST_LINK_BYTES_PER_S)
    by = "bytes" if moved >= ops / INT32_OPS_PER_S else "operations"
    return 1e3 * max(moved, ops / INT32_OPS_PER_S), by


def _ntt_cases(device, rng, coeffs, quot):
    """Kernel 3's calls to check: the leaf proof's shapes (the iNTTs of
    135 x 256 and 20 x 256, the LDEs of 135, 20 and 16 x 256 -> 2048, the
    coset iNTT of 2 x 2048, the final polynomial's 2 x 256 with its
    unshift) and a forward 135 x 256; then all four modes (forward,
    inverse, the LDE of 2^(log_n - 3) inputs with the shift, inverse with
    the unshift) on 3 columns at 2^12 (one pass) and 2^13, 2^14 (two)."""
    from qp_zk_circuits_tpu_torch.field import gf_np as F

    unshift = int(F.inv(F.MULTIPLICATIVE_GROUP_GENERATOR))
    lde_bits = quot.shape[1].bit_length() - 1
    cases = [(coeffs, 8, dict(inverse=True)), (coeffs[:20], 8, dict(inverse=True)),
             (coeffs, lde_bits, dict(shift=7)), (coeffs[:20], lde_bits, dict(shift=7)),
             (coeffs[:16], lde_bits, dict(shift=7)),
             (quot, lde_bits, dict(inverse=True, out_shift=unshift)),
             (quot[:, :256], 8, dict(inverse=True, out_shift=unshift)), (coeffs, 8, {})]
    for log_n in (12, 13, 14):
        x = _felts((3, 1 << log_n), rng, device)
        cases += [(x, log_n, {}), (x, log_n, dict(inverse=True)),
                  (x[:, : 1 << (log_n - 3)], log_n, dict(shift=7)),
                  (x, log_n, dict(inverse=True, out_shift=unshift))]
    return cases


def _ntt_grouped_cases(device, rng):
    """Kernel 3's grouped output, as a salted batch's commit writes it: G
    proofs' C columns each into the first C rows of its (C + 4, N) part of
    a (G, C + 4, N) buffer, the 4 salt rows between the groups left as they
    were. At the K = 16 ZK leaf batch's LDE (16 x 135 x 512 -> 4096, the
    one-pass coset path), and on 3 groups of 5 columns a forward 2^12 (one
    pass), a forward 2^13 and an LDE 2^11 -> 2^14 (two passes). Each
    against the plain version run on the card, the salt rows against their
    values before the call; one launch a pass."""
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.poly import ntt

    g = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    got, want = [], []
    for k, c, log_n, n_in, shift, passes in (
            (BATCH_K, ZK_LEAF_WIRES, 12, ZK_LEAF_N, g, 1), (3, 5, 12, 1 << 12, None, 1),
            (3, 5, 13, 1 << 13, None, 2), (3, 5, 14, 1 << 11, g, 2)):
        x = _felts((k * c, n_in), rng, device)
        buf = _felts((k, c + 4, 1 << log_n), rng, device)
        salt = buf[:, c:].clone()
        before = ntt.batched_ntt.launches
        if ntt.batched_ntt(x, log_n, shift=shift, out=buf[:, :c]).data_ptr() != buf.data_ptr():
            raise AssertionError("kernel 3 did not write into the grouped buffer")
        if ntt.batched_ntt.launches != before + passes:
            raise AssertionError(f"kernel 3's grouped 2^{log_n} took other than {passes} launches")
        got += [buf[:, :c], buf[:, c:]]
        want += [ntt.batched_ntt_plain(x, log_n, shift=shift).view(k, c, -1), salt]
    return got, want


def _tree_cases(device, rng, wires_rows, cap):
    """Trees against the plain version: the four of a leaf proof, wires (135
    columns), Z and partial products (20), quotient (16), each over a strided
    lde.T, and the FRI layer's contiguous (256, 16) rows; the ZK leaf's
    salted wires (139) and Z or quotient (20) over 4096 rows; then the
    plans' edges, rows of 4, 5 and 135 felts (4: unhashed) over 16 and 256 leaves to
    caps of 2^0, 2^2 and the leaves themselves (no level above them)."""
    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps

    m = wires_rows.shape[0]
    cases = [(wires_rows, cap), (_felts((20, m), rng, device).T, cap),
             (_felts((16, m), rng, device).T, cap), (_felts((m >> 3, 16), rng, device), cap)]
    # the ZK leaf's salted oracles: 135 wires and 16 Z, partial-product or
    # quotient rows, each with its 4 salt rows, over 4096 points
    cases += [(_felts((rows, 2 * m), rng, device).T, cap) for rows in (139, 20)]
    cases += [(_felts((n, cols), rng, device), c) for cols in (4, 5, 135) for n in (16, 256)
              for c in (0, 2, n.bit_length() - 1)]
    got, want = [], []
    for x, c in cases:
        got += ps.merkle_levels(x, c)
        want += ps.merkle_levels_plain(x, c)
    return got, want


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    # the package is imported only once a card is there
    from qp_zk_circuits_tpu_torch.tools.timing import card

    smi = card()
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


def _fixture_verifier_data(data):
    """The leaf's VerifierCircuitData: a shape-only build's layout with the
    committed fixture's constants cap and circuit digest."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData

    meta = json.loads(FIXTURE_META.read_text())[FIXTURE.name]
    return VerifierCircuitData(
        data.config, data.degree_bits, list(data.gate_types), data.num_selectors,
        data.const_cols.shape[0], np.array(meta["constants_cap"], dtype=np.uint64),
        np.array(meta["circuit_digest"], dtype=np.uint64), len(data.public_input_targets))


def _spy(owner, attr, calls):
    """Replace owner.attr by a wrapper that records each call's arguments;
    returns the undo."""
    fn = getattr(owner, attr)

    def inner(*args):
        calls.append(args)
        return fn(*args)

    setattr(owner, attr, inner)
    return lambda: setattr(owner, attr, fn)


def _outcome(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class and message are compared
        return f"{type(e).__name__}: {e}"
    return "accepted"


def phase_host() -> None:
    """Build the host library (native/*.c, the system C compiler) and hold
    each compiled function against its Python form on this host, at the
    leaf's shapes, bit-exact: a transcript duplex, a Poseidon2 gate row,
    the sponge over each oracle's row width and a FRI leaf, a 2-to-1, a
    Merkle path of the leaf's depth, an absorb of the leaf's openings, the
    leaf's witness (the tape against the Python replay), and the leaf
    fixture's vanishing check (tape) and FRI query rounds, accepted and
    rejected alike; medians on the host clock."""
    import numpy as np

    from qp_zk_circuits_tpu_torch import native as nat
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.fri import verifier as fv
    from qp_zk_circuits_tpu_torch.hash import merkle
    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps
    from qp_zk_circuits_tpu_torch.plonk import builder, prover, witness_tape
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts
    from qp_zk_circuits_tpu_torch.plonk import verifier as pv
    from qp_zk_circuits_tpu_torch.plonk.gates import Poseidon2Gate
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes
    from qp_zk_circuits_tpu_torch.wormhole import leaf_circuit
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import test_inputs_0

    t0 = time.time()
    so = nat.build()
    nat.lib()
    print(f"[host] {so.name} built by cc in {time.time() - t0:.1f} s; flags: {nat.flags()}",
          flush=True)
    rng = np.random.default_rng(9)
    circuit = leaf_circuit.WormholeCircuit()
    data = circuit.build(shape_only=True)
    cfg = data.config

    def same(a, b) -> bool:
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return np.array_equal(np.asarray(a), np.asarray(b))

    def check(name, fast, pure, runs=50, pure_runs=5):
        if not same(fast(), pure()):
            raise AssertionError(f"[host] {name}: the C library and its Python form differ")
        c_ms = _host_median_ms(fast, runs)
        py_ms = _host_median_ms(pure, pure_runs)
        print(f"[host] {name}: bit-exact; C {c_ms:.4f} ms, Python {py_ms:.3f} ms", flush=True)

    state = F.rand_felts(12, rng)
    check("permute, one state (a transcript duplex)",
          lambda: ps.permute_np(state), lambda: ps._permute_scalar_pure(state))
    gate_in = F.rand_felts(12, rng)

    def fill(fn):
        out = {}
        fn(lambda c: int(gate_in[c]) if c < 12 else 0, out.__setitem__)
        return out

    check("permute trace (a Poseidon2 gate row)", lambda: fill(Poseidon2Gate().fill_row),
          lambda: fill(Poseidon2Gate()._fill_row_pure))
    nc, qdf = cfg.num_challenges, cfg.max_quotient_degree_factor
    npp = -(-cfg.num_routed_wires // qdf) - 1
    arity = 1 << cfg.fri_config.reduction_strategy.schedule(data.degree_bits)[0]
    for what, width in (("constants and sigmas", data.num_preprocessed), ("wires", cfg.num_wires),
                        ("Z and partial products", nc + nc * npp), ("quotient", nc * qdf),
                        ("FRI leaf", 2 * arity)):
        row = F.rand_felts(width, rng)
        check(f"sponge over a {what} row ({width} felts)", lambda row=row: ps.hash_no_pad(row),
              lambda row=row: ps._hash_no_pad_pure(row))
    left, right = F.rand_felts(4, rng), F.rand_felts(4, rng)
    check("2-to-1", lambda: ps.two_to_one_np(left, right), lambda: ps._two_to_one_pure(left, right))
    levels = data.degree_bits + cfg.fri_config.rate_bits - cfg.fri_config.cap_height
    leaf, sibs = F.rand_felts(4, rng), F.rand_felts((levels, 4), rng)
    check(f"Merkle walk of {levels} levels",
          lambda: merkle.merkle_root_from_proof(leaf, 77, sibs),
          lambda: merkle._merkle_root_from_proof_pure(leaf, 77, sibs))
    felts = F.rand_felts(2 * (data.num_preprocessed + cfg.num_wires + 2 * nc + nc * npp + nc * qdf),
                         rng)

    def absorb(per_felt):
        ch = ts.Challenger()
        ch.observe(np.uint64(5))
        if per_felt:
            for f in felts:
                ch.observe(f)
        else:
            ch.observe_many(felts)
        return ch.state, ch.input_buf, ch.output_buf, ch.challenge()

    check(f"absorb of {felts.size} felts (the openings)", lambda: absorb(False),
          lambda: absorb(True))

    def witness_pw():
        pw = builder.PartialWitness()
        leaf_circuit.fill_witness(pw, test_inputs_0(), circuit.targets)
        return pw

    t = time.perf_counter()
    builder.witness_root_values(data, witness_pw())  # records the program
    record_ms = 1e3 * (time.perf_counter() - t)

    def replay():
        arr = np.zeros(data.num_targets, dtype=np.uint64)
        for r, v in builder.run_generators(data, witness_pw()).items():
            arr[r] = v
        return arr

    tapes = nat.counts["wt_run"]
    check("leaf witness (tape against the Python replay)",
          lambda: builder.witness_root_values(data, witness_pw()), replay, runs=20, pure_runs=3)
    if nat.counts["wt_run"] <= tapes:
        raise AssertionError("[host] the leaf's witness did not run the tape")
    print(f"[host] the leaf's first witness (records the program) {record_ms:.2f} ms", flush=True)

    vdata = _fixture_verifier_data(data)
    blob = FIXTURE.read_bytes()
    vanishing, rounds = [], []
    undo = [_spy(pv, "verify_vanishing_at_zeta", vanishing), _spy(fv, "_query_rounds", rounds)]
    try:
        t = time.perf_counter()
        pv.verify(vdata, proof_from_bytes(blob))
        first_ms = 1e3 * (time.perf_counter() - t)
    finally:
        for u in undo:
            u()
    print(f"[host] the fixture's first verify (records the constraint tape) {first_ms:.2f} ms",
          flush=True)
    args = vanishing[0]
    check("vanishing check (constraint tape), fixture", lambda: prover.verify_vanishing_at_zeta(*args),
          lambda: prover._verify_vanishing_pure(*args), runs=20, pure_runs=3)
    bad_openings = proof_from_bytes(blob).openings
    bad_openings.wires = np.array(bad_openings.wires, dtype=np.uint64)
    bad_openings.wires[0, 1] = (int(bad_openings.wires[0, 1]) + 1) % F.P
    bad = (args[0], bad_openings, *args[2:])
    if prover.verify_vanishing_at_zeta(*bad) or prover._verify_vanishing_pure(*bad):
        raise AssertionError("[host] a changed opening passed the vanishing check")
    qargs = rounds[0]
    check("FRI query rounds, fixture (Python: the loop)", lambda: _outcome(lambda: fv._query_rounds(*qargs)),
          lambda: _outcome(lambda: fv._query_rounds_pure(*qargs)), runs=20, pure_runs=3)
    proof = proof_from_bytes(blob)
    step = proof.fri_proof.query_rounds[3].steps[0]
    step.leaf_values = np.array(step.leaf_values, dtype=np.uint64)
    step.leaf_values[1, 0] = (int(step.leaf_values[1, 0]) + 1) % F.P
    tampered = (*qargs[:4], proof.fri_proof, *qargs[5:])
    got = _outcome(lambda: fv._query_rounds(*tampered))
    want = _outcome(lambda: fv._query_rounds_pure(*tampered))
    if want == "accepted" or got != f"{want} (query round 3)":
        raise AssertionError(f"[host] a changed FRI leaf: C {got!r}, Python {want!r}")
    print(f"[host] a changed FRI leaf value: C and Python reject it ({got})", flush=True)

    # the batch path's host calls, K = 16 at once against 16 single calls:
    # the transcripts' absorb (the openings) and duplex, and the leaf's tape
    k = 16
    states, bufs = F.rand_felts((k, 12), rng), F.rand_felts((k, 3), rng)
    rows = F.rand_felts((k, felts.size), rng)

    def versus(name, batched, singles, runs=20):
        if not same(batched(), singles()):
            raise AssertionError(f"[host] {name}: one call over {k} differs from {k} calls")
        one, many = _host_median_ms(batched, runs), _host_median_ms(singles, runs)
        print(f"[host] {name}: bit-exact; one call over {k} {one:.4f} ms, {k} single calls "
              f"{many:.4f} ms (OpenMP over the {k}, flags above)", flush=True)

    def absorbs():
        out = [nat.absorb_many(states[i], list(bufs[i]), rows[i]) for i in range(k)]
        return np.stack([st for st, _ in out]), np.array([b for _, b in out], dtype=np.uint64)

    def duplexes():
        x = states.copy()
        x[:, :3] = bufs
        return np.stack([ps.permute_np(row) for row in x])

    versus(f"absorb of {felts.size} felts, {k} transcripts",
           lambda: nat.absorb_batch(states, bufs, rows), absorbs)
    versus(f"duplex, {k} transcripts", lambda: nat.duplex_batch(states, bufs), duplexes)
    pws = [witness_pw() for _ in range(k)]
    versus(f"leaf witness tape, {k} witnesses", lambda: witness_tape.run_tape_many(data, pws),
           lambda: [witness_tape.run_tape(data, pw) for pw in pws], runs=5)


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
    from qp_zk_circuits_tpu_torch.field import random as frandom
    from qp_zk_circuits_tpu_torch.fri import oracle as fo
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts
    from qp_zk_circuits_tpu_torch.poly import ntt

    rng = np.random.default_rng(0)
    wires, lde_bits, rate, cap = 135, 11, 3, 4
    m = 1 << lde_bits
    a = _felts((wires, m), rng, device)
    b = _felts((wires, m), rng, device)
    ea, eb = _edge_pairs(device)
    a.view(-1)[: ea.numel()] = ea
    b.view(-1)[: eb.numel()] = eb
    n_el = a.numel()
    grind = _felts((1 << 17, ps.WIDTH), rng, device)
    lde = _felts((wires, m), rng, device)
    lde.view(-1)[: ea.numel()] = ea
    rows = lde.T  # the leaf matrix as the commit hashes it: strided rows
    level = _felts((m, ps.DIGEST_LEN), rng, device)
    level.view(-1)[: ea.numel()] = ea
    # batches that are not a multiple of a block, led by the edge values
    odd_states = _felts((1029, ps.WIDTH), rng, device)
    odd_states.view(-1)[: ea.numel()] = ea
    odd_rows = _felts((wires, 2051), rng, device)
    odd_rows.view(-1)[: ea.numel()] = ea
    odd_rows = odd_rows.T
    coeffs = _felts((wires, m >> rate), rng, device)
    quot = _felts((2, m), rng, device)  # the quotient's nc rows
    perms_per_row = -(-wires // ps.RATE)
    perm_ops = PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD
    ew_bytes = 3 * 8 * n_el

    def cases(fn, plain, *args):
        """Each argument tuple through the wrapper and the plain version."""
        return [fn(*a) for a in args], [plain(*a) for a in args]

    def pairs(x):
        return (x[0::2], x[1::2])

    return [
        dict(name="goldilocks_add", wrapper=gl.add, path=False, kernel1=True, source="qp_zk_circuits_tpu_torch/csrc/field_kernels.cu",
             replaces="qp_zk_circuits_tpu/field/goldilocks.py:137",
             run=lambda: gl.add(a, b), plain=lambda: gl.add_plain(a, b),
             bytes=ew_bytes, ops=OPS_ADD * n_el),
        dict(name="goldilocks_sub", wrapper=gl.sub, path=False, kernel1=True, source="qp_zk_circuits_tpu_torch/csrc/field_kernels.cu",
             replaces="qp_zk_circuits_tpu/field/goldilocks.py:145",
             run=lambda: gl.sub(a, b), plain=lambda: gl.sub_plain(a, b),
             bytes=ew_bytes, ops=OPS_ADD * n_el),
        dict(name="goldilocks_mul", wrapper=gl.mul, path=False, kernel1=True, source="qp_zk_circuits_tpu_torch/csrc/field_kernels.cu",
             replaces="qp_zk_circuits_tpu/ops/field_kernels.py:100",
             run=lambda: gl.mul(a, b), plain=lambda: gl.mul_plain(a, b),
             bytes=ew_bytes, ops=OPS_MUL * n_el),
        # the grind's 2^17 states, one thread a state; checked at 1029 states too
        dict(name="poseidon2_permute", wrapper=ps.permute, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/poseidon2.py:415",
             run=lambda: ps.permute(grind), plain=lambda: ps.permute_plain(grind),
             check=lambda: cases(ps.permute, ps.permute_plain, (grind,), (odd_states,)),
             bytes=2 * grind.numel() * 8, ops=grind.shape[0] * perm_ops),
        # lane-split, off the main path since the tree has its own entry;
        # checked at the wires' shape and at 2051 rows of 135 and of 4 felts
        dict(name="poseidon2_hash_rows", wrapper=ps.hash_rows, path=False, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/poseidon2.py:449",
             run=lambda: ps.hash_rows(rows), plain=lambda: ps.hash_rows_plain(rows),
             check=lambda: cases(ps.hash_rows, ps.hash_rows_plain, (rows,), (odd_rows,),
                                 (odd_rows[:, : ps.DIGEST_LEN],)),
             bytes=(rows.numel() + m * ps.DIGEST_LEN) * 8,
             ops=m * perms_per_row * perm_ops),
        dict(name="poseidon2_two_to_one", wrapper=ps.two_to_one, path=False, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/poseidon2.py:492",
             run=lambda: ps.two_to_one(*pairs(level)),
             plain=lambda: ps.two_to_one_plain(*pairs(level)),
             check=lambda: cases(ps.two_to_one, ps.two_to_one_plain, pairs(level),
                                 pairs(odd_states[:, : 2 * ps.DIGEST_LEN].reshape(-1, ps.DIGEST_LEN))),
             bytes=(level.numel() + level.numel() // 2) * 8,
             ops=(m // 2) * perm_ops),
        # the wires tree, 2048 x 135 to a cap of 16: the row sponges and the
        # levels; checked at the four trees of a leaf proof and the plans' edges
        dict(name="poseidon2_merkle_tree", wrapper=ps.merkle_levels, source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/hash/merkle.py:37",
             run=lambda: ps.merkle_levels(rows, cap), plain=lambda: ps.merkle_levels_plain(rows, cap),
             check=lambda: _tree_cases(device, rng, rows, cap),
             **dict(zip(("bytes", "ops"), tree_work(m, wires, cap)))),
        # timed at the leaf LDE (135 x 256 -> 2048); checked at the leaf
        # proof's shapes and in all four modes on both sides of the one-pass
        # limit, with grouped outputs at the ZK batch's salted LDE buffer
        # (and at 2^19 in phase_aggregation_ntt)
        dict(name="ntt", wrapper=ntt.batched_ntt, source="qp_zk_circuits_tpu_torch/csrc/ntt.cu",
             replaces="qp_zk_circuits_tpu/poly/ntt.py:132",
             run=lambda: ntt.batched_ntt(coeffs, lde_bits, shift=7),
             plain=lambda: ntt.batched_ntt_plain(coeffs, lde_bits, shift=7),
             check=lambda: tuple(a + b for a, b in zip(
                 cases(ntt.batched_ntt, ntt.batched_ntt_plain, *(
                     (x, log_n, kw.get("inverse", False), kw.get("shift"), kw.get("out_shift"))
                     for x, log_n, kw in _ntt_cases(device, rng, coeffs, quot))),
                 _ntt_grouped_cases(device, rng))),
             **dict(zip(("bytes", "ops"), ntt_work(wires, m >> rate, lde_bits, shift=True)))),
        dict(name="quotient", wrapper=tprover.quotient_evals,
             source="qp_zk_circuits_tpu_torch/csrc/quotient.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover.py:114",
             setup=lambda: _quotient_case(device)),
        dict(name="permutation_polys", wrapper=tprover.compute_permutation_polys,
             source="qp_zk_circuits_tpu_torch/csrc/permutation.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:581",
             setup=lambda: _permutation_case(device)),
        dict(name="fri_composition", wrapper=fri.compute_composition,
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/fri/prover.py:184",
             setup=lambda: _composition_case(device)),
        dict(name="eval_openings", wrapper=fo.eval_openings,
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/fri/oracle.py:187",
             setup=lambda: _openings_case(device)),
        dict(name="fri_fold", wrapper=fri.fold_round,
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/fri/prover.py:122",
             setup=lambda: _fold_case(device)),
        dict(name="query_gather", wrapper=fri.query_gather,
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/fri/oracle.py:225",
             setup=lambda: _gather_case(device)),
        # the batch path's kernels (phase_batch reads their launches): a
        # proof axis in kernel 2's tree, A and B, at the K = 16 leaf batch
        dict(name="poseidon2_merkle_forest", wrapper=ps.merkle_forest, path="batch",
             source="qp_zk_circuits_tpu_torch/csrc/poseidon2.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _forest_case(device)),
        dict(name="quotient_batch", wrapper=tprover.quotient_evals_batch, path="batch",
             source="qp_zk_circuits_tpu_torch/csrc/quotient.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _quotient_batch_case(device)),
        dict(name="permutation_polys_batch", wrapper=tprover.compute_permutation_polys_batch,
             path="batch", source="qp_zk_circuits_tpu_torch/csrc/permutation.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _permutation_batch_case(device)),
        # the batch's FRI tail with a proof axis (the vmapped :655-790)
        dict(name="fri_composition_batch", wrapper=fri.compute_composition_batch, path="batch",
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _composition_batch_case(device)),
        dict(name="eval_openings_batch", wrapper=fo.eval_openings_batch, path="batch",
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _openings_batch_case(device)),
        dict(name="fri_fold_batch", wrapper=fri.fold_round_batch, path="batch",
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _fold_batch_case(device)),
        dict(name="query_gather_batch", wrapper=fri.query_gather_batch, path="batch",
             source="qp_zk_circuits_tpu_torch/csrc/fri.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _gather_batch_case(device)),
        # the ZK path's device-rng draws (phase_zk reads its launches)
        dict(name="rand_felts", wrapper=frandom.rand_felts, path="zk",
             source="qp_zk_circuits_tpu_torch/csrc/random.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:381",
             setup=lambda: _rand_felts_case(device)),
        # kernels I and J, the fused prover's transcript and grind on the
        # card (phase_fused reads their launches)
        dict(name="transcript", wrapper=ts.transcript_segment, path="fused",
             source="qp_zk_circuits_tpu_torch/csrc/transcript.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:67",
             setup=lambda: _transcript_case(device)),
        dict(name="grind", wrapper=ts.grind_device, path="fused",
             source="qp_zk_circuits_tpu_torch/csrc/transcript.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:296",
             setup=lambda: _grind_case(device)),
        # kernels I and J with a proof axis, the fused batch's transcripts
        # and grinds (phase_fused_batch reads their launches)
        dict(name="transcript_batch", wrapper=ts.transcript_segment_batch, path="fused_batch",
             source="qp_zk_circuits_tpu_torch/csrc/transcript.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _transcript_batch_case(device)),
        dict(name="grind_batch", wrapper=ts.grind_device_batch, path="fused_batch",
             source="qp_zk_circuits_tpu_torch/csrc/transcript.cu",
             replaces="qp_zk_circuits_tpu/plonk/prover_fused.py:1007",
             setup=lambda: _grind_batch_case(device)),
        # kernel H, the coefficient-sharded NTT's local steps (phase_mesh
        # reads their launches from the dryrun's run)
        dict(name="shard_deinterleave", wrapper=ntt.shard_deinterleave, path="mesh",
             source="qp_zk_circuits_tpu_torch/csrc/shard.cu",
             replaces="qp_zk_circuits_tpu/poly/ntt.py:197",
             setup=lambda: _shard_case(device, cross=False)),
        dict(name="shard_cross_ntt", wrapper=ntt.shard_cross_ntt, path="mesh",
             source="qp_zk_circuits_tpu_torch/csrc/shard.cu",
             replaces="qp_zk_circuits_tpu/poly/ntt.py:197",
             setup=lambda: _shard_case(device, cross=True)),
    ]


@functools.cache
def _leaf_data(device):
    """A leaf circuit of its own for the kernel checks, so the main path's
    prover starts with nothing cached."""
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    return WormholeProver(device=device).data


@functools.cache
def _zk_leaf_data(device):
    """The ZK leaf's circuit (the private batch's config) for the kernel
    checks, apart from the one phase_zk builds."""
    from qp_zk_circuits_tpu_torch.utils.config_policy import wormhole_private_batch_circuit_config
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver

    return WormholeProver(wormhole_private_batch_circuit_config(), device=device).data


def _cpu(xs):
    return [x.cpu() if hasattr(x, "cpu") else x for x in xs]


def _variant(data, **config):
    """The circuit data with its config changed (a fresh object: no tables
    cached), routing tables cut to the routed wires."""
    import dataclasses

    cfg = dataclasses.replace(data.config, **config)
    nr = cfg.num_routed_wires
    return dataclasses.replace(data, config=cfg, id_coords=data.id_coords[:nr],
                               sigma_vals=data.sigma_vals[:nr])


def _fused_variants(data) -> list:
    """The leaf with 1, 2 and 4 challenges, and the canonical ZK profile's
    routing (60 routed wires, qdf 8: a ragged last chunk of 4)."""
    return [data, _variant(data, num_challenges=1), _variant(data, num_challenges=4),
            _variant(data, num_routed_wires=60)]


def _quotient_args(data, rng, device):
    """Random LDE wires and Z/pp rows, random challenges and PI hash."""
    from qp_zk_circuits_tpu_torch.field import gf_np as F

    cfg = data.config
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    npp = -(-cfg.num_routed_wires // cfg.max_quotient_degree_factor) - 1
    return [_felts((cfg.num_wires, m), rng, device), _felts((nc + nc * npp, m), rng, device),
            *(F.rand_felts(nc, rng) for _ in range(3)), F.rand_felts(4, rng)]


def _quotient_rec(data, args, device) -> list:
    """Kernel A's single-wrapper arguments from `_quotient_args`: the LDEs,
    then the challenges and PI hash in one record on `device`."""
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    wires, zpp, alphas, betas, gammas, pi = args
    return [wires, zpp, tprover.host_records(device, 1, data.config.num_challenges,
                                             alphas=alphas, betas=betas, gammas=gammas,
                                             pis=pi)[0]]


def _quotient_work(data) -> tuple[int, int]:
    """Kernel A's bytes and integer operations: each input read once, the
    (nc, m) output written once; the field ops of `quotient_field_ops`."""
    cfg = data.config
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    npp = -(-cfg.num_routed_wires // cfg.max_quotient_degree_factor) - 1
    muls, adds = quotient_field_ops(data)
    rows = cfg.num_wires + data.constants_oracle.lde.shape[0] + nc + nc * npp + 3 + nc
    return rows * m * 8, m * (muls * OPS_MUL + adds * OPS_ADD)


def _permutation_work(data) -> tuple[int, int]:
    """Kernel B's bytes and integer operations. Per (row, challenge): beta
    times id_i and sigma_i with 2 adds each, the chunk products, one batch
    inverse across all rows (3 muls a chunk denominator), cn_j * cd_j^-1, and
    one multiply a ratio for the running products that give Z and the
    partial products; per challenge one Fermat inverse."""
    cfg = data.config
    nc, nr, n = cfg.num_challenges, cfg.num_routed_wires, data.n
    nchunks = -(-nr // cfg.max_quotient_degree_factor)
    muls = 2 * nr + 2 * (nr - nchunks) + 3 * nchunks + nchunks + nchunks
    return ((3 * nr * n + nc * nchunks * n) * 8,
            nc * ((n * muls + INV_MULS) * OPS_MUL + n * 4 * nr * OPS_ADD))


def _permutation_args(data, rng, device, zeros=()):
    """A random trace and random beta, gamma; each (challenge, row, wire) of
    `zeros` gets the wire value that makes its denominator factor 0."""
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl

    cfg = data.config
    nc = cfg.num_challenges
    trace = F.rand_felts((cfg.num_wires, data.n), rng)
    betas, gammas = F.rand_felts(nc, rng), F.rand_felts(nc, rng)
    for c, row, wire in zeros:
        trace[wire, row] = -(int(betas[c]) * int(data.sigma_vals[wire, row]) + int(gammas[c])) % gl.P
    return [gl.from_u64(trace, device), betas, gammas]


def _permutation_rec(data, args, device) -> list:
    """Kernel B's single-wrapper arguments from `_permutation_args`: the
    trace, then the betas and gammas in one record on `device`."""
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    trace, betas, gammas = args
    return [trace, tprover.host_records(device, 1, data.config.num_challenges, betas=betas,
                                        gammas=gammas)[0]]


def _quotient_case(device) -> dict:
    """Kernel A at the leaf: random LDE wires and Z/pp rows, the circuit's
    own constants, selectors and sigmas, random challenges; checked with 1, 2
    and 4 challenges and with the ragged last chunk of 60 routed wires."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    data = _leaf_data(device)
    rng = np.random.default_rng(1)
    cases = [(d, _quotient_rec(d, _quotient_args(d, rng, device), device))
             for d in _fused_variants(data)]
    args = cases[0][1]
    cpu_args = _cpu(args)
    work_bytes, ops = _quotient_work(data)
    return dict(
        run=lambda: tprover.quotient_evals(data, *args),
        plain=lambda: tprover.quotient_evals_plain(data, *cpu_args), plain_on_host=True,
        check=lambda: ([tprover.quotient_evals(d, *a) for d, a in cases],
                       [tprover.quotient_evals_plain(d, *_cpu(a)) for d, a in cases]),
        bytes=work_bytes, ops=ops,
    )


def _permutation_case(device) -> dict:
    """Kernel B at the leaf: a random trace and random beta, gamma (one tile
    of 256 rows); checked with 1, 2 and 4 challenges, 60 routed wires, and at
    1024 rows (four tiles) with zero denominators on both sides of a tile
    boundary (rows 255 and 256) and in the last row."""
    import dataclasses

    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    data = _leaf_data(device)
    rng = np.random.default_rng(2)
    rows = 4 * data.n
    four_tiles = dataclasses.replace(data, degree_bits=rows.bit_length() - 1,
                                     id_coords=np.tile(data.id_coords, 4),
                                     sigma_vals=np.tile(data.sigma_vals, 4))
    cases = [(d, _permutation_rec(d, _permutation_args(d, rng, device), device))
             for d in _fused_variants(data)]
    cases.append((four_tiles, _permutation_rec(four_tiles, _permutation_args(
        four_tiles, rng, device, zeros=[(0, 255, 3), (0, 256, 70), (1, 256, 0), (1, rows - 1, 9)]),
        device)))
    args = cases[0][1]
    cpu_args = _cpu(args)
    work_bytes, ops = _permutation_work(data)
    return dict(
        run=lambda: tprover.compute_permutation_polys(data, *args),
        plain=lambda: tprover.compute_permutation_polys_plain(data, *cpu_args),
        plain_on_host=True,
        check=lambda: ([tprover.compute_permutation_polys(d, *a) for d, a in cases],
                       [tprover.compute_permutation_polys_plain(d, *_cpu(a)) for d, a in cases]),
        bytes=work_bytes, ops=ops,
    )


#: the batch path's proofs a batch (chip_smoke's K), and the stream's length
BATCH_K = 16
STREAM_LEN = 48


def _forest_case(device) -> dict:
    """Kernel 2's forest at the K = 16 batch's wires commit: sixteen LDEs of
    135 x 2048 read as rows in place, each to a cap of 16; checked at K = 16
    and K = 17 (kernels A and B's cap plus one) against the plain version
    on the card, bit-exact."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps

    rng = np.random.default_rng(11)
    wires, m, cap = 135, 2048, 4
    k = BATCH_K
    stack = _felts((k + 1, wires, m), rng, device)

    def leaves(n):
        return stack[:n].transpose(1, 2)

    def flat(forest):
        return [lvl for tree in forest for lvl in tree]

    return dict(
        run=lambda: ps.merkle_forest(leaves(k), cap),
        plain=lambda: ps.merkle_forest_plain(leaves(k), cap),
        check=lambda: (flat(ps.merkle_forest(leaves(k), cap)) + flat(ps.merkle_forest(leaves(k + 1), cap)),
                       flat(ps.merkle_forest_plain(leaves(k), cap))
                       + flat(ps.merkle_forest_plain(leaves(k + 1), cap))),
        **dict(zip(("bytes", "ops"), (k * x for x in tree_work(m, wires, cap)))),
    )


def _stacked(per_proof, n, device=None):
    """The first n proofs' arguments stacked: tensors along a new first axis
    (moved to `device` when given), host felts as (n, ...) arrays."""
    import numpy as np
    import torch

    out = []
    for col in zip(*per_proof[:n]):
        if hasattr(col[0], "cpu"):
            t = torch.stack(col)
            out.append(t if device is None else t.to(device))
        else:
            out.append(np.stack(col))
    return out


def _quotient_batch_case(device) -> dict:
    """Kernel A with a proof axis at the leaf: K = 16 proofs' random LDE
    wires and Z/pp rows and their own challenges and PI hashes; checked at
    K = 16 (one launch pair) and K = 17 (two), and at the K = 16 ZK leaf
    batch's salted stacks, against the plain version run on CPU copies. Its work: each proof's operands and output once, the
    circuit's tables once, K times one proof's operations."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    import torch

    from qp_zk_circuits_tpu_torch.fri.config import SALT_SIZE

    data = _leaf_data(device)
    cfg = data.config
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    rng = np.random.default_rng(12)
    k = BATCH_K
    per = [_quotient_rec(data, _quotient_args(data, rng, device), device) for _ in range(k + 1)]
    args, args17 = _stacked(per, k), _stacked(per, k + 1)
    cpu, cpu17 = _stacked(per, k, "cpu"), _stacked(per, k + 1, "cpu")
    # the K = 16 ZK leaf batch: the stacked LDEs of the salted commits, (16,
    # 139, 4096) wires and (16, 20, 4096) Z/pp, each proof's salt rows after
    # its polynomials' (the prover passes these stacks whole)
    zk = _zk_leaf_data(device)
    zk_m = zk.n << zk.config.rate_bits
    zk_per = [_quotient_args(zk, rng, device) for _ in range(k)]
    for a in zk_per:
        a[:2] = [torch.cat([t, _felts((SALT_SIZE, zk_m), rng, device)]) for t in a[:2]]
    zk_per = [_quotient_rec(zk, a, device) for a in zk_per]
    zk_args, zk_cpu = _stacked(zk_per, k), _stacked(zk_per, k, "cpu")
    _, ops = _quotient_work(data)
    zrows = per[0][1].shape[0]
    shared = data.constants_oracle.lde.shape[0] + 3
    return dict(
        run=lambda: tprover.quotient_evals_batch(data, *args),
        plain=lambda: tprover.quotient_evals_batch_plain(data, *cpu), plain_on_host=True,
        check=lambda: ([tprover.quotient_evals_batch(d, *a)
                        for d, a in ((data, args), (data, args17), (zk, zk_args))],
                       [tprover.quotient_evals_batch_plain(d, *a)
                        for d, a in ((data, cpu), (data, cpu17), (zk, zk_cpu))]),
        bytes=(k * (cfg.num_wires + zrows + nc) + shared) * m * 8, ops=k * ops,
    )


def _permutation_batch_case(device) -> dict:
    """Kernel B with a proof axis at the leaf: K = 16 random traces with
    their own betas and gammas, zero denominators in two proofs; checked at
    K = 16 and K = 17 against the plain version run on CPU copies. Its work:
    each proof's wires and columns once, the routing tables once, K times
    one proof's operations."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    data = _leaf_data(device)
    cfg = data.config
    rng = np.random.default_rng(13)
    k = BATCH_K
    per = [_permutation_rec(data, _permutation_args(
        data, rng, device, zeros=[(0, 17, 3), (1, 255, 79)] if i in (2, k) else ()), device)
           for i in range(k + 1)]
    args, args17 = _stacked(per, k), _stacked(per, k + 1)
    cpu, cpu17 = _stacked(per, k, "cpu"), _stacked(per, k + 1, "cpu")
    nr, n, nc = cfg.num_routed_wires, data.n, cfg.num_challenges
    nchunks = -(-nr // cfg.max_quotient_degree_factor)
    _, ops = _permutation_work(data)
    return dict(
        run=lambda: tprover.compute_permutation_polys_batch(data, *args),
        plain=lambda: tprover.compute_permutation_polys_batch_plain(data, *cpu),
        plain_on_host=True,
        check=lambda: ([tprover.compute_permutation_polys_batch(data, *a) for a in (args, args17)],
                       [tprover.compute_permutation_polys_batch_plain(data, *a) for a in (cpu, cpu17)]),
        bytes=(k * (nr * n + nc * nchunks * n) + 2 * nr * n) * 8, ops=k * ops,
    )


def _fri_leaf_case(device, seed):
    """The leaf's FRI inputs at random: the four oracles' LDEs (their real
    column counts, with the field edge values), coefficient rows, the
    circuit's opening instance at a random zeta, claimed openings, alpha."""
    from types import SimpleNamespace

    import numpy as np

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.plonk.proof import fri_instance

    data = _leaf_data(device)
    cfg = data.config
    rng = np.random.default_rng(seed)
    m = data.n << cfg.rate_bits
    nc = cfg.num_challenges
    rows = leaf_oracle_rows(data)
    edges = np.array([gl.P - 1, 0, 1 << 32], dtype=np.uint64)

    def felts(shape):
        x = F.rand_felts(shape, rng)
        x.reshape(-1)[: edges.size] = edges
        return gl.from_u64(x, device)

    oracles = [SimpleNamespace(lde=felts((c, m)), coeffs=felts((c, data.n))) for c in rows]
    zeta, zeta_next = F.rand_felts(2, rng), F.rand_felts(2, rng)
    instance = fri_instance(data, zeta, zeta_next)
    openings = [F.rand_felts((len(b.polys), 2), rng) for b in instance.batches]
    return dict(data=data, oracles=oracles, instance=instance, openings=openings,
                alpha=F.rand_felts(2, rng), zeta=zeta, zeta_next=zeta_next, nz=nc,
                lde_bits=data.degree_bits + cfg.rate_bits, rng=rng,
                schedule=cfg.fri_config.reduction_strategy.schedule(data.degree_bits))


def _cpu_oracles(oracles):
    from types import SimpleNamespace

    return [SimpleNamespace(**{k: v.cpu() for k, v in vars(o).items()}) for o in oracles]


def _composition_work(instance, m: int) -> tuple[int, int]:
    """Kernel C's bytes and integer operations for one proof: each column
    the instance names read once, the claimed values, Q written;
    `fri_field_ops`."""
    cols = len({t for b in instance.batches for t in b.polys})
    k = instance.num_terms()
    muls, adds = fri_field_ops(m, k, len(instance.batches))
    return (cols * m + 2 * k + 2 * m) * 8, muls * OPS_MUL + adds * OPS_ADD


def _staged_composition(oracles, instance, openings, alpha, lde_bits: int, arity_bits: int):
    """Kernel C as the staged single proof calls it: the host openings and
    alpha uploaded into their record, then `compute_composition`."""
    from qp_zk_circuits_tpu_torch.fri import prover as fri

    ys, rec = fri.composition_inputs([instance], [openings], [alpha], oracles[0].lde.device)
    return fri.compute_composition(oracles, tuple(b.polys for b in instance.batches), ys[0],
                                   rec[0], lde_bits, arity_bits)


def _staged_openings(oracles, zeta, zeta_next, next_oracle: int, next_count: int):
    """Kernel D as the staged single proof calls it: the host points
    uploaded into their record, `eval_openings`, the values brought back
    and cut."""
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.fri import oracle as fo

    rec = fo.point_records(oracles[0].coeffs.device, [zeta], [zeta_next])[0]
    return fo.split_openings(gl.to_u64(fo.eval_openings(oracles, rec, next_oracle, next_count)),
                             oracles, next_count)


def _staged_fold(leaves, beta, a_bits: int, log_m: int, shift_pow: int, next_bits: int):
    """Kernel E as the staged single proof calls it: the host beta uploaded
    into its record, then `fold_round`."""
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    return fri.fold_round(leaves, fri.beta_records(leaves.device, [beta])[0], ts.REC_FRI_BETA,
                          a_bits, log_m, shift_pow, next_bits)


def _composition_case(device) -> dict:
    """Kernel C at the leaf: the circuit's instance (two batches, about 255
    columns at zeta and the Z columns at g * zeta), Q in the first round's
    leaf layout; two launches a call."""
    from qp_zk_circuits_tpu_torch.fri import prover as fri

    c = _fri_leaf_case(device, seed=3)
    ys, rec = fri.composition_inputs([c["instance"]], [c["openings"]], [c["alpha"]], device)
    polys = tuple(b.polys for b in c["instance"].batches)
    args = (polys, ys[0], rec[0], c["lde_bits"], c["schedule"][0])
    cpu_args = (polys, ys[0].cpu(), rec[0].cpu(), *args[3:])
    cpu = _cpu_oracles(c["oracles"])
    return dict(
        run=lambda: fri.compute_composition(c["oracles"], *args),
        plain=lambda: fri.compute_composition_plain(cpu, *cpu_args), plain_on_host=True,
        **dict(zip(("bytes", "ops"), _composition_work(c["instance"], 1 << c["lde_bits"]))),
    )


def _fri_batch_leaf_case(device, seed):
    """BATCH_K + 1 proofs' FRI inputs at the leaf's shapes, as a batch holds
    them: the constants oracle shared, each of the other three oracles'
    LDEs and coefficient rows one stacked buffer, each proof its own zeta,
    g * zeta, instance, claimed openings, alpha and beta; with `trees`, each
    oracle's Merkle tree (a forest a stack)."""
    from types import SimpleNamespace

    import numpy as np

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.hash import merkle
    from qp_zk_circuits_tpu_torch.plonk.proof import fri_instance

    data = _leaf_data(device)
    cfg = data.config
    rng = np.random.default_rng(seed)
    k = BATCH_K + 1
    n = data.n
    m = n << cfg.rate_bits
    cap = cfg.fri_config.cap_height
    rows = leaf_oracle_rows(data)
    consts = SimpleNamespace(lde=_felts((rows[0], m), rng, device),
                             coeffs=_felts((rows[0], n), rng, device))
    consts.tree = merkle.build_merkle_tree(consts.lde.T, cap)
    stacks = []
    for r in rows[1:]:
        lde = _felts((k, r, m), rng, device)
        stacks.append((lde, _felts((k, r, n), rng, device),
                       merkle.build_merkle_forest(lde.transpose(1, 2), cap)))
    oracles = [[consts] + [SimpleNamespace(lde=lde[i], coeffs=co[i], tree=trees[i])
                           for lde, co, trees in stacks] for i in range(k)]
    cpu = [[SimpleNamespace(lde=o.lde.cpu(), coeffs=o.coeffs.cpu()) for o in proof]
           for proof in oracles]
    zetas, zeta_nexts = F.rand_felts((k, 2), rng), F.rand_felts((k, 2), rng)
    instances = [fri_instance(data, z, zn) for z, zn in zip(zetas, zeta_nexts)]
    openings = [[F.rand_felts((len(b.polys), 2), rng) for b in inst.batches]
                for inst in instances]
    return dict(data=data, oracles=oracles, cpu=cpu,
                instances=instances, openings=openings, zetas=zetas, zeta_nexts=zeta_nexts,
                alphas=F.rand_felts((k, 2), rng), betas=F.rand_felts((k, 2), rng),
                nz=cfg.num_challenges, lde_bits=data.degree_bits + cfg.rate_bits, rng=rng,
                schedule=cfg.fri_config.reduction_strategy.schedule(data.degree_bits))


def _composition_batch_case(device) -> dict:
    """Kernel C with a proof axis at the K = 16 leaf batch: each proof's own
    LDEs (the constants shared), points, claimed openings and alpha; checked
    at K = 16 (one launch) and K = 17 (two) against the plain version on CPU
    copies; timed beside 16 single calls. Its work: 16 times a proof's."""
    from qp_zk_circuits_tpu_torch.fri import prover as fri

    c = _fri_batch_leaf_case(device, seed=21)
    k, a = BATCH_K, c["schedule"][0]
    polys = tuple(b.polys for b in c["instances"][0].batches)
    inputs = {dev: fri.composition_inputs(c["instances"], c["openings"], c["alphas"], dev)
              for dev in (device, "cpu")}

    def args(oracles, n, dev=device):
        ys, rec = inputs[dev]
        return (oracles[:n], polys, ys[:n], rec[:n], c["lde_bits"], a)

    work = _composition_work(c["instances"][0], 1 << c["lde_bits"])
    return dict(
        run=lambda: fri.compute_composition_batch(*args(c["oracles"], k)),
        plain=lambda: fri.compute_composition_batch_plain(*args(c["cpu"], k, "cpu")),
        plain_on_host=True,
        check=lambda: ([fri.compute_composition_batch(*args(c["oracles"], n)) for n in (k, k + 1)],
                       [fri.compute_composition_batch_plain(*args(c["cpu"], n, "cpu"))
                        for n in (k, k + 1)]),
        singles=lambda: [_staged_composition(*x, c["lde_bits"], a) for x in zip(
            c["oracles"][:k], c["instances"], c["openings"], c["alphas"])],
        bytes=k * work[0], ops=k * work[1],
    )


def _openings_batch_case(device) -> dict:
    """Kernel D with a proof axis at the K = 16 leaf batch: every oracle's
    coefficient rows of each proof at its own zeta and the Z rows at its
    g * zeta; checked at K = 16 and 17 against the plain version on CPU
    copies; timed beside 16 single calls. Its work: 16 times a proof's."""
    from qp_zk_circuits_tpu_torch.fri import oracle as fo

    c = _fri_batch_leaf_case(device, seed=22)
    k, nz = BATCH_K, c["nz"]
    n = c["oracles"][0][0].coeffs.shape[1]
    rows = sum(o.coeffs.shape[0] for o in c["oracles"][0])
    rec = {dev: fo.point_records(dev, c["zetas"], c["zeta_nexts"]) for dev in (device, "cpu")}

    def run(oracles, count, fn=fo.eval_openings_batch, dev=device):
        return fn(oracles[:count], rec[dev][:count], 2, nz)

    work = openings_work(rows, rows + nz, n)
    return dict(
        run=lambda: run(c["oracles"], k),
        plain=lambda: run(c["cpu"], k, fo.eval_openings_batch_plain, "cpu"), plain_on_host=True,
        check=lambda: ([run(c["oracles"], j) for j in (k, k + 1)],
                       [run(c["cpu"], j, fo.eval_openings_batch_plain, "cpu") for j in (k, k + 1)]),
        singles=lambda: [_staged_openings(o, z, zn, 2, nz) for o, z, zn in zip(
            c["oracles"][:k], c["zetas"], c["zeta_nexts"])],
        bytes=k * work[0], ops=k * work[1],
    )


def _fold_batch_case(device) -> dict:
    """Kernel E with a proof axis at the K = 16 leaf batch: each proof's
    round of arity 2^3 over m = 2048 values held as (256, 16) leaf rows,
    folded with its own beta into the natural-order last layer; checked at
    K = 16 and 17 against the plain version on CPU copies; timed beside 16
    single calls. Its work: 16 times a proof's."""
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    c = _fri_batch_leaf_case(device, seed=23)
    k, a, log_m = BATCH_K, c["schedule"][0], c["lde_bits"]
    m = 1 << log_m
    leaves = _felts((k + 1, m >> a, 2 << a), c["rng"], device)
    cpu = leaves.cpu()
    betas = c["betas"]
    rec, cpu_rec = fri.beta_records(device, betas), fri.beta_records("cpu", betas)
    slot = ts.REC_FRI_BETA
    work = fold_work(m, a)
    return dict(
        run=lambda: fri.fold_round_batch(leaves[:k], rec[:k], slot, a, log_m, 0, 0),
        plain=lambda: fri.fold_round_batch_plain(cpu[:k], cpu_rec[:k], slot, a, log_m, 0, 0),
        plain_on_host=True,
        check=lambda: ([fri.fold_round_batch(leaves[:j], rec[:j], slot, a, log_m, 0, 0)
                        for j in (k, k + 1)],
                       [fri.fold_round_batch_plain(cpu[:j], cpu_rec[:j], slot, a, log_m, 0, 0)
                        for j in (k, k + 1)]),
        singles=lambda: [_staged_fold(leaves[i], betas[i], a, log_m, 0, 0) for i in range(k)],
        bytes=k * work[0], ops=k * work[1],
    )


def _gather_batch_case(device) -> dict:
    """Kernel F with a proof axis at the K = 16 leaf batch: each proof's 28
    queries' leaf rows and Merkle paths of its four oracles (the constants
    shared) and of its FRI round's leaves and tree, 10 segments a proof, one
    plan of 1,592 bytes for 16 proofs (the indices uploaded in one copy, a
    pointer a proof), into pinned host memory; checked at
    K = 16 (one launch) and 17 (two) against the plain version on CPU
    copies; timed beside 16 single calls. Its work: 16 times a proof's."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.hash import merkle

    c = _fri_batch_leaf_case(device, seed=24)
    cfg = c["data"].config.fri_config
    k, a = BATCH_K, c["schedule"][0]
    m = 1 << c["lde_bits"]
    leaves = _felts((k + 1, m >> a, 2 << a), c["rng"], device)
    trees = merkle.build_merkle_forest(leaves, min(cfg.cap_height, c["lde_bits"] - a))
    sources = [fri._gather_sources(o, [(x, t)]) for o, x, t in zip(c["oracles"], leaves, trees)]
    cpu = [_cpu_sources(s) for s in sources]
    indices = [[0, m - 1] + [int(i) for i in c["rng"].integers(0, m, cfg.num_query_rounds - 2)]
               for _ in sources]
    width = fri.pack_gather_plan(sources[0], indices[0])[1]

    def plain(j):
        return torch.stack([fri.query_gather_plain(s, i) for s, i in zip(cpu[:j], indices[:j])])

    def check():
        per = fri.gather_group(len(sources[0]))
        if len(sources[0]) != 10 or per != 16:
            raise AssertionError("a leaf batch's gather plan is not 10 segments, 16 proofs")
        got = []
        for j in (k, k + 1):
            before = fri.query_gather_batch.launches
            got.append(torch.as_tensor(fri.query_gather_batch(sources[:j], indices[:j])
                                       .view(np.int64)))
            if fri.query_gather_batch.launches - before != -(-j // per):
                raise AssertionError(f"kernel F's gather of {j} proofs took other than "
                                     f"{-(-j // per)} launches")
        return got, [plain(k), plain(k + 1)]

    work = gather_work(len(indices[0]), width)
    return dict(
        run=lambda: fri.query_gather_batch(sources[:k], indices[:k]),
        plain=lambda: plain(k), plain_on_host=True, check=check,
        singles=lambda: [fri.query_gather(s, i) for s, i in zip(sources[:k], indices)],
        bytes=k * work[0], ops=k * work[1], host_bytes=k * work[2],
    )


def _openings_case(device) -> dict:
    """Kernel D at the leaf: every oracle's coefficient rows at zeta and the
    Z rows at g * zeta, one (rows, 2) result. Checked also with no row at
    g * zeta, at n = 1, 32 and 2^12 (four chunks: two launches), with
    one-row segments and with row counts that are not a multiple of a
    block's tile (8 rows a block at one chunk, 32 above)."""
    from types import SimpleNamespace

    from qp_zk_circuits_tpu_torch.fri import oracle as fo

    c = _fri_leaf_case(device, seed=4)
    cpu = _cpu_oracles(c["oracles"])
    n = c["oracles"][0].coeffs.shape[1]
    rows = sum(o.coeffs.shape[0] for o in c["oracles"])
    args = (fo.point_records(device, [c["zeta"]], [c["zeta_next"]])[0], 2, c["nz"])
    cpu_args = _cpu(args)
    counts = [o.coeffs.shape[0] for o in c["oracles"]]
    edges = [(counts, 256, 2, 0), (counts, 1, 2, 2), (counts, 32, 2, 2), (counts, 1 << 12, 2, 2),
             ([1, 33, 1], 300, 2, 1), ([3, 5], 3000, 2, 0), ([7], 1025, 1, 0)]
    cases = []
    for shape, n_e, nz, nxt in edges:
        oracles = [SimpleNamespace(coeffs=_felts((r, n_e), c["rng"], device)) for r in shape]
        cases.append((oracles, (fo.point_records(device, [c["zeta"]], [c["zeta_next"]])[0],
                                nxt, nz)))

    def check():
        got = [fo.eval_openings(c["oracles"], *args)]
        want = [fo.eval_openings_plain(cpu, *cpu_args)]
        for oracles, a in cases:
            got.append(fo.eval_openings(oracles, *a))
            want.append(fo.eval_openings_plain(_cpu_oracles(oracles), *_cpu(a)))
        return got, want

    return dict(
        run=lambda: fo.eval_openings(c["oracles"], *args),
        plain=lambda: fo.eval_openings_plain(cpu, *cpu_args), plain_on_host=True, check=check,
        **dict(zip(("bytes", "ops"), openings_work(rows, rows + c["nz"], n))),
    )


def _fold_case(device) -> dict:
    """Kernel E at the leaf: the one round of arity 2^3 over m = 2048 values
    held as (256, 16) leaf rows, folded into the natural-order last layer.
    Checked also at every arity 2^1..2^4 into natural order and into leaves
    of arity 2^4, with a layer of fewer rows than a block and one above the
    spread limit (one or two threads a row), each with another coset shift."""
    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    c = _fri_leaf_case(device, seed=5)
    a, log_m = c["schedule"][0], c["lde_bits"]
    m = 1 << log_m
    leaves = c["oracles"][1].lde.reshape(-1)[: 2 * m].reshape(m >> a, 2 << a).clone()
    slot = ts.REC_FRI_BETA
    args = (fri.beta_records(device, [F.rand_felts(2, c["rng"])])[0], slot, a, log_m, 0, 0)
    leaves_cpu = leaves.cpu()
    cases = []
    for a_e in range(1, fri.MAX_ARITY_BITS + 1):
        # the leaf's layer, fewer rows than a block, more than E_SPREAD_ROWS
        for log_m_e in (log_m, a_e + 3, a_e + 14):
            for nxt in (0, 4):
                if nxt <= log_m_e - a_e:
                    cases.append((_felts((1 << (log_m_e - a_e), 2 << a_e), c["rng"], device),
                                  (fri.beta_records(device, [F.rand_felts(2, c["rng"])])[0],
                                   slot, a_e, log_m_e, a_e + nxt, nxt)))

    def check():
        got = [fri.fold_round(leaves, *args)] + [fri.fold_round(x, *ar) for x, ar in cases]
        want = [fri.fold_round_plain(leaves_cpu, *_cpu(args))]
        want += [fri.fold_round_plain(x.cpu(), *_cpu(ar)) for x, ar in cases]
        return got, want

    return dict(
        run=lambda: fri.fold_round(leaves, *args),
        plain=lambda: fri.fold_round_plain(leaves_cpu, *_cpu(args)), plain_on_host=True,
        check=check,
        **dict(zip(("bytes", "ops"), fold_work(m, a))),
    )


def _cpu_sources(sources):
    """CPU copies of gather sources; a Merkle path's whole buffer is copied
    (its levels above level 0 lie past the matrix's own view)."""
    import torch

    from qp_zk_circuits_tpu_torch.fri import prover as fri

    out = []
    for s in sources:
        mat = s.matrix
        if s.levels:
            full = torch.empty(0, dtype=mat.dtype, device=mat.device).set_(mat.untyped_storage())
            mat = full.cpu().as_strided(mat.shape, mat.stride(), mat.storage_offset())
        else:
            mat = mat.cpu()
        out.append(fri.GatherSource(mat, s.mask, s.shift, s.flip, s.levels))
    return out


def _per_level(sources, trees):
    """The same gather with a segment a tree level: each path source of
    `sources` replaced by its tree's levels (`trees` in path order)."""
    from qp_zk_circuits_tpu_torch.fri import prover as fri

    out, paths = [], iter(trees)
    for s in sources:
        if not s.levels:
            out.append(s)
            continue
        out += [fri.GatherSource(lvl, s.mask, shift=l, flip=1)
                for l, lvl in enumerate(next(paths).digests[:-1])]
    return out


def _gather_case(device) -> dict:
    """Kernel F at the leaf: the 28 queries' leaf rows and Merkle paths of
    the four oracles and the FRI round's leaves and path (10 segments, a
    tree's path one), indices 0 and m - 1 among them. Checked also with a
    segment a level (the leaf's 37), at the plan's largest (128 segments,
    one of width 1, 128 queries, a packed row of 382 values), at a row of
    1,200 values (wider than a block) and at the ZK leaf's salted rows
    (139, 20 and 20 values at m = 4096), each into pinned host memory in one
    launch; one segment or one query over the plan must raise."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.hash import merkle

    c = _fri_leaf_case(device, seed=6)
    data = c["data"]
    cfg = data.config.fri_config
    m = 1 << c["lde_bits"]
    a = c["schedule"][0]
    trees = [merkle.build_merkle_tree(o.lde.T, cfg.cap_height) for o in c["oracles"]]
    leaves = c["oracles"][1].lde.reshape(-1)[: 2 * m].reshape(m >> a, 2 << a).clone()
    layer_tree = merkle.build_merkle_tree(leaves, min(cfg.cap_height, c["lde_bits"] - a))
    sources = [fri.GatherSource(o.lde.T, m - 1) for o in c["oracles"]]
    for t in trees:
        sources += fri._sibling_sources(t, m - 1)
    sources.append(fri.GatherSource(leaves, (m >> a) - 1))
    sources += fri._sibling_sources(layer_tree, (m >> a) - 1)
    indices = [0, m - 1] + [int(i) for i in c["rng"].integers(0, m, cfg.num_query_rounds - 2)]
    cpu = _cpu_sources(sources)
    width = fri.pack_gather_plan(sources, indices)[1]
    levels = _per_level(sources, trees + [layer_tree])
    # the plan's largest: 127 segments of 3 values and one of 1, 128 queries
    buf = _felts((1 << 12,), c["rng"], device)
    big = [fri.GatherSource(buf.as_strided((256, 3), (3, 1)), 255, shift=k % 3, flip=k % 2)
           for k in range(fri.MAX_GATHER_SEGMENTS - 1)]
    big.append(fri.GatherSource(buf.as_strided((256, 1), (1, 1)), 255))
    big_idx = [0, 255] + [int(i) for i in c["rng"].integers(0, 256, fri.MAX_GATHER_QUERIES - 2)]
    # a packed row wider than a block (1,200 values): its threads stride
    wide_mat = _felts((64, 600), c["rng"], device)
    wide = [fri.GatherSource(wide_mat, 63), fri.GatherSource(wide_mat, 63, flip=1)]
    # the ZK leaf's four oracles at m = 4096: the constants, then the salted
    # wires (139 rows), Z and partial products (20) and quotient (20), each
    # with its tree's path
    zk_m = 2 * m
    zk_ldes = [_felts((rows, zk_m), c["rng"], device)
               for rows in (c["oracles"][0].lde.shape[0], 139, 20, 20)]
    zk = [fri.GatherSource(lde.T, zk_m - 1) for lde in zk_ldes]
    for lde in zk_ldes:
        zk += fri._sibling_sources(merkle.build_merkle_tree(lde.T, cfg.cap_height), zk_m - 1)
    zk_idx = [0, zk_m - 1] + [int(i) for i in c["rng"].integers(0, zk_m, cfg.num_query_rounds - 2)]
    cases = [(sources, cpu, indices), (levels, _cpu_sources(levels), indices),
             (big, _cpu_sources(big), big_idx), (wide, _cpu_sources(wide), big_idx[:28]),
             (zk, _cpu_sources(zk), zk_idx)]

    def check():
        if (len(sources), len(levels)) != (10, 37):
            raise AssertionError(f"leaf gather plans of {len(sources)} and {len(levels)} "
                                 "segments, expected 10 and 37")
        got, want = [], []
        for srcs, srcs_cpu, idx in cases:
            before = fri.query_gather.launches
            got.append(torch.as_tensor(fri.query_gather(srcs, idx).view(np.int64)))
            if fri.query_gather.launches - before != 1:
                raise AssertionError("kernel F's gather took other than one launch")
            want.append(fri.query_gather_plain(srcs_cpu, idx))
        for srcs, idx in ((big + big[:1], big_idx), (big, big_idx + [0])):
            try:
                fri.query_gather(srcs, idx)
            except ValueError:
                continue
            raise AssertionError(f"kernel F took a plan over its capacity: {len(srcs)} "
                                 f"segments, {len(idx)} queries")
        return got, want

    return dict(
        run=lambda: fri.query_gather(sources, indices),
        plain=lambda: fri.query_gather_plain(cpu, indices), plain_on_host=True, check=check,
        **dict(zip(("bytes", "ops", "host_bytes"), gather_work(len(indices), width))),
    )


def _leaf_schedule(ts, state, src: dict, out: dict, g: int):
    """The fused leaf proof's transcript segments (plonk/prover_fused.py's
    order) over `src`'s tensors, writing `out`'s: the digest, PI hash and
    wires cap, then the betas and gammas; each later cap and its challenges;
    zeta and g * zeta; the openings and FRI's alpha; each round's cap and
    beta; the final polynomial (its (2, m_f) rows read transposed); the
    witness, its response and the query indices. Returns the challenger."""
    ch = ts.DeviceChallenger(state)
    nc = out["betas"].numel()
    ch.segment(observe=[(src["digest"], None), (src["pi"], None),
                        (src["caps"][0], out["caps"][0])],
               squeeze=[(out["betas"], 0), (out["gammas"], 0)])
    ch.segment(observe=[(src["caps"][1], out["caps"][1])], squeeze=[(out["alphas"], 0)])
    ch.segment(observe=[(src["caps"][2], out["caps"][2])], squeeze=[(out["zeta"], 0)],
               scale=(out["zeta_next"], g))
    ch.segment(observe=[(src["openings"], None)], squeeze=[(out["fri_alpha"], 0)])
    for r, cap in enumerate(src["fri_caps"]):
        ch.segment(observe=[(cap, None)], squeeze=[(out["fri_betas"][2 * r : 2 * r + 2], 0)])
    ch.segment(observe=[(src["final"][:, : src["final_len"]].T, None)])
    ch.segment(observe=[(src["witness"], out["pow"][:1])],
               squeeze=[(out["pow"][1:], 0), (out["indices"], src["lde_bits"])])
    assert nc == out["gammas"].numel() == out["alphas"].numel()
    return ch


def _transcript_case(device) -> dict:
    """Kernel I at the leaf proof's whole schedule (`_leaf_schedule`: the
    leaf's packed shapes, seeded random values, a fresh state), against the
    plain version on CPU copies: every challenge, index, copied cap, the
    final state. Bound: the dependent chain, its permutations in series
    (PERM_CHAIN multiplies of MUL_LATENCY_CYCLES), far above its bytes and
    operations."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    data = _leaf_data(device)
    views = tfused.fused_bundle(data).packer.views(np.zeros(tfused.fused_bundle(data).packer.size))
    rng = np.random.default_rng(31)
    rounds = len([k for k in views if k.startswith("fri_cap_")])
    nc = data.config.num_challenges
    host = dict(digest=F.rand_felts((4,), rng), pi=F.rand_felts((4,), rng),
                caps=[F.rand_felts(views[k].shape, rng)
                      for k in ("wires_cap", "zs_pp_cap", "quotient_cap")],
                openings=F.rand_felts(views["openings"].shape, rng),
                fri_caps=[F.rand_felts(views[f"fri_cap_{r}"].shape, rng) for r in range(rounds)],
                final=F.rand_felts(views["final_poly"].shape, rng),
                witness=F.rand_felts((1,), rng))
    final_len = fri._final_len(data.config.fri_config, data.degree_bits)
    lde_bits = data.degree_bits + data.config.rate_bits
    g = int(F.primitive_root_of_unity(data.degree_bits))
    sizes = dict(betas=nc, gammas=nc, alphas=nc, zeta=2, zeta_next=2, fri_alpha=2,
                 fri_betas=2 * rounds, pow=2, indices=views["query_indices"].shape[0])

    def inputs(dev):
        def t(a):
            return gl.from_u64(a, dev)
        return dict(digest=t(host["digest"]), pi=t(host["pi"]), caps=[t(c) for c in host["caps"]],
                    openings=t(host["openings"]), fri_caps=[t(c) for c in host["fri_caps"]],
                    final=t(host["final"]), witness=t(host["witness"]), final_len=final_len,
                    lde_bits=lde_bits)

    def outputs(dev):
        flat = torch.zeros(sum(sizes.values()) + sum(c.size for c in host["caps"]),
                           dtype=torch.int64, device=dev)
        out, at = {}, 0
        for name, n in sizes.items():
            out[name], at = flat[at : at + n], at + n
        out["caps"] = []
        for c in host["caps"]:
            out["caps"].append(flat[at : at + c.size])
            at += c.size
        return flat, out

    card_in, cpu_in = inputs(device), inputs("cpu")
    card_state = torch.zeros(ts.TS_WORDS, dtype=torch.int64, device=device)
    card_flat, card_out = outputs(device)
    perms = []

    def run():
        card_state.zero_()
        ch = _leaf_schedule(ts, card_state, card_in, card_out, g)
        perms[:] = [ch.permutations]
        return card_flat

    def plain():
        state = torch.zeros(ts.TS_WORDS, dtype=torch.int64)
        flat, out = outputs("cpu")
        _leaf_schedule(ts, state, cpu_in, out, g)
        return torch.cat([flat, state])

    def check():
        before = ts.transcript_segment.launches
        got = torch.cat([run(), card_state])
        if ts.transcript_segment.launches - before != 6 + rounds:
            raise AssertionError("kernel I took other than a launch a segment")
        return [got], [plain()]

    run()
    src_felts = 8 + sum(c.size for c in host["caps"]) + host["openings"].size + sum(
        c.size for c in host["fri_caps"]) + 2 * final_len + 1
    perm_ops = PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD
    return dict(run=run, plain=plain, plain_on_host=True, check=check,
                bytes=8 * (src_felts + ts.TS_WORDS * 2 + card_flat.numel()),
                ops=perms[0] * perm_ops, permutations=perms[0],
                chain_ms=1e3 * perms[0] * PERM_CHAIN * MUL_LATENCY_CYCLES / SM_CLOCK_HZ)


def _grind_case(device) -> dict:
    """Kernel J at 16 bits from a transcript state with 5 felts in its input
    buffer: the lowest witness against the plain version run on the card
    (sweeps of 2^17 in order); with its limit at the chunk below the
    witness's it finds none (best stays 2^64 - 1). Timed from reset words,
    by CUDA events (a graph replay of one call would start found). Bound:
    operations, a permutation for each candidate up to the witness."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    bits = 16
    state = torch.zeros(ts.TS_WORDS, dtype=torch.int64, device=device)
    ch = ts.DeviceChallenger(state)
    ch.segment(observe=[(gl.from_u64(F.rand_felts((13,), np.random.default_rng(32)), device),
                         None)])
    init = torch.tensor([0, -1], dtype=torch.int64, device=device)
    words = init.clone()

    def run():
        words.copy_(init)
        ts.grind_device(state, ch.in_len, bits, words)
        return words[1:]

    def plain():
        w = init.clone()
        ts.grind_plain(state, ch.in_len, bits, w)
        return w[1:]

    def check():
        got = run().clone()
        want = plain()
        limited = init.clone()
        ts.grind_device(state, ch.in_len, bits, limited, limit=int(want) // 128 * 128)
        if int(limited[1]) != -1:
            raise AssertionError("kernel J found a witness at or above its limit")
        return [got], [want]

    def events_ms(runs=20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(runs):
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    witness = int(plain())
    perm_ops = PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD
    return dict(run=run, plain=plain, check=check, device=events_ms, witness=witness,
                bytes=8 * (ts.TS_WORDS + 4), ops=(witness + 1) * perm_ops)


def _leaf_schedule_batch(ts, states, src: dict, out: dict, g: int):
    """`_leaf_schedule` for K transcripts at once (DeviceChallengerBatch):
    `src`'s tensors with a leading proof axis (the digest one (4,) vector
    read by all), `out`'s (K, n) rows. Returns the challenger."""
    ch = ts.DeviceChallengerBatch(states)
    k = len(ch)
    ch.segment(observe=[(src["digest"].expand(k, -1), None), (src["pi"], None),
                        (src["caps"][0], out["caps"][0])],
               squeeze=[(out["betas"], 0), (out["gammas"], 0)])
    ch.segment(observe=[(src["caps"][1], out["caps"][1])], squeeze=[(out["alphas"], 0)])
    ch.segment(observe=[(src["caps"][2], out["caps"][2])], squeeze=[(out["zeta"], 0)],
               scale=(out["zeta_next"], g))
    ch.segment(observe=[(src["openings"], None)], squeeze=[(out["fri_alpha"], 0)])
    for r, cap in enumerate(src["fri_caps"]):
        ch.segment(observe=[(cap, None)], squeeze=[(out["fri_betas"][:, 2 * r : 2 * r + 2], 0)])
    ch.segment(observe=[(src["final"][:, :, : src["final_len"]].transpose(1, 2), None)])
    ch.segment(observe=[(src["witness"], out["pow"][:, :1])],
               squeeze=[(out["pow"][:, 1:], 0), (out["indices"], src["lde_bits"])])
    return ch


def _transcript_batch_case(device) -> dict:
    """Kernel I with a proof axis at the leaf proof's whole schedule for K =
    16 transcripts (timed) and 17 (checked), each proof its own seeded
    random values of the leaf's packed shapes, the states rows of a wider
    buffer and every output a (K, n) row a proof apart (strided, as the
    fused batch's record and part-major output are), against the plain
    version on CPU copies: every challenge, index, copied cap, the final
    states; one launch a segment for all K. Bound: the dependent chain, one
    transcript's permutations in series (the K run side by side while K is
    at most the SM count), far above K proofs' bytes and operations."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    data = _leaf_data(device)
    views = tfused.fused_bundle(data).packer.views(np.zeros(tfused.fused_bundle(data).packer.size))
    rng = np.random.default_rng(34)
    rounds = len([k for k in views if k.startswith("fri_cap_")])
    nc = data.config.num_challenges
    kk = BATCH_K + 1

    def felts(shape):
        return F.rand_felts((kk,) + tuple(shape), rng)

    host = dict(digest=F.rand_felts((4,), rng), pi=felts((4,)),
                caps=[felts(views[k].shape) for k in ("wires_cap", "zs_pp_cap", "quotient_cap")],
                openings=felts(views["openings"].shape),
                fri_caps=[felts(views[f"fri_cap_{r}"].shape) for r in range(rounds)],
                final=felts(views["final_poly"].shape), witness=felts((1,)))
    final_len = fri._final_len(data.config.fri_config, data.degree_bits)
    lde_bits = data.degree_bits + data.config.rate_bits
    g = int(F.primitive_root_of_unity(data.degree_bits))
    sizes = dict(betas=nc, gammas=nc, alphas=nc, zeta=2, zeta_next=2, fri_alpha=2,
                 fri_betas=2 * rounds, pow=2, indices=views["query_indices"].shape[0])
    cap_sizes = [c[0].size for c in host["caps"]]
    width = sum(sizes.values()) + sum(cap_sizes) + 3  # rows a little wider than their parts

    def inputs(dev, k):
        def t(a):
            return gl.from_u64(np.ascontiguousarray(a[:k]), dev)
        return dict(digest=gl.from_u64(host["digest"], dev), pi=t(host["pi"]),
                    caps=[t(c) for c in host["caps"]], openings=t(host["openings"]),
                    fri_caps=[t(c) for c in host["fri_caps"]], final=t(host["final"]),
                    witness=t(host["witness"]), final_len=final_len, lde_bits=lde_bits)

    def outputs(dev, k):
        flat = torch.zeros((k, width), dtype=torch.int64, device=dev)
        out, at = {}, 0
        for name, n in sizes.items():
            out[name], at = flat[:, at : at + n], at + n
        out["caps"] = []
        for n in cap_sizes:
            out["caps"].append(flat[:, at : at + n])
            at += n
        return flat, out

    def states(dev, k):
        return torch.zeros((k, ts.TS_WORDS + 5), dtype=torch.int64, device=dev)[:, : ts.TS_WORDS]

    card_in = {k: inputs(device, k) for k in (BATCH_K, kk)}
    card_states = {k: states(device, k) for k in (BATCH_K, kk)}
    card_out = {k: outputs(device, k) for k in (BATCH_K, kk)}
    perms = []

    def run(k=BATCH_K):
        card_states[k].zero_()
        ch = _leaf_schedule_batch(ts, card_states[k], card_in[k], card_out[k][1], g)
        perms[:] = [ch.permutations]
        return card_out[k][0]

    def plain(k=BATCH_K):
        st = states("cpu", k)
        flat, out = outputs("cpu", k)
        _leaf_schedule_batch(ts, st, inputs("cpu", k), out, g)
        return torch.cat([flat, st], 1)

    def check():
        got, want = [], []
        for k in (BATCH_K, kk):
            before = ts.transcript_segment_batch.launches
            got.append(torch.cat([run(k), card_states[k]], 1))
            if ts.transcript_segment_batch.launches - before != 6 + rounds:
                raise AssertionError("kernel I's batch form took other than a launch a segment")
            want.append(plain(k))
        return got, want

    run()
    src_felts = 8 + sum(cap_sizes) + host["openings"][0].size + sum(
        c[0].size for c in host["fri_caps"]) + 2 * final_len + 1
    perm_ops = PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD
    return dict(run=run, plain=plain, plain_on_host=True, check=check,
                bytes=8 * BATCH_K * (src_felts + ts.TS_WORDS * 2 + width),
                ops=BATCH_K * perms[0] * perm_ops, permutations=perms[0],
                chain_ms=1e3 * perms[0] * PERM_CHAIN * MUL_LATENCY_CYCLES / SM_CLOCK_HZ)


#: the seed of the batch grind's transcripts: of its first 16, one's 16-bit
#: witness lies past 2^17 (216,308) and each past the first chunk of 128
GRIND_BATCH_SEED = 33


def _grind_batch_case(device) -> dict:
    """Kernel J over K = 16 leaf transcripts (timed) and 17 (checked) at 16
    bits, each transcript 13 seeded felts observed (5 in its input buffer):
    each proof's lowest witness against the plain version run on the card
    (sweeps of 2^17 for the proofs still open), one witness past the first
    2^17 candidates and each past the first chunk; with the limit between
    the witnesses, the proofs below it keep theirs and the rest find none.
    Timed from reset words, by CUDA events. Bound: operations, a
    permutation for each candidate up to each proof's witness, summed over
    the K proofs."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    bits, k = 16, BATCH_K
    states = torch.zeros((k + 1, ts.TS_WORDS), dtype=torch.int64, device=device)
    ch = ts.DeviceChallengerBatch(states)
    ch.segment(observe=[(gl.from_u64(F.rand_felts((k + 1, 13), np.random.default_rng(
        GRIND_BATCH_SEED)), device), None)])
    init = torch.tensor([[0, -1]] * (k + 1), dtype=torch.int64, device=device)
    words = init.clone()

    def run():
        words.copy_(init)
        ts.grind_device_batch(states[:k], ch.in_len, bits, words[:k])
        return words[:k, 1]

    def grind(fn, n, limit=None):
        w = init[:n].clone()
        fn(states[:n], ch.in_len, bits, w, limit)
        return w[:, 1]

    def plain():
        return grind(ts.grind_batch_plain, k)

    def check():
        got = run().clone()
        want = plain()
        found = sorted(int(x) for x in want)
        if found[-1] < 1 << 17 or found[0] < 128:
            raise AssertionError(f"the batch grind's witnesses {found} do not reach past 2^17 "
                                 "and the first chunk")
        limit = found[k // 2] // 128 * 128
        return ([got, grind(ts.grind_device_batch, k + 1), grind(ts.grind_device_batch, k, limit)],
                [want, grind(ts.grind_batch_plain, k + 1), grind(ts.grind_batch_plain, k, limit)])

    def events_ms(runs=20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(runs):
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    witnesses = [int(x) for x in plain()]
    perm_ops = PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD
    return dict(run=run, plain=plain, check=check, device=events_ms, witnesses=witnesses,
                bytes=8 * k * (ts.TS_WORDS + 4), ops=sum(w + 1 for w in witnesses) * perm_ops)


#: the ZK leaf (the private batch's config on the leaf circuit): 135 wires,
#: n = 512 rows of which 260 are used, LDE m = 4096
ZK_LEAF_WIRES, ZK_LEAF_N, ZK_LEAF_USED, ZK_LEAF_M = 135, 512, 260, 4096
#: a Philox proof key for the kernel checks
RAND_KEY = 0x5DEECE66D


def _rand_felts_case(device) -> dict:
    """Kernel G at a device-rng ZK leaf proof's draws: the blinding rows
    (stream 0) written in place into the trace's columns past the used rows
    (a strided view, 16-byte stores), the three salts (streams 1-3) into 4 x
    4096 rows, and the scalar-store paths: an odd count, 3 x 1001 felts (a
    block's pair cut short), the trace's columns from an odd start with an
    odd row length (no pair aligned, rows that split Philox blocks), a
    transposed view (column stride 512), one column, and a vector of 2^20 +
    1 felts (more blocks than one grid's threads); each against the plain
    version on a CPU copy, nothing written outside its view. Timed at the
    blinding draw; one torch.randint of the same count is timed beside it
    (another stream, so no library computes this function)."""
    import torch

    from qp_zk_circuits_tpu_torch.field import random as frandom

    trace = torch.zeros((ZK_LEAF_WIRES, ZK_LEAF_N), dtype=torch.int64, device=device)
    blind = trace[:, ZK_LEAF_USED:]
    salts = torch.empty((3, 4, ZK_LEAF_M), dtype=torch.int64, device=device)
    odd = torch.empty((3, 1001), dtype=torch.int64, device=device)
    draws = [(0, blind)] + [(1 + i, salts[i]) for i in range(3)] + [(5, odd)]
    edges = [torch.zeros(shape, dtype=torch.int64, device=device) for shape in (
        (ZK_LEAF_WIRES, ZK_LEAF_N), (ZK_LEAF_N, ZK_LEAF_WIRES), (ZK_LEAF_N, 9), ((1 << 20) + 1,))]
    edge_views = [edges[0][:, ZK_LEAF_USED - 1:], edges[1].T, edges[2][:, 5:6], edges[3]]

    def check():
        got, want = [], []
        for stream, out in draws + [(6 + i, v) for i, v in enumerate(edge_views)]:
            before = frandom.rand_felts.launches
            frandom.rand_felts(RAND_KEY, stream, out)
            if frandom.rand_felts.launches != before + 1:
                raise AssertionError("kernel G took other than one launch")
            got.append(out.clone())
            want.append(frandom.rand_felts_plain(
                RAND_KEY, stream, torch.empty(tuple(out.shape), dtype=torch.int64)))
        if trace[:, :ZK_LEAF_USED].any():
            raise AssertionError("kernel G wrote outside the trace's blinding columns")
        for base, view in zip(edges, edge_views):
            view.zero_()
            if base.any():
                raise AssertionError("kernel G wrote outside a view")
        return got, want

    count = blind.numel()
    return dict(
        run=lambda: frandom.rand_felts(RAND_KEY, 0, blind),
        plain=lambda: frandom.rand_felts_plain(
            RAND_KEY, 0, torch.empty(tuple(blind.shape), dtype=torch.int64)),
        plain_on_host=True, check=check,
        library_note=lambda: torch.randint(0, (1 << 63) - 1, (count,), dtype=torch.int64,
                                           device=device),
        **dict(zip(("bytes", "ops"), rand_felts_work(count))),
    )


#: the sharded NTT's sizes and shard counts in phase_mesh (kernel H's shapes)
MESH_NTT_LOG_N = (20, 24)
MESH_NTT_SHARDS = (2, 4, 8)
#: the shard count of the kernel H rows' timed call, and the sharded leaf's
MESH_D = 4


def shard_work(d: int, l: int, cross: bool) -> tuple[int, int]:
    """Kernel H's bytes and integer operations on one shard's L felts: each
    read once and written once; the DFT's least work a radix-2 transform of
    each of the L / D columns, (D / 2) log2 D multiplies and D log2 D adds
    (the inverse's 1/D is folded into the roots); the deinterleave none."""
    bits = d.bit_length() - 1
    ops = (l // d) * ((d // 2) * bits * OPS_MUL + d * bits * OPS_ADD) if cross else 0
    return 2 * l * 8, ops


def _shard_case(device, cross: bool) -> dict:
    """Kernel H (one entry) timed on one shard of N = 2^24 over D = 4 (L =
    2^22 felts); checked against its plain version on the card at every
    shard's block of the sharded NTT's shapes, N = 2^20 and 2^24 over D =
    2, 4, 8, and at D = 1 and 64, and on slabs of L/D = 1 and 2 columns at
    every D from 1 to 64 (the DFT's thread with one column and with a pair;
    both directions for the DFT)."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.poly import ntt

    def inputs(log_n, d, seed):
        x = _card_felts(((1 << log_n) // d,), seed, device)
        return x if not cross else x.view(d, -1)

    def slab(d, cols, seed):
        x = _card_felts((d * cols,), seed, device)
        return x if not cross else x.view(d, cols)

    def call(x, d, inverse=False):
        return ntt.shard_cross_ntt(x, inverse) if cross else ntt.shard_deinterleave(x, d)

    def plain(x, d, inverse=False):
        return (ntt.shard_cross_ntt_plain(x, inverse) if cross
                else ntt.shard_deinterleave_plain(x, d))

    def check():
        got, want = [], []
        cases = [(log_n, d) for log_n in MESH_NTT_LOG_N for d in MESH_NTT_SHARDS]
        xs = [(inputs(log_n, d, log_n * 100 + d), d)
              for log_n, d in cases + [(20, 1), (20, 64), (24, 64)]]
        xs += [(slab(1 << b, cols, 10 * b + cols), 1 << b) for b in range(7) for cols in (1, 2)]
        for x, d in xs:
            for inverse in ((False, True) if cross else (False,)):
                before = ntt.shard_cross_ntt.launches + ntt.shard_deinterleave.launches
                got.append(call(x, d, inverse))
                if ntt.shard_cross_ntt.launches + ntt.shard_deinterleave.launches != before + 1:
                    raise AssertionError("kernel H took other than one launch")
                want.append(plain(x, d, inverse))
        return got, want

    x = inputs(24, MESH_D, 7)
    l = x.numel()
    # one PyTorch copy computes the deinterleave (its plain version); no
    # library call computes the DFT over the field
    library = None if cross else (lambda: x.view(-1, MESH_D).t().contiguous())
    return dict(run=lambda: call(x, MESH_D), plain=lambda: plain(x, MESH_D), check=check,
                library=library, **dict(zip(("bytes", "ops"), shard_work(MESH_D, l, cross))))


def _host_median_ms(fn, runs: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_kernels(kernels) -> None:
    import torch

    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.tools.timing import device_ms, graph_ms, median_ms

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
        if [tuple(g.shape) for g in got] != [tuple(w.shape) for w in want]:
            raise AssertionError(f"{k['name']}: shapes differ from the plain version")
        err = max(int((g.cpu() != w.cpu()).sum()) for g, w in zip(got, want))
        if err:
            at = [(i, (g.cpu() != w.cpu()).nonzero()[:4].tolist()) for i, (g, w) in
                  enumerate(zip(got, want)) if not torch.equal(g.cpu(), w.cpu())]
            raise AssertionError(f"{k['name']}: {err} elements differ from the plain version "
                                 f"(output, first indices: {at})")
        k["max_abs_err"] = 0
        k["ms"] = median_ms(k["run"], runs=20)
        k["device_ms"] = k["device"]() if "device" in k else device_ms(k["run"])
        if k.get("plain_on_host"):
            k["plain_ms"] = _host_median_ms(k["plain"], runs=3)
        else:
            k["plain_ms"] = median_ms(k["plain"], runs=3, warmup=1)
        k["bound_ms"], k["bound_by"] = _bound((k["bytes"], k["ops"], k.get("host_bytes", 0)))
        if k.get("chain_ms", 0) > k["bound_ms"]:
            k["bound_ms"], k["bound_by"] = k["chain_ms"], "chain"
        dev = "not measured" if k["device_ms"] is None else f"{k['device_ms']:.4f} ms"
        where = "host" if k.get("plain_on_host") else "card"
        note = ""
        if "library_note" in k:
            note = (f"; torch.randint of as many int64s, another stream: "
                    f"{median_ms(k['library_note'], runs=20):.4f} ms")
        # one PyTorch call computing the same function, where there is one:
        # checked against the plain version, its device time as device_ms's
        k["library_ms"] = None
        if k.get("library") is not None:
            if not torch.equal(k["library"](), k["plain"]()):
                raise AssertionError(f"{k['name']}: the library call differs from the plain version")
            k["library_ms"] = graph_ms(k["library"])
            note += f"; library call, device {k['library_ms']:.4f} ms"
        if "chain_ms" in k:
            note += (f"; the chain: {k['permutations']} permutations x {PERM_CHAIN} dependent "
                     f"multiplies x {MUL_LATENCY_CYCLES} cycles")
        if "singles" in k:
            # the batch's work as the single wrapper does it, a call a proof
            k["singles_ms"] = median_ms(k["singles"], runs=10)
            k["singles_device_ms"] = device_ms(k["singles"])
            note += (f"; {BATCH_K} single calls {k['singles_ms']:.4f} ms, device "
                     f"{k['singles_device_ms']:.4f} ms")
        print(f"[kernel] {k['name']}: bit-exact; {k['ms']:.4f} ms, device {dev} "
              f"(plain on the {where} {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}){note}", flush=True)


def phase_aggregation_tree(device, log_rows: int = 19, cols: int = 135,
                           cap: int = 4, sample: int = 256) -> None:
    """The tree at the private batch's wires shape, 2^19 x 135 (553 MB):
    timed as one call and as the per-level form (hash_rows, then one
    two_to_one launch a level); the plain version is too slow here, so 256
    nodes of every level are checked against hash_rows_plain of their rows
    or two_to_one_plain of their children in the kernel's level below."""
    import torch

    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps
    from qp_zk_circuits_tpu_torch.tools.timing import median_ms

    gen = torch.Generator(device=device).manual_seed(19)
    # uniform below 2^63 < p: canonical felts, made on the card from a seed
    lde = torch.randint(0, (1 << 63) - 1, (cols, 1 << log_rows), generator=gen,
                        dtype=torch.int64, device=device)
    rows = lde.T

    def per_level():
        cur = ps.hash_rows(rows)
        while cur.shape[0] > 1 << cap:
            cur = ps.two_to_one(cur[0::2], cur[1::2])
        return cur

    levels = ps.merkle_levels(rows, cap)
    torch.cuda.synchronize()
    idx_gen = torch.Generator(device=device).manual_seed(20)
    checked = 0
    for lvl, got in enumerate(levels):
        n = got.shape[0]
        idx = torch.randint(0, n, (min(sample, n),), generator=idx_gen, device=device)
        if lvl == 0:
            want = ps.hash_rows_plain(rows[idx])
        else:
            below = levels[lvl - 1]
            want = ps.two_to_one_plain(below[2 * idx], below[2 * idx + 1])
        bad = int((got[idx] != want).sum())
        if bad:
            raise AssertionError(f"2^{log_rows} tree level {lvl}: {bad} sampled values differ")
        checked += idx.numel()
    if not torch.equal(levels[-1], per_level()):
        raise AssertionError(f"2^{log_rows} tree cap differs from the per-level build")
    # CUDA events only: the tree is one or two launches, so its span is its
    # device time, and a profiler window over these long kernels has been
    # seen to miss some of them
    tree_ms = median_ms(lambda: ps.merkle_levels(rows, cap), runs=5)
    per_level_ms = median_ms(per_level, runs=5)
    bound_ms, bound_by = _bound(tree_work(1 << log_rows, cols, cap))
    plan = ps.tree_plan(1 << log_rows, cap, ps._sm_count(torch.device(device).index))
    print(f"[tree 2^{log_rows}] {cols} columns, cap 2^{cap}, plan {plan}: {checked} sampled "
          f"nodes over {len(levels)} levels equal their plain hashes, cap equal to the "
          f"per-level build; tree {tree_ms:.4f} ms, per-level form {per_level_ms:.4f} ms "
          f"(CUDA events); bound {bound_ms:.4f} ms by {bound_by}", flush=True)
    del lde, rows, levels
    torch.cuda.empty_cache()


def _card_felts(shape, seed: int, device):
    """Canonical felts made on the card from a seed (uniform below 2^63 < p)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, (1 << 63) - 1, shape, generator=gen, dtype=torch.int64,
                         device=device)


def _timed(fn, work) -> str:
    """CUDA-event span of one call (median of 5), its kernels' device time
    (graph replay) and the bound of `work`."""
    from qp_zk_circuits_tpu_torch.tools.timing import device_ms, median_ms

    bound_ms, by = _bound(work)
    return (f"{median_ms(fn, runs=5):.4f} ms, device {device_ms(fn):.4f} ms, bound "
            f"{bound_ms:.4f} ms by {by}")


def phase_aggregation_ntt(device, degree_bits: int = 16, rate: int = 3, checked: int = 8) -> None:
    """Kernel 3 at the private batch's shapes (two passes): the commit's LDE
    of 135 columns 2^16 -> 2^19 (the first `checked` columns in full
    against `batched_ntt_plain` run on the card), the round trip
    intt(ntt(x)) == x on all 135 columns of 2^16, and the quotient's coset
    iNTT of 2 x 2^19 in full against the plain version on the card. Each
    timed beside its bound."""
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.poly import ntt

    wires, n = 135, 1 << degree_bits
    log_m = degree_bits + rate
    coeffs = _card_felts((wires, n), 21, device)
    before = ntt.batched_ntt.launches
    lde = ntt.batched_ntt(coeffs, log_m, shift=7)
    launches = ntt.batched_ntt.launches - before
    want = ntt.batched_ntt_plain(coeffs[:checked], log_m, shift=7)
    if not torch.equal(lde[:checked], want):
        raise AssertionError(f"2^{log_m} LDE differs from the plain version")
    line = _timed(lambda: ntt.batched_ntt(coeffs, log_m, shift=7),
                  ntt_work(wires, n, log_m, shift=True))
    print(f"[ntt 2^{log_m}] LDE {wires} x 2^{degree_bits} -> 2^{log_m}, passes "
          f"{ntt.pass_bits(log_m)}, {launches} launches: the first {checked} columns "
          f"({checked << log_m} values) equal batched_ntt_plain on the card; {line}", flush=True)
    del lde, want

    evals = ntt.batched_ntt(coeffs, degree_bits)
    back = ntt.batched_ntt(evals, degree_bits, inverse=True)
    if not torch.equal(back, coeffs):
        raise AssertionError(f"intt(ntt(x)) != x at {wires} x 2^{degree_bits}")
    line = _timed(lambda: ntt.batched_ntt(evals, degree_bits, inverse=True),
                  ntt_work(wires, n, degree_bits, inverse=True))
    print(f"[ntt 2^{degree_bits}] iNTT {wires} x 2^{degree_bits}, passes "
          f"{ntt.pass_bits(degree_bits)}: intt(ntt(x)) == x on all {wires} columns; {line}",
          flush=True)
    del coeffs, evals, back

    quot = _card_felts((2, 1 << log_m), 22, device)
    unshift = int(F.inv(F.MULTIPLICATIVE_GROUP_GENERATOR))
    got = ntt.batched_ntt(quot, log_m, inverse=True, out_shift=unshift)
    if not torch.equal(got, ntt.batched_ntt_plain(quot, log_m, inverse=True, out_shift=unshift)):
        raise AssertionError(f"2 x 2^{log_m} coset iNTT differs from the plain version")
    line = _timed(lambda: ntt.batched_ntt(quot, log_m, inverse=True, out_shift=unshift),
                  ntt_work(2, 1 << log_m, log_m, inverse=True))
    print(f"[ntt 2^{log_m}] coset iNTT 2 x 2^{log_m}: all {got.numel()} values equal the "
          f"plain version on the card; {line}", flush=True)
    del quot, got
    torch.cuda.empty_cache()


def _composition_2_19(leaf, device, lde_bits: int) -> None:
    """Kernel C at m = 2^lde_bits: the leaf's four oracles' column counts and
    opening instance, random LDEs made on the card, Q in the leaf layout of
    the first arity of schedule(lde_bits - rate), against
    `compute_composition_plain` run on the card (its field ops on kernel 1)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.plonk.proof import fri_instance

    cfg = leaf.config
    m = 1 << lde_bits
    rows = leaf_oracle_rows(leaf)
    oracles = [SimpleNamespace(lde=_card_felts((c, m), 30 + i, device)) for i, c in enumerate(rows)]
    rng = np.random.default_rng(19)
    instance = fri_instance(leaf, F.rand_felts(2, rng), F.rand_felts(2, rng))
    openings = [F.rand_felts((len(b.polys), 2), rng) for b in instance.batches]
    arity = cfg.fri_config.reduction_strategy.schedule(lde_bits - cfg.rate_bits)[0]
    ys, rec = fri.composition_inputs([instance], [openings], [F.rand_felts(2, rng)], device)
    args = (tuple(b.polys for b in instance.batches), ys[0], rec[0], lde_bits, arity)
    before = fri.compute_composition.launches
    got = fri.compute_composition(oracles, *args)
    launches = fri.compute_composition.launches - before
    if not torch.equal(got, fri.compute_composition_plain(oracles, *args)):
        raise AssertionError(f"composition at m = 2^{lde_bits} differs from the plain version")
    k = instance.num_terms()
    cols = len({t for b in instance.batches for t in b.polys})
    muls, adds = fri_field_ops(m, k, len(instance.batches))
    line = _timed(lambda: fri.compute_composition(oracles, *args),
                  ((cols * m + 2 * k + 2 * m) * 8, muls * OPS_MUL + adds * OPS_ADD))
    print(f"[fused 2^{lde_bits - cfg.rate_bits}] composition m = {m}, {k} terms over {cols} "
          f"columns, arity 2^{arity}, {launches} launch(es): all {got.numel()} values equal "
          f"compute_composition_plain run on the card (its field ops on kernel 1); {line}",
          flush=True)
    del oracles, got
    torch.cuda.empty_cache()


def phase_aggregation_fused(device, degree_bits: int = 16) -> None:
    """Kernels A and B at the private batch's size: the leaf's config and
    gate table on a circuit of 2^16 rows, with random constants, selectors,
    sigmas (m = 2^19 LDE rows) and routing tables. B against its plain
    version on CPU copies, in full, with zero denominators on both sides of a
    tile boundary; A against `quotient_evals_plain` run on the card, in full
    (its field ops go through kernel 1, which the kernel phase holds
    bit-exact against its plain version). Each timed (CUDA events around a
    call, and the kernels' own device time) beside its bound."""
    import dataclasses
    from types import SimpleNamespace

    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover

    leaf = _leaf_data(device)
    cfg = leaf.config
    n = 1 << degree_bits
    m = n << cfg.rate_bits
    rng = np.random.default_rng(16)
    nr = cfg.num_routed_wires
    data = dataclasses.replace(
        leaf, degree_bits=degree_bits,
        id_coords=F.rand_felts((nr, n), rng), sigma_vals=F.rand_felts((nr, n), rng),
        constants_oracle=SimpleNamespace(
            lde=_felts((leaf.constants_oracle.lde.shape[0], m), rng, device)),
    )

    def report(name, fn, got, want, work):
        if tuple(got.shape) != tuple(want.shape) or not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{name}: differs from the plain version")
        return _timed(fn, work)

    args = _permutation_rec(data, _permutation_args(
        data, rng, device, zeros=[(0, 255, 3), (0, 256, 70), (1, 256, 0)]), device)
    before = tprover.compute_permutation_polys.launches
    got = tprover.compute_permutation_polys(data, *args)
    launches = tprover.compute_permutation_polys.launches - before
    t0 = time.perf_counter()
    want = tprover.compute_permutation_polys_plain(data, *_cpu(args))
    plain_s = time.perf_counter() - t0
    line = report("permutation_polys 2^16", lambda: tprover.compute_permutation_polys(data, *args),
                  got, want, _permutation_work(data))
    print(f"[fused 2^{degree_bits}] permutation_polys n = {n}: {launches} launches, all "
          f"{want.numel()} values equal the plain version on CPU copies ({plain_s:.1f} s), "
          f"zero denominators at rows 255 and 256; {line}", flush=True)
    del args, got, want

    args = _quotient_rec(data, _quotient_args(data, rng, device), device)
    got = tprover.quotient_evals(data, *args)
    want = tprover.quotient_evals_plain(data, *args)
    line = report("quotient 2^19", lambda: tprover.quotient_evals(data, *args), got, want,
                  _quotient_work(data))
    print(f"[fused 2^{degree_bits}] quotient m = {m}: all {want.numel()} values equal "
          f"quotient_evals_plain run on the card (its field ops on kernel 1, held bit-exact "
          f"in the kernel phase); {line}", flush=True)
    del args, got, want, data
    torch.cuda.empty_cache()

    _composition_2_19(leaf, device, degree_bits + cfg.rate_bits)


def phase_aggregation_fri_tail(device, degree_bits: int = 16) -> None:
    """Kernels D, E and F at the private batch's degree 16 (the leaf's config
    and its four oracles' row counts): D on all 264 rows of 2^16 coefficients
    (262 at zeta, 2 at g * zeta), every row against `eval_openings_plain` run
    on the card; E's three rounds of schedule(16) in sequence (2^19 values
    in leaves of arity 2^4, then 2^15, then 2^11 into the last layer), each
    round's every value against `fold_round_plain` run on the card on the
    same input; F gathering 28 queries' rows and paths of the four oracles
    at m = 2^19 and of the three rounds (14 segments, a path a tree; 89 with
    a segment a level), into pinned host memory, against the plain gather.
    Each timed beside its bound."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.field import goldilocks as gl
    from qp_zk_circuits_tpu_torch.fri import oracle as fo
    from qp_zk_circuits_tpu_torch.fri import prover as fri
    from qp_zk_circuits_tpu_torch.hash import merkle
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts

    leaf = _leaf_data(device)
    cfg = leaf.config
    fri_cfg = cfg.fri_config
    n = 1 << degree_bits
    lde_bits = degree_bits + cfg.rate_bits
    m = 1 << lde_bits
    nc = cfg.num_challenges
    rows = leaf_oracle_rows(leaf)
    rng = np.random.default_rng(17)

    oracles = [SimpleNamespace(coeffs=_card_felts((r, n), 40 + i, device))
               for i, r in enumerate(rows)]
    args = (fo.point_records(device, [F.rand_felts(2, rng)], [F.rand_felts(2, rng)])[0], 2, nc)
    before = fo.eval_openings.launches
    got = fo.eval_openings(oracles, *args)
    launches = fo.eval_openings.launches - before
    want = fo.eval_openings_plain(oracles, *args)
    if not torch.equal(got, want):
        raise AssertionError(f"openings at n = 2^{degree_bits} differ from the plain version")
    line = _timed(lambda: fo.eval_openings(oracles, *args),
                  openings_work(sum(rows), sum(rows) + nc, n))
    print(f"[fri tail 2^{degree_bits}] openings {sum(rows) + nc} rows x 2^{degree_bits}, "
          f"{launches} launches: every row equals eval_openings_plain run on the card; {line}",
          flush=True)
    del oracles, got, want

    rounds = fri_rounds(leaf, degree_bits)
    layer = _card_felts((m >> rounds[0][1], 2 << rounds[0][1]), 45, device)
    layers, shift_pow = [], 0
    for r, (bits, a, nxt) in enumerate(rounds):
        call = (fri.beta_records(device, [F.rand_felts(2, rng)])[0], ts.REC_FRI_BETA, a, bits,
                shift_pow, nxt)
        layers.append(layer)
        folded = fri.fold_round(layer, *call)
        if not torch.equal(folded, fri.fold_round_plain(layer, *call)):
            raise AssertionError(f"fold round {r} at m = 2^{bits} differs from the plain version")
        line = _timed(lambda: fri.fold_round(layers[-1], *call), fold_work(1 << bits, a))
        print(f"[fri tail 2^{degree_bits}] fold round {r}: m = 2^{bits}, arity 2^{a}, next "
              f"2^{nxt}: all {folded.numel()} values equal fold_round_plain run on the card; "
              f"{line}", flush=True)
        layer, shift_pow = folded, shift_pow + a

    sources, trees = [], []
    for i, r in enumerate(rows):
        lde = _card_felts((r, m), 50 + i, device)
        sources.append(fri.GatherSource(lde.T, m - 1))
        trees.append(merkle.build_merkle_tree(lde.T, fri_cfg.cap_height))
    for t in trees:
        sources += fri._sibling_sources(t, m - 1)
    for leaves in layers:
        mask = leaves.shape[0] - 1
        trees.append(merkle.build_merkle_tree(leaves, min(fri_cfg.cap_height, mask.bit_length())))
        sources.append(fri.GatherSource(leaves, mask))
        sources += fri._sibling_sources(trees[-1], mask)
    levels = _per_level(sources, trees)
    q = fri_cfg.num_query_rounds
    indices = [0, m - 1] + [int(i) for i in rng.integers(0, m, q - 2)]
    got = fri.query_gather(sources, indices)
    want = gl.to_u64(fri.query_gather_plain(sources, indices))
    if not np.array_equal(got, want) or not np.array_equal(fri.query_gather(levels, indices), want):
        raise AssertionError(f"query gather at m = 2^{lde_bits} differs from the plain version")
    line = _timed(lambda: fri.query_gather(sources, indices), gather_work(q, got.shape[1]))
    print(f"[fri tail 2^{degree_bits}] query gather m = 2^{lde_bits}, {q} queries, "
          f"{len(sources)} segments ({len(levels)} a segment a level), {got.shape[1]} values "
          f"a query into pinned host memory: equal to the plain gather in both forms; {line}",
          flush=True)
    del sources, layers, layer, got
    torch.cuda.empty_cache()


def _verify_path(prover, blobs: list[bytes]) -> str:
    """Close the main path on the host: the port's WormholeVerifier on the
    card-built circuit data accepts each proof; the verifier.bin /
    common.bin pair of that data hashes to the keccak pins and loads with
    the pins enforced, and the loaded verifier accepts the last proof;
    copies of it with one FRI query leaf value or one public input changed
    are rejected. Returns a line with the host verify times."""
    import numpy as np

    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes
    from qp_zk_circuits_tpu_torch.plonk.verifier import VerificationError
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.wormhole import artifacts
    from qp_zk_circuits_tpu_torch.wormhole import canonical_pins as pins
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    from qp_zk_circuits_tpu_torch import native as nat
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import TRANSCRIPT_STAGES, VERIFY_STAGES, stage_times

    verifier = WormholeVerifier(prover.data)
    times = []
    for blob in blobs:
        proof = proof_from_bytes(blob)
        before = (nat.counts["fri_verify_queries"], nat.counts["eval_tape"])
        t = time.perf_counter()
        verifier.verify(proof)
        times.append(1e3 * (time.perf_counter() - t))
        if (nat.counts["fri_verify_queries"], nat.counts["eval_tape"]) != (before[0] + 1, before[1] + 1):
            raise AssertionError("a verify did not take the compiled FRI and vanishing paths")
    split = stage_times(VERIFY_STAGES + TRANSCRIPT_STAGES,
                        lambda: verifier.verify(proof_from_bytes(blobs[-1])))
    pair = artifacts.leaf_verifier_artifacts(prover.data)
    for name, pin in (("verifier.bin", pins.CANONICAL_LEAF_VERIFIER_KECCAK256),
                      ("common.bin", pins.CANONICAL_LEAF_COMMON_KECCAK256)):
        if artifacts.artifact_keccak(pair[name]) != pin:
            raise AssertionError(f"{name} of the card-built circuit data misses its keccak pin")
    loaded = WormholeVerifier.new_from_bytes(pair["verifier.bin"], pair["common.bin"],
                                             enforce_pins=True)
    t = time.perf_counter()
    public = loaded.verify(proof_from_bytes(blobs[-1]))
    loaded_ms = 1e3 * (time.perf_counter() - t)
    P = (1 << 64) - (1 << 32) + 1

    def leaf_value(p):
        step = p.fri_proof.query_rounds[0].steps[0]
        lv = np.array(step.leaf_values, dtype=np.uint64)
        lv[0, 0] = np.uint64((int(lv[0, 0]) + 1) % P)
        step.leaf_values = lv

    def public_input(p):
        pis = np.array(p.public_inputs, dtype=np.uint64)
        pis[3] = np.uint64((int(pis[3]) + 1) % P)
        p.public_inputs = pis

    rejected = []
    for name, tamper in (("a FRI query leaf value", leaf_value), ("a public input", public_input)):
        bad = proof_from_bytes(blobs[-1])
        tamper(bad)
        try:
            loaded.verify(bad)
        except VerificationError as e:
            rejected.append(f"{name}: {e}")
            continue
        raise AssertionError(f"the verifier accepted a proof with {name} changed")
    parts = "; ".join(f"{name} {v['ms']:.3f} ms ({v['calls']} calls)" for name, v in split.items())
    print(f"[verify split] one verify of the warm proof: {parts}", flush=True)
    return (f"[verify] WormholeVerifier accepts the cold and warm proofs through the compiled "
            f"query rounds and constraint tape (host "
            f"{', '.join(f'{t:.1f}' for t in times)} ms); verifier.bin and common.bin of the "
            f"card-built circuit data hash to the keccak pins and load with the pins enforced; "
            f"the loaded verifier accepts the warm proof ({loaded_ms:.1f} ms, volume_fee_bps "
            f"{public.volume_fee_bps}) and rejects {'; '.join(rejected)}; {card()}")


def phase_main_path(kernels) -> None:
    import torch

    from qp_zk_circuits_tpu_torch import native as nat
    from qp_zk_circuits_tpu_torch.plonk import transcript as ts
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import PROVE_STAGES, TRANSCRIPT_STAGES, stage_times
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
    tapes = nat.counts["wt_run"]
    blob, cold_s = prove_once()
    for k in kernels:
        k["launches"] = k["wrapper"].launches
    if nat.counts["wt_run"] != tapes:
        raise AssertionError("the cold proof ran a witness tape before its program was recorded")
    # the warm proof: its witness from the tape, the transcript's permutations
    # (a duplex each, and those of its absorbs) through the host library
    duplexes = []
    restore = _spy(ts.Challenger, "_duplex", duplexes)
    before = dict(nat.counts)
    try:
        blob2, warm_s = prove_once()
    finally:
        restore()
    ran = {k: nat.counts[k] - before.get(k, 0) for k in nat.counts}
    if ran.get("wt_run") != 1:
        raise AssertionError(f"the warm proof's witness did not come from the tape: {ran}")
    if not duplexes or ran.get("permute_batch", 0) < len(duplexes) or not ran.get("absorb_many"):
        raise AssertionError(f"the transcript's {len(duplexes)} duplexes did not all go through "
                             f"the host library: {ran}")
    stages = stage_times(PROVE_STAGES + TRANSCRIPT_STAGES, prove_once)
    transcript = stages["transcript (duplex + absorb)"]["ms"]
    print(f"[main] warm proof: witness from the tape (1 run); transcript {len(duplexes)} duplexes "
          f"and {ran['absorb_many']} absorbs through the host library ({ran['permutations']} "
          f"permutations in all); "
          f"stage-timed proof {stages['total']['ms']:.2f} ms: witness "
          f"{stages['witness (host)']['ms']:.2f} ms, transcript {transcript:.2f} ms", flush=True)
    for name, b in (("cold", blob), ("warm", blob2)):
        digest = hashlib.sha256(b).hexdigest()
        if len(b) != meta["len"] or digest != meta["sha256"]:
            raise AssertionError(f"{name} proof differs from the fixture: {len(b)} B, {digest}")
    verify_line = _verify_path(prover, [blob, blob2])
    missing = [k["name"] for k in kernels if k.get("path", True) is True and k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    rounds = len(cfg.fri_config.reduction_strategy.schedule(prover.data.degree_bits))
    limits = _single_limits(rounds)
    fused = {k["name"]: k["launches"] for k in kernels if k["name"] in limits}
    off = {name: n for name, n in fused.items() if not limits[name][0] <= n <= limits[name][1]}
    if off:
        raise AssertionError(f"stages outside their launch limits {limits}: {off}")
    kernel1 = {k["name"]: k["launches"] for k in kernels if k.get("kernel1")}
    if sum(kernel1.values()) > 5:
        raise AssertionError(f"kernel 1 launched {kernel1} times on the main path (at most 5)")
    counts = ", ".join(f"{k['name']}={k['launches']}" for k in kernels)
    print(f"[main] leaf: {cfg.num_wires} wires, degree_bits {prover.data.degree_bits}, "
          f"{cfg.fri_config.num_query_rounds} queries, {cfg.fri_config.proof_of_work_bits} PoW bits, "
          f"{rounds} FRI round(s); build {build_s:.2f} s, prove cold {1e3 * cold_s:.1f} ms, "
          f"warm {1e3 * warm_s:.1f} ms; proof {len(blob)} B == fixture; launches per proof: "
          f"{counts}; kernel-1 launches per proof: {sum(kernel1.values())}", flush=True)
    print(verify_line, flush=True)
    return prover


STAGED_ENV = "QZKT_STAGED_PROVER"


class _prover_env:
    """QZKT_STAGED_PROVER=1 for the span (staged=True), or unset (`prove`'s
    own dispatch: the fused prover at the leaf's degree). The phases run
    with it set (`main`), their checks the staged prover's internals; the
    [fused] phases lift it."""

    def __init__(self, staged: bool):
        self.staged = staged

    def __enter__(self):
        import os

        self.saved = os.environ.pop(STAGED_ENV, None)
        if self.staged:
            os.environ[STAGED_ENV] = "1"

    def __exit__(self, *exc):
        import os

        os.environ.pop(STAGED_ENV, None)
        if self.saved is not None:
            os.environ[STAGED_ENV] = self.saved


def _copies(fn, runs: int = 3) -> dict:
    """fn() `runs` times under torch.profiler, a run: the memcpy calls of the
    CUDA runtime ("calls", host side) and the device's copies by direction.
    Both are read because a device-side copy record was seen missing (a
    whole smoke's run, one in three proofs' host->device copies) where the
    runtime calls were there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    out = {way: sum(1 for n in device if f"Memcpy {way}" in n) / runs
           for way in ("HtoD", "DtoH", "DtoD")}
    out["calls"] = sum(1 for n in host if n.startswith("cudaMemcpy")) / runs
    return out


def phase_fused(kernels, zk_leaf) -> dict:
    """The JAX package's default path, the fused prover (plonk/
    prover_fused.py), through `prove`'s own dispatch:

      * WormholeProver(device="cuda").prove_inputs(test_inputs_0(), seed=0),
        a fresh prover, cold then warm, with every count at 0 just before
        the cold proof: both byte-equal to the fixture, every kernel of the
        path launched (kernels I and J among them), the staged grind's
        permute not; one upload and one download a proof (the transfer
        helpers' calls, and torch.profiler's host<->device copies of a warm
        proof: one each way) and the library launches;
      * the ZK leaf of [zk] in host rng (seed 7, the fixture) and device rng
        (accepted, and equal to the staged device-rng proof of the seed);
      * warm fused and staged leaf proofs in alternation, ms, the fused
        proof's device busy share and its `_last_prove_timings`, beside the
        card.
    Returns the fused leaf prover."""
    import statistics

    import torch

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import _device_profile
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import test_inputs_0
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    meta = json.loads(FIXTURE_META.read_text())[FIXTURE.name]
    transfers = []
    saved = tfused._upload, tfused._download

    def upload(*args):
        transfers.append("up")
        return saved[0](*args)

    def download(*args):
        transfers.append("down")
        return saved[1](*args)

    with _prover_env(staged=False):
        prover = WormholeProver(device="cuda")
        if not tprover.uses_fused(prover.data):
            raise AssertionError("[fused] the leaf does not take the fused prover")
        inputs = test_inputs_0()
        tfused._upload, tfused._download = upload, download
        try:
            blobs, runs, launches = [], [], []
            for _ in range(2):
                del transfers[:]
                proof, took, counts = _counted(kernels, lambda: prover.prove_inputs(inputs,
                                                                                   seed=0))
                blobs.append(proof_to_bytes(proof))
                runs.append(took)
                launches.append(counts)
                if transfers != ["up", "down"]:
                    raise AssertionError(f"[fused] a proof's transfers were {transfers}")
        finally:
            tfused._upload, tfused._download = saved
        for k in kernels:
            if k["name"] in ("transcript", "grind"):
                k["launches"] = launches[0][k["name"]]
        for name, b in zip(("cold", "warm"), blobs):
            digest = hashlib.sha256(b).hexdigest()
            if len(b) != meta["len"] or digest != meta["sha256"]:
                raise AssertionError(f"[fused] {name} proof differs from the fixture")
        # the staged grind's permute is kernel J on this path
        missing = [k["name"] for k in kernels if k.get("path", True) in (True, "fused")
                   and k["name"] != "poseidon2_permute" and launches[0][k["name"]] <= 0]
        if missing or launches[0]["poseidon2_permute"]:
            raise AssertionError(f"[fused] kernels not launched {missing}, staged grind "
                                 f"{launches[0]['poseidon2_permute']}")
        copies = _copies(lambda: prover.prove_inputs(inputs, seed=0))
        # two copies a proof, one of them device->host and none device to
        # device: the other is the upload
        if (copies["calls"], copies["DtoH"], copies["DtoD"]) != (2.0, 1.0, 0.0):
            raise AssertionError(f"[fused] a warm proof's copies: {copies}")
        verifier = WormholeVerifier(prover.data)
        for b in blobs:
            verifier.verify(proof_from_bytes(b))
        lib = sum(launches[1].values())
        counts = ", ".join(f"{n}={c}" for n, c in launches[1].items() if c)
        print(f"[fused] leaf: fresh prover, proof cold {1e3 * runs[0]:.1f} ms, warm "
              f"{1e3 * runs[1]:.1f} ms, both == fixture and accepted; one upload and one "
              f"download a proof, a warm proof's copies {copies}; {lib} library launches a "
              f"proof ({counts})", flush=True)

        # the ZK leaf, both rng modes
        zk_inputs = test_inputs_0()
        zk_blob = proof_to_bytes(zk_leaf.prove_inputs(zk_inputs, seed=ZK_SEED))
        if zk_blob != ZK_FIXTURE.read_bytes():
            raise AssertionError("[fused] the host-rng ZK leaf differs from its fixture")
        zk_pw = zk_leaf._partial_witness(zk_inputs)
        dev = proof_to_bytes(tprover.prove(zk_leaf.data, zk_pw, seed=ZK_SEED, rng_mode="device"))
        if zk_leaf.data.__dict__["_last_prove_timings"]["rng_mode"] != "device":
            raise AssertionError("[fused] the device-rng ZK leaf did not take the fused prover")
        WormholeVerifier(zk_leaf.data).verify(proof_from_bytes(dev))
        staged_dev = proof_to_bytes(tprover.prove_staged(zk_leaf.data, zk_pw, seed=ZK_SEED,
                                                         rng_mode="device"))
        if dev != staged_dev or dev == zk_blob:
            raise AssertionError("[fused] the device-rng ZK leaf differs from the staged one "
                                 "of its seed, or equals the host-rng one")
        print(f"[fused] ZK leaf (degree {zk_leaf.data.degree_bits}): host rng == fixture; "
              f"device rng accepted, == the staged device-rng proof", flush=True)

        # warm fused and staged leaf proofs in turns
        pw = prover._partial_witness(inputs)
        fused_ms, staged_ms, splits = [], [], []
        for r in range(12):
            for which in ((0, 1) if r % 2 == 0 else (1, 0)):
                t = time.perf_counter()
                if which == 0:
                    tprover.prove(prover.data, pw, seed=0)
                    torch.cuda.synchronize()
                    fused_ms.append(1e3 * (time.perf_counter() - t))
                    splits.append(dict(prover.data.__dict__["_last_prove_timings"]))
                else:
                    tprover.prove_staged(prover.data, pw, seed=0)
                    torch.cuda.synchronize()
                    staged_ms.append(1e3 * (time.perf_counter() - t))
        prof = _device_profile(lambda: tprover.prove(prover.data, pw, seed=0))
        fused_med = statistics.median(fused_ms)
        busy = ("device not measured" if prof["device_ms"] is None else
                f"device {prof['device_ms']:.3f} ms in {prof['device_launches']} device "
                f"launches, busy {100 * prof['device_ms'] / prof['profiled_wall_ms']:.1f} % of a "
                f"profiled {prof['profiled_wall_ms']:.2f} ms")
        split = {key: statistics.median(sp[key] for sp in splits)
                 for key in ("witness_pack_s", "upload_s", "dispatch_s", "execute_fetch_s",
                             "unpack_s")}
        print(f"[fused] warm leaf in turns, 12 each: fused median {fused_med:.2f} ms "
              f"(min {min(fused_ms):.2f}, max {max(fused_ms):.2f}), staged median "
              f"{statistics.median(staged_ms):.2f} ms (min {min(staged_ms):.2f}, max "
              f"{max(staged_ms):.2f}); fused {busy}; fused split (medians, s) {split}, "
              f"flat in/out MB {splits[-1]['flat_in_mb']}/{splits[-1]['flat_out_mb']}; "
              f"{card()}", flush=True)
    return prover


def _fused_launches(label: str, kernels, launches: dict, data, device_rng: bool) -> None:
    """A fused proof's launches: every kernel of the single path and of the
    fused path launched, within `_path_launches`' limits; kernel I once a
    segment (a commit each, the openings, each FRI round, the final
    polynomial, the witness and indices), kernel J once where the circuit
    grinds, the staged grind's permute never, kernel G one to four times in
    device rng and never else."""
    fcfg = data.config.fri_config
    rounds = len(fcfg.reduction_strategy.schedule(data.degree_bits))
    grinds = int(fcfg.proof_of_work_bits > 0)
    limits = {**_single_limits(rounds), "ntt": (1, 14), "eval_openings": (1, 2),
              "poseidon2_permute": (0, 0), "transcript": (6 + rounds, 6 + rounds),
              "grind": (grinds, grinds), "rand_felts": (1, 4) if device_rng else (0, 0)}
    missing = [k["name"] for k in kernels if k.get("path", True) in (True, "fused")
               and k["name"] not in limits and launches[k["name"]] <= 0]
    off = {n: launches[n] for n, (lo, hi) in limits.items() if not lo <= launches[n] <= hi}
    kernel1 = sum(launches[k["name"]] for k in kernels if k.get("kernel1"))
    if missing or off or kernel1 > 5:
        raise AssertionError(f"{label}: kernels not launched {missing}, launches outside "
                             f"{limits}: {off}, kernel 1 {kernel1}")


def _fused_batch_limits(k: int, rounds: int) -> dict:
    """The launch limits of a fused batch of k leaf proofs: the staged
    batch's stages (`_batch_limits`: a stacked kernel-3 call a commit and
    the final polynomials, a forest a commit and a FRI round, A-F a launch
    a group of 16), kernel I's batch form once a segment for all k (the
    three commits, the openings, each FRI round, the final polynomial, the
    witness and indices), kernel J's once; no single-proof transcript or
    grind, no staged grind's permute."""
    return {**_batch_limits(k, rounds), "poseidon2_permute": (0, 0),
            "transcript_batch": (6 + rounds, 6 + rounds), "grind_batch": (1, 1)}


def _check_fused_batch_launches(label: str, kernels, launches: dict, k: int, rounds: int,
                                chunks: int = 1) -> None:
    """Every stage of `chunks` fused batches of k proofs within
    `_fused_batch_limits`, kernel 1 at most five times a batch."""
    limits = {n: (chunks * lo, chunks * hi) for n, (lo, hi) in _fused_batch_limits(
        k, rounds).items()}
    off = {n: launches[n] for n, (lo, hi) in limits.items() if not lo <= launches[n] <= hi}
    kernel1 = sum(launches[x["name"]] for x in kernels if x.get("kernel1"))
    if off or kernel1 > 5 * chunks:
        raise AssertionError(f"{label}: launches outside their limits {limits}: {off}, "
                             f"kernel 1 {kernel1}")


def phase_fused_batch(kernels, prover, zk_leaf) -> None:
    """The JAX package's default batch and stream (plonk/prover_fused.py::
    prove_fused_batch, prove_fused_stream) through `prove_batch`'s and
    `prove_stream`'s own dispatch (QZKT_STAGED_PROVER lifted), on the
    [fused] phase's leaf prover:

      * fused leaf batches of the two real spends of
        two_real_leaves_same_block(), alternating, at K = 1, 4, 16 (cold and
        warm), 17 and 33, and a 48-leaf fused stream in chunks of 16 from a
        generator, each with the counts at 0 just before it and read just
        after: every proof equals its fixture (leaf_proof_real0/1.bin) and
        the port's verifier accepts it; one upload and one download a batch
        (a chunk: the stream's three uploads alternate two pinned slots);
        every stage within `_fused_batch_limits`; the warm K = 16 batch's
        library launches printed (at most BATCH_LAUNCHES_MAX) and its
        host<->device copies (torch.profiler: one each way); the kernel
        table's batch rows of kernels I and J take their launches from it;
      * a host-rng ZK batch of the ZK leaf of [zk], K = 4 (seed 7), equal to
        the staged batch (`prove_from_traces`) of the same seed, accepted;
      * per-proof ms of the warm fused K = 16 batch, the fused 48-stream,
        the staged K = 16 batch and the single fused proof, each from its
        inputs (the witness fill included), in alternating turns on the
        host clock (medians, min, max), the fused batch's and the stream's
        host split (`_last_prove_timings`; the stream's fill runs in its
        witness and pack, the batch's before it) and the fused batch's
        device busy share, beside the card."""
    import torch

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk import prover_fused as tfused
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import _device_profile
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import (
        test_inputs_0,
        two_real_leaves_same_block,
    )
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    t_phase = time.perf_counter()
    meta = json.loads(FIXTURE_META.read_text())
    names = ("leaf_proof_real0.bin", "leaf_proof_real1.bin")
    want = [FIXTURE.parent.joinpath(n).read_bytes() for n in names]
    for name, blob in zip(names, want):
        if len(blob) != meta[name]["len"] or hashlib.sha256(blob).hexdigest() != meta[name]["sha256"]:
            raise AssertionError(f"{name} is not the committed fixture")
    leaves = two_real_leaves_same_block()
    inputs = [leaves[i % 2] for i in range(STREAM_LEN)]
    verifier = WormholeVerifier(prover.data)
    rounds = len(prover.data.config.fri_config.reduction_strategy.schedule(
        prover.data.degree_bits))
    transfers = []
    saved = tfused._upload, tfused._download

    def upload(flat, b, slot=0):
        transfers.append(("up", slot))
        return saved[0](flat, b, slot)

    def download(*args):
        transfers.append(("down",))
        return saved[1](*args)

    def run(label, fn, count, chunk):
        """fn() with the counts at 0 and the transfers recorded: the bytes,
        the verifier, one upload and one download a chunk, the launch
        limits; returns (s, launches)."""
        del transfers[:]
        proofs, took, launches = _counted(kernels, fn)
        if len(proofs) != count:
            raise AssertionError(f"[fused batch] {label}: {len(proofs)} proofs for {count}")
        for i, proof in enumerate(proofs):
            if proof_to_bytes(proof) != want[i % 2]:
                raise AssertionError(f"[fused batch] {label}: proof {i} differs from its fixture")
            verifier.verify(proof)
        chunks = count // chunk
        ups = [t[1] for t in transfers if t[0] == "up"]
        if len(ups) != chunks or len(transfers) != 2 * chunks or ups != [i % 2 for i in range(
                chunks)]:
            raise AssertionError(f"[fused batch] {label}: transfers {transfers}")
        if prover.data.__dict__["_last_prove_timings"]["proofs"] != count:
            raise AssertionError(f"[fused batch] {label} did not take the fused batch")
        _check_fused_batch_launches(f"[fused batch] {label}", kernels, launches, chunk, rounds,
                                    chunks)
        return took, launches

    with _prover_env(staged=False):
        tfused._upload, tfused._download = upload, download
        try:
            cold_s, _ = run("cold K = 16", lambda: prover.prove_inputs_batch(
                inputs[:BATCH_K], seed=0), BATCH_K, BATCH_K)
            warm_s, launches = run(f"K = {BATCH_K}", lambda: prover.prove_inputs_batch(
                inputs[:BATCH_K], seed=0), BATCH_K, BATCH_K)
            others = []
            for k in (1, 4, BATCH_K + 1, 2 * BATCH_K + 1):
                took, other = run(f"K = {k}", lambda k=k: prover.prove_inputs_batch(
                    inputs[:k], seed=0), k, k)
                others.append(f"K = {k} {1e3 * took:.1f} ms, {sum(other.values())} launches")
            stream_s, stream_launches = run(
                f"stream of {STREAM_LEN}", lambda: prover.prove_inputs_stream(
                    (x for x in inputs), batch=BATCH_K, seed=0), STREAM_LEN, BATCH_K)
        finally:
            tfused._upload, tfused._download = saved
        for k in kernels:
            if k.get("path") == "fused_batch":
                k["launches"] = launches[k["name"]]
        total = sum(launches.values())
        missing = [k["name"] for k in kernels if k.get("path") in ("batch", "fused_batch")
                   and launches[k["name"]] <= 0]
        if missing or total > BATCH_LAUNCHES_MAX:
            raise AssertionError(f"[fused batch] K = {BATCH_K}: {total} library launches (at "
                                 f"most {BATCH_LAUNCHES_MAX}); not launched: {missing}")
        copies = _copies(lambda: prover.prove_inputs_batch(inputs[:BATCH_K], seed=0))
        if (copies["calls"], copies["DtoH"], copies["DtoD"]) != (2.0, 1.0, 0.0):
            raise AssertionError(f"[fused batch] a warm K = {BATCH_K} batch's copies: {copies}")
        print(f"[fused batch] leaf batches of the two real spends: K = {BATCH_K} cold "
              f"{1e3 * cold_s:.1f} ms, warm {1e3 * warm_s:.1f} ms; {'; '.join(others)}; stream "
              f"of {STREAM_LEN} in chunks of {BATCH_K} {1e3 * stream_s:.1f} ms, "
              f"{sum(stream_launches.values())} launches; every proof == its fixture and "
              f"accepted, one upload and one download a batch (a chunk; the stream's uploads "
              f"alternate two slots); warm K = {BATCH_K}: {total} library launches (at most "
              f"{BATCH_LAUNCHES_MAX}): {', '.join(f'{n}={v}' for n, v in launches.items() if v)}; "
              f"copies {copies}", flush=True)

        # the host-rng ZK batch against the staged batch of its seed
        zk_pws = [zk_leaf._partial_witness(leaves[i % 2]) for i in range(4)]
        zk_fused = [proof_to_bytes(p) for p in tprover.prove_batch(zk_leaf.data, zk_pws,
                                                                     seed=ZK_SEED)]
        if zk_leaf.data.__dict__["_last_prove_timings"].get("proofs") != 4:
            raise AssertionError("[fused batch] the ZK batch did not take the fused batch")
        with _prover_env(staged=True):
            zk_staged = [proof_to_bytes(p) for p in tprover.prove_batch(zk_leaf.data, zk_pws,
                                                                          seed=ZK_SEED)]
        if zk_fused != zk_staged or len(set(zk_fused)) != 4:
            raise AssertionError("[fused batch] the host-rng ZK batch differs from the staged "
                                 "batch of its seed")
        zk_verifier = WormholeVerifier(zk_leaf.data)
        for blob in zk_fused:
            zk_verifier.verify(proof_from_bytes(blob))
        print(f"[fused batch] ZK leaf batch, K = 4, host rng (seed {ZK_SEED}): == the staged "
              f"batch of its seed, accepted", flush=True)

        # per-proof times in turns, each from the inputs (the witness fill included)
        single_inputs = test_inputs_0()

        def staged_batch():
            with _prover_env(staged=True):
                return prover.prove_inputs_batch(inputs[:BATCH_K], seed=0)

        batch_name, stream_name = f"fused K = {BATCH_K}", f"fused stream {STREAM_LEN}"
        cases = {
            batch_name: (BATCH_K, lambda: prover.prove_inputs_batch(inputs[:BATCH_K], seed=0)),
            stream_name: (STREAM_LEN, lambda: prover.prove_inputs_stream(
                (x for x in inputs), batch=BATCH_K, seed=0)),
            f"staged K = {BATCH_K}": (BATCH_K, staged_batch),
            "fused single": (1, lambda: prover.prove_inputs(single_inputs, seed=0)),
        }
        ms = {name: [] for name in cases}
        splits = {batch_name: [], stream_name: []}
        # what each turn spent outside the prover: the interpreter's cyclic
        # collections (gc.callbacks) and the CUDA caching allocator's
        # cudaMalloc calls and retries (torch.cuda.memory_stats)
        turns = {name: [] for name in cases}
        collecting = {"start": 0.0, "s": 0.0, "full": 0}

        def on_gc(phase, info):
            if phase == "start":
                collecting["start"] = time.perf_counter()
                return
            collecting["s"] += time.perf_counter() - collecting["start"]
            collecting["full"] += info["generation"] == 2

        def allocator():
            stats = torch.cuda.memory_stats()
            return stats.get("num_device_alloc", -1), stats.get("num_alloc_retries", -1)

        order = list(cases)
        gc.callbacks.append(on_gc)
        try:
            for r in range(6):
                for name in (order if r % 2 == 0 else order[::-1]):
                    count, fn = cases[name]
                    gc_before, full_before = collecting["s"], collecting["full"]
                    alloc_before = allocator()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms[name].append(1e3 * (time.perf_counter() - t) / count)
                    alloc = allocator()
                    turns[name].append(dict(
                        turn=r, ms=round(ms[name][-1], 3),
                        gc_ms=round(1e3 * (collecting["s"] - gc_before), 3),
                        full_collections=collecting["full"] - full_before,
                        cuda_mallocs=alloc[0] - alloc_before[0],
                        alloc_retries=alloc[1] - alloc_before[1]))
                    if name in splits:
                        splits[name].append(dict(prover.data.__dict__["_last_prove_timings"]))
                        turns[name][-1]["split"] = {
                            key: splits[name][-1][key] for key in (
                                "witness_pack_s", "upload_s", "dispatch_s", "execute_fetch_s",
                                "unpack_s", "chunk_s") if key in splits[name][-1]}
        finally:
            gc.callbacks.remove(on_gc)
        for name, v in turns.items():
            slow = max(v, key=lambda x: x["ms"])
            print(f"[fused batch] {name}: ms a proof by turn {[x['ms'] for x in v]}; the "
                  f"slowest turn {slow}; collections over the 6 turns "
                  f"{sum(x['gc_ms'] for x in v):.1f} ms, "
                  f"{sum(x['full_collections'] for x in v)} of them full", flush=True)
        prof = _device_profile(cases[batch_name][1])
        busy = ("device not measured" if prof["device_ms"] is None else
                f"device {prof['device_ms']:.3f} ms in {prof['device_launches']} device launches, "
                f"busy {100 * prof['device_ms'] / prof['profiled_wall_ms']:.1f} % of a profiled "
                f"{prof['profiled_wall_ms']:.2f} ms")
        keys = ("witness_pack_s", "upload_s", "dispatch_s", "execute_fetch_s", "unpack_s")
        split = {name: {key: statistics.median(x[key] for x in v) for key in keys}
                 for name, v in splits.items()}
        print(f"[fused batch] ms a proof in turns, 6 each (median, min, max): " + "; ".join(
            f"{name} {statistics.median(v):.3f} ({min(v):.3f}, {max(v):.3f})"
            for name, v in ms.items()) + f"; fused K = {BATCH_K} {busy}; host split (medians, "
              f"s, a batch and a stream) {split}; {card()}", flush=True)
    print(f"[fused batch] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_fused_aggregation(kernels, built) -> None:
    """The aggregation circuits on the fused prover, as the miner's service
    proves them:

      * the canonical N = 2 private batch of [aggregation] after
        `warmup_fused(..., rng_mode="host")` (the JAX package's default
        warms device rng, whose bytes differ by design): the batch of the
        fixture's leaves in host rng (rng PB_RNG, seed PB_SEED) equal to
        canonical_private_batch.bin, accepted; warm fused and staged in
        turns;
      * the warm prover's device-rng batch ("auto" after its device-rng
        warm-up, the circuit's warmed mode restored) of [aggregation]'s
        seed: equal to the staged device-rng batch of that seed, accepted;
      * the public batch over that device-rng batch, its circuit warmed as
        `PublicBatchProver(warm_start=True)` warms it: cold and warm equal
        to the staged public batch of [aggregation], accepted.
    Every proof's launches those of the fused path (`_fused_launches`)."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.plonk.verifier import verify
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.wormhole import inputs as wi
    from qp_zk_circuits_tpu_torch.wormhole import private_batch as tpb
    from qp_zk_circuits_tpu_torch.wormhole.public_batch import PublicBatchProver

    mk = _agg_fixtures()
    prover, circuit, leaves = built["private"], built["private_circuit"], built["leaves"]
    data = circuit.data
    warm_mode = data.__dict__.get("_warm_rng_mode")
    want = _committed("canonical_private_batch.bin")

    def host_proof():
        return prover.aggregate(leaves, seed=mk.PB_SEED, rng=np.random.default_rng(mk.PB_RNG),
                                rng_mode="host")

    with _prover_env(staged=False):
        try:
            t0 = time.perf_counter()
            tprover.warmup_fused(data, tpb._dummy_witness(circuit, prover.dummy_template,
                                                           np.random.default_rng(0)),
                                 rng_mode="host")
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            if not tprover.uses_fused(data) or data.degree_bits <= tprover.FUSED_DEGREE_BITS_MAX:
                raise AssertionError("[fused] the private batch is not a warmed large circuit")
            runs = []
            for _ in range(2):
                proof, took, launches = _counted(kernels, host_proof)
                runs.append(took)
                if proof_to_bytes(proof) != want:
                    raise AssertionError("[fused] the fused host-rng private batch differs from "
                                         "the JAX fixture")
                _fused_launches("[fused] host-rng private batch", kernels, launches, data, False)
            verify(data, proof)
            staged = []
            for _ in range(2):
                with _prover_env(staged=True):
                    staged.append(_counted(kernels, host_proof)[1])
        finally:
            if warm_mode is not None:
                data.__dict__["_warm_rng_mode"] = warm_mode
        print(f"[fused] canonical private batch (N = {mk.N_LEAF}, degree {data.degree_bits}): "
              f"warmup_fused(host) {warm_s:.2f} s; fused host-rng proof cold {runs[0]:.3f} s, "
              f"warm {runs[1]:.3f} s, == JAX fixture, accepted; staged {staged[0]:.3f}, "
              f"{staged[1]:.3f} s; {card()}", flush=True)

        dev_runs = []
        for _ in range(2):
            dev_proof, took, launches = _counted(kernels, lambda: prover.aggregate(
                leaves, seed=mk.PB_SEED + 1, rng=np.random.default_rng(mk.PB_RNG + 1)))
            dev_runs.append(took)
            if data.__dict__["_last_prove_timings"]["rng_mode"] != "device":
                raise AssertionError("[fused] the warm private batch did not draw on the card")
            _fused_launches("[fused] device-rng private batch", kernels, launches, data, True)
            if proof_to_bytes(dev_proof) != proof_to_bytes(built["dev_proof"]):
                raise AssertionError("[fused] the device-rng private batch differs from the "
                                     "staged one of its seed")
        verify(data, dev_proof)
        print(f"[fused] warm private batch, device rng (auto): {dev_runs[0]:.3f}, "
              f"{dev_runs[1]:.3f} s, == the staged device-rng batch of its seed, accepted, "
              f"kernel G {launches['rand_felts']} launches", flush=True)

        pub = built["public_circuit"]
        t0 = time.perf_counter()
        pub_prover = PublicBatchProver(pub, lambda p: verify(data, p), built["dummy_pb"],
                                       warm_start=True)
        torch.cuda.synchronize()
        pub_warm_s = time.perf_counter() - t0
        if not tprover.uses_fused(pub.data):
            raise AssertionError("[fused] the warmed public batch does not take the fused prover")
        address = wi.BytesDigest(mk.PUB_ADDRESS)
        pub_runs = []
        for _ in range(2):
            out, took, launches = _counted(kernels, lambda: pub_prover.commit(
                [built["dev_proof"]], address).prove(seed=mk.PUB_SEED))
            pub_runs.append(took)
            _fused_launches("[fused] public batch", kernels, launches, pub.data, False)
            if proof_to_bytes(out) != built["public_proof"]:
                raise AssertionError("[fused] the fused public batch differs from the staged one")
        verify(pub.data, out)
    print(f"[fused] public batch (degree {pub.data.degree_bits}), warmed as warm_start warms "
          f"it ({pub_warm_s:.2f} s): proof cold {pub_runs[0]:.3f} s, warm {pub_runs[1]:.3f} s, "
          f"== the staged public batch, accepted; {sum(launches.values())} library launches "
          f"a proof; {card()}", flush=True)


def _single_limits(rounds: int) -> dict:
    """The launch limits of one leaf proof: (least, most) a wrapper. One
    tree a commit (wires, Z and partial products, quotient) and one a FRI
    round, at most two launches each; no per-level 2-to-1 launch; kernel G
    none (a host-rng or non-ZK proof draws nothing on the card)."""
    trees = 3 + rounds
    return {"ntt": (1, 7), "quotient": (1, 2), "permutation_polys": (1, 2),
            "fri_composition": (1, 2),
            "eval_openings": (1, 1), "fri_fold": (rounds, rounds), "query_gather": (1, 1),
            "poseidon2_merkle_tree": (trees, 2 * trees), "poseidon2_two_to_one": (0, 0),
            "rand_felts": (0, 0), **{name: (0, 0) for name in BATCH_FRI + FUSED_BATCH}}


#: the batch path's FRI kernels with a proof axis: a single proof runs none
BATCH_FRI = ("fri_composition_batch", "eval_openings_batch", "fri_fold_batch",
             "query_gather_batch")
#: kernels I and J with a proof axis: only the fused batch runs them
FUSED_BATCH = ("transcript_batch", "grind_batch")
#: a K = 16 leaf batch's library launches at most (129 when C, D, E, F, the
#: round's tree and the final iNTT ran once a proof: seven a proof)
BATCH_LAUNCHES_MAX = 30


def _batch_limits(k: int, rounds: int) -> dict:
    """The launch limits of a batch of k leaf proofs: (least, most) a
    wrapper. Kernel 3: one stacked iNTT and LDE a commit (at most six) and
    one stacked iNTT of the k final polynomials; the forest: one call of at
    most two launches a commit and a FRI round; A and B at most two
    launches a group of PROOFS_PER_LAUNCH proofs; C, D, F once a group
    (D twice above one chunk of coefficients), E a round a group; the grind
    one permute launch a sweep for all proofs (set by the caller from the
    witnesses); the single-proof forms of A-F and of the tree, and the
    per-level 2-to-1, never."""
    from qp_zk_circuits_tpu_torch import _cuda

    groups = -(-k // _cuda.PROOFS_PER_LAUNCH)
    forests = 3 + rounds
    return {"ntt": (2, 7), "poseidon2_merkle_forest": (forests, 2 * forests),
            "poseidon2_merkle_tree": (0, 0),
            "quotient_batch": (2 * groups, 2 * groups),
            "permutation_polys_batch": (groups, 2 * groups),
            "quotient": (0, 0), "permutation_polys": (0, 0), "poseidon2_two_to_one": (0, 0),
            "fri_composition": (0, 0), "eval_openings": (0, 0), "fri_fold": (0, 0),
            "query_gather": (0, 0), "fri_composition_batch": (groups, groups),
            "eval_openings_batch": (groups, 2 * groups),
            "fri_fold_batch": (rounds * groups, rounds * groups),
            "query_gather_batch": (groups, groups), "rand_felts": (0, 0),
            "transcript": (0, 0), "grind": (0, 0), **{name: (0, 0) for name in FUSED_BATCH}}


def _check_batch_launches(label: str, kernels, launches: dict, proofs, rounds: int,
                          chunk: int = BATCH_K) -> None:
    """Every stage of the len(proofs) / chunk batches of `chunk` proofs
    within `_batch_limits`; the grind one permute launch a sweep of 2^17
    candidates for all the chunk's proofs, as many as its highest PoW
    witness needs."""
    sweep = 1 << 17
    chunks = len(proofs) // chunk
    sweeps = sum(1 + max(int(p.fri_proof.pow_witness) for p in proofs[c * chunk:(c + 1) * chunk])
                 // sweep for c in range(chunks))
    limits = _batch_limits(chunk, rounds)
    limits = {n: (chunks * lo, chunks * hi) for n, (lo, hi) in limits.items()}
    limits["poseidon2_permute"] = (sweeps, sweeps)
    off = {n: launches[n] for n, (lo, hi) in limits.items() if not lo <= launches[n] <= hi}
    kernel1 = sum(launches[k["name"]] for k in kernels if k.get("kernel1"))
    if off or kernel1 > 5 * chunks:
        raise AssertionError(f"{label}: launches outside their limits {limits}: "
                             f"{off}, kernel 1 {kernel1}")


def phase_batch(kernels) -> None:
    """The batch and stream paths: WormholeProver(device="cuda") on the two
    real spends of two_real_leaves_same_block(), alternating, as batches of
    K = 1, 4, 16, 17 and 33 (kernel F's groups of 16, 16 and 1 into one
    pinned buffer) and as a 48-leaf stream in chunks of 16 (bench.py's
    shape). Each path runs with every wrapper's count set to 0 just before
    it and read just after: each proof's bytes equal its JAX fixture (the
    single proof's bytes), the port's verifier accepts it, and each stage
    stays within its launch limits (`_batch_limits`: C, D, E and F once a
    group of 16 proofs, a forest a commit and a FRI round, one stacked
    final iNTT); the batch rows of the kernel table take their launches from
    the warm K = 16 batch, whose library launches (at most
    BATCH_LAUNCHES_MAX) are printed beside a single proof's library and
    device launches (torch.profiler, glue kernels and copies included: 61,
    six of them the staged prover's challenge-record uploads).
    Then per-proof times of K = 1, 4, 16 and 17 batches, beside a single
    proof, on the host clock; and the batched grind's first sweep (2^17
    states for each of 16 proofs, one permute launch) against its plain
    version, timed beside its bound."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import _device_profile
    from qp_zk_circuits_tpu_torch.tools.timing import card, device_ms, median_ms
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import two_real_leaves_same_block
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    meta = json.loads(FIXTURE_META.read_text())
    names = ("leaf_proof_real0.bin", "leaf_proof_real1.bin")
    want = [FIXTURE.parent.joinpath(n).read_bytes() for n in names]
    for name, blob in zip(names, want):
        if len(blob) != meta[name]["len"] or hashlib.sha256(blob).hexdigest() != meta[name]["sha256"]:
            raise AssertionError(f"{name} is not the committed fixture")
    leaves = two_real_leaves_same_block()
    prover = WormholeProver(device="cuda")
    verifier = WormholeVerifier(prover.data)
    cfg = prover.data.config
    rounds = len(cfg.fri_config.reduction_strategy.schedule(prover.data.degree_bits))

    def run(label, fn, count, chunk):
        """fn() with the counts at 0; checks the bytes, the verifier, the
        launch limits of count / chunk batches; returns (s, launches)."""
        proofs, took, launches = _counted(kernels, fn)
        if len(proofs) != count:
            raise AssertionError(f"[batch] {label}: {len(proofs)} proofs for {count} inputs")
        for i, proof in enumerate(proofs):
            if proof_to_bytes(proof) != want[i % 2]:
                raise AssertionError(f"[batch] {label}: proof {i} differs from its fixture")
            verifier.verify(proof)
        _check_batch_launches(f"[batch] {label}", kernels, launches, proofs, rounds, chunk)
        return took, launches

    inputs = [leaves[i % 2] for i in range(STREAM_LEN)]
    cold_s, _ = run("cold batch", lambda: prover.prove_inputs_batch(inputs[:BATCH_K], seed=0),
                    BATCH_K, BATCH_K)
    batch_s, launches = run(f"batch of {BATCH_K}",
                            lambda: prover.prove_inputs_batch(inputs[:BATCH_K], seed=0), BATCH_K,
                            BATCH_K)
    for k in kernels:
        if k.get("path") == "batch":
            k["launches"] = launches[k["name"]]
    missing = [k["name"] for k in kernels if k.get("path") == "batch" and k["launches"] <= 0]
    total = sum(launches.values())
    if missing or total > BATCH_LAUNCHES_MAX:
        raise AssertionError(f"[batch] K = {BATCH_K}: {total} library launches (at most "
                             f"{BATCH_LAUNCHES_MAX}); not launched: {missing}")
    print(f"[batch] K = {BATCH_K} leaf batch (the two real spends alternating): cold "
          f"{1e3 * cold_s:.1f} ms, warm {1e3 * batch_s:.1f} ms ({1e3 * batch_s / BATCH_K:.2f} ms "
          f"a proof); every proof equals its fixture and verifies; {total} library launches "
          f"(at most {BATCH_LAUNCHES_MAX}; 129 before the FRI tail's proof axis): "
          f"{', '.join(f'{n}={v}' for n, v in launches.items() if v)}", flush=True)
    for k in (1, 4, BATCH_K + 1, 2 * BATCH_K + 1):
        took, other = run(f"batch of {k}", lambda k=k: prover.prove_inputs_batch(inputs[:k], seed=0),
                          k, k)
        print(f"[batch] K = {k}: {1e3 * took:.1f} ms, every proof equals its fixture and "
              f"verifies; {sum(other.values())} library launches", flush=True)
    stream_s, stream_launches = run(
        f"stream of {STREAM_LEN}", lambda: prover.prove_inputs_stream(
            (x for x in inputs), batch=BATCH_K, seed=0), STREAM_LEN, BATCH_K)
    print(f"[batch] stream of {STREAM_LEN} leaves in chunks of {BATCH_K} (a generator of "
          f"inputs): {1e3 * stream_s:.1f} ms, {1e3 * stream_s / STREAM_LEN:.2f} ms a proof; every "
          f"proof equals its fixture and verifies; {sum(stream_launches.values())} library "
          f"launches", flush=True)
    single, _, single_launches = _counted(kernels, lambda: prover.prove_inputs(inputs[0], seed=0))
    if proof_to_bytes(single) != want[0]:
        raise AssertionError("[batch] the single proof differs from its fixture")
    prof = _device_profile(lambda: prover.prove_inputs(inputs[0], seed=0))
    # 55 until the challenge records: since then kernels A, B, C, D, E (one
    # FRI round) and F take the staged prover's host challenges (F: its
    # indices) in one upload each, six more copies
    if prof["device_launches"] != 61:
        raise AssertionError(f"[batch] a single leaf proof made {prof['device_launches']} device "
                             "launches, not 61")
    print(f"[batch] a single leaf proof: {sum(single_launches.values())} library launches, "
          f"{prof['device_launches']} device launches (torch.profiler, glue kernels included)",
          flush=True)
    per_proof = {}
    for k in (1, 4, BATCH_K, BATCH_K + 1):
        per_proof[k] = _host_median_ms(
            lambda k=k: (prover.prove_inputs_batch(inputs[:k], seed=0), torch.cuda.synchronize()),
            runs=3) / k
    single_ms = _host_median_ms(lambda: (prover.prove_inputs(inputs[0], seed=0),
                                         torch.cuda.synchronize()), runs=5)
    print(f"[batch] ms a proof (median of 3 batches): "
          f"{', '.join(f'K = {k}: {v:.2f}' for k, v in per_proof.items())}; single proof "
          f"{single_ms:.2f}; {card()}", flush=True)
    # the batched grind's first sweep: 2^17 candidates for each of 16 proofs
    # in one kernel-2 permute launch
    states = _felts((BATCH_K << 17, ps.WIDTH), np.random.default_rng(14), "cuda")
    got, want = ps.permute(states), ps.permute_plain(states)
    if not torch.equal(got, want):
        raise AssertionError("[batch] the grind's sweep of 16 proofs differs from the plain version")
    perm_ops = PERM_MULS * OPS_MUL + PERM_ADDS * OPS_ADD
    bound, by = _bound((2 * states.numel() * 8, states.shape[0] * perm_ops))
    plain = median_ms(lambda: ps.permute_plain(states), runs=1, warmup=0)
    print(f"[batch] the grind's sweep for {BATCH_K} proofs ({states.shape[0]} states, one "
          f"permute launch): bit-exact; {median_ms(lambda: ps.permute(states), runs=10):.4f} ms, "
          f"device {device_ms(lambda: ps.permute(states)):.4f} ms (plain on the card "
          f"{plain:.3f} ms, bound {bound:.4f} ms by {by})", flush=True)
    _batch_tail_timings(prover.data)


def _batch_tail_timings(data) -> None:
    """The batch's other FRI-tail calls at K = 16, each against its plain
    version on the card and timed beside its bound: the round's forest (16
    trees of the (m >> a, 2^(a+1)) leaf rows) and the stacked iNTT of the 16
    final polynomials with the unshift folded in; and the bound of the
    K = 16 ZK leaf batch's grouped LDE (kernel 3 into the salted (16, 139,
    4096) buffer, the `_commit_j` salt row), beside its device time."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.field import gf_np as F
    from qp_zk_circuits_tpu_torch.hash import poseidon2 as ps
    from qp_zk_circuits_tpu_torch.poly import ntt
    from qp_zk_circuits_tpu_torch.tools.timing import device_ms, median_ms

    rng = np.random.default_rng(25)
    cfg = data.config
    lde_bits = data.degree_bits + cfg.rate_bits
    (a,) = cfg.fri_config.reduction_strategy.schedule(data.degree_bits)
    cap = min(cfg.fri_config.cap_height, lde_bits - a)
    rows, cols = 1 << (lde_bits - a), 2 << a
    leaves = _felts((BATCH_K, rows, cols), rng, "cuda")
    final = _felts((2 * BATCH_K, rows), rng, "cuda")
    unshift = int(F.inv(F.pow_scalar(F.MULTIPLICATIVE_GROUP_GENERATOR, 1 << a)))
    log_f = rows.bit_length() - 1
    zk_x = _felts((BATCH_K * ZK_LEAF_WIRES, ZK_LEAF_N), rng, "cuda")
    zk_buf = torch.zeros((BATCH_K, ZK_LEAF_WIRES + 4, ZK_LEAF_M), dtype=torch.int64, device="cuda")
    g = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    cases = (
        ("the round's forest", lambda: ps.merkle_forest(leaves, cap),
         lambda: ps.merkle_forest_plain(leaves, cap),
         tuple(BATCH_K * x for x in tree_work(rows, cols, cap))),
        ("the stacked final iNTT", lambda: ntt.batched_ntt(final, log_f, inverse=True,
                                                            out_shift=unshift),
         lambda: ntt.batched_ntt_plain(final, log_f, inverse=True, out_shift=unshift),
         ntt_work(2 * BATCH_K, rows, log_f, inverse=True, out_shift=True)),
        ("the ZK batch's grouped LDE", lambda: ntt.batched_ntt(
            zk_x, ZK_LEAF_M.bit_length() - 1, shift=g, out=zk_buf[:, :ZK_LEAF_WIRES]),
         lambda: ntt.batched_ntt_plain(zk_x, ZK_LEAF_M.bit_length() - 1, shift=g),
         ntt_work(BATCH_K * ZK_LEAF_WIRES, ZK_LEAF_N, ZK_LEAF_M.bit_length() - 1, shift=True)),
    )
    for label, run, plain, work in cases:
        got, want = run(), plain()
        flat = [x for tree in got for x in tree] if isinstance(got, list) else [got.reshape(-1)]
        ref = [x for tree in want for x in tree] if isinstance(want, list) else [want.reshape(-1)]
        if not all(torch.equal(x, y) for x, y in zip(flat, ref, strict=True)):
            raise AssertionError(f"[batch] {label} differs from its plain version")
        bound, by = _bound(work)
        print(f"[batch] {label} at K = {BATCH_K}: bit-exact; {median_ms(run, runs=10):.4f} ms, "
              f"device {device_ms(run):.4f} ms (plain on the card "
              f"{median_ms(plain, runs=1, warmup=0):.3f} ms, bound {bound:.5f} ms by {by})",
              flush=True)


def phase_zk(kernels) -> None:
    """The ZK path: the private batch's config on the leaf circuit
    (WormholeProver(wormhole_private_batch_circuit_config(), device="cuda"),
    degree 9). Each run with every wrapper's count set to 0 just before it
    and read just after: host-rng proofs of test_inputs_0() (cold, warm)
    equal the committed JAX fixture within the single proof's limits and
    launch kernel G never; a device-rng proof launches it at most four
    times (the blinding rows and three salts), is accepted and differs from
    the host one, and repeats for the same seed; a K = 16 batch and a
    48-leaf stream in chunks of 16 of the two real spends (host rng): proof
    0 equals the single proof of the same seed, every proof is accepted,
    within the batch's limits; a copy with a salt felt of an opened row
    changed is rejected. Then warm medians and the device's busy share."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.fri.config import SALT_SIZE
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_from_bytes, proof_to_bytes
    from qp_zk_circuits_tpu_torch.plonk.verifier import VerificationError
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import _device_profile
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.utils.config_policy import wormhole_private_batch_circuit_config
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import (
        test_inputs_0,
        two_real_leaves_same_block,
    )
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    meta = json.loads(FIXTURE_META.read_text())[ZK_FIXTURE.name]
    want = ZK_FIXTURE.read_bytes()
    if len(want) != meta["len"] or hashlib.sha256(want).hexdigest() != meta["sha256"]:
        raise AssertionError(f"{ZK_FIXTURE.name} is not the committed fixture")
    t0 = time.time()
    prover = WormholeProver(wormhole_private_batch_circuit_config(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    data = prover.data
    cfg = data.config
    verifier = WormholeVerifier(data)
    rounds = len(cfg.fri_config.reduction_strategy.schedule(data.degree_bits))
    inputs = test_inputs_0()

    def run(label, fn, limits):
        """fn() with the counts at 0; checks each stage's launches against
        `limits` (kernel 1 at most five a proof); returns (out, s, launches)."""
        for k in kernels:
            k["wrapper"].launches = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
        off = {n: launches[n] for n, (lo, hi) in limits.items() if not lo <= launches[n] <= hi}
        kernel1 = sum(launches[k["name"]] for k in kernels if k.get("kernel1"))
        if off or kernel1 > 5:
            raise AssertionError(f"[zk] {label}: launches outside their limits {limits}: "
                                 f"{off}, kernel 1 {kernel1}")
        return out, took, launches

    def host():
        return proof_to_bytes(prover.prove_inputs(inputs, seed=ZK_SEED))

    def device():
        return proof_to_bytes(tprover.prove_staged(data, prover._partial_witness(inputs),
                                                   seed=ZK_SEED, rng_mode="device"))

    single = _single_limits(rounds)
    cold, cold_s, _ = run("cold host-rng proof", host, single)
    warm, warm_s, host_launches = run("warm host-rng proof", host, single)
    for name, blob in (("cold", cold), ("warm", warm)):
        if blob != want:
            raise AssertionError(f"[zk] the {name} host-rng proof differs from the JAX fixture")
        verifier.verify(proof_from_bytes(blob))
    dev_blob, dev_s, dev_launches = run("device-rng proof", device, {**single, "rand_felts": (1, 4)})
    for k in kernels:
        if k.get("path") == "zk":
            k["launches"] = dev_launches[k["name"]]
    if dev_blob == want:
        raise AssertionError("[zk] the device-rng proof equals the host-rng one")
    verifier.verify(proof_from_bytes(dev_blob))
    if run("second device-rng proof", device, {"rand_felts": (1, 4)})[0] != dev_blob:
        raise AssertionError("[zk] two device-rng proofs of one seed differ")

    bad = proof_from_bytes(warm)
    row = np.array(bad.fri_proof.query_rounds[0].initial_rows[1], dtype=np.uint64)
    row[-SALT_SIZE] = np.uint64((int(row[-SALT_SIZE]) + 1) % ((1 << 64) - (1 << 32) + 1))
    bad.fri_proof.query_rounds[0].initial_rows[1] = row
    try:
        verifier.verify(bad)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("[zk] the verifier accepted a proof with a salt felt changed")

    leaves = two_real_leaves_same_block()
    batch_inputs = [leaves[i % 2] for i in range(STREAM_LEN)]
    first = proof_to_bytes(prover.prove_inputs(batch_inputs[0], seed=ZK_SEED))

    def run_batch(label, fn, count):
        for k in kernels:
            k["wrapper"].launches = 0
        t = time.perf_counter()
        proofs = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
        if len(proofs) != count or proof_to_bytes(proofs[0]) != first:
            raise AssertionError(f"[zk] {label}: {len(proofs)} proofs, proof 0 not the single "
                                 "proof of the same seed")
        for proof in proofs:
            verifier.verify(proof)
        _check_batch_launches(f"[zk] {label}", kernels, launches, proofs, rounds)
        return took, sum(launches.values())

    def batch():
        return prover.prove_inputs_batch(batch_inputs[:BATCH_K], seed=ZK_SEED)

    batch_cold_s, _ = run_batch("cold batch", batch, BATCH_K)
    batch_s, batch_launches = run_batch(f"batch of {BATCH_K}", batch, BATCH_K)
    stream_s, stream_launches = run_batch(
        f"stream of {STREAM_LEN}", lambda: prover.prove_inputs_stream(
            (x for x in batch_inputs), batch=BATCH_K, seed=ZK_SEED), STREAM_LEN)

    host_ms = _host_median_ms(lambda: (host(), torch.cuda.synchronize()), runs=5)
    dev_ms = _host_median_ms(lambda: (device(), torch.cuda.synchronize()), runs=5)
    batch_ms = _host_median_ms(lambda: (batch(), torch.cuda.synchronize()), runs=3) / BATCH_K
    busy = {mode: _device_profile(fn) for mode, fn in (("host", host), ("device", device))}
    busy_batch = _device_profile(batch)

    def share(profile, ms):
        return "not measured" if profile["device_ms"] is None else (
            f"{profile['device_ms']:.3f} device ms, busy {100 * profile['device_ms'] / ms:.1f} %, "
            f"{profile['device_launches']} device launches")

    lib = ", ".join(f"{n}={v}" for n, v in host_launches.items() if v)
    print(f"[zk] leaf under the private batch's config: {cfg.num_wires} wires, "
          f"{cfg.num_routed_wires} routed, degree_bits {data.degree_bits} ({data.num_rows_used} "
          f"rows used), {cfg.fri_config.num_query_rounds} queries, "
          f"{cfg.fri_config.proof_of_work_bits} PoW bits; build {build_s:.2f} s; host-rng proof "
          f"cold {1e3 * cold_s:.1f} ms, warm {1e3 * warm_s:.1f} ms, {len(warm)} B == fixture; "
          f"library launches a proof: {lib}", flush=True)
    print(f"[zk] device-rng proof: {1e3 * dev_s:.1f} ms, kernel G {dev_launches['rand_felts']} "
          f"launches, accepted, not the host-rng bytes, the same for the same seed; a changed "
          f"salt felt rejected: {rejected}", flush=True)
    print(f"[zk] K = {BATCH_K} batch: cold {1e3 * batch_cold_s:.1f} ms, warm "
          f"{1e3 * batch_s:.1f} ms, {batch_launches} library launches; stream of {STREAM_LEN} "
          f"in chunks of {BATCH_K}: {1e3 * stream_s:.1f} ms ({1e3 * stream_s / STREAM_LEN:.2f} ms "
          f"a proof), {stream_launches} library launches; proof 0 equals the single proof and "
          f"every proof verifies", flush=True)
    print(f"[zk] warm medians: host-rng {host_ms:.2f} ms ({share(busy['host'], host_ms)}); "
          f"device-rng {dev_ms:.2f} ms ({share(busy['device'], dev_ms)}); batch "
          f"{batch_ms:.2f} ms a proof ({share(busy_batch, batch_ms * BATCH_K)} a batch); "
          f"{card()}", flush=True)
    return prover


def philox_sass_mix() -> dict:
    """Kernel G's compiled instructions a Philox block: `tools/sass_mix.py`'s
    count of the 16-byte-store instance's main loop (its largest innermost
    loop, ILP blocks an iteration; ILP read from csrc/random.cu), by class,
    divided by ILP."""
    import re

    from qp_zk_circuits_tpu_torch import _cuda
    from qp_zk_circuits_tpu_torch.tools import sass_mix

    src = _cuda.CSRC / "random.cu"
    ilp = int(re.search(r"constexpr int ILP = (\d+);", src.read_text()).group(1))
    (insns,) = [v for k, v in sass_mix.parse(sass_mix.disassemble(src)).items()
                if "rand_felts_kernel" in k and "ILb1" in k]
    first, last = max(sass_mix.loops(insns), key=lambda span: span[1] - span[0])
    ops, classes = sass_mix.mix(insns, first, last)
    per_block = {k: v / ilp for k, v in classes.items()}
    per_block["all"] = sum(classes.values()) / ilp
    per_block["IMAD.WIDE"] = sum(v for k, v in ops.items() if k.startswith("IMAD.WIDE")) / ilp
    return per_block


def phase_aggregation_rand(device, degree_bits: int = 16, rate: int = 3) -> None:
    """Kernel G at the private batch's degree-16 draws: the blinding rows,
    135 x (2^16 - 64) felts written through a strided view of a 135 x 2^16
    trace, and the three salts' 4 x 2^19 rows; and at that size the
    scalar-store paths: the trace's columns from an odd start, `[:, 63:]`
    (an odd row length, no pair aligned, rows that split Philox blocks), a
    transposed 2^16 x 135 trace's view and one column of it; each (every
    draw more blocks than one grid's threads) against the plain version run
    on the card (too slow on the host at this size), bit-exact, nothing
    written outside its view, and timed beside its bound; then the
    kernel's compiled instructions a block (`philox_sass_mix`)."""
    import torch

    from qp_zk_circuits_tpu_torch.field import random as frandom
    from qp_zk_circuits_tpu_torch.tools.timing import device_ms, median_ms

    n = 1 << degree_bits
    trace = torch.zeros((ZK_LEAF_WIRES, n), dtype=torch.int64, device=device)
    blind = trace[:, 64:]
    salts = torch.empty((3, 4, n << rate), dtype=torch.int64, device=device)
    draws = [(0, blind)] + [(1 + i, salts[i]) for i in range(3)]
    odd_trace = torch.zeros((ZK_LEAF_WIRES, n), dtype=torch.int64, device=device)
    cols_trace = torch.zeros((n, ZK_LEAF_WIRES), dtype=torch.int64, device=device)
    edges = [(odd_trace, odd_trace[:, 63:]), (cols_trace, cols_trace.T),
             (cols_trace, cols_trace[:, 5:6])]
    for stream, out in draws + [(4 + i, view) for i, (_, view) in enumerate(edges)]:
        frandom.rand_felts(RAND_KEY, stream, out)
        want = frandom.rand_felts_plain(RAND_KEY, stream,
                                        torch.empty(tuple(out.shape), dtype=torch.int64,
                                                    device=device))
        if not torch.equal(out, want):
            raise AssertionError(f"[rand 2^{degree_bits}] stream {stream} differs from the plain "
                                 "version")
    if trace[:, :64].any():
        raise AssertionError(f"[rand 2^{degree_bits}] kernel G wrote outside the blinding columns")
    for base, view in edges:
        view.zero_()
        if base.any():
            raise AssertionError(f"[rand 2^{degree_bits}] kernel G wrote outside a view")
    del odd_trace, cols_trace, edges

    def all_draws():
        for stream, out in draws:
            frandom.rand_felts(RAND_KEY, stream, out)

    lines = []
    for label, fn, count in (
            (f"blinding {ZK_LEAF_WIRES} x {n - 64}", lambda: frandom.rand_felts(RAND_KEY, 0, blind),
             blind.numel()),
            (f"salts 3 x 4 x 2^{degree_bits + rate}", lambda: [
                frandom.rand_felts(RAND_KEY, 1 + i, salts[i]) for i in range(3)], salts.numel()),
            ("all four draws", all_draws, blind.numel() + salts.numel())):
        bound, by = _bound(rand_felts_work(count))
        lines.append(f"{label}: {median_ms(fn, runs=10):.4f} ms, device {device_ms(fn):.4f} ms, "
                     f"bound {bound:.4f} ms by {by}")
    count = blind.numel() + salts.numel()
    randint = median_ms(lambda: torch.randint(0, (1 << 63) - 1, (count,), dtype=torch.int64,
                                              device=device), runs=10)
    mix = philox_sass_mix()
    print(f"[rand 2^{degree_bits}] kernel G at the private batch's draws, all bit-exact against "
          f"the plain version on the card (and the odd-start, transposed and one-column views "
          f"of 2^{degree_bits} rows): {'; '.join(lines)}; torch.randint of {count} int64s "
          f"(another stream) {randint:.4f} ms; SASS a block (tools/sass_mix.py, the 16-byte "
          f"store instance's main loop): {mix['all']:g} instructions, {mix['IMAD.WIDE']:g} "
          f"IMAD.WIDE, " + ", ".join(f"{k} {v:g}" for k, v in sorted(mix.items())
                                    if k not in ("all", "IMAD.WIDE")), flush=True)


AGG_DIR = ROOT / "tests" / "torch_fixtures"


def _agg_fixtures():
    """tests/torch_fixtures/make_agg_fixture.py: the recursion and
    aggregation fixtures' seeds and configs (it imports no JAX until one of
    its parts runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_agg_fixture",
                                                  AGG_DIR / "make_agg_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _committed(name: str) -> bytes:
    """A committed fixture's bytes, checked against fixtures.json."""
    meta = json.loads(FIXTURE_META.read_text())[name]
    blob = (AGG_DIR / name).read_bytes()
    if len(blob) != meta["len"] or hashlib.sha256(blob).hexdigest() != meta["sha256"]:
        raise AssertionError(f"{name} is not the committed fixture")
    return blob


def _same_vdata(label: str, data, prefix: str) -> None:
    """The card-built circuit's verifier data against a fixture's pair."""
    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData

    vd = VerifierCircuitData.from_circuit_data(data)
    if (vd.to_common_bytes() != _committed(f"{prefix}_common.bin")
            or vd.to_verifier_only_bytes() != _committed(f"{prefix}_verifier.bin")):
        raise AssertionError(f"{label}: the verifier data differs from the JAX package's")


def _counted(kernels, fn):
    """fn() with every wrapper's count at 0: (out, seconds, launches)."""
    import torch

    for k in kernels:
        k["wrapper"].launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, {k["name"]: k["wrapper"].launches for k in kernels}


def _path_launches(label: str, kernels, launches: dict, rounds: int, device_rng: bool) -> None:
    """A single proof's launches: every kernel of the single path launched,
    within `_single_limits` with the larger circuits' second launches (a
    kernel-3 transform above 2^12 points takes two passes, kernel D two
    launches above one chunk of 1024 coefficients) and kernel G one to four
    times for a device-rng proof; kernel 1 at most five times."""
    limits = {**_single_limits(rounds), "ntt": (1, 14), "eval_openings": (1, 2)}
    if device_rng:
        limits["rand_felts"] = (1, 4)
    missing = [k["name"] for k in kernels if k.get("path", True) is True
               and launches[k["name"]] <= 0]
    off = {n: launches[n] for n, (lo, hi) in limits.items() if not lo <= launches[n] <= hi}
    kernel1 = sum(launches[k["name"]] for k in kernels if k.get("kernel1"))
    if missing or off or kernel1 > 5:
        raise AssertionError(f"{label}: kernels not launched {missing}, launches outside "
                             f"{limits}: {off}, kernel 1 {kernel1}")


def phase_recursion(kernels) -> None:
    """tests/test_recursion.py's circuits on the card: the inner circuit
    z = x * y and the outer circuit that verifies its proof (degree 11).
    The outer verifier data and both proofs (seeds 1 and 2) equal the JAX
    fixtures byte for byte; the outer proof is accepted; the outer witness
    runs on the compiled tape from its second run on."""
    import qp_zk_circuits_tpu_torch as tpkg
    from qp_zk_circuits_tpu_torch import native as nat
    from qp_zk_circuits_tpu_torch.plonk.builder import PartialWitness
    from qp_zk_circuits_tpu_torch.plonk.prover import prove
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.plonk.verifier import verify
    from qp_zk_circuits_tpu_torch.recursion.verifier_gadget import fill_proof_targets
    from qp_zk_circuits_tpu_torch.tools.timing import card

    mk = _agg_fixtures()
    for mod in ("fri.config", "plonk.config", "plonk.serialization", "recursion.verifier_gadget"):
        __import__(f"qp_zk_circuits_tpu_torch.{mod}")
    t0 = time.perf_counter()
    inner, x, y, _, outer, pt = mk.recursion_circuits(tpkg, lambda b: b.build(device="cuda"))
    build_s = time.perf_counter() - t0
    _same_vdata("[recursion] outer", outer, "recursion_outer")
    pw = PartialWitness()
    pw.set_target(x, mk.INNER_WITNESS[0])
    pw.set_target(y, mk.INNER_WITNESS[1])
    inner_proof = prove(inner, pw, seed=mk.INNER_SEED)
    if proof_to_bytes(inner_proof) != _committed("recursion_inner_proof.bin"):
        raise AssertionError("[recursion] the inner proof differs from the JAX fixture")
    times = []
    for run in range(2):
        opw = PartialWitness()
        fill_proof_targets(opw, pt, inner_proof)
        tapes = nat.counts["wt_run"]
        outer_proof, took, launches = _counted(kernels, lambda: prove(outer, opw, seed=mk.OUTER_SEED))
        times.append(took)
        if run and nat.counts["wt_run"] != tapes + 1:
            raise AssertionError("[recursion] the second outer witness did not run on the tape")
        if proof_to_bytes(outer_proof) != _committed("recursion_outer_proof.bin"):
            raise AssertionError("[recursion] the outer proof differs from the JAX fixture")
    rounds = len(outer.config.fri_config.reduction_strategy.schedule(outer.degree_bits))
    _path_launches("[recursion] outer proof", kernels, launches, rounds, False)
    t = time.perf_counter()
    verify(outer, outer_proof)
    verify_ms = 1e3 * (time.perf_counter() - t)
    print(f"[recursion] outer circuit verifying a proof of z = x * y: degree_bits "
          f"{outer.degree_bits} ({outer.num_rows_used} rows used), {rounds} FRI rounds; build of "
          f"both {build_s:.1f} s; outer verifier data, inner and outer proofs == JAX fixtures; "
          f"outer proof cold {1e3 * times[0]:.1f} ms, warm {1e3 * times[1]:.1f} ms (witness "
          f"on the tape), verify {verify_ms:.1f} ms; {card()}", flush=True)


def _agg_test_profile(kernels, mk) -> None:
    """The aggregation test profile (tests/test_aggregation.py, N = 2,
    reduced FRI) on the card: the leaf, private batch and public batch
    circuits' verifier data equal the JAX package's; the host-rng private
    batch over the fixture leaves (commit on default_rng(PB_RNG), seed
    PB_SEED) and the public batch over [it, the fixture's dummy private
    batch] equal the JAX fixtures byte for byte. A fake leaf
    (`wormhole/fake_leaf.py`: the leaf's 21 public inputs and none of its
    constraints) proves the first leaf's public inputs, verifies under its
    own circuit and is refused at the batch's admission, where the real
    leaf's verifier data checks it (the reference's VK-substitution case).
    The fake circuit is smaller than the leaf, so what refuses its proof is
    its shape (the number of FRI commit caps), before the constants cap or
    the digest is compared."""
    import numpy as np

    import qp_zk_circuits_tpu_torch as tpkg
    from qp_zk_circuits_tpu_torch.plonk.serialization import (
        VerifierCircuitData,
        proof_from_bytes,
        proof_to_bytes,
    )
    from qp_zk_circuits_tpu_torch.plonk.verifier import VerificationError, verify
    from qp_zk_circuits_tpu_torch.wormhole import inputs as wi
    from qp_zk_circuits_tpu_torch.wormhole.fake_leaf import FakeLeafCircuit
    from qp_zk_circuits_tpu_torch.wormhole.leaf_circuit import WormholeCircuit
    from qp_zk_circuits_tpu_torch.wormhole.private_batch import PrivateBatchCircuit, PrivateBatchProver
    from qp_zk_circuits_tpu_torch.wormhole.public_batch import PublicBatchCircuit, PublicBatchProver
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    leaf_cfg, pb_cfg, pub_cfg = mk.test_configs(tpkg)
    t0 = time.perf_counter()
    leaf = WormholeCircuit(leaf_cfg).build(device="cuda")
    leaf_vd = VerifierCircuitData.from_circuit_data(leaf)
    pb = PrivateBatchCircuit(leaf_vd, mk.N_LEAF, config=pb_cfg, enforce_security_floor=False,
                             device="cuda")
    pb_s = time.perf_counter() - t0
    _same_vdata("[aggregation] test-profile private batch", pb.data, "agg_private_batch")
    leaves = [proof_from_bytes(_committed(f"agg_leaf{i}.bin")) for i in range(2)]
    prover = PrivateBatchProver(pb, WormholeVerifier(leaf, enforce_security_floor=False),
                                proof_from_bytes(_committed("agg_dummy_leaf.bin")))
    agg, agg_s, launches = _counted(kernels, lambda: prover.commit(
        leaves, rng=np.random.default_rng(mk.PB_RNG)).prove(seed=mk.PB_SEED, rng_mode="host"))
    if proof_to_bytes(agg) != _committed("agg_private_batch.bin"):
        raise AssertionError("[aggregation] the test-profile private batch differs from the JAX "
                             "fixture")
    rounds = len(pb_cfg.fri_config.reduction_strategy.schedule(pb.data.degree_bits))
    _path_launches("[aggregation] test-profile private batch", kernels, launches, rounds, False)
    fake = FakeLeafCircuit(leaf_cfg, device="cuda")
    fake_proof = fake.prove_pis(leaves[0].public_inputs, seed=0)
    verify(fake.data, fake_proof)
    try:
        prover.commit([fake_proof])
    except VerificationError as e:
        substituted = str(e)
    else:
        raise AssertionError("[aggregation] a fake leaf's proof passed the batch's admission")
    t0 = time.perf_counter()
    pub = PublicBatchCircuit(VerifierCircuitData.from_circuit_data(pb.data), 2, mk.N_LEAF,
                             config=pub_cfg, device="cuda")
    pub_s = time.perf_counter() - t0
    _same_vdata("[aggregation] test-profile public batch", pub.data, "agg_public_batch")
    pub_prover = PublicBatchProver(pub, lambda p: verify(pb.data, p),
                                   proof_from_bytes(_committed("agg_dummy_private_batch.bin")))
    out, pub_proof_s, _ = _counted(kernels, lambda: pub_prover.commit(
        [agg], wi.BytesDigest(mk.PUB_ADDRESS)).prove(seed=mk.PUB_SEED))
    if proof_to_bytes(out) != _committed("agg_public_batch.bin"):
        raise AssertionError("[aggregation] the test-profile public batch differs from the JAX "
                             "fixture")
    verify(pub.data, out)
    print(f"[aggregation] test profile (N = {mk.N_LEAF}, {pb_cfg.fri_config.num_query_rounds} "
          f"queries): private batch degree_bits {pb.data.degree_bits}, {rounds} FRI rounds, leaf "
          f"and batch built in {pb_s:.1f} s, cold host-rng proof {agg_s:.2f} s == JAX fixture; "
          f"public batch degree_bits {pub.data.degree_bits}, built in {pub_s:.1f} s, cold proof "
          f"{pub_proof_s:.2f} s == JAX fixture; both verifier data == JAX; a fake leaf's "
          f"proof of a real leaf's public inputs verifies under its own circuit and is "
          f"refused at admission by its shape ({substituted})", flush=True)


def _agg_artifacts(mk) -> None:
    """The artifact set at the aggregation test profile, on the card:
    `generate_all_circuit_binaries` publishes the full set atomically (the
    leaf pair and dummy, the private batch pair and its all-dummy proof,
    the public batch pair, config.json, nothing left beside it); both
    layers' provers load from it (`new_from_binaries_dir`: rebuilt from
    source, pinned byte for byte, the dummy templates verified), the loaded
    private prover aggregates the fixture leaves and the loaded public
    prover proves over that batch, verified; a flipped byte in either
    layer's verifier.bin is refused."""
    import tempfile

    import numpy as np

    import qp_zk_circuits_tpu_torch as tpkg
    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData, proof_from_bytes
    from qp_zk_circuits_tpu_torch.plonk.verifier import verify
    from qp_zk_circuits_tpu_torch.wormhole import artifacts as art
    from qp_zk_circuits_tpu_torch.wormhole import inputs as wi
    from qp_zk_circuits_tpu_torch.wormhole.leaf_circuit import WormholeCircuit
    from qp_zk_circuits_tpu_torch.wormhole.private_batch import PrivateBatchProver
    from qp_zk_circuits_tpu_torch.wormhole.public_batch import PublicBatchProver

    leaf_cfg, pb_cfg, pub_cfg = mk.test_configs(tpkg)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "bins"
        t0 = time.perf_counter()
        art.generate_all_circuit_binaries(
            out, num_leaf_proofs=mk.N_LEAF, num_private_batch_proofs=2, include_aggregation=True,
            seed=3, leaf_config=leaf_cfg, private_batch_config=pb_cfg,
            public_batch_config=pub_cfg, enforce_security_floor=False, device="cuda")
        gen_s = time.perf_counter() - t0
        names = sorted(p.name for p in out.iterdir())
        left = sorted(p.name for p in Path(tmp).iterdir())
        if names != sorted(art.FULL_ARTIFACT_SET) or left != ["bins"]:
            raise AssertionError(f"[artifacts] published {names}, beside it {left}")
        leaf_rebuild = VerifierCircuitData.from_circuit_data(
            WormholeCircuit(leaf_cfg).build(device="cuda"))

        def load_private():
            return PrivateBatchProver.new_from_binaries_dir(
                out, config=pb_cfg, leaf_rebuild=leaf_rebuild, enforce_security_floor=False,
                device="cuda")

        t0 = time.perf_counter()
        private = load_private()
        public = PublicBatchProver.new_from_binaries_dir(
            out, config=pub_cfg, private_batch_rebuild=VerifierCircuitData.from_circuit_data(
                private.circuit.data), enforce_security_floor=False, device="cuda")
        load_s = time.perf_counter() - t0
        leaves = [proof_from_bytes(_committed(f"agg_leaf{i}.bin")) for i in range(2)]
        agg = private.aggregate(leaves, seed=41, rng=np.random.default_rng(5))
        verify(private.circuit.data, agg)
        pub = public.commit([agg], wi.BytesDigest(mk.PUB_ADDRESS)).prove(seed=42)
        verify(public.circuit.data, pub)

        def load_public():
            return art.load_canonical_public_batch_verifier_data(
                out, rebuild=VerifierCircuitData.from_circuit_data(public.circuit.data))

        refused = []
        for name, load in ((art.PRIVATE_BATCH_VERIFIER_BIN, load_private),
                           (art.PUBLIC_BATCH_VERIFIER_BIN, load_public)):
            good = (out / name).read_bytes()
            bad = bytearray(good)
            bad[-3] ^= 1
            (out / name).write_bytes(bytes(bad))
            try:
                load()
            except art.ArtifactError as e:
                refused.append(str(e))
            else:
                raise AssertionError(f"[artifacts] a flipped byte in {name} was loaded")
            (out / name).write_bytes(good)
    print(f"[artifacts] test profile: generate_all_circuit_binaries published the "
          f"{len(names)}-file set in {gen_s:.1f} s; both provers loaded from it in {load_s:.1f} s "
          f"(rebuilt, pinned, dummies verified), a private and a public batch proven from them "
          f"and verified; refused: {'; '.join(refused)}", flush=True)


def _quotient_spy(tprover, seen: list):
    """Wrap kernel A's wrapper so that its operands and output are kept (its
    launches, which the wrapper adds to the module's name, go on counting on
    the wrapper)."""
    real = tprover.quotient_evals

    def spy(data, wires_lde, zs_pp_lde, *args):
        out = real(data, wires_lde, zs_pp_lde, *args)
        real.launches += spy.launches
        spy.launches = 0
        seen.append((data, wires_lde.clone(), zs_pp_lde.clone(),
                     tuple(a.clone() for a in args), out.clone()))
        return out

    spy.launches = 0
    tprover.quotient_evals = spy
    return lambda: setattr(tprover, "quotient_evals", real)


def _clock_calls(module, name: str, took: list):
    """Wrap `module.name` so that each call's seconds go into `took`;
    returns the function that puts the real one back."""
    real = getattr(module, name)

    def timed(*args):
        t = time.perf_counter()
        out = real(*args)
        took.append(time.perf_counter() - t)
        return out

    setattr(module, name, timed)
    return lambda: setattr(module, name, real)


def _warm_profile(label, kernels, fn, verify_fn) -> str:
    """A warm proof's numbers: seconds, library launches, device ms and
    launches and the busy share (torch.profiler), and verify ms."""
    from qp_zk_circuits_tpu_torch.tools.profile_leaf import _device_profile

    proof, took, launches = _counted(kernels, fn)
    prof = _device_profile(fn)
    t = time.perf_counter()
    verify_fn(proof)
    verify_ms = 1e3 * (time.perf_counter() - t)
    lib = sum(launches.values())
    busy = ("device not measured" if prof["device_ms"] is None else
            f"{prof['device_ms']:.2f} device ms in {prof['device_launches']} device launches, "
            f"busy {100 * prof['device_ms'] / (1e3 * took):.1f} %")
    top = ", ".join(f"{k[:48]} {v['device_ms']:.2f} ms x{v['count']}"
                    for k, v in list(prof["top_kernels"].items())[:6])
    return (f"{label}: warm {took:.3f} s, {lib} library launches, {busy}; verify "
            f"{verify_ms:.1f} ms; top device kernels: {top}")


def phase_aggregation(kernels) -> dict:
    """The aggregation layers on the card. First the test profile
    (`_agg_test_profile`). Then the canonical configs, N = 2 leaves a
    private batch and m = 2 private batches a public batch:

      * the two real leaves of two_real_leaves_same_block() (seed 0, equal
        to the leaf fixtures) and the dummy leaf (seed 12, equal to the JAX
        package's), proved by the port;
      * PrivateBatchCircuit(N = 2): build seconds, degree_bits, and its
        verifier data equal to the JAX package's;
      * the host-rng private batch (commit on default_rng(PB_RNG), seed
        PB_SEED), cold and second, each equal to the JAX fixture, the
        second one's witness from the compiled tape (its time holds the
        witness program's lowering to the tape, timed apart);
      * PrivateBatchProver(warm_start=True) (`plonk/prover.py::warmup`),
        then a warm device-rng aggregate ("auto" after the warm-up): every
        kernel of the path launched (kernel G too), the witness from the
        tape, accepted by the port's verifier, one tampered copy rejected;
        kernel A's operands of that proof (the batch's own descriptor table
        and LDEs) through its plain version on the card, every row;
      * a public batch over [that batch, a dummy private batch]: build
        seconds, degree_bits, cold and second proofs (the second on the
        tape, its lowering timed apart), verified;
      * for each warm proof: seconds, library and device launches, the busy
        share and verify ms.

    Returns the canonical circuits and provers it built, the staged
    device-rng private batch and the staged public batch's bytes, for
    `phase_fused_aggregation` and `phase_service`."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch import native as nat
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk import witness_tape as wt
    from qp_zk_circuits_tpu_torch.plonk.serialization import (
        VerifierCircuitData,
        proof_from_bytes,
        proof_to_bytes,
    )
    from qp_zk_circuits_tpu_torch.plonk.verifier import VerificationError, verify
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.wormhole import inputs as wi
    from qp_zk_circuits_tpu_torch.wormhole.dummy_proof import generate_dummy_proof
    from qp_zk_circuits_tpu_torch.wormhole.private_batch import (
        PrivateBatchCircuit,
        PrivateBatchProver,
        generate_dummy_private_batch_proof,
    )
    from qp_zk_circuits_tpu_torch.wormhole.prover import WormholeProver
    from qp_zk_circuits_tpu_torch.wormhole.public_batch import PublicBatchCircuit, PublicBatchProver
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import two_real_leaves_same_block
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    mk = _agg_fixtures()
    _agg_test_profile(kernels, mk)
    _agg_artifacts(mk)

    leaf_prover = WormholeProver(device="cuda")
    leaves = [leaf_prover.prove_inputs(i, seed=0) for i in two_real_leaves_same_block()]
    dummy = generate_dummy_proof(leaf_prover, seed=mk.DUMMY_LEAF_SEED)
    for name, proof in (("leaf_proof_real0.bin", leaves[0]), ("leaf_proof_real1.bin", leaves[1]),
                        ("canonical_dummy_leaf.bin", dummy)):
        if proof_to_bytes(proof) != _committed(name):
            raise AssertionError(f"[aggregation] the port's {name} differs from the JAX fixture")
    leaf_verifier = WormholeVerifier(leaf_prover.data)
    t0 = time.perf_counter()
    circuit = PrivateBatchCircuit(VerifierCircuitData.from_circuit_data(leaf_prover.data),
                                  mk.N_LEAF, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    data = circuit.data
    cfg = data.config
    rounds = len(cfg.fri_config.reduction_strategy.schedule(data.degree_bits))
    _same_vdata("[aggregation] canonical private batch", data, "canonical_private_batch")
    prover = PrivateBatchProver(circuit, leaf_verifier, dummy)

    def host_proof():
        return prover.aggregate(leaves, seed=mk.PB_SEED, rng=np.random.default_rng(mk.PB_RNG),
                                rng_mode="host")

    want = _committed("canonical_private_batch.bin")
    host_runs, host_lowered = [], []
    restore = _clock_calls(wt, "compile_tape", host_lowered)
    try:
        for run in range(2):
            tapes = nat.counts["wt_run"]
            proof, took, launches = _counted(kernels, host_proof)
            host_runs.append(took)
            if proof_to_bytes(proof) != want:
                raise AssertionError(f"[aggregation] the {('cold', 'second')[run]} host-rng "
                                     "private batch differs from the JAX fixture")
            if run and nat.counts["wt_run"] != tapes + 1:
                raise AssertionError("[aggregation] the second private batch's witness did not "
                                     "run on the compiled tape")
            _path_launches("[aggregation] host-rng private batch", kernels, launches, rounds,
                           False)
    finally:
        restore()
    t0 = time.perf_counter()
    warm = PrivateBatchProver(circuit, leaf_verifier, dummy, warm_start=True)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    seen = []
    restore = _quotient_spy(tprover, seen)
    tapes = nat.counts["wt_run"]
    try:
        dev_proof, dev_s, launches = _counted(kernels, lambda: warm.aggregate(
            leaves, seed=mk.PB_SEED + 1, rng=np.random.default_rng(mk.PB_RNG + 1)))
    finally:
        restore()
    if nat.counts["wt_run"] != tapes + 1:
        raise AssertionError("[aggregation] the device-rng batch's witness did not run on the tape")
    _path_launches("[aggregation] device-rng private batch", kernels, launches, rounds, True)
    dev_launches = launches
    if proof_to_bytes(dev_proof) == want:
        raise AssertionError("[aggregation] the device-rng batch equals the host-rng one")
    verify(data, dev_proof)
    bad = proof_from_bytes(proof_to_bytes(dev_proof))
    step = bad.fri_proof.query_rounds[-1].steps[-1]
    lv = np.array(step.leaf_values, dtype=np.uint64)
    lv[1, 0] = np.uint64((int(lv[1, 0]) + 1) % ((1 << 64) - (1 << 32) + 1))
    step.leaf_values = lv
    try:
        verify(data, bad)
    except VerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("[aggregation] the verifier accepted a tampered private batch")
    # kernel A on this batch's own descriptor table and LDEs, every row,
    # against its plain version run on the card
    (qdata, wires_lde, zs_pp_lde, qargs, got), = seen
    plain = tprover.quotient_evals_plain(qdata, wires_lde, zs_pp_lde, *qargs)
    if not torch.equal(got, plain):
        raise AssertionError("[aggregation] kernel A differs from its plain version on the "
                             "private batch")
    desc, k_total = tprover.quotient_descriptors(qdata)

    dummy_pb = generate_dummy_private_batch_proof(circuit, dummy, rng=np.random.default_rng(
        mk.DUMMY_PB_RNG), seed=mk.DUMMY_PB_SEED)
    t0 = time.perf_counter()
    pub = PublicBatchCircuit(VerifierCircuitData.from_circuit_data(data), 2, mk.N_LEAF,
                             device="cuda")
    torch.cuda.synchronize()
    pub_build_s = time.perf_counter() - t0
    pub_prover = PublicBatchProver(pub, lambda p: verify(data, p), dummy_pb)
    address = wi.BytesDigest(mk.PUB_ADDRESS)

    def pub_proof():
        return pub_prover.commit([dev_proof], address).prove(seed=mk.PUB_SEED)

    pub_runs, pub_lowered = [], []
    restore = _clock_calls(wt, "compile_tape", pub_lowered)
    try:
        for run in range(2):
            tapes = nat.counts["wt_run"]
            out, took, launches = _counted(kernels, pub_proof)
            pub_runs.append(took)
            if run and nat.counts["wt_run"] != tapes + 1:
                raise AssertionError("[aggregation] the public batch's witness did not run on "
                                     "the tape")
            verify(pub.data, out)
    finally:
        restore()
    pub_rounds = len(pub.data.config.fri_config.reduction_strategy.schedule(pub.data.degree_bits))
    _path_launches("[aggregation] public batch", kernels, launches, pub_rounds, False)
    parsed = wi.PublicBatchPublicInputs.from_felts(out.public_inputs, 2, mk.N_LEAF)
    if parsed.aggregator_address != address or sum(
            a.summed_output_amount for a in parsed.account_data) != sum(
            p.public.output_amount_1 + p.public.output_amount_2
            for p in two_real_leaves_same_block()):
        raise AssertionError("[aggregation] the public batch's outputs are not the leaves'")

    print(f"[aggregation] canonical private batch (N = {mk.N_LEAF}): {cfg.num_wires} wires, "
          f"{cfg.num_routed_wires} routed, degree_bits {data.degree_bits} ({data.num_rows_used} "
          f"rows used), {cfg.fri_config.num_query_rounds} queries, {rounds} FRI rounds, "
          f"{desc.shape[0]} kernel-A groups and {k_total} constraints; build {build_s:.1f} s; "
          f"host-rng proof cold {host_runs[0]:.3f} s, second {host_runs[1]:.3f} s (the witness "
          f"program lowered to its tape in {sum(host_lowered):.3f} s, then the tape's first "
          f"run), both == JAX fixture; verifier data == JAX; warm-up {warmup_s:.2f} s; "
          f"device-rng proof {dev_s:.3f} s, kernel G {dev_launches['rand_felts']} launches, witness on the tape, "
          f"accepted, a tampered last-round leaf rejected ({rejected}); kernel A == plain on "
          f"all {got.shape[1]} points; {card()}", flush=True)
    print(f"[aggregation] canonical public batch (m = 2 over [the device-rng batch, a dummy]): "
          f"degree_bits {pub.data.degree_bits} ({pub.data.num_rows_used} rows used), "
          f"{pub_rounds} FRI rounds; build {pub_build_s:.1f} s; proof cold {pub_runs[0]:.3f} s, "
          f"second {pub_runs[1]:.3f} s (the tape lowered in {sum(pub_lowered):.3f} s, then its "
          f"first run), verified", flush=True)
    for line in (
            _warm_profile("[aggregation] host-rng private batch", kernels, host_proof,
                          lambda p: verify(data, p)),
            _warm_profile("[aggregation] device-rng private batch", kernels, lambda: warm.aggregate(
                leaves, seed=mk.PB_SEED + 1, rng=np.random.default_rng(mk.PB_RNG + 1)),
                lambda p: verify(data, p)),
            _warm_profile("[aggregation] public batch", kernels, pub_proof,
                          lambda p: verify(pub.data, p))):
        print(line, flush=True)
    return dict(leaf_prover=leaf_prover, leaves=leaves, private=warm, private_circuit=circuit,
                dummy_pb=dummy_pb, public_circuit=pub, dev_proof=dev_proof,
                public_proof=proof_to_bytes(out), leaf_data=data)


def _write_bins(root: Path, built: dict) -> None:
    """The canonical artifact set of the circuits `phase_aggregation` built
    (config.json, both batch layers' verifier pairs, the dummy private
    batch), as `generate_all_circuit_binaries` would publish it, and an
    `aot/` subdirectory of junk beside them that the service must leave
    inert."""
    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData, proof_to_bytes
    from qp_zk_circuits_tpu_torch.wormhole import artifacts as art

    root.mkdir(parents=True)
    art.CircuitBinsConfig(num_leaf_proofs=built["private_circuit"].n_leaf,
                          num_private_batch_proofs=built["public_circuit"].m).save(
        root / art.CONFIG_JSON)
    for circuit, verifier_bin, common_bin in (
            (built["private_circuit"], art.PRIVATE_BATCH_VERIFIER_BIN, art.PRIVATE_BATCH_COMMON_BIN),
            (built["public_circuit"], art.PUBLIC_BATCH_VERIFIER_BIN, art.PUBLIC_BATCH_COMMON_BIN)):
        vd = VerifierCircuitData.from_circuit_data(circuit.data)
        (root / verifier_bin).write_bytes(vd.to_verifier_only_bytes())
        (root / common_bin).write_bytes(vd.to_common_bytes())
    (root / art.DUMMY_PRIVATE_BATCH_PROOF_BIN).write_bytes(proof_to_bytes(built["dummy_pb"]))
    (root / "aot").mkdir()
    (root / "aot" / "entry.bin").write_bytes(b"not an executable")


def _fused_proof(label: str, data, rng_mode: str) -> None:
    """Raises unless the last proof of `data` came from the fused prover, in
    `rng_mode` (a non-ZK circuit's "host"); pops its record."""
    timings = data.__dict__.pop("_last_prove_timings", None)
    if timings is None or timings["rng_mode"] != rng_mode:
        raise AssertionError(f"{label}: not a fused proof in {rng_mode} rng ({timings})")


def phase_service(kernels, built: dict) -> None:
    """The miner's path end to end at the canonical sizes (N = 2 leaves a
    private batch, m = 2 private batches a public batch), on the circuits
    `phase_aggregation` built, through `prove`'s own dispatch (`main` runs
    it without QZKT_STAGED_PROVER): the warmed batch circuits on the fused
    prover, as the service runs them:

      * four real spends of one block (`n_real_leaves_same_block(4)`)
        proven as one fused batch (`prove_inputs_batch`, K = 4: one upload
        and one download, kernels I and J with a proof axis), within the
        fused batch's launch limits, each accepted;
      * folded into two private batches (the warm private prover);
      * `PublicBatchAggregator.from_binaries_dir` over the canonical
        artifact set of those circuits (`_write_bins`; the private batch's
        rebuild passed in, the public batch circuit rebuilt and pinned,
        `warm_start=True`, which flips it onto the fused prover);
      * both private batches pushed (a verify each) into one bucket; a
        second push of one refused (duplicate nullifier) and a dummy
        private batch refused;
      * the bucket aggregated from the pool's snapshot into a public batch,
        accepted by the service's `verify`, bound to its address, and
        refused by a service of another address; the `aot/` directory left
        as it was;
      * each step's seconds."""
    import tempfile

    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData
    from qp_zk_circuits_tpu_torch.tools.timing import card
    from qp_zk_circuits_tpu_torch.wormhole import inputs as wi
    from qp_zk_circuits_tpu_torch.wormhole.aggregator_service import PublicBatchAggregator
    from qp_zk_circuits_tpu_torch.wormhole.pool import PoolError
    from qp_zk_circuits_tpu_torch.wormhole.private_batch import BatchCompatibilityError
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import n_real_leaves_same_block
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    steps = {}
    leaf_prover = built["leaf_prover"]
    spends = n_real_leaves_same_block(4)
    rounds = len(leaf_prover.data.config.fri_config.reduction_strategy.schedule(
        leaf_prover.data.degree_bits))
    leaves, steps["prove 4 leaves (batch)"], launches = _counted(
        kernels, lambda: leaf_prover.prove_inputs_batch(spends, seed=0))
    _check_fused_batch_launches("[service] leaf batch", kernels, launches, len(spends), rounds)
    leaf_verifier = WormholeVerifier(leaf_prover.data)
    for proof in leaves:
        leaf_verifier.verify(proof)
    t = time.perf_counter()
    privates = []
    for i in (0, 2):
        privates.append(built["private"].aggregate(leaves[i:i + 2], seed=60 + i,
                                                   rng=np.random.default_rng(70 + i)))
        _fused_proof("[service] private batch", built["private_circuit"].data, "device")
    torch.cuda.synchronize()
    steps["fold into 2 private batches"] = time.perf_counter() - t
    address = wi.BytesDigest(bytes(range(1, 33)))
    with tempfile.TemporaryDirectory() as tmp:
        bins = Path(tmp) / "bins"
        _write_bins(bins, built)
        t = time.perf_counter()
        service = PublicBatchAggregator.from_binaries_dir(
            bins, address, private_batch_rebuild=VerifierCircuitData.from_circuit_data(
                built["private_circuit"].data), warm_start=True, device="cuda")
        torch.cuda.synchronize()
        steps["from_binaries_dir (warm start)"] = time.perf_counter() - t
        refused = []

        def refuse(label, proof, reason):
            try:
                service.push_proof(proof)
            except PoolError as e:
                if reason not in str(e):
                    raise
                refused.append(f"{label}: {e}")
            else:
                raise AssertionError(f"[service] the pool admitted a {label} private batch")

        t = time.perf_counter()
        keys = [service.push_proof(privates[0])]
        steps["push (verify)"] = time.perf_counter() - t
        # a second push of it while its bucket has room: its nullifiers
        refuse("the same batch again", privates[0], "duplicate nullifier")
        keys.append(service.push_proof(privates[1]))
        refuse("a dummy private batch", built["dummy_pb"], "dummy")
        stats = service.bucket_stats()
        if len(set(keys)) != 1 or [s.num_proofs for s in stats.values()] != [2]:
            raise AssertionError(f"[service] the two private batches are not one bucket: {stats}")
        t = time.perf_counter()
        public = service.aggregate(keys[0], seed=80)
        torch.cuda.synchronize()
        _fused_proof("[service] public batch", service.circuit.data, "host")
        steps["aggregate (snapshot + prove)"] = time.perf_counter() - t
        t = time.perf_counter()
        parsed = service.verify(public)
        steps["verify"] = time.perf_counter() - t
        if parsed.aggregator_address != address or service.pool.num_proofs() != 2:
            raise AssertionError("[service] the public batch is not bound to the service's "
                                 "address, or the pool gave up custody")
        other = PublicBatchAggregator(service.circuit, service.inner_verify,
                                      service.outer_verify, service.dummy_template,
                                      wi.BytesDigest(bytes(32 * [7])))
        try:
            other.verify(public)
        except BatchCompatibilityError as e:
            refused.append(f"another address: {e}")
        else:
            raise AssertionError("[service] a service of another address accepted the proof")
        if [p.name for p in (bins / "aot").iterdir()] != ["entry.bin"]:
            raise AssertionError("[service] the bins directory's aot/ was touched")
    print(f"[service] 4 leaves -> 2 private batches -> pool (one bucket) -> public batch "
          f"(degree_bits {service.circuit.data.degree_bits}) accepted and bound to the "
          f"service's address; refused: {'; '.join(refused)}; seconds: "
          f"{', '.join(f'{k} {v:.3f}' for k, v in steps.items())}; {card()}", flush=True)


#: the wrappers whose launches a sharded commit multiplies (each shard's
#: transforms, each device's subtree forest, the top levels' 2-to-1)
MESH_SPLIT = {"ntt": ("ntt",),
              "trees": ("poseidon2_merkle_tree", "poseidon2_merkle_forest", "poseidon2_two_to_one")}


def _mesh_launches(label: str, launches: dict, single: dict, d: int) -> None:
    """A sharded proof's launches against the single proof's: kernel 3's and
    the trees' at most D times as many, every other wrapper's the same."""
    grouped = {name for names in MESH_SPLIT.values() for name in names}
    off = {n: (launches[n], single[n]) for n in single if n not in grouped
           and launches[n] != single[n]}
    for names in MESH_SPLIT.values():
        got, one = sum(launches[n] for n in names), sum(single[n] for n in names)
        if not 0 < got <= d * one:
            off[names] = (got, one)
    if off:
        raise AssertionError(f"{label}: launches (sharded, single) outside their limits: {off}")


def phase_mesh(kernels, leaf, zk_leaf, built) -> None:
    """The device mesh on the one card: D shards of cuda:0 (the JAX package's
    virtual devices), each run with every count at 0 just before it and
    read just after:

      * the leaf (the main path's prover), its three commits tensor-parallel
        at D = 2, 4 and 8: byte-equal to the fixture and accepted by the
        port's verifier, each wrapper's launches against the single
        proof's (kernel 3 and the trees at most D times, the rest equal);
      * the ZK leaf at D = 4 in host rng (the fixture) and device rng (the
        single-card device-rng proof of the same seed, accepted);
      * the canonical N = 2 private batch at D = 4, host rng (degree 14,
        2^17-row LDEs 139, 20 and 20 wide): the JAX package's bytes;
      * `sharded_prove_batch` of 16 leaf witnesses over a (4, 1) mesh, cold
        and warm: each proof the fixture and `prove_batch`'s, the launches
        four K = 4 batches';
      * `ntt_sharded` at N = 2^20 and 2^24 over D = 2, 4, 8, both ways:
        bit-equal to kernel 3's single NTT, the round trip the input, timed
        beside the single NTT (the first call of a shard count and
        direction builds kernel 3's output-multiplier tables, timed apart);
      * `sharded_batch_commit` on (16, 135, 256) traces over a (2, 2) mesh:
        equal to the unsharded `batch_commit_step` (`commit_batch`);
      * `tools/dryrun_multichip.py` on 4 shards, whose run gives kernel H's
        rows their launches;
      * with two cards or more, one shard a card: the leaf (tp), the ZK
        leaf in device rng, a dp batch of 4 a card (cold and warm),
        `ntt_sharded` at 2^24 and the dryrun over the cards; with one, a
        line that says that part did not run.
    Kernel H against its plain versions sits in the kernel phase."""
    import numpy as np
    import torch

    from qp_zk_circuits_tpu_torch.models import batch_commit_step, sharded_batch_commit
    from qp_zk_circuits_tpu_torch.parallel import collectives as col
    from qp_zk_circuits_tpu_torch.parallel.mesh import Mesh, make_prover_mesh, sharded_prove_batch
    from qp_zk_circuits_tpu_torch.plonk import prover as tprover
    from qp_zk_circuits_tpu_torch.plonk.serialization import proof_to_bytes
    from qp_zk_circuits_tpu_torch.poly import ntt
    from qp_zk_circuits_tpu_torch.tools.dryrun_multichip import dryrun_multichip
    from qp_zk_circuits_tpu_torch.tools.timing import card, device_ms, median_ms
    from qp_zk_circuits_tpu_torch.wormhole.test_helpers import (
        test_inputs_0,
        two_real_leaves_same_block,
    )
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    print(f"[mesh] layout: D shards on 1 card (cuda:0), the collectives device copies; "
          f"{cards} card(s) visible; {card()}", flush=True)

    def one_card(d):
        return Mesh(["cuda:0"] * d, ("cols",))

    def counted(fn):
        col.all_to_all.copies = col.gather.copies = 0
        out, took, launches = _counted(kernels, fn)
        return out, took, launches, col.all_to_all.copies + col.gather.copies

    inputs = test_inputs_0()
    want = FIXTURE.read_bytes()
    verifier = WormholeVerifier(leaf.data)
    blob, single_s, single, _ = counted(lambda: proof_to_bytes(leaf.prove_inputs(inputs, seed=0)))
    if blob != want:
        raise AssertionError("[mesh] the single leaf proof differs from the fixture")
    parts = []
    for d in (2, 4, 8):
        proof, took, launches, copies = counted(
            lambda: leaf.prove_inputs(inputs, seed=0, mesh=one_card(d)))
        if proof_to_bytes(proof) != want:
            raise AssertionError(f"[mesh] the leaf at D = {d} differs from the fixture")
        verifier.verify(proof)
        _mesh_launches(f"[mesh] leaf D = {d}", launches, single, d)
        parts.append(f"D = {d} {1e3 * took:.1f} ms, {sum(launches.values())} library launches, "
                     f"{copies} copies")
    commits_bound, commits_by = _bound(leaf_commits_work(leaf.data))
    tp_device = device_ms(lambda: leaf.prove_inputs(inputs, seed=0, mesh=one_card(MESH_D)))
    print(f"[mesh] leaf, three commits tensor-parallel: byte-equal to the fixture and accepted "
          f"at every D; single {1e3 * single_s:.1f} ms, {sum(single.values())} library launches; "
          f"{'; '.join(parts)}; the three commits' bound {commits_bound:.5f} ms by {commits_by} "
          f"(the single commits' work: the shards add none); the proof's launches at D = "
          f"{MESH_D} by graph replay {tp_device:.4f} device ms", flush=True)

    zk_data = zk_leaf.data
    zk_pw = zk_leaf._partial_witness(inputs)
    zk_want = ZK_FIXTURE.read_bytes()
    host, host_s, host_l, host_c = counted(lambda: proof_to_bytes(tprover.prove(
        zk_data, zk_pw, seed=ZK_SEED, rng_mode="host", mesh=one_card(MESH_D))))
    if host != zk_want:
        raise AssertionError("[mesh] the ZK leaf at D = 4 (host rng) differs from the fixture")
    dev_single = proof_to_bytes(tprover.prove_staged(zk_data, zk_pw, seed=ZK_SEED,
                                                     rng_mode="device"))
    dev, dev_s, dev_l, dev_c = counted(lambda: tprover.prove(
        zk_data, zk_pw, seed=ZK_SEED, rng_mode="device", mesh=one_card(MESH_D)))
    if proof_to_bytes(dev) != dev_single:
        raise AssertionError("[mesh] the ZK leaf at D = 4 (device rng) differs from the "
                             "single-card device-rng proof of its seed")
    WormholeVerifier(zk_data).verify(dev)
    print(f"[mesh] ZK leaf D = {MESH_D}: host rng == fixture, {1e3 * host_s:.1f} ms, "
          f"{sum(host_l.values())} library launches, {host_c} copies; device rng == the "
          f"single-card device-rng proof, accepted, {1e3 * dev_s:.1f} ms, kernel G "
          f"{dev_l['rand_felts']} launches, {sum(dev_l.values())} library launches, {dev_c} "
          f"copies", flush=True)

    mk = _agg_fixtures()
    pb, pb_s, pb_l, pb_c = counted(lambda: built["private"].aggregate(
        built["leaves"], seed=mk.PB_SEED, rng=np.random.default_rng(mk.PB_RNG),
        rng_mode="host", mesh=one_card(MESH_D)))
    if proof_to_bytes(pb) != _committed("canonical_private_batch.bin"):
        raise AssertionError("[mesh] the canonical private batch at D = 4 differs from the JAX "
                             "fixture")
    pdata = built["private_circuit"].data
    print(f"[mesh] canonical N = 2 private batch D = {MESH_D} (degree_bits {pdata.degree_bits}, "
          f"host rng) == fixture: {pb_s:.3f} s, {sum(pb_l.values())} library launches, {pb_c} "
          f"copies", flush=True)

    spends = two_real_leaves_same_block()
    batch_inputs = [spends[i % 2] for i in range(BATCH_K)]
    fixtures = [_committed(f"leaf_proof_real{i}.bin") for i in range(2)]
    dp_mesh = make_prover_mesh(4, dp=4, devices=["cuda:0"] * 4)

    def dp_batch():
        return sharded_prove_batch(leaf.data, dp_mesh,
                                   [leaf._partial_witness(x) for x in batch_inputs], seed=0)

    # a group is a K = 4 batch of the same witnesses and seed: its launches
    _, _, group_l, _ = counted(lambda: leaf.prove_inputs_batch(batch_inputs[:4], seed=0))
    batch = leaf.prove_inputs_batch(batch_inputs, seed=0)
    dp_runs = []
    for run in ("cold", "warm"):
        proofs, dp_s, dp_l, _ = counted(dp_batch)
        for i, (p, q) in enumerate(zip(proofs, batch, strict=True)):
            if proof_to_bytes(p) != fixtures[i % 2] or proof_to_bytes(q) != fixtures[i % 2]:
                raise AssertionError(f"[mesh] dp proof {i} ({run}) differs from its fixture or "
                                     "prove_batch's")
        if dp_l != {n: 4 * c for n, c in group_l.items()}:
            raise AssertionError(f"[mesh] dp launches ({run}) {dp_l}, not four groups' "
                                 f"{group_l}")
        dp_runs.append(f"{run} {1e3 * dp_s:.1f} ms")
    dp_bound, dp_by = _bound(_sum_work([leaf_proof_work(leaf.data, p.fri_proof.pow_witness)
                                        for p in proofs]))
    dp_device = device_ms(dp_batch)
    print(f"[mesh] sharded_prove_batch of {BATCH_K} leaves over a (4, 1) mesh, the groups in "
          f"turn: each proof == its fixture and prove_batch's; "
          f"{', '.join(dp_runs)}, {sum(dp_l.values())} library launches (four K = 4 groups' "
          f"{sum(group_l.values())} each), {dp_device:.4f} device ms "
          f"by graph replay; bound {dp_bound:.4f} ms by {dp_by} ({BATCH_K} leaf proofs' work, "
          f"`leaf_proof_work`)", flush=True)

    lines = []
    for log_n in MESH_NTT_LOG_N:
        x = _card_felts((1 << log_n,), log_n, "cuda")
        fwd = ntt.ntt(x)
        single_ms = median_ms(lambda: ntt.ntt(x), runs=5)
        for d in MESH_NTT_SHARDS:
            mesh = one_card(d)
            for inverse, src, want_out in ((False, x, fwd), (True, fwd, x)):
                t = time.perf_counter()
                got = torch.cat(ntt.ntt_sharded(src, mesh, inverse=inverse))
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t
                if not torch.equal(got, ntt.ntt(src, inverse=inverse)):
                    raise AssertionError(f"[mesh] ntt_sharded 2^{log_n} D = {d} differs from "
                                         f"kernel 3's single NTT (inverse {inverse})")
                if inverse and not torch.equal(got, want_out):
                    raise AssertionError(f"[mesh] the sharded round trip at 2^{log_n} D = {d} "
                                         "is not the input")
                ms = median_ms(lambda: ntt.ntt_sharded(src, mesh, inverse=inverse), runs=5)
                lines.append(f"2^{log_n} D = {d} {'inverse' if inverse else 'forward'} "
                             f"{ms:.3f} ms (first {first_s:.2f} s)")
            del got
        lines.append(f"2^{log_n} single NTT {single_ms:.3f} ms")
        del x, fwd
        torch.cuda.empty_cache()
    print(f"[mesh] ntt_sharded bit-equal to kernel 3's single NTT, round trips the input; "
          f"CUDA events: {'; '.join(lines)}", flush=True)

    traces = _card_felts((BATCH_K, 135, 256), 5, "cuda")
    cmesh = make_prover_mesh(4, dp=2, devices=["cuda:0"] * 4)
    (caps, ldes), core_s, core_l, core_c = counted(
        lambda: sharded_batch_commit(cmesh, rate_bits=3, cap_height=1)(traces))
    want_caps, want_ldes = batch_commit_step(traces, 3, 1)
    if not (torch.equal(caps, want_caps) and torch.equal(ldes, want_ldes)):
        raise AssertionError("[mesh] sharded_batch_commit differs from commit_batch")
    core_bound, core_by = _bound(_sum_work([commit_work(135, 256, 3, 1, True)] * BATCH_K))
    core_device = device_ms(lambda: sharded_batch_commit(cmesh, rate_bits=3, cap_height=1)(traces))
    print(f"[mesh] commit core (16, 135, 256) over (2, 2) == commit_batch: {1e3 * core_s:.1f} "
          f"ms, {sum(core_l.values())} library launches, {core_c} copies, {core_device:.4f} "
          f"device ms by graph replay; bound {core_bound:.5f} ms by {core_by} (16 commits' "
          f"`commit_work`)", flush=True)

    summary, dry_s, dry_l, _ = counted(lambda: dryrun_multichip(4, ["cuda:0"] * 4))
    for k in kernels:
        if k.get("path") == "mesh":
            k["launches"] = dry_l[k["name"]]
    missing = [k["name"] for k in kernels if k.get("path") == "mesh" and k["launches"] <= 0]
    if missing:
        raise AssertionError(f"[mesh] kernels not launched by the dryrun: {missing}")
    print(f"[mesh] {summary}: {dry_s:.2f} s, kernel H launches "
          f"{dry_l['shard_deinterleave']} + {dry_l['shard_cross_ntt']}", flush=True)

    if cards >= 2:
        per_card = Mesh([f"cuda:{i}" for i in range(cards)], ("cols",))
        proof, took, launches, copies = counted(
            lambda: leaf.prove_inputs(inputs, seed=0, mesh=per_card))
        if proof_to_bytes(proof) != want:
            raise AssertionError("[mesh] the leaf with one shard a card differs from the fixture")
        _mesh_launches(f"[mesh] leaf, {cards} cards", launches, single, cards)
        dev_cards = proof_to_bytes(tprover.prove(zk_data, zk_pw, seed=ZK_SEED,
                                                 rng_mode="device", mesh=per_card))
        if dev_cards != dev_single:
            raise AssertionError("[mesh] the device-rng ZK leaf over the cards differs from the "
                                 "single-card proof of its seed")
        k = 4 * cards
        cards_dp = make_prover_mesh(cards, dp=cards)
        dp_inputs = [spends[i % 2] for i in range(k)]
        dp_cards = []
        for run in ("cold", "warm"):
            dp_proofs, dp_cards_s, dp_cards_l, _ = counted(lambda: sharded_prove_batch(
                leaf.data, cards_dp, [leaf._partial_witness(x) for x in dp_inputs], seed=0))
            for i in range(cards):
                torch.cuda.synchronize(i)
            if [proof_to_bytes(p) for p in dp_proofs] != [fixtures[i % 2] for i in range(k)]:
                raise AssertionError(f"[mesh] the dp batch with one shard a card differs ({run})")
            if dp_cards_l != {n: cards * c for n, c in group_l.items()}:
                raise AssertionError(f"[mesh] dp launches over the cards ({run}) {dp_cards_l}")
            dp_cards.append(f"{run} {1e3 * dp_cards_s:.1f} ms")
        x = _card_felts((1 << 24,), 24, "cuda")
        ntt_ms = []
        for inverse in (False, True):
            want_out = ntt.ntt(x, inverse=inverse)
            got = torch.cat([b.to(x.device) for b in ntt.ntt_sharded(x, per_card, inverse=inverse)])
            if not torch.equal(got, want_out):
                raise AssertionError(f"[mesh] ntt_sharded 2^24 over {cards} cards differs "
                                     f"(inverse {inverse})")
            def call():
                ntt.ntt_sharded(x, per_card, inverse=inverse)
                for i in range(cards):
                    torch.cuda.synchronize(i)

            ntt_ms.append(_host_median_ms(call, runs=5))
        del x, got, want_out
        torch.cuda.empty_cache()
        summary = dryrun_multichip(cards)
        print(f"[mesh] one shard a card on {cards} cards (peer copies): the leaf tp proof == "
              f"fixture, {1e3 * took:.1f} ms, {sum(launches.values())} library launches, "
              f"{copies} copies; the device-rng ZK leaf == the single-card proof; {k} dp proofs "
              f"(a group a card) == their fixtures, {', '.join(dp_cards)}; "
              f"ntt_sharded 2^24 == kernel 3's, "
              f"forward {ntt_ms[0]:.3f} ms, inverse {ntt_ms[1]:.3f} ms (host clock, every card "
              f"synchronized); {summary}", flush=True)
    else:
        print("[mesh] one shard a card: not run (1 card visible)", flush=True)
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


TOOLS_TIMEOUT_S = 420


def _tool(args: list[str]):
    """Start `python -m qp_zk_circuits_tpu_torch.tools.<args>` from the
    checkout's root; returns the process (stdout and stderr piped)."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-m", f"qp_zk_circuits_tpu_torch.tools.{args[0]}",
                             *args[1:]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, label: str) -> str:
    """Wait for a `_tool` process (killed after TOOLS_TIMEOUT_S); its stdout,
    or an error with its stderr's end if it failed."""
    import subprocess

    try:
        out, err = proc.communicate(timeout=TOOLS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"[tools] {label} did not end within {TOOLS_TIMEOUT_S} s") from None
    if proc.returncode != 0:
        raise AssertionError(f"[tools] {label} exited {proc.returncode}:\n{err[-3000:]}")
    return out


def phase_tools(leaf) -> None:
    """The port's host tools:

      * `tools/memprof.py --canonical --num-leaf-proofs 2 --json` on the card,
        in a process of its own as a user runs it:
        each phase's wall seconds, RSS peak and the card's allocation peak
        (`torch.cuda.max_memory_allocated` over the phase), every device
        peak a number, the card named;
      * `tools/circuit_builder_cli.py` in a process of its own, into a
        temporary directory, without
        `--include-aggregation` (the leaf's artifacts): `config.json` loads,
        the leaf verifier data loads with its pins against the main path's
        card-built leaf, and the dummy proof it wrote is accepted and is a
        dummy;
      * the sweep report's measured anchors (`tools/sweep_shapes.py`'s
        `load_anchor` and `anchors_section`, what `--anchor` adds to the
        report) from that memprof output: the section names the card, puts
        the canonical N = 2 batch's device peak beside `estimate_device_mb`
        and shows no TPU figure. The sweep's shape builds take minutes on
        the host and reach no kernel; the CPU tests hold their rows to the
        JAX package's."""
    import tempfile

    from qp_zk_circuits_tpu_torch.plonk.serialization import VerifierCircuitData, proof_from_bytes
    from qp_zk_circuits_tpu_torch.tools import sweep_shapes
    from qp_zk_circuits_tpu_torch.wormhole import artifacts as art
    from qp_zk_circuits_tpu_torch.wormhole.verifier import WormholeVerifier

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="qzk_tools_") as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        out = _finish(_tool(["memprof", "--canonical", "--num-leaf-proofs", "2", "--json"]),
                      "memprof")
        memprof_s = time.perf_counter() - t
        record = json.loads(out.strip().splitlines()[-1])
        phases = record["phases"]
        if not record["card"] or any(p[2] is None or p[2] <= 0 for p in phases.values()):
            raise AssertionError(f"[tools] memprof on the card without a card or a device "
                                 f"peak: {record}")
        (tmp / "memprof.json").write_text(out)
        print(f"[tools] memprof --canonical N = 2 on {record['card']} ({memprof_s:.1f} s "
              f"process): " + "; ".join(
                  f"{name} {w:.3f} s, RSS peak {rss:.1f} MiB, device peak {dev:.1f} MiB"
                  for name, (w, rss, dev) in phases.items()), flush=True)

        t = time.perf_counter()
        bins = tmp / "bins"
        _finish(_tool(["circuit_builder_cli", "--output", str(bins), "--num-leaf-proofs", "2"]),
                "circuit_builder_cli")
        cli_s = time.perf_counter() - t
        cfg = art.CircuitBinsConfig.load(bins / art.CONFIG_JSON)
        if (cfg.num_leaf_proofs, cfg.num_private_batch_proofs) != (2, 2):
            raise AssertionError(f"[tools] config.json says {cfg}")
        vdata = art.load_canonical_leaf_verifier_data(
            bins, rebuild=VerifierCircuitData.from_circuit_data(leaf.data))
        dummy = proof_from_bytes(art.read_artifact_file(bins / art.DUMMY_PROOF_BIN,
                                                        art.MAX_AGG_ARTIFACT_BYTES))
        if not WormholeVerifier(vdata).verify(dummy).is_dummy:
            raise AssertionError("[tools] the CLI's dummy proof is not a dummy")
        print(f"[tools] circuit_builder_cli --num-leaf-proofs 2 ({cli_s:.1f} s process): "
              f"{sorted(p.name for p in bins.iterdir())} published; the leaf verifier data "
              f"loads with its pins, the dummy proof accepted", flush=True)

        text = "\n".join(sweep_shapes.anchors_section(
            {"memprof": sweep_shapes.load_anchor(str(tmp / "memprof.json"))}))
    against = [line for line in text.splitlines() if "device peak of the prove phase" in line]
    if "TPU" in text or record["card"] not in text or len(against) != 1:
        raise AssertionError("[tools] the sweep's anchors section shows a TPU figure, misses the "
                             "card or the device peak against the estimate")
    print(f"[tools] sweep_shapes anchors section from that memprof output: the card named, no "
          f"TPU figure; {against[0]}", flush=True)
    print(f"[tools] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import os

    sys.path.insert(0, str(ROOT))
    # the phases check the staged prover's internals; the [fused] phases
    # and [service] lift this for `prove`'s own dispatch
    os.environ[STAGED_ENV] = "1"
    device_info = phase_device()
    phase_build()
    phase_host()
    kernels = kernel_table("cuda")
    phase_kernels(kernels)
    phase_aggregation_tree("cuda")
    phase_aggregation_ntt("cuda")
    phase_aggregation_fused("cuda")
    phase_aggregation_fri_tail("cuda")
    leaf = phase_main_path(kernels)
    phase_batch(kernels)
    zk_leaf = phase_zk(kernels)
    phase_aggregation_rand("cuda")
    phase_recursion(kernels)
    built = phase_aggregation(kernels)
    fused_leaf = phase_fused(kernels, zk_leaf)
    phase_fused_batch(kernels, fused_leaf, zk_leaf)
    phase_fused_aggregation(kernels, built)
    with _prover_env(staged=False):
        phase_service(kernels, built)
    phase_mesh(kernels, leaf, zk_leaf, built)
    phase_tools(leaf)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        # library_ms: null where no single PyTorch call computes the
        # function (torch.randint, timed beside kernel G, draws another stream)
        k["route"] = "cuda"
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k} for k in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
