"""Fiat-Shamir transcript: a Poseidon2 duplex-sponge challenger (host side).

Mirrors the role of plonky2's `Challenger` (the reference's transcripts must
reproduce Fiat-Shamir exactly for cross-verification — SURVEY §7 "Hard
parts"): observe proof elements as felts, derive challenges by duplexing.
The challenger is host logic (a tiny state) — challenges gate the device
pipeline stages, so they live where the control flow lives. Its
permutations run in the C library of native/ (`_duplex` through
`poseidon2.permute_np`; `observe_many` absorbs 16 felts or more in one call,
`native.absorb_many`). Only the PoW grind runs on the device.

The fused prover (plonk/prover_fused.py) runs the same transcript on the
card: `DeviceChallenger` holds the sponge state in device memory and runs
each segment of the schedule as one kernel-I launch (csrc/transcript.cu),
writing its challenges into a challenge record (`REC_*`, the layout of
csrc/challenges.cuh) that kernels A-E read, and `grind_device` is its grind
(kernel J). Only how full the buffers are lives on the host: the schedule
fixes it, never a value. The fused batch (plonk/prover_fused.py::
prove_fused_batch) drives K such transcripts with one set of fills:
`DeviceChallengerBatch`, one kernel-I launch a segment for all K
(`transcript_segment_batch`) and one kernel-J launch for all K grinds
(`grind_device_batch`). The staged prover writes its host challenges into
a record of the same layout (`challenge_records`), one copy, so both paths
launch the same kernels.

A batch of proofs of one circuit drives K transcripts through the same
schedule: `ChallengerBatch` holds their (K, 12) states and advances them in
lockstep, one C call a step for all K (`native.absorb_batch`,
`native.duplex_batch`), and `unbind` hands back K `Challenger`s in the
states they reached. `grind_pow_batch` grinds K transcripts in one
kernel-2 launch a sweep. A batch's FRI phases draw on the `ChallengerBatch`
itself (fri/prover.py::fri_commit_phase_batch, fri_query_phase_batch).

Determinism contract: the prover and verifier drive a Challenger through the
identical observe/challenge schedule; any reordering breaks verification
(tested in tests/test_fri.py with a tampered-transcript probe).
"""

from __future__ import annotations

import functools

import numpy as np

import torch

from .. import _cuda
from .. import native as nat
from ..field import goldilocks as gl
from ..hash import poseidon2 as ps


class Challenger:
    def __init__(self):
        self.state = np.zeros(ps.WIDTH, dtype=np.uint64)
        self.input_buf: list[np.uint64] = []
        self.output_buf: list[np.uint64] = []

    # -- observing ---------------------------------------------------------
    def observe(self, felt) -> None:
        self.output_buf.clear()
        self.input_buf.append(np.uint64(felt))
        if len(self.input_buf) == ps.RATE:
            self._duplex()

    def observe_many(self, felts) -> None:
        arr = np.asarray(felts, dtype=np.uint64).ravel()
        if arr.size >= 16:
            # one C call; observe()'s output-buffer rule: the buffer holds the
            # rate only when the last felt completed a block
            self.output_buf.clear()
            before = len(self.input_buf)
            self.state, self.input_buf = nat.absorb_many(self.state, self.input_buf, arr)
            if (before + arr.size) % ps.RATE == 0:
                self.output_buf = list(self.state[: ps.RATE])
            return
        for f in arr:
            self.observe(f)

    def observe_ext(self, ext_val) -> None:
        self.observe_many(np.asarray(ext_val, dtype=np.uint64).ravel())

    def observe_cap(self, cap: np.ndarray) -> None:
        self.observe_many(np.asarray(cap, dtype=np.uint64).ravel())

    # -- challenges --------------------------------------------------------
    def _duplex(self) -> None:
        st = self.state.copy()
        if self.input_buf:
            st[: len(self.input_buf)] = self.input_buf
        self.state = ps.permute_np(st)
        self.input_buf.clear()
        self.output_buf = list(self.state[: ps.RATE])

    def challenge(self) -> np.uint64:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop(0)

    def challenge_many(self, n: int) -> np.ndarray:
        return np.array([self.challenge() for _ in range(n)], dtype=np.uint64)

    def challenge_ext(self) -> np.ndarray:
        c0 = self.challenge()
        c1 = self.challenge()
        return np.array([c0, c1], dtype=np.uint64)

    def challenge_index(self, domain_size: int) -> int:
        """Sample a query index in [0, domain_size) (power-of-two domain)."""
        return int(self.challenge()) % domain_size

    def fork(self) -> "Challenger":
        c = Challenger()
        c.state = self.state.copy()
        c.input_buf = list(self.input_buf)
        c.output_buf = list(self.output_buf)
        return c


class ChallengerBatch:
    """K challengers of one circuit's proofs advanced in lockstep. The
    schedule is the circuit's, so every transcript's input and output
    buffers hold as many felts at each step: they are (K, fill) arrays.
    Each method is `Challenger`'s, K at once, and leaves the K states
    bit-equal to K `Challenger`s driven alike."""

    def __init__(self, count: int):
        self.state = np.zeros((count, ps.WIDTH), dtype=np.uint64)
        self.input_buf = np.zeros((count, 0), dtype=np.uint64)
        self.output_buf = np.zeros((count, 0), dtype=np.uint64)

    def __len__(self) -> int:
        return self.state.shape[0]

    def observe_many(self, felts) -> None:
        """Row k of felts (K, n) into transcript k (`Challenger.observe_many`:
        the output buffer holds the rate only when the last felt completed
        a block)."""
        arr = np.asarray(felts, dtype=np.uint64).reshape(len(self), -1)
        if not arr.shape[1]:
            return
        before = self.input_buf.shape[1]
        self.state, self.input_buf = nat.absorb_batch(self.state, self.input_buf, arr)
        full = (before + arr.shape[1]) % ps.RATE == 0
        self.output_buf = self.state[:, : ps.RATE].copy() if full else self.output_buf[:, :0]

    def _duplex(self) -> None:
        self.state = nat.duplex_batch(self.state, self.input_buf)
        self.input_buf = self.input_buf[:, :0]
        self.output_buf = self.state[:, : ps.RATE].copy()

    def challenge(self) -> np.ndarray:
        """One challenge of each transcript, (K,)."""
        if self.input_buf.shape[1] or not self.output_buf.shape[1]:
            self._duplex()
        out = self.output_buf[:, 0].copy()
        self.output_buf = self.output_buf[:, 1:]
        return out

    def challenge_many(self, n: int) -> np.ndarray:
        """(K, n) challenges."""
        out = np.empty((len(self), n), dtype=np.uint64)
        for j in range(n):
            out[:, j] = self.challenge()
        return out

    def challenge_ext(self) -> np.ndarray:
        return self.challenge_many(2)

    def observe_cap(self, caps) -> None:
        """Cap k (2^h, 4) into transcript k (`Challenger.observe_cap`)."""
        self.observe_many(np.asarray(caps, dtype=np.uint64).reshape(len(self), -1))

    def challenge_index(self, domain_size: int) -> np.ndarray:
        """A query index of each transcript in [0, domain_size) (a power of
        two: the challenge's low bits), (K,)."""
        return self.challenge() % np.uint64(domain_size)

    def fork(self) -> "ChallengerBatch":
        c = ChallengerBatch(len(self))
        c.state, c.input_buf, c.output_buf = (
            a.copy() for a in (self.state, self.input_buf, self.output_buf))
        return c

    @classmethod
    def of(cls, challengers: list[Challenger]) -> "ChallengerBatch":
        """K Challengers in lockstep (their buffers equally full) as one
        batch, each in the state it reached."""
        if len({(len(c.input_buf), len(c.output_buf)) for c in challengers}) != 1:
            raise ValueError("the transcripts' buffers differ: they are not in lockstep")
        c = cls(len(challengers))
        c.state = np.stack([ch.state for ch in challengers])
        c.input_buf, c.output_buf = (
            np.array([getattr(ch, buf) for ch in challengers], dtype=np.uint64).reshape(
                len(challengers), -1) for buf in ("input_buf", "output_buf"))
        return c

    def unbind(self) -> list[Challenger]:
        """K Challengers in the states the transcripts reached."""
        out = []
        for k in range(len(self)):
            c = Challenger()
            c.state = self.state[k].copy()
            c.input_buf = [np.uint64(v) for v in self.input_buf[k]]
            c.output_buf = [np.uint64(v) for v in self.output_buf[k]]
            out.append(c)
        return out


#: a grind sweep's candidates by device type: one kernel-2 launch of 2^17
#: states on the card; 2^14 on the CPU, where the plain permutation's cost
#: a state does not fall with the sweep's size, so a grind stops within
#: 2^14 states of its witness
SWEEP = {"cuda": 1 << 17, "cpu": 1 << 14}


def _sweep(pow_bits: int, batch: int | None, device) -> int:
    """A grind sweep's candidates: `batch` (by default the device's
    `SWEEP`), or 2^(pow_bits + 5) if fewer, which all fail with odds of
    e^-32."""
    if batch is None:
        batch = SWEEP[torch.device(device).type]
    return min(batch, 1 << (pow_bits + 5))


def grind_pow(
    challenger: Challenger, pow_bits: int, device, batch: int | None = None
) -> np.uint64:
    """Find the lowest witness w such that observing w yields a challenge with
    >= pow_bits leading zero bits (the reference's 16-bit FRI grind,
    `wormhole/circuit/src/profile.rs:138-144`): `grind_pow_batch` of one
    transcript."""
    return grind_pow_batch([challenger], pow_bits, device, batch)[0]


def grind_pow_batch(
    challengers, pow_bits: int, device, batch: int | None = None
) -> list[np.uint64]:
    """`grind_pow` for K transcripts in lockstep, a `ChallengerBatch` or K
    `Challenger`s with equally full buffers (neither is changed), each
    keeping its own lowest passing witness (the JAX package's `_grind_j`
    under `vmap`, whose while_loop masks the lanes that are done).

    A sweep gives every unfinished transcript `batch` candidate duplex
    states (w = start + i in the next input slot), as a single grind's sweep
    does, so a proof's grind work stays a single proof's, and permutes them
    all in one kernel-2 launch on `device`; a mask and a min over each
    transcript's candidates pick its lowest passing one, so the result is
    the same as a sequential search, and the transcript leaves the sweeps.
    A sweep takes at most 2^(pow_bits + 5) candidates (`_sweep`): the
    leaf's 16 bits keep the card's 2^17, and a grind of few bits does not
    permute 2^17 states for a witness that one in 2^pow_bits candidates
    passes. Every sweep size finds the same, lowest, witness."""
    if not 0 <= pow_bits <= 32:
        raise ValueError(f"pow_bits out of range: {pow_bits}")
    ch = challengers if isinstance(challengers, ChallengerBatch) else ChallengerBatch.of(
        challengers)
    if pow_bits == 0:
        return [np.uint64(0)] * len(ch)
    batch = _sweep(pow_bits, batch, device)
    threshold = 1 << (64 - pow_bits)
    k = ch.input_buf.shape[1]
    states = ch.state.copy()
    states[:, :k] = ch.input_buf
    base_state = gl.from_u64(states, device)
    idx = torch.arange(batch, dtype=torch.int64, device=device)
    found: dict[int, np.uint64] = {}
    open_ = list(range(len(ch)))
    start = 0
    while open_:
        base = base_state if len(open_) == len(ch) else base_state[
            torch.as_tensor(open_, device=device)]
        u = base.shape[0]
        cand = base.unsqueeze(1).expand(u, batch, ps.WIDTH).clone()
        cand[:, :, k] = idx + start
        out0 = ps.permute(cand.reshape(u * batch, ps.WIDTH))[:, 0].reshape(u, batch)
        # u64 out0 < 2^(64 - pow_bits)  <=>  no bit at or above 64 - pow_bits
        passing = (out0 >> (64 - pow_bits)) == 0
        first = torch.where(passing, idx, batch).min(dim=1).values.tolist()
        for i, f in zip(list(open_), first):
            if f < batch:
                found[i] = np.uint64(start + f)
                open_.remove(i)
        start += batch
    witnesses = [found[i] for i in range(len(ch))]
    # the device and host Poseidon2 are pinned bit-identical, so a mismatch
    # here is a real bug: fail loudly, never mask it
    probe = ch.fork()
    probe.observe_many(np.array(witnesses, dtype=np.uint64).reshape(-1, 1))
    if (probe.challenge() >= np.uint64(threshold)).any():
        raise AssertionError("PoW grind verification mismatch")
    return witnesses


def check_pow(challenger: Challenger, witness, pow_bits: int) -> bool:
    challenger.observe(witness)
    return int(challenger.challenge()) < (1 << (64 - pow_bits))


# ---------------------------------------------------------------------------
# the challenge record: where kernels A-E read a proof's challenges

#: word offsets of a record (csrc/challenges.cuh, the one other table of
#: them): the alphas, betas and gammas (nc <= 4 each), the public-input
#: hash, zeta, g * zeta, FRI's alpha, then round r's beta at REC_FRI_BETA + 2 r
REC_ALPHA, REC_BETA, REC_GAMMA, REC_PI = 0, 4, 8, 12
REC_ZETA, REC_ZETA_NEXT, REC_FRI_ALPHA, REC_FRI_BETA = 16, 18, 20, 22
MAX_FRI_ROUNDS = 16
REC_WORDS = 56


def challenge_records(device, count: int, fields: dict) -> torch.Tensor:
    """`count` records (count, REC_WORDS) on `device` in one copy: `fields`
    maps a word offset to the host felts that start there, (count, w) (or w
    for one record). The staged prover's form of the fused transcript's
    record."""
    host = np.zeros((count, REC_WORDS), dtype=np.uint64)
    for slot, values in fields.items():
        v = np.asarray(values, dtype=np.uint64).reshape(count, -1)
        host[:, slot : slot + v.shape[1]] = v
    return gl.from_u64(host, device)


# ---------------------------------------------------------------------------
# kernel I: the transcript on the card

#: the transcript's device state: the sponge state, then the input buffer
TS_WORDS = ps.WIDTH + ps.RATE
#: a segment observes at most this many ranges and squeezes at most this
#: many runs of challenges (csrc/transcript.cu MAX_SRC, MAX_SQ)
MAX_SOURCES = 4
MAX_SQUEEZES = 4
_SEGMENT_WORDS = 5 + 6 * MAX_SOURCES + 3 * MAX_SQUEEZES + 2
#: the batch entry's proof strides after a segment's words (csrc/transcript.cu
#: STRIDE_WORDS): the states', each source's, each record's, each squeeze's,
#: the scale's
_STRIDE_WORDS = 2 + 2 * MAX_SOURCES + MAX_SQUEEZES
_U64 = (1 << 64) - 1


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """A source as the (rows, cols) view its felts are absorbed from, row by
    row (a vector is one column)."""
    if t.dim() == 1:
        return t.unsqueeze(1)
    if t.dim() != 2:
        raise ValueError(f"a transcript source is a vector or a matrix, got {tuple(t.shape)}")
    return t


def _segment_limits(state, in_len, out_len, observe, squeeze, scale) -> None:
    if state.dim() != 1 or state.shape[0] != TS_WORDS:
        raise ValueError(f"a transcript state is ({TS_WORDS},), got {tuple(state.shape)}")
    if not 0 <= in_len < ps.RATE or not 0 <= out_len <= ps.RATE:
        raise ValueError(f"buffer fills {in_len}, {out_len} outside the sponge's rate")
    if len(observe) > MAX_SOURCES or len(squeeze) > MAX_SQUEEZES:
        raise ValueError(f"{len(observe)} sources and {len(squeeze)} squeezes: a segment takes "
                         f"at most {MAX_SOURCES} and {MAX_SQUEEZES}")
    for src, record in observe:
        rows = _as_rows(src)
        if record is not None and (record.dim() != 1 or record.numel() != rows.numel()
                                   or record.stride(0) != 1):
            raise ValueError("a source's record is a contiguous vector of its size")
    for dst, bits in squeeze:
        if dst.dim() != 1 or dst.stride(0) != 1 or not 0 <= bits <= 32:
            raise ValueError("a squeeze writes a contiguous vector, as indices of at most 32 bits")
    if scale is not None and (scale[0].dim() != 1 or scale[0].numel() != 2
                              or sum(d.numel() for d, _ in squeeze) < 2):
        raise ValueError("the scale takes the segment's last extension pair")


def _one_proof(observe, squeeze, scale) -> tuple:
    """A segment's operands of one transcript as the batch of one's: each
    source, record, squeeze and the scale with a proof axis of 1."""
    return ([(_as_rows(s).unsqueeze(0), None if r is None else r.unsqueeze(0))
             for s, r in observe],
            [(d.unsqueeze(0), bits) for d, bits in squeeze],
            None if scale is None else (scale[0].unsqueeze(0), scale[1]))


def transcript_segment_plain(state, in_len: int, out_len: int, observe=(), squeeze=(),
                             scale=None) -> None:
    """Plain torch version of `transcript_segment` (same arguments):
    `transcript_segment_batch_plain` of one transcript (the host
    Challenger's duplex rules on the state's tensor, the permutation
    `poseidon2.permute_plain`)."""
    _segment_limits(state, in_len, out_len, observe, squeeze, scale)
    transcript_segment_batch_plain(state.unsqueeze(0), in_len, out_len,
                                   *_one_proof(observe, squeeze, scale))


@functools.cache
def _transcript_lib(index: int | None):
    """The kernel library with kernels I's and J's Poseidon2 constants in
    CUDA device `index`'s __constant__ memory."""
    lib = _cuda.lib()
    ext_rcs, int_rcs, diag = (
        np.ascontiguousarray(a, dtype=np.uint64)
        for a in (ps.external_round_constants(), ps.internal_round_constants(), ps.internal_diag())
    )
    with _cuda.on_device(torch.device("cuda", index)):
        err = lib.qzk_transcript_set_constants(
            ext_rcs.ctypes.data, int_rcs.ctypes.data, diag.ctypes.data)
    _cuda.check(err, "qzk_transcript_set_constants")
    return lib


def transcript_segment(state: torch.Tensor, in_len: int, out_len: int, observe=(), squeeze=(),
                       scale=None) -> None:
    """One segment of a transcript whose state (TS_WORDS,) lies on the
    device and whose buffers hold `in_len` and `out_len` felts: observe each
    (source, record) in turn, a source a vector or a (rows, cols) matrix of
    any strides absorbed row by row and copied into `record` (a contiguous
    vector) unless that is None; then squeeze each (dst, bits) in turn,
    dst.numel() challenges into the contiguous vector dst, as query indices
    lo & (2^bits - 1) when bits > 0; then, with scale = (dst2, factor), the
    last two challenges times factor into dst2 (zeta_next = g * zeta). The
    state is updated in place; the caller advances the fills
    (`DeviceChallenger`).

    On a CUDA state: kernel I (csrc/transcript.cu), the batch entry's launch
    for one transcript, one warp. On a CPU state: the plain version."""
    _segment_limits(state, in_len, out_len, observe, squeeze, scale)
    if state.device.type == "cpu":
        transcript_segment_plain(state, in_len, out_len, observe, squeeze, scale)
        return
    _launch_segment(state.unsqueeze(0), in_len, out_len, *_one_proof(observe, squeeze, scale))
    transcript_segment.launches += 1


transcript_segment.launches = 0


def _advance(in_len: int, out_len: int, observed: int, squeezed: int) -> tuple[int, int, int]:
    """The buffers' fills after observing `observed` felts and drawing
    `squeezed` challenges, and the permutations that took: the host
    Challenger's rules on counts alone."""
    perms = 0
    for _ in range(observed):
        in_len, out_len = in_len + 1, 0
        if in_len == ps.RATE:
            in_len, out_len, perms = 0, ps.RATE, perms + 1
    for _ in range(squeezed):
        if in_len or not out_len:
            in_len, out_len, perms = 0, ps.RATE, perms + 1
        out_len -= 1
    return in_len, out_len, perms


# ---------------------------------------------------------------------------
# kernel I over K transcripts: the fused batch's


def _as_rows_batch(t: torch.Tensor) -> torch.Tensor:
    """A batch source as the (K, rows, cols) view each proof's felts are
    absorbed from, row by row (a (K, n) matrix is one column a proof)."""
    if t.dim() == 2:
        return t.unsqueeze(2)
    if t.dim() != 3:
        raise ValueError(f"a batch transcript source is (K, n) or (K, rows, cols), got "
                         f"{tuple(t.shape)}")
    return t


def _proof_rows(name: str, t: torch.Tensor, k: int, width: int | None = None) -> None:
    """A (K, width) operand that the segment writes: int64, contiguous within
    a proof's row, rows that do not overlap."""
    if t.dim() != 2 or t.shape[0] != k or (width is not None and t.shape[1] != width):
        raise ValueError(f"{name} {tuple(t.shape)}, expected ({k}, {width or 'n'})")
    if t.shape[1] and t.stride(1) != 1:
        raise ValueError(f"{name}: each proof's row is contiguous")
    if k > 1 and abs(t.stride(0)) < t.shape[1]:
        raise ValueError(f"{name}: proof stride {t.stride(0)} below its row of {t.shape[1]}: "
                         "the proofs' rows overlap")


def _segment_batch_limits(states, in_len, out_len, observe, squeeze, scale) -> int:
    """Raises on what kernel I's batch form does not take; returns K."""
    if states.dim() != 2 or states.shape[0] < 1:
        raise ValueError(f"a batch of transcript states is (K >= 1, {TS_WORDS}), got "
                         f"{tuple(states.shape)}")
    k = states.shape[0]
    _proof_rows("the states", states, k, TS_WORDS)
    if not 0 <= in_len < ps.RATE or not 0 <= out_len <= ps.RATE:
        raise ValueError(f"buffer fills {in_len}, {out_len} outside the sponge's rate")
    if len(observe) > MAX_SOURCES or len(squeeze) > MAX_SQUEEZES:
        raise ValueError(f"{len(observe)} sources and {len(squeeze)} squeezes: a segment takes "
                         f"at most {MAX_SOURCES} and {MAX_SQUEEZES}")
    operands = [states]
    for src, record in observe:
        rows = _as_rows_batch(src)
        if rows.shape[0] != k:
            raise ValueError(f"a source of {rows.shape[0]} proofs for {k} transcripts")
        operands.append(rows)
        if record is not None:
            _proof_rows("a source's record", record, k, rows[0].numel())
            operands.append(record)
    for dst, bits in squeeze:
        _proof_rows("a squeeze", dst, k)
        if not 0 <= bits <= 32:
            raise ValueError("a squeeze writes indices of at most 32 bits")
        operands.append(dst)
    if scale is not None:
        _proof_rows("the scale", scale[0], k, 2)
        if sum(d.shape[1] for d, _ in squeeze) < 2:
            raise ValueError("the scale takes the segment's last extension pair")
        operands.append(scale[0])
    # the kernel steps a proof by whole int64 elements
    if any(t.dtype != torch.int64 for t in operands):
        raise TypeError("a batch transcript operand is int64: its proof stride counts whole "
                        "8-byte felts")
    return k


def transcript_segment_batch_plain(states, in_len: int, out_len: int, observe=(), squeeze=(),
                                   scale=None) -> None:
    """Plain torch version of `transcript_segment_batch` (same arguments):
    the host Challenger's duplex rules on the K states at once, one
    `poseidon2.permute_plain` of (K, WIDTH) a duplex."""
    k = _segment_batch_limits(states, in_len, out_len, observe, squeeze, scale)
    st = states[:, : ps.WIDTH].clone()
    inb = [states[:, ps.WIDTH + t] for t in range(in_len)]
    out = out_len

    def duplex():
        nonlocal st, inb, out
        if inb:
            st = torch.cat([torch.stack(inb, 1), st[:, len(inb) :]], 1)
        st = ps.permute_plain(st)
        inb, out = [], ps.RATE

    for src, record in observe:
        vals = _as_rows_batch(src).reshape(k, -1)
        if record is not None:
            record.copy_(vals)
        n, i = vals.shape[1], 0
        while i < n:
            if not inb and n - i >= ps.RATE:  # a whole block
                inb = list(vals[:, i : i + ps.RATE].unbind(1))
                i += ps.RATE
            else:
                inb.append(vals[:, i])
                i += 1
            out = 0
            if len(inb) == ps.RATE:
                duplex()
    last = []
    for dst, bits in squeeze:
        for j in range(dst.shape[1]):
            if inb or out == 0:
                duplex()
            v = st[:, ps.RATE - out]
            out -= 1
            last = (last + [v])[-2:]
            dst[:, j] = v & ((1 << bits) - 1) if bits else v
    if scale is not None:
        factor = gl.felt(scale[1], states.device)
        scale[0].copy_(gl.mul_plain(torch.stack(last, 1), factor))
    states[:, : ps.WIDTH] = st
    tail = torch.zeros((k, ps.RATE), dtype=torch.int64, device=states.device)
    if inb:
        tail[:, : len(inb)] = torch.stack(inb, 1)
    states[:, ps.WIDTH :] = tail


def transcript_segment_batch(states: torch.Tensor, in_len: int, out_len: int, observe=(),
                             squeeze=(), scale=None) -> None:
    """`transcript_segment` for K transcripts of one schedule (a batch of
    proofs of one circuit): states (K, TS_WORDS) on the device, whose
    buffers all hold `in_len` and `out_len` felts; each source (K, n) or
    (K, rows, cols) of any strides (proof i's felts at row i, a stride of 0
    to observe one tensor into every transcript), each record (K, n), each
    squeeze's dst (K, count) and the scale's dst2 (K, 2) with rows
    contiguous a proof and not overlapping. Each proof's operands may lie
    anywhere a constant stride apart (the fused batch's stacked upload and
    part-major output).

    On CUDA tensors: kernel I's batch form (csrc/transcript.cu), one launch
    of K one-warp blocks. On CPU tensors: the plain version."""
    k = _segment_batch_limits(states, in_len, out_len, observe, squeeze, scale)
    if states.device.type == "cpu":
        transcript_segment_batch_plain(states, in_len, out_len, observe, squeeze, scale)
        return
    _launch_segment(states, in_len, out_len, observe, squeeze, scale)
    transcript_segment_batch.launches += 1


def _launch_segment(states, in_len, out_len, observe, squeeze, scale) -> None:
    """Kernel I's launch (csrc/transcript.cu qzk_transcript_batch) for the
    (K, TS_WORDS) states and their operands with a proof axis: a segment's
    words for proof 0, then each operand's proof stride."""
    _cuda.require_cuda_int64(states, *(s for s, _ in observe),
                             *(r for _, r in observe if r is not None), *(d for d, _ in squeeze),
                             *(() if scale is None else (scale[0],)))
    sources = [_as_rows_batch(s) for s, _ in observe]
    words = np.zeros(_SEGMENT_WORDS + _STRIDE_WORDS, dtype=np.uint64)
    words[:5] = [states.data_ptr(), in_len, out_len, len(observe), len(squeeze)]
    strides = [states.stride(0)] + [0] * (_STRIDE_WORDS - 1)
    for i, (rows, (_, record)) in enumerate(zip(sources, observe)):
        words[5 + 6 * i : 11 + 6 * i] = [
            rows.data_ptr(), rows.shape[1], rows.shape[2], rows.stride(1) & _U64,
            rows.stride(2) & _U64, 0 if record is None else record.data_ptr()]
        strides[1 + i] = rows.stride(0)
        strides[1 + MAX_SOURCES + i] = 0 if record is None else record.stride(0)
    at = 5 + 6 * MAX_SOURCES
    for i, (dst, bits) in enumerate(squeeze):
        words[at + 3 * i : at + 3 * i + 3] = [dst.data_ptr(), dst.shape[1], bits]
        strides[1 + 2 * MAX_SOURCES + i] = dst.stride(0)
    if scale is not None:
        words[_SEGMENT_WORDS - 2 : _SEGMENT_WORDS] = [scale[0].data_ptr(), int(scale[1]) % gl.P]
        strides[-1] = scale[0].stride(0)
    words[_SEGMENT_WORDS:] = [s & _U64 for s in strides]
    lib = _transcript_lib(states.device.index)
    with _cuda.on_device(states.device):
        err = lib.qzk_transcript_batch(words.ctypes.data, states.shape[0], _cuda.stream())
    _cuda.check(err, "qzk_transcript_batch")


transcript_segment_batch.launches = 0


class DeviceChallengerBatch:
    """The host `Challenger`'s schedule on K transcript states held on the
    device, K proofs of one circuit (the JAX package's
    plonk/prover_fused.py::DeviceChallenger, under jax.vmap for a batch,
    :1007): the sponge states and input buffers in `states` (K, TS_WORDS),
    zeros for fresh transcripts, each buffer zero past its fill after each
    segment; the buffers' fills, which the circuit's schedule alone sets,
    here, one set for all K (`ChallengerBatch`). Each `segment` is one
    `transcript_segment_batch` call for all K; `permutations` counts one
    transcript's duplexes so far."""

    def __init__(self, states: torch.Tensor):
        self.states = states
        self.in_len = 0
        self.out_len = 0
        self.permutations = 0

    def __len__(self) -> int:
        return self.states.shape[0]

    def segment(self, observe=(), squeeze=(), scale=None) -> None:
        transcript_segment_batch(self.states, self.in_len, self.out_len, observe, squeeze, scale)
        self._advance(sum(_as_rows_batch(s)[0].numel() for s, _ in observe),
                      sum(d.shape[1] for d, _ in squeeze))

    def _advance(self, observed: int, squeezed: int) -> None:
        self.in_len, self.out_len, perms = _advance(self.in_len, self.out_len, observed, squeezed)
        self.permutations += perms

    def grind(self, pow_bits: int, words: torch.Tensor, limit: int | None = None) -> None:
        """Kernel J from these transcripts' states (`grind_device_batch`)."""
        grind_device_batch(self.states, self.in_len, pow_bits, words, limit)


class DeviceChallenger(DeviceChallengerBatch):
    """`DeviceChallengerBatch` of one proof (the fused single proof's): its
    state (TS_WORDS,), each segment's operands one proof's, without a proof
    axis (`transcript_segment`), the grind `grind_device`."""

    def __init__(self, state: torch.Tensor):
        super().__init__(state.unsqueeze(0))
        self.state = state

    def segment(self, observe=(), squeeze=(), scale=None) -> None:
        transcript_segment(self.state, self.in_len, self.out_len, observe, squeeze, scale)
        self._advance(sum(_as_rows(s).numel() for s, _ in observe),
                      sum(d.numel() for d, _ in squeeze))

    def grind(self, pow_bits: int, words: torch.Tensor, limit: int | None = None) -> None:
        grind_device(self.state, self.in_len, pow_bits, words, limit)


# ---------------------------------------------------------------------------
# kernel J: the grind on the card


def grind_limit(pow_bits: int) -> int:
    """The candidates a device grind tries at most: 2^(pow_bits + 12), so a
    grind stops short of its witness with odds of e^-4096."""
    return 1 << min(pow_bits + 12, 44)


def _grind_limits(state, in_len, pow_bits, words) -> None:
    if state.dim() != 1 or state.shape[0] != TS_WORDS or not 0 <= in_len < ps.RATE:
        raise ValueError("a grind starts from a transcript state with a part-full input buffer")
    if not 1 <= pow_bits <= 32:
        raise ValueError(f"pow_bits {pow_bits}: a device grind takes 1..32")
    if words.shape != (2,) or words.dtype != torch.int64:
        raise ValueError("a grind's words are (next candidate, best witness), int64")


def grind_plain(state, in_len: int, pow_bits: int, words, limit: int | None = None,
                batch: int | None = None) -> None:
    """Plain torch version of `grind_device` (same arguments):
    `grind_batch_plain` of one transcript, sweeps of `batch` candidates
    (`_sweep`) in order, the first sweep with a passing candidate giving
    the lowest one."""
    _grind_limits(state, in_len, pow_bits, words)
    grind_batch_plain(state.unsqueeze(0), in_len, pow_bits, words.unsqueeze(0), limit, batch)


def grind_device(state: torch.Tensor, in_len: int, pow_bits: int, words: torch.Tensor,
                 limit: int | None = None) -> None:
    """The PoW grind from a device transcript (its state and input fill):
    the lowest w below `limit` (`grind_limit`) such that observing w and
    drawing a challenge gives one below 2^(64 - pow_bits), written to
    words[1]; `words` (2,) int64 on the state's device holds (0, -1) before
    the call (the next candidate, the best so far as u64 2^64 - 1), and
    words[1] stays -1 if no candidate below the limit passes.

    On CUDA tensors: kernel J (csrc/transcript.cu), the batch entry's launch
    for one grind, which loops on the card until it has the witness. On CPU
    tensors: the plain version."""
    _grind_limits(state, in_len, pow_bits, words)
    limit = grind_limit(pow_bits) if limit is None else limit
    if state.device.type == "cpu":
        grind_plain(state, in_len, pow_bits, words, limit)
        return
    _launch_grind(state.unsqueeze(0), in_len, pow_bits, words.unsqueeze(0), limit)
    grind_device.launches += 1


grind_device.launches = 0


# ---------------------------------------------------------------------------
# kernel J over K grinds: the fused batch's


def _grind_batch_limits(states, in_len, pow_bits, words) -> int:
    if states.dim() != 2 or states.shape[0] < 1 or not 0 <= in_len < ps.RATE:
        raise ValueError("a batch grind starts from (K >= 1, TS_WORDS) transcript states with "
                         "part-full input buffers")
    k = states.shape[0]
    _proof_rows("the states", states, k, TS_WORDS)
    if not 1 <= pow_bits <= 32:
        raise ValueError(f"pow_bits {pow_bits}: a device grind takes 1..32")
    _proof_rows("the grind's words", words, k, 2)
    if states.dtype != torch.int64 or words.dtype != torch.int64:
        raise TypeError("a batch grind's states and words are int64 (next candidate, best "
                        "witness) rows")
    return k


def grind_batch_plain(states, in_len: int, pow_bits: int, words, limit: int | None = None,
                      batch: int | None = None) -> None:
    """Plain torch version of `grind_device_batch` (same arguments): sweeps
    of `batch` candidates (`_sweep`) in order for every proof still open,
    each proof left with its lowest passing witness from the first sweep
    with one (the loop's one data-dependent step, on the card in kernel J)
    and the end of that sweep as its next candidate."""
    k = _grind_batch_limits(states, in_len, pow_bits, words)
    limit = grind_limit(pow_bits) if limit is None else limit
    dev = states.device
    base = torch.cat([states[:, ps.WIDTH : ps.WIDTH + in_len], states[:, in_len : ps.WIDTH]], 1)
    batch = _sweep(pow_bits, batch, dev)
    idx = torch.arange(batch, dtype=torch.int64, device=dev)
    open_ = torch.ones(k, dtype=torch.bool, device=dev)
    words[:, 0] = 0
    start = 0
    while start < limit:
        rows = open_.nonzero().flatten()
        if not rows.numel():
            break
        cand = base[rows].unsqueeze(1).expand(rows.numel(), batch, ps.WIDTH).clone()
        cand[:, :, in_len] = idx + start
        out0 = ps.permute_plain(cand.reshape(-1, ps.WIDTH))[:, 0].reshape(rows.numel(), batch)
        passing = ((out0 >> (64 - pow_bits)) == 0) & (idx < limit - start)
        start += batch
        found = passing.any(1)
        first = torch.where(passing, idx, batch).min(1).values + (start - batch)
        words[rows, 0] = start
        words[rows[found], 1] = first[found]
        open_[rows[found]] = False


def grind_device_batch(states: torch.Tensor, in_len: int, pow_bits: int, words: torch.Tensor,
                       limit: int | None = None) -> None:
    """`grind_device` for K transcripts of one schedule (the JAX package's
    `_grind_j` under vmap): states (K, TS_WORDS) whose input buffers all
    hold `in_len` felts, words (K, 2) int64, each row (0, -1) before the
    call; proof i's lowest witness below `limit` goes to words[i, 1], which
    stays -1 if it has none.

    On CUDA tensors: kernel J's batch form (csrc/transcript.cu), one launch
    for all K, each proof stopping at its own witness. On CPU tensors: the
    plain version."""
    k = _grind_batch_limits(states, in_len, pow_bits, words)
    limit = grind_limit(pow_bits) if limit is None else limit
    if states.device.type == "cpu":
        grind_batch_plain(states, in_len, pow_bits, words, limit)
        return
    _launch_grind(states, in_len, pow_bits, words, limit)
    grind_device_batch.launches += 1


def _launch_grind(states, in_len, pow_bits, words, limit) -> None:
    """Kernel J's launch (csrc/transcript.cu qzk_grind_batch) for the (K,
    TS_WORDS) states and their (K, 2) words."""
    _cuda.require_cuda_int64(states, words)
    lib = _transcript_lib(states.device.index)
    with _cuda.on_device(states.device):
        err = lib.qzk_grind_batch(states.data_ptr(), states.stride(0), in_len, pow_bits,
                                  words.data_ptr(), words.stride(0), states.shape[0], limit,
                                  _cuda.stream())
    _cuda.check(err, "qzk_grind_batch")


grind_device_batch.launches = 0
