"""Fiat-Shamir transcript: a Poseidon2 duplex-sponge challenger (host side).

Mirrors the role of plonky2's `Challenger` (the reference's transcripts must
reproduce Fiat-Shamir exactly for cross-verification — SURVEY §7 "Hard
parts"): observe proof elements as felts, derive challenges by duplexing.
The challenger is host logic (a tiny state) — challenges gate the device
pipeline stages, so they live where the control flow lives. Its
permutations run in the C library of native/ (`_duplex` through
`poseidon2.permute_np`; `observe_many` absorbs 16 felts or more in one call,
`native.absorb_many`). Only the PoW grind runs on the device.

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

import numpy as np

import torch

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
