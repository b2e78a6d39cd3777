"""Fiat-Shamir transcript: a Poseidon2 duplex-sponge challenger (host side).

Mirrors the role of plonky2's `Challenger` (the reference's transcripts must
reproduce Fiat-Shamir exactly for cross-verification — SURVEY §7 "Hard
parts"): observe proof elements as felts, derive challenges by duplexing.
The challenger is host logic (a tiny state) — challenges gate the device
pipeline stages, so they live where the control flow lives. Its
permutations run in the C library of native/ (`_duplex` through
`poseidon2.permute_np`; `observe_many` absorbs 16 felts or more in one call,
`native.absorb_many`). Only the PoW grind runs on the device.

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


def grind_pow(
    challenger: Challenger, pow_bits: int, device, batch: int = 1 << 17
) -> np.uint64:
    """Find the lowest witness w such that observing w yields a challenge with
    >= pow_bits leading zero bits (the reference's 16-bit FRI grind,
    `wormhole/circuit/src/profile.rs:138-144`).

    Each sweep permutes `batch` candidate duplex states (w = start + i in the
    next input slot) in one kernel-2 launch on `device`; a mask and a min over
    the candidate indices pick the lowest passing one, so the result is the
    same as a sequential search."""
    if not 0 <= pow_bits <= 32:
        raise ValueError(f"pow_bits out of range: {pow_bits}")
    if pow_bits == 0:
        return np.uint64(0)
    base = challenger.fork()
    threshold = 1 << (64 - pow_bits)
    k = len(base.input_buf)
    state = base.state.copy()
    state[:k] = np.asarray(base.input_buf, dtype=np.uint64)[:k]
    base_state = gl.from_u64(state, device)
    idx = torch.arange(batch, dtype=torch.int64, device=device)
    start = 0
    while True:
        states = base_state.expand(batch, ps.WIDTH).clone()
        states[:, k] = idx + start
        out0 = ps.permute(states)[:, 0]
        # u64 out0 < 2^(64 - pow_bits)  <=>  no bit at or above 64 - pow_bits
        passing = (out0 >> (64 - pow_bits)) == 0
        first = int(torch.where(passing, idx, batch).min())
        if first < batch:
            w = np.uint64(start + first)
            probe = base.fork()
            probe.observe(w)
            if int(probe.challenge()) < threshold:
                return w
            # the device and host Poseidon2 are pinned bit-identical, so a
            # mismatch here is a real bug — fail loudly, never mask it
            raise AssertionError("PoW grind verification mismatch")
        start += batch


def check_pow(challenger: Challenger, witness, pow_bits: int) -> bool:
    challenger.observe(witness)
    return int(challenger.challenge()) < (1 << (64 - pow_bits))
