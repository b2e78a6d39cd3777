"""In-circuit Fiat-Shamir challenger: the duplex sponge over targets.

Must reproduce the host `plonk/transcript.Challenger` schedule EXACTLY —
observe/duplex/squeeze with the same overwrite semantics — or the recursive
verifier derives different challenges than the proof was built with."""

from __future__ import annotations

from ..hash import poseidon2 as ps
from ..plonk.builder import CircuitBuilder
from .ext_gadgets import ExtTarget


class RecursiveChallenger:
    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.state = [b.zero()] * ps.WIDTH
        self.input_buf: list[int] = []
        self.output_buf: list[int] = []

    def observe(self, t: int) -> None:
        self.output_buf.clear()
        self.input_buf.append(t)
        if len(self.input_buf) == ps.RATE:
            self._duplex()

    def observe_many(self, ts) -> None:
        for t in ts:
            self.observe(t)

    def observe_cap_targets(self, cap_targets) -> None:
        """cap_targets: list of 4-target digests."""
        for digest in cap_targets:
            self.observe_many(digest)

    def _duplex(self) -> None:
        st = list(self.input_buf) + self.state[len(self.input_buf) :]
        self.state = self.b.permute(st)
        self.input_buf.clear()
        self.output_buf = list(self.state[: ps.RATE])

    def challenge(self) -> int:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop(0)

    def challenge_many(self, n: int) -> list[int]:
        return [self.challenge() for _ in range(n)]

    def challenge_ext(self) -> ExtTarget:
        c0 = self.challenge()
        c1 = self.challenge()
        return ExtTarget(c0, c1)
