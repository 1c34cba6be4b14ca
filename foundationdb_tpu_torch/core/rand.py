"""Deterministic randomness — the backbone of replayable simulation.

Mirrors the reference's split between `g_random` (seeded, deterministic,
drives every decision inside simulation) and `g_nondeterministic_random`
(explicitly quarantined nondeterminism) — flow/DeterministicRandom.h,
flow/IRandom.h. Every simulated run is a pure function of the seed.
"""

from __future__ import annotations

import random as _pyrandom


class DeterministicRandom:
    """Seeded PRNG. All simulation decisions must flow through one instance."""

    def __init__(self, seed: int):
        self.seed = seed
        self._r = _pyrandom.Random(seed)

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) — matches the reference's randomInt."""
        if hi <= lo:
            raise ValueError(f"randomInt empty range [{lo},{hi})")
        return lo + self._r.randrange(hi - lo)

    def random_int64(self, lo: int, hi: int) -> int:
        return self.random_int(lo, hi)

    def random_unique_id(self) -> "UID":
        return UID(self._r.getrandbits(64), self._r.getrandbits(64))

    def random_alpha_numeric(self, length: int) -> str:
        chars = "abcdefghijklmnopqrstuvwxyz0123456789"
        return "".join(chars[self._r.randrange(36)] for _ in range(length))

    def random_bytes(self, length: int) -> bytes:
        return self._r.getrandbits(8 * length).to_bytes(length, "little") if length else b""

    def random_choice(self, seq):
        return seq[self._r.randrange(len(seq))]

    def random_shuffle(self, seq) -> None:
        self._r.shuffle(seq)

    def coinflip(self, p: float = 0.5) -> bool:
        return self._r.random() < p

    def push_state(self) -> object:
        return self._r.getstate()

    def pop_state(self, state: object) -> None:
        self._r.setstate(state)


class UID:
    """128-bit identifier, printed as 16 hex digits (first part) like the reference."""

    __slots__ = ("first", "second")

    def __init__(self, first: int = 0, second: int = 0):
        self.first = first
        self.second = second

    def __str__(self):
        return f"{self.first:016x}{self.second:016x}"

    def short(self) -> str:
        return f"{self.first:016x}"

    def __repr__(self):
        return f"UID({self.first:#x},{self.second:#x})"

    def __eq__(self, other):
        return isinstance(other, UID) and self.first == other.first and self.second == other.second

    def __hash__(self):
        return hash((self.first, self.second))

    def __lt__(self, other):
        return (self.first, self.second) < (other.first, other.second)

    def is_valid(self) -> bool:
        return bool(self.first or self.second)
