"""Reversible id permutations for randomized workloads.

The analog of upstream src/testing/id.zig: the workload encodes a
monotone sequence number into the transfer id through a reversible
permutation, so ids exercise diverse bit patterns (dense-low, bit-reversed,
zigzag-interleaved, pseudorandom) while any observed id can be decoded
back to its sequence number. The identity permutation would leave the
id-index hot paths (hash maps, lo-major sorted runs, bloom filters)
exercised only by dense small integers — the permutations make every
randomized schedule also a key-distribution test.
"""

from __future__ import annotations

U64 = (1 << 64) - 1


class IdPermutation:
    """encode(seq) -> id and decode(id) -> seq, bijective on u64."""

    name = "identity"

    def encode(self, seq: int) -> int:
        return seq & U64

    def decode(self, ident: int) -> int:
        return ident & U64


class IdReflect(IdPermutation):
    """Bit-reversed ids: dense sequences land at the TOP of the key space
    (exercises the hi-word tie paths of lo-major indexes)."""

    name = "reflect"

    def encode(self, seq: int) -> int:
        return int(f"{seq & U64:064b}"[::-1], 2)

    decode = encode  # an involution


class IdZigzag(IdPermutation):
    """Even sequences count up from 0, odd count down from u64 max —
    interleaves both ends of the key space."""

    name = "zigzag"

    def encode(self, seq: int) -> int:
        seq &= U64
        return (seq >> 1) if seq % 2 == 0 else (U64 - (seq >> 1))

    def decode(self, ident: int) -> int:
        ident &= U64
        if ident <= (U64 >> 1):
            return (ident << 1) & U64
        return ((U64 - ident) << 1 | 1) & U64


class IdRandom(IdPermutation):
    """4-round Feistel network over the u64 halves — pseudorandom-looking
    ids, exactly invertible."""

    name = "random"
    _KEYS = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
             0x94D049BB133111EB, 0xD6E8FEB86659FD93)

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed & U64

    @staticmethod
    def _round(x: int, k: int) -> int:
        x = (x ^ k) & 0xFFFFFFFF
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        return x & 0xFFFFFFFF

    def encode(self, seq: int) -> int:
        left, right = (seq >> 32) & 0xFFFFFFFF, seq & 0xFFFFFFFF
        for k in self._KEYS:
            left, right = right, left ^ self._round(right, k ^ self.seed)
        return ((left << 32) | right) & U64

    def decode(self, ident: int) -> int:
        left, right = (ident >> 32) & 0xFFFFFFFF, ident & 0xFFFFFFFF
        for k in reversed(self._KEYS):
            left, right = right ^ self._round(left, k ^ self.seed), left
        return ((left << 32) | right) & U64


ALL = (IdPermutation, IdReflect, IdZigzag, IdRandom)


def pick(rng) -> IdPermutation:
    """Seeded choice of a permutation instance (random ones get a seeded
    key so each schedule sees a different pseudorandom id space)."""
    cls = rng.choice(ALL)
    if cls is IdRandom:
        return IdRandom(seed=rng.getrandbits(64))
    return cls()
