"""EWAH word-aligned compressed bitset codec.

Mirrors upstream src/ewah.zig:12-28: the encoded stream alternates
marker words and literal words. Each marker holds (uniform_bit, uniform_word
run length, literal word count); uniform runs (all-0 / all-1 words) are
elided, literals follow verbatim. Used to persist the grid free set
compactly (reference free_set.zig persists via ewah through the checkpoint
trailer).

This build vectorizes over numpy u64 words: run boundaries are found with
diff/nonzero rather than a word-at-a-time loop, so encoding a multi-million-
block bitset stays O(words) numpy work.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 64
_ALL_ONES = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

# Marker layout (one u64): bit 0 = uniform bit value; bits 1..32 = number of
# uniform words; bits 32..64 = number of literal words that follow.
_UNIFORM_SHIFT = np.uint64(1)
_LITERAL_SHIFT = np.uint64(32)
_COUNT_MASK = np.uint64(0x7FFF_FFFF)


def bitset_to_words(bits: np.ndarray) -> np.ndarray:
    """(n,) bool → ceil(n/64) u64 words, little-endian bit order."""
    raw = np.packbits(np.asarray(bits, dtype=bool), bitorder="little").tobytes()
    raw = raw.ljust(-(-len(bits) // WORD_BITS) * 8, b"\x00")
    return np.frombuffer(raw, dtype="<u8").copy()


def words_to_bitset(words: np.ndarray, n_bits: int) -> np.ndarray:
    out = np.unpackbits(words.view("<u8").view(np.uint8), bitorder="little")
    return out[:n_bits].astype(bool)


def encode(words: np.ndarray) -> bytes:
    """Compress (n,) u64 words into the EWAH stream (little-endian bytes)."""
    words = np.ascontiguousarray(words, dtype="<u8")
    n = len(words)
    if n == 0:
        return b""
    uniform = (words == 0) | (words == _ALL_ONES)
    # Segment the word stream into maximal runs of equal "kind":
    # kind 0 = literal, 1 = uniform-zero, 2 = uniform-one.
    kind = np.zeros(n, dtype=np.int8)
    kind[words == 0] = 1
    kind[words == _ALL_ONES] = 2
    boundaries = np.nonzero(np.diff(kind))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])

    out: list[np.ndarray] = []
    i = 0
    runs = list(zip(starts, ends, kind[starts]))
    while i < len(runs):
        s, e, k = runs[i]
        if k != 0:
            uniform_bit = 1 if k == 2 else 0
            count = e - s
            i += 1
        else:
            uniform_bit = 0
            count = 0
        # Literals (if any) directly follow the uniform run.
        if i < len(runs) and runs[i][2] == 0:
            ls, le, _ = runs[i]
            i += 1
        else:
            ls = le = 0
        # A marker's run length is capped; emit as many markers as needed.
        while count > int(_COUNT_MASK):
            out.append(np.array(
                [uniform_bit | (int(_COUNT_MASK) << 1)], dtype="<u8"
            ))
            count -= int(_COUNT_MASK)
        n_lit = le - ls
        marker = np.uint64(uniform_bit) | (np.uint64(count) << _UNIFORM_SHIFT) | (
            np.uint64(n_lit) << _LITERAL_SHIFT
        )
        out.append(np.array([marker], dtype="<u8"))
        if n_lit:
            out.append(words[ls:le])
    return np.concatenate(out).tobytes()


def decode(data: bytes, n_words: int) -> np.ndarray:
    """Decompress into exactly n_words u64 words."""
    stream = np.frombuffer(data, dtype="<u8")
    out = np.zeros(n_words, dtype="<u8")
    pos = 0  # in stream
    w = 0  # in out
    while pos < len(stream):
        marker = int(stream[pos])
        pos += 1
        uniform_bit = marker & 1
        n_uniform = (marker >> 1) & int(_COUNT_MASK)
        n_literal = marker >> 32
        if n_uniform:
            if uniform_bit:
                out[w : w + n_uniform] = _ALL_ONES
            w += n_uniform
        if n_literal:
            out[w : w + n_literal] = stream[pos : pos + n_literal]
            pos += n_literal
            w += n_literal
    assert w == n_words, f"ewah stream decoded {w} words, expected {n_words}"
    return out
