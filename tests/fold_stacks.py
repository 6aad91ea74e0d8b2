"""Compaction-fold stacks and tiled-merge pairs made with numpy from a
seed, shared by the CPU parity tests (tests/test_torch_compaction.py,
tests/test_torch_merge.py), the card's tests (tests/test_torch_cuda.py)
and chip_smoke.py. numpy only: no JAX, no torch.

`stack(rng, k, b, case)` gives (keys (k, b, 3), payloads (k, b, 3))
uint32: k sorted runs in the merge's run format ([lo0, lo1, pad], pad rows
[0, 0, 1] last), stacked oldest first, of the inputs a k-way merge is
likely to get wrong (CASES):

  - "uneven": real lengths from 0 to b, random 64-bit lo words;
  - "equal": every real row of every run has the same key, so the order
    is the runs' order alone;
  - "top": lo words >= 2^63 with duplicates within and across runs, one
    lo of all ones (it sorts before the pad rows);
  - "all_pad": every other run holds pad rows only.

`merge_pair(rng, case, n, m)` gives the tiled merge's edge inputs, two
sorted runs, for each (case, n, m, tile) of MERGE_EDGES.
"""

import numpy as np

CASES = ("uneven", "equal", "top", "all_pad")


def stack(rng, k, b, case):
    keys = np.zeros((k, b, 3), np.uint32)
    keys[:, :, 2] = 1
    for i in range(k):
        n = b if i == k // 2 else int(rng.integers(0, b + 1))
        if case == "all_pad" and i % 2:
            n = 0
        if case == "equal":
            lo = np.full(n, (1 << 63) | 12345, np.uint64)
        elif case == "top":
            lo = rng.integers(0, 40, n, dtype=np.uint64) | np.uint64(1 << 63)
        else:
            lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        lo = np.sort(lo)
        if case == "top" and n:
            lo[-1] = np.uint64((1 << 64) - 1)
        keys[i, :n, 0] = lo & np.uint64(0xFFFFFFFF)
        keys[i, :n, 1] = lo >> np.uint64(32)
        keys[i, :n, 2] = 0
    pays = rng.integers(0, 1 << 32, (k, b, 3), dtype=np.uint64).astype(np.uint32)
    return keys, pays


# --- the tiled merge's edge inputs -----------------------------------------

# (case, n, m, tile) of `merge_pair`: two sorted runs of n and m rows, n and
# m multiples of the wrapper's `tile`, chosen against the tiled merge
# (csrc/merge_kernel_tiled.cu picks its own tile of a few hundred rows):
#
#   - "a_empty" / "b_empty": one run has no row;
#   - "uneven": odd numbers of 64-row tiles, random keys with duplicates,
#     n + m not a multiple of the kernel's tile;
#   - "equal": every row of both runs holds one key (A's rows come first),
#     over several of the kernel's tiles;
#   - "ones_pad": lo words of all ones, then pad rows [0, 0, 1], in both;
#   - "a_below" / "b_below": every row of one run below every row of the
#     other;
#   - "unaligned": A holds the multiples of 3 and B the rest, so the
#     outputs before row d take ceil(d / 3) rows of A and a tile's spans
#     start off 16-byte boundaries (12 a0 bytes);
#   - "tile1": the wrapper's tile 1, runs of 7 and 3 rows.
MERGE_EDGES = (
    ("a_empty", 0, 640, 64), ("b_empty", 704, 0, 64), ("uneven", 576, 320, 64),
    ("uneven", 64 * 13, 64 * 7, 64), ("equal", 1280, 704, 64), ("ones_pad", 512, 768, 256),
    ("a_below", 768, 1024, 256), ("b_below", 768, 1024, 256), ("unaligned", 448, 896, 64),
    ("tile1", 7, 3, 1),
)


def _lo_run(lo):
    """Run-format keys (len(lo), 3) of sorted uint64 lo words."""
    keys = np.zeros((len(lo), 3), np.uint32)
    keys[:, 0] = lo & np.uint64(0xFFFFFFFF)
    keys[:, 1] = lo >> np.uint64(32)
    return keys


def merge_pair(rng, case, n, m):
    """(keys_a (n, 3), pays_a (n, 3), keys_b (m, 3), pays_b (m, 3)) uint32,
    each run sorted in the merge's order; see MERGE_EDGES."""
    def draw(k, space, base=0):
        return np.sort(rng.integers(0, space, k, dtype=np.uint64) + np.uint64(base))

    if case == "equal":
        lo_a = np.full(n, (1 << 63) | 77, np.uint64)
        lo_b = np.full(m, (1 << 63) | 77, np.uint64)
    elif case == "a_below":
        lo_a, lo_b = draw(n, 1 << 40), draw(m, 1 << 40, 1 << 41)
    elif case == "b_below":
        lo_a, lo_b = draw(n, 1 << 40, 1 << 41), draw(m, 1 << 40)
    elif case == "unaligned":
        assert 2 * n == m, "B holds the two non-multiples of 3 between A's rows"
        lo_a = np.arange(n, dtype=np.uint64) * np.uint64(3)
        lo_b = np.array([v for v in range(3 * n) if v % 3], np.uint64)
    else:  # duplicates within and across the runs, top-bit lo words
        lo_a = draw(n, 64) | np.uint64(1 << 63)
        lo_b = draw(m, 64) | np.uint64(1 << 63)
    ka, kb = _lo_run(lo_a), _lo_run(lo_b)
    if case == "ones_pad":
        for keys in (ka, kb):
            keys[-keys.shape[0] // 4:] = [0, 0, 1]
            keys[-keys.shape[0] // 4 - 5:-keys.shape[0] // 4, :2] = 0xFFFFFFFF
    pay = lambda k: rng.integers(0, 1 << 32, (k, 3), dtype=np.uint64).astype(np.uint32)
    return ka, pay(n), kb, pay(m)
