"""Inputs of the sorted-set membership kernel (ops/scanops.py
scan_intersect_mask): its edge cases and the query path's shapes.

No jax: the CPU tests hold the plain version against the reference
package on them, the card tests and chip_smoke.py hold the kernel
against the plain version, and tools/torch_kernel_ab.py times the query
shapes.
"""

import numpy as np

PAD = np.uint32(0xFFFFFFFF)

# (nc, nr) of phase 7's 29 launches (chip_smoke.py's query traffic, 64
# batches, the 16 materialized filters): the first list is an account's
# rows over all time, padded to a power of two; the run a code's or the
# ledger's rows inside one 1/8 time window.
QUERY_SHAPES = [(256, 4096), (256, 65536), (8192, 65536), (8192, 262144)]

EDGES = ["nr=1", "nc>nr", "all pads", "top-bit rows", "all below", "all above",
         "tile-edge ties", "256 in 2^16", "dense tiles past their span"]


def pad(a: np.ndarray, n: int) -> np.ndarray:
    """An ascending uint32 array padded with 0xFFFFFFFF to length n."""
    out = np.full(n, PAD, dtype=np.uint32)
    out[:len(a)] = a
    return out


def _rows(rng, n, lo=0, hi=(1 << 32) - 1) -> np.ndarray:
    return np.unique(rng.integers(lo, hi, n, dtype=np.uint64)).astype(np.uint32)


def query_shape(rng, nc: int, nr: int):
    """(cand, run) padded to (nc, nr) as the query path gives them: the run
    is three quarters of nr rows from a window of twice as many, the
    candidates three quarters of nc rows of a 2^20-row timeline, half of
    them drawn from the run."""
    k = 3 * nr // 4
    w0 = int(rng.integers(0, (1 << 20) - 2 * k))
    run = _rows(rng, k, w0, w0 + 2 * k)
    m = 3 * nc // 4
    cand = np.unique(np.concatenate([rng.choice(run, m // 2), _rows(rng, m - m // 2, 0, 1 << 20)]))
    return pad(cand, nc), pad(run, nr)


def edge(rng, case: str):
    """(cand, run) of one EDGES case, both ascending uint32."""
    if case == "nr=1":  # one run row; candidates below, at and above it
        return np.array([0, 4, 5, 6, PAD], np.uint32), np.array([5], np.uint32)
    if case == "nc>nr":  # the wrapper does not need cand to be the shorter
        run = _rows(rng, 3000)
        return pad(np.unique(np.concatenate([run[::3], _rows(rng, 4000)])), 8192), pad(run, 4096)
    if case == "all pads":  # pads meet pads
        return np.full(256, PAD, np.uint32), pad(_rows(rng, 100), 128)
    if case == "top-bit rows":  # an int32 view would order these as negative
        run = _rows(rng, 3000, 1 << 31)
        cand = np.unique(np.concatenate([rng.choice(run, 400), _rows(rng, 400, (1 << 31) - 1000)]))
        return pad(cand, 1024), pad(run, 4096)
    if case == "all below":
        return pad(_rows(rng, 200, 0, 999), 256), pad(_rows(rng, 1000, 1000, 9000), 1024)
    if case == "all above":  # above every real row, below the pads
        return pad(_rows(rng, 200, 20_000, 30_000), 256), pad(_rows(rng, 1000, 1000, 9000), 1024)
    if case == "tile-edge ties":
        # Candidates equal to every 32nd row (so to every splitter: the
        # sample here takes every 128th) and to the rows beside them, and
        # a run of pads that crosses many candidate tiles.
        run = np.arange(0, 3 * 60_000, 3, dtype=np.uint32)
        cand = np.unique(np.concatenate([run[::32], run[31::32], run[33::32], run[::32] + 1]))
        return pad(cand, 16_384), pad(run, 65_536)
    if case == "256 in 2^16":
        return query_shape(rng, 256, 1 << 16)
    if case == "dense tiles past their span":
        # A dense list (2^16 candidates in 2^19 rows) whose tiles near its
        # end span far more rows than a tile stages: they search the span
        # in global memory.
        run = np.arange(0, 1 << 20, 2, dtype=np.uint32)
        cand = np.unique(np.concatenate([_rows(rng, 70_000, 0, 1 << 17), _rows(rng, 900, 1 << 17, 1 << 20)]))
        return pad(cand[-(1 << 16):], 1 << 16), run
    raise ValueError(case)
