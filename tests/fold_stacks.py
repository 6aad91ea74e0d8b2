"""Compaction-fold stacks made with numpy from a seed, shared by the CPU
parity tests (tests/test_torch_compaction.py), the card's tests
(tests/test_torch_cuda.py) and chip_smoke.py. numpy only: no JAX, no
torch.

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
