"""Per-kernel call-shape registry (slim copy of the reference package's
devicestats.py: the two calls the state machine makes).

`note_call` records the argument shapes of each kernel-entry call while
the tracer is enabled; `retire_bucket` drops the rows of a scratch-ring
bucket the workload stopped using, so the registry stays bounded. The
reference's compiler cost model has no counterpart here. `cost` gives
the least work of a store-stage, query-path, compaction or mesh-commit
entry from its arguments (the single-device commit kernels' costs are
stated beside them in chip_smoke.py).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from tigerbeetle_tpu_torch import tracer

_lock = threading.Lock()
_shapes: Dict[str, Dict[str, Optional[int]]] = {}
_SHAPES_PER_ENTRY_MAX = 16  # bucket shapes are power-of-two padded: few


def _spec_key(args) -> str:
    """"8192x4:torch.uint32|8192:torch.int32"-style key over the array
    leaves of the arguments (NamedTuples and sequences recurse)."""
    parts = []

    def walk(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            parts.append("x".join(str(int(d)) for d in x.shape) + f":{x.dtype}")
        elif isinstance(x, (tuple, list)):
            for f in x:
                walk(f)
        else:
            parts.append(f"={x!r}")

    walk(args)
    return "|".join(parts)


def note_call(entry: str, args: tuple, bucket: Optional[int] = None) -> None:
    """Record one kernel-entry call's argument shapes (metadata reads
    only — never a device sync). `bucket` tags the row with its
    scratch-ring pad size."""
    if not tracer.enabled():
        return
    key = _spec_key(args)
    with _lock:
        rows = _shapes.setdefault(entry, {})
        if key in rows or len(rows) < _SHAPES_PER_ENTRY_MAX:
            rows[key] = bucket


def reset() -> None:
    """Forget every recorded shape (a run that reads the shapes of one
    window calls it first)."""
    with _lock:
        _shapes.clear()


def retire_bucket(bucket: int) -> None:
    """Drop every shape row tagged with a retired scratch-ring bucket."""
    with _lock:
        for entry, rows in list(_shapes.items()):
            for k in [k for k, b in rows.items() if b == bucket]:
                del rows[k]
            if not rows:
                del _shapes[entry]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _log2(n: int) -> int:
    return max(int(n), 1).bit_length()


# entry -> (its call's arguments -> (bytes, integer operations)): the
# bytes the function must move (each input read once, each output written
# once) and a count of its integer operations, from the shapes alone.
COSTS = {
    # cols, ts, rows, pad in; keys and payload (5 n, 3) u32 out; ~40
    # operations a record.
    "query_index_keys": lambda cols, ts, rows, pad: (
        _nbytes(cols, ts, rows, pad) + 2 * 5 * rows.numel() * 12,
        40 * rows.numel(),
    ),
    # the same bytes; a stable sort of 5 n rows of the function, whatever
    # the design: ~4 operations a row (a 96-bit compare and a move) for
    # each of log2(n) merge levels.
    "query_index_keys_sorted": lambda cols, ts, rows, pad: (
        _nbytes(cols, ts, rows, pad) + 2 * 5 * rows.numel() * 12,
        40 * rows.numel() + 4 * 5 * rows.numel() * max(1, (rows.numel() - 1).bit_length()),
    ),
    # both runs in, their merge out; ~8 operations a key compare, and
    # about five compares a row: its merge step, its share of a thread's
    # merge-path search in shared memory (9 steps for 3 rows) and of the
    # tile's two co-rank searches (3 rounds of up to 64 probes for 384 rows).
    "merge_kernel_tiled": lambda ka, pa, kb, pb: (
        2 * _nbytes(ka, pa, kb, pb),
        (ka.shape[0] + kb.shape[0]) * 8 * 5,
    ),
    # both runs in, their merge out; a binary search over the other run
    # per row.
    "merge_kernel": lambda ka, pa, kb, pb: (
        2 * _nbytes(ka, pa, kb, pb),
        (ka.shape[0] + kb.shape[0]) * 8 * _log2(max(ka.shape[0], kb.shape[0])),
    ),
    # the stack in, its merge out; a merge step a row at each of the
    # log2(k) levels of the in-tile tree, and a binary search over a run
    # for each of the k - 1 other runs of each sample (one row in
    # min(b, 8192 / k)).
    "compact_fold_kernel": lambda keys, pays: (
        2 * _nbytes(keys, pays),
        keys.shape[0] * keys.shape[1] * (_log2(keys.shape[0]) - 1) * 8
        + keys.shape[0] * keys.shape[1] // min(keys.shape[1], max(1, 8192 // keys.shape[0]))
        * (keys.shape[0] - 1) * 8 * _log2(keys.shape[1]),
    ),
    # both arrays in, one byte a candidate out; a binary search each.
    "scan_intersect_mask": lambda cand, run: (
        _nbytes(cand, run) + cand.numel(),
        cand.numel() * 4 * _log2(run.numel()),
    ),
    # parallel/sharding.py, the commit over a device mesh. The k events
    # [lo, lo + k) (ten fields and the host code: one dp slice, or the
    # slices one card validates) and two ledger words an event in, a code
    # and a routing byte an event out; ~60 operations an event.
    "sharded_validate": lambda state, b, host_code, lo, k: (
        (sum(_nbytes(x) // x.shape[0] for x in (*b, host_code)) + 8 + 5) * k,
        60 * k,
    ),
    # the shard's four tables in and out, the events' slots, amounts,
    # masks (and removal amounts) in; ~24 operations a row, ~80 an event.
    "sharded_apply": lambda state, dr, cr, amount, p_amount, mask, base: (
        2 * _nbytes(*state[:4]) + _nbytes(dr, cr, amount, mask)
        + (0 if p_amount is None else _nbytes(p_amount)) + 1,
        24 * state[0].shape[0] + 80 * dr.shape[0],
    ),
    # every shard's four tables in and out, the events once (every shard of
    # a launch reads one copy); the operations of sharded_apply a shard.
    "sharded_apply_grouped": lambda states, bases, dr, cr, amount, p_amount, mask: (
        sum(2 * _nbytes(*st[:4]) for st in states) + _nbytes(dr, cr, amount, mask)
        + (0 if p_amount is None else _nbytes(p_amount)) + 1,
        len(states) * (24 * states[0][0].shape[0] + 80 * dr.shape[0]),
    ),
    # the slots in, four (k, 4) blocks out, and the rows the shard owns
    # read once (`owned` of them where the caller counted them, else k).
    "sharded_read": lambda state, slots, base, a, owned=None: (
        _nbytes(slots) + 64 * slots.shape[0] + 64 * (slots.shape[0] if owned is None else owned),
        8 * slots.shape[0],
    ),
    # the slots in, four (k, 4) blocks out, and the rows the launch's
    # shards own read once (`owned` of them where the caller counted
    # them, else k: every row of a dp row has its owner among them).
    "sharded_read_grouped": lambda states, bases, slots, a, owned=None: (
        _nbytes(slots) + 64 * slots.shape[0] + 64 * (slots.shape[0] if owned is None else owned),
        8 * slots.shape[0],
    ),
}
COSTS["sharded_validate_grouped"] = COSTS["sharded_validate"]


def cost(entry: str, args: tuple):
    """(bytes, integer operations) of one call of `entry` on `args`."""
    return COSTS[entry](*args)


def observed_shapes() -> Dict[str, list]:
    with _lock:
        return {e: sorted(rows) for e, rows in _shapes.items()}

