"""Durable grooves: typed object stores over the grid-backed LSM tier.

The reference keeps EVERY state-machine collection in a groove (object
tree + indexes, upstream src/lsm/groove.zig:138; the state machine
declares four — accounts, transfers, posted, account_history,
state_machine.zig:167-303). This build keeps accounts device/RAM-resident
(they are the flagship kernel's working set, bounded by accounts_max) and
transfers in DurableLog + DurableIndex; this module adds the remaining
two grooves so NO state grows unbounded in Python structures:

  PostedGroove   — pending-transfer fulfillment (timestamp -> posted/
                   voided), reference PostedGroove.
  HistoryGroove  — per-transfer balance snapshots of HISTORY-flagged
                   accounts (reference account_history groove +
                   AccountBalancesGrooveValue), append-only log + an
                   account-id secondary index for the
                   get_account_history scan.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tigerbeetle_tpu_torch.lsm.log import DurableLog
from tigerbeetle_tpu_torch.lsm.store import NOT_FOUND, pack_keys
from tigerbeetle_tpu_torch.lsm.tree import DurableIndex

# One history row: the post-event balances of the (up to two)
# HISTORY-flagged accounts a transfer touched; u128 balances as u64 pairs.
# Identical field meaning to vsr/snapshot.HISTORY_DTYPE, but
# account ids are split (lo, hi) for vectorized index staging.
HISTORY_DTYPE = np.dtype(
    [("timestamp", "<u8")]
    + [
        (f"{side}_{field}_{half}", "<u8")
        for side in ("dr", "cr")
        for field in (
            "account_id",
            "debits_pending", "debits_posted",
            "credits_pending", "credits_posted",
        )
        for half in ("lo", "hi")
    ]
)


class PostedGroove:
    """timestamp -> fulfillment (u8) as a unique durable index.

    Entries are insert-once by contract (a pending transfer is fulfilled
    at most once; already-posted/voided rejection precedes any re-insert),
    which is exactly DurableIndex's unique-key contract. RAM cost is the
    memtable plus table metadata — bounded, unlike a plain dict that
    grew with every two-phase transfer ever committed.
    """

    def __init__(self, grid, *, memtable_max: int = 1 << 14,
                 device=None) -> None:
        self.index = DurableIndex(
            grid, unique=True, memtable_max=memtable_max, device=device
        )

    @property
    def count(self) -> int:
        return self.index.count

    @staticmethod
    def _keys(ts: np.ndarray) -> np.ndarray:
        return pack_keys(
            np.asarray(ts, dtype=np.uint64),
            np.zeros(len(ts), dtype=np.uint64),
        )

    def get_many(self, ts: np.ndarray, default: int) -> np.ndarray:
        """(k,) pending timestamps -> (k,) i32 fulfillment (default where
        absent)."""
        if len(ts) == 0:
            return np.zeros(0, dtype=np.int32)
        vals = self.index.lookup_batch(self._keys(ts))
        return np.where(
            vals == NOT_FOUND, np.int32(default), vals.astype(np.int32)
        )

    def get(self, ts: int, default=None):
        v = self.index.lookup_batch(self._keys(np.array([ts], dtype=np.uint64)))[0]
        return default if v == NOT_FOUND else int(v)

    def contains(self, ts: int) -> bool:
        return self.get(ts) is not None

    def insert_many(self, items: Dict[int, int]) -> None:
        if not items:
            return
        ts = np.fromiter(items.keys(), dtype=np.uint64, count=len(items))
        vals = np.fromiter(items.values(), dtype=np.uint32, count=len(items))
        self.index.insert_batch(self._keys(ts), vals)

    def insert_arrays(self, ts: np.ndarray, vals: np.ndarray) -> None:
        if len(ts):
            self.index.insert_batch(
                self._keys(ts), np.asarray(vals, dtype=np.uint32)
            )

    def compact_step(self, quota_entries: int) -> None:
        self.index.compact_step(quota_entries)

    def compact_backlog(self) -> int:
        return self.index.compact_backlog()

    def request_major(self) -> int:
        return self.index.request_major()

    def storm_active(self) -> bool:
        return self.index.storm_active()

    def compact_prefetch_one(self) -> bool:
        return self.index.compact_prefetch_one()


class _PostedView:
    """Per-batch dict-facade over a PostedGroove for the serial oracle:
    writes land in an overlay (so linked-chain rollback can delete them),
    reads fall through to the groove. `drain()` commits the overlay."""

    def __init__(self, groove: PostedGroove) -> None:
        self._g = groove
        self.new: Dict[int, int] = {}

    def get(self, k, default=None):
        if k in self.new:
            return self.new[k]
        return self._g.get(k, default)

    def __contains__(self, k) -> bool:
        return k in self.new or self._g.contains(k)

    def __setitem__(self, k, v) -> None:
        self.new[k] = v

    def __delitem__(self, k) -> None:
        # Only same-batch inserts are ever rolled back (oracle undo log).
        del self.new[k]

    def drain(self) -> None:
        self._g.insert_many(self.new)
        self.new = {}


class HistoryGroove:
    """Append-only HISTORY_DTYPE rows + account-id secondary index.

    The get_account_history scan is an index range-read + log gather —
    O(account's rows), vectorized — instead of a host oracle
    join over a Python list.
    """

    def __init__(self, grid, *, memtable_max: int = 1 << 14,
                 device=None) -> None:
        self.log = DurableLog(grid, HISTORY_DTYPE)
        self.rows = DurableIndex(
            grid, unique=False, memtable_max=memtable_max, device=device
        )

    @property
    def count(self) -> int:
        return self.log.count

    def append_batch(self, recs: np.ndarray) -> None:
        """Append history rows; index each present side's account id —
        ONE coalesced unsorted insert for both sides (the index is
        non-unique and account_rows() sorts values at read time, so the
        per-commit sort the old two insert_batch calls paid bought
        nothing)."""
        if len(recs) == 0:
            return
        row_ids = self.log.append_batch(recs)
        parts_k, parts_v = [], []
        for side in ("dr", "cr"):
            lo = recs[f"{side}_account_id_lo"]
            hi = recs[f"{side}_account_id_hi"]
            present = (lo != 0) | (hi != 0)
            if present.any():
                parts_k.append(pack_keys(lo[present], hi[present]))
                parts_v.append(row_ids[present])
        if parts_k:
            self.rows.insert_unsorted(
                np.concatenate(parts_k), np.concatenate(parts_v)
            )

    def account_rows(self, account_id: int) -> np.ndarray:
        """All history rows touching the account, ascending timestamp
        (row order IS timestamp order — commit order)."""
        U64 = (1 << 64) - 1
        key = pack_keys(
            np.array([account_id & U64], dtype=np.uint64),
            np.array([account_id >> 64], dtype=np.uint64),
        )[0]
        rows = self.rows.lookup_range(key)
        return self.log.gather(rows)

    def compact_step(self, quota_entries: int) -> None:
        self.rows.compact_step(quota_entries)

    def compact_backlog(self) -> int:
        return self.rows.compact_backlog()

    def request_major(self) -> int:
        return self.rows.request_major()

    def storm_active(self) -> bool:
        return self.rows.storm_active()

    def compact_prefetch_one(self) -> bool:
        return self.rows.compact_prefetch_one()

    def flush_pending(self, max_blocks: int) -> None:
        self.log.flush_pending(max_blocks)
