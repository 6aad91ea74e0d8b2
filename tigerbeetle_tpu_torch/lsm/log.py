"""Durable append-only object log over grid blocks.

The transfer object store (reference groove.zig object tree keyed by
timestamp). Commit order IS key order — transfer timestamps increase
monotonically with row — so the "tree" degenerates into an append-only
sequence of full data blocks plus an in-RAM tail: no sorting, no
compaction, O(1) appends, exact row → block addressing. Point reads gather
whole blocks through the grid LRU; range scans iterate block windows
(bounded memory — no full-log `scan()` on the hot
path and survives only as `export_all()` for state-sync snapshots).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from tigerbeetle_tpu_torch.io.grid import Grid

BLOCK_TYPE_LOG = 3


class DurableLog:
    """Append-only structured-record log: RAM = one tail block + LRU cache."""

    def __init__(self, grid: Grid, dtype: np.dtype) -> None:
        self.grid = grid
        self.dtype = dtype
        self.records_per_block = grid.payload_max // dtype.itemsize
        assert self.records_per_block > 0
        self.blocks: List[int] = []  # flushed blocks, in row order
        # Full blocks not yet written to the grid: commit appends are pure
        # RAM; grid IO happens on the compaction beat (flush_pending) or at
        # checkpoint — the reference's object tree likewise defers block
        # writes to compaction (groove.zig), keeping the commit path free
        # of storage calls.
        self._pending_blocks: List[np.ndarray] = []
        self._tail = np.zeros(self.records_per_block, dtype=dtype)
        self._tail_len = 0
        self.count = 0

    # --- write ----------------------------------------------------------

    def append_batch(self, records: np.ndarray, ts=None) -> np.ndarray:
        """Append (k,) records; returns their row indices (u32). RAM-only:
        call flush_pending() from the beat (or checkpoint) to emit blocks.
        `ts` optionally overrides the timestamp column during the copy, so
        callers need not pre-copy their arrays just to stamp them."""
        k = len(records)
        rows = np.arange(self.count, self.count + k, dtype=np.uint32)
        self.count += k
        off = 0
        rpb = self.records_per_block
        while off < k:
            take = min(k - off, rpb - self._tail_len)
            dst = slice(self._tail_len, self._tail_len + take)
            self._tail[dst] = records[off : off + take]
            if ts is not None:
                self._tail["timestamp"][dst] = ts[off : off + take]
            self._tail_len += take
            off += take
            if self._tail_len == rpb:
                # Move, don't copy: the full tail becomes the pending block
                # and a fresh (uninitialized — only [:tail_len] is ever
                # read) buffer takes its place.
                self._pending_blocks.append(self._tail)
                self._tail = np.empty(rpb, dtype=self.dtype)
                self._tail_len = 0
        return rows

    def flush_pending(self, max_blocks: int | None = None) -> int:
        """Write up to `max_blocks` pending full blocks to the grid (all of
        them when None). Returns how many remain pending."""
        n = len(self._pending_blocks) if max_blocks is None else min(
            max_blocks, len(self._pending_blocks)
        )
        for i in range(n):
            block = self.grid.write_block(
                self._pending_blocks[i].tobytes(), BLOCK_TYPE_LOG
            )
            self.blocks.append(block)
        del self._pending_blocks[:n]
        return len(self._pending_blocks)

    # --- read -----------------------------------------------------------

    def _read_block(self, b: int) -> np.ndarray:
        if b < len(self.blocks):
            payload = self.grid.read_block(self.blocks[b])
            return np.frombuffer(payload, dtype=self.dtype)
        return self._pending_blocks[b - len(self.blocks)]

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Rows → records, preserving the order of `rows`."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros(len(rows), dtype=self.dtype)
        if len(rows) == 0:
            return out
        rpb = self.records_per_block
        blk = rows // rpb
        off = rows % rpb
        tail_base = len(self.blocks) + len(self._pending_blocks)
        # Group rows by block with one sort instead of one full-array
        # mask per touched block (scan candidates touch most blocks, so
        # the masks were O(blocks x rows)). Scan/intersect callers pass
        # ascending rows, making the sort a no-op check.
        if len(rows) > 1 and bool(np.any(blk[1:] < blk[:-1])):
            order = np.argsort(blk, kind="stable")
            blk, off = blk[order], off[order]
        else:
            order = None
        bounds = np.flatnonzero(np.r_[True, blk[1:] != blk[:-1], True])
        for i in range(len(bounds) - 1):
            s, e = int(bounds[i]), int(bounds[i + 1])
            b = int(blk[s])
            if b >= tail_base:
                tail_off = off[s:e]
                assert (tail_off < self._tail_len).all()
                got = self._tail[tail_off]
            else:
                got = self._read_block(b)[off[s:e]]
            if order is None:
                out[s:e] = got
            else:
                out[order[s:e]] = got
        return out

    def resident_fraction(self) -> float:
        """Fraction of this log's flushed blocks whose payload is
        resident in the grid's LRU (pending blocks and the tail are RAM
        by construction). The scan planner's fetch-cost signal: gathering
        a row from a resident block costs ~a few index-entry walks, from
        a cold block ~3 orders of magnitude more (storage read + checksum
        verify), which decides whether probing a coarse index to shrink
        the gather pays for itself."""
        if not self.blocks:
            return 1.0
        hot = sum(1 for b in self.blocks if self.grid.cache_contains(b))
        return hot / len(self.blocks)

    def scan_range(self, row_start: int, row_end: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (base_row, records) windows covering [row_start, row_end)."""
        row_end = min(row_end, self.count)
        if row_start >= row_end:
            return
        rpb = self.records_per_block
        full = len(self.blocks) + len(self._pending_blocks)
        b0 = row_start // rpb
        b1 = (row_end - 1) // rpb
        for b in range(b0, b1 + 1):
            base = b * rpb
            if b < full:
                recs = self._read_block(b)
            else:
                recs = self._tail[: self._tail_len]
            lo = max(row_start - base, 0)
            hi = min(row_end - base, len(recs))
            if hi > lo:
                yield base + lo, recs[lo:hi]

    def export_all(self) -> np.ndarray:
        """Whole-log materialization — test/tooling helper only (state
        sync is block-level). Not part of the query path."""
        parts = [recs for _, recs in self.scan_range(0, self.count)]
        if not parts:
            return np.zeros(0, dtype=self.dtype)
        return np.concatenate(parts)

    # --- checkpoint -----------------------------------------------------

    def checkpoint(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block index array u32, tail records) for the snapshot blob.
        Flushes every pending block first — checkpoint state references
        grid blocks, not RAM."""
        self.flush_pending()
        return (
            np.array(self.blocks, dtype=np.uint32),
            self._tail[: self._tail_len].copy(),
        )

    def restore(self, blocks: np.ndarray, tail: np.ndarray) -> None:
        self.blocks = [int(b) for b in blocks]
        self._pending_blocks = []
        self._tail_len = len(tail)
        self._tail[: self._tail_len] = tail
        self.count = len(self.blocks) * self.records_per_block + self._tail_len
