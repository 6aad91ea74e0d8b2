"""Durable LSM index: sorted table files on grid blocks.

The device-first re-design of the reference's tree/table/compaction stack
(upstream src/lsm/tree.zig, table.zig:43-60, compaction.zig:280):

  - A *table* is one index block + N data blocks of sorted (u128 key, u32
    value) entries, all checksummed grid blocks (io/grid.py). The index
    block holds per-data-block key fences — the analog of table.zig's index
    block — so point lookups read exactly one data block.
  - The *memtable* is unsorted appended batches (vectorized inserts only,
    matching the prefetch-batch design, groove.zig:644-909); it flushes as a
    sorted level-0 table. The query index's batches may be lazy device
    runs (ops/qindex.QueryKeyRun): a flush of sorted runs no read has
    materialized folds them on the device (ops/merge.merge_kernel_tiled);
    any other flush or read materializes them first.
  - Compaction (the reference's leveled k-way merge, driven by the
    replica's per-op beat) is not part of this port yet: flushed tables
    stay in level 0, and reads walk them newest first.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.io.grid import Grid
from tigerbeetle_tpu_torch.lsm.store import (
    KEY_DTYPE,
    NOT_FOUND,
    Bloom,
    merge_host_kway,
    search_run,
    sort_kv,
    sort_lo_major,
)

ENTRY_SIZE = KEY_DTYPE.itemsize + 4  # key + u32 value
U64_MAX = (1 << 64) - 1


def _mark_seg(cand: np.ndarray, seg: np.ndarray, hit: np.ndarray) -> int:
    """Mark hit[i] = 1 for every ascending cand[i] present in seg;
    returns the newly marked count (marks accumulate across segments).
    Ascending segments — the flush-fresh common case, commit order IS
    row order — take the C gallop. Segments a merge left non-ascending
    (tables are LO-major only; account_rows also interleaves
    debit-then-credit runs per commit) are marked with one vectorized
    searchsorted into cand instead of paying a per-segment sort."""
    from tigerbeetle_tpu_torch.lsm.store import gallop_mark_u32

    if len(cand) == 0 or len(seg) == 0:
        return 0
    if len(seg) == 1 or bool(np.all(seg[1:] >= seg[:-1])):
        return gallop_mark_u32(cand, seg, hit)
    pos = np.searchsorted(cand, seg)
    # A position of len(cand) means seg value > every candidate; clamp
    # to 0, which the equality re-check below rejects.
    pos[pos == len(cand)] = 0
    sel = cand[pos] == seg
    if not sel.any():
        return 0
    idx = pos[sel]
    before = int(np.count_nonzero(hit))
    hit[idx] = 1
    return int(np.count_nonzero(hit)) - before

# Per-data-block fence in the index block.
INDEX_ENTRY_DTYPE = np.dtype(
    [
        ("first_hi", "<u8"), ("first_lo", "<u8"),
        ("last_hi", "<u8"), ("last_lo", "<u8"),
        ("block", "<u4"),
        ("count", "<u4"),
    ]
)

BLOCK_TYPE_DATA = 1
BLOCK_TYPE_INDEX = 2

@dataclass(eq=False)  # identity equality: tables live in LRU lists
class TableInfo:
    """In-memory descriptor of one on-disk table (manifest.zig TableInfo)."""

    index_block: int
    count: int
    key_min: Tuple[int, int]  # (hi, lo)
    key_max: Tuple[int, int]

    # Decoded index entries, lazily cached (the index block itself also sits
    # in the grid's LRU, this just skips re-parsing).
    _fences: Optional[np.ndarray] = None
    # Per-run Bloom filter over the table's keys (~1 byte/entry, no false
    # negatives): point lookups skip this table entirely unless the bloom
    # flags a key — dup-checks and query reads stop probing cold runs.
    # Built LAZILY on the table's first probe (with the decoded mirror,
    # or one streaming pass for over-budget tables) so pure-ingest
    # workloads never pay the build; None means "probe normally".
    bloom: Optional[Bloom] = None
    # Whole-table decoded mirror (keys, vals), LRU-budgeted at the tree
    # (see DurableIndex._decode_table): tables are immutable, so a point
    # lookup becomes ONE vectorized search over the concatenated run
    # instead of a Python iteration per candidate block — the difference
    # between ~30 µs/block and ~0.2 µs/key on 8190-key batches (the
    # reference's set-associative value cache serves the same role,
    # set_associative_cache.zig:15).
    _decoded: Optional[Tuple[np.ndarray, np.ndarray]] = None


def _key_bloom(keys: np.ndarray) -> Bloom:
    """Per-run Bloom over a table's keys (RAM-only read acceleration —
    results are identical with or without it: no false negatives).
    Sized at ~16 bits/key (2 bytes RAM per table row): per-key FP ~1.6%,
    so an 8190-key miss batch probes a flagged table with ~130 keys
    instead of the whole batch."""
    b = Bloom(2 * len(keys))
    b.add(keys["lo"], keys["hi"])
    return b


class DurableIndex:
    """u128 → u32 index over grid-backed sorted tables.

    unique=True: keys inserted at most once (transfer id index); lookups
    return the value or NOT_FOUND. unique=False: duplicate keys allowed
    (secondary indexes, e.g. account → transfer row); `lookup_range` returns
    every value for a key range in insertion order (values are monotone per
    key because merges keep older runs first).
    """

    def __init__(
        self,
        grid: Grid,
        *,
        unique: bool = True,
        memtable_max: int = 1 << 16,
        growth: int = 8,
        name: Optional[str] = None,
        merge_hint: Optional[str] = None,
    ) -> None:
        self.grid = grid
        self.unique = unique
        # Metric identity: named trees publish tables-per-level gauges
        # (`lsm.<name>.tables_l<N>`); anonymous trees skip the gauges but
        # still feed the shared lsm.* counters.
        self.name = name
        self.memtable_max = memtable_max
        self.growth = growth
        # merge_hint="dups": the tree's keys are known low-cardinality
        # (secondary indexes over ledger/code-class fields), where the
        # galloping k-way merge block-copies duplicate runs (~30x the
        # radix) — route every sorted fold through it regardless of run
        # count. Without the hint the k-way merge is used only for ≤ 8
        # runs (head selection is linear in k; wide random merges lose
        # to one radix pass).
        self.merge_hint = merge_hint
        # Memtable batches: appended in the store context, read drain-free
        # from the commit thread under the flag-before-batch publish order
        # (_sort_mem_lazily) — never concurrently mutated from both.
        # A batch is a (keys, vals) tuple or a lazy device run.
        self._mem: list = []  # tidy: owner=commit|store
        # tidy: owner=commit|store — per-batch lo-major-sorted flag, published BEFORE its batch
        self._mem_sorted: List[bool] = []
        self._mem_count = 0  # tidy: owner=commit|store
        # levels[0] is newest-flush tables (append order = age order).
        # Flush/compaction publish-then-retire so drain-free readers never
        # miss entries; structural changes stay in the store context.
        self.levels: List[List[TableInfo]] = [[]]  # tidy: owner=commit|store
        self.count = 0  # tidy: owner=commit|store
        # Whole-table decoded-mirror LRU (see _decode_table). The lock
        # covers ONLY the LRU bookkeeping (list + row counter).
        self._decoded_lru: List[TableInfo] = []  # tidy: guarded-by=_lru_lock
        self._decoded_rows = 0  # tidy: guarded-by=_lru_lock
        self._lru_lock = threading.Lock()

    # --- geometry -------------------------------------------------------

    @property
    def entries_per_block(self) -> int:
        return (self.grid.payload_max - 16) // ENTRY_SIZE

    @property
    def fences_per_index(self) -> int:
        return (self.grid.payload_max - 16) // INDEX_ENTRY_DTYPE.itemsize

    # --- write path -----------------------------------------------------

    def insert_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        if len(keys) == 0:
            return
        keys = np.ascontiguousarray(keys)
        vals = np.asarray(values, dtype=np.uint32)
        # Sort each batch once at insert time so lookups never re-sort —
        # through the fused C sort+gather (one call instead of the
        # argsort + two fancy-index passes).
        self.insert_sorted(*sort_kv(keys, vals))

    def insert_sorted(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Append a batch already in lo-major stable order (the C staging
        path pre-sorts during extraction, hostops_build_sorted_kv).

        Flag-before-batch publish order: a concurrent drain-free reader
        (the transfer-id index dup-confirm on the commit thread) that
        observes the new batch also observes its sorted flag, so it
        never takes _sort_mem_lazily's mutation branch against a tree
        the store thread is appending to."""
        if len(keys) == 0:
            return
        self._mem_sorted.append(True)
        self._mem.append((keys, vals))
        self._mem_count += len(keys)
        self.count += len(keys)
        if self._mem_count >= self.memtable_max:
            self.flush_memtable()

    def insert_unsorted(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Append WITHOUT per-batch sorting — for write-heavy non-unique
        indexes whose reads either tolerate unsorted memtable batches
        (lookup_range scans them with a mask) or trigger the lazy sort in
        lookup_batch. The flush re-sorts the whole memtable anyway, so
        deferring drops one radix pass per commit off the hot path.
        (Never used for the drain-free-read transfer-id index, whose
        batches are all insert-time sorted.)"""
        if len(keys) == 0:
            return
        self._mem_sorted.append(False)
        self._mem.append((keys, vals))
        self._mem_count += len(keys)
        self.count += len(keys)
        if self._mem_count >= self.memtable_max:
            self.flush_memtable()

    def insert_run_lazy(self, run) -> None:
        """Append a dispatched device run (ops/qindex.QueryKeyRun): a handle
        whose keys stay on the device until `materialize()`, the
        split-phase write path of the device query index. The run counts
        toward the flush threshold at once (flush cadence, hence grid
        allocation order, is the host path's); its bytes are demanded only
        at a flush, a read or the idle prefetch. Only for trees read
        behind a store barrier (query_rows)."""
        if run.n == 0:
            return
        self._mem_sorted.append(run.sorted)
        self._mem.append(run)
        self._mem_count += run.n
        self.count += run.n
        if self._mem_count >= self.memtable_max:
            self.flush_memtable()

    def _resolve_mem(self) -> None:
        """Materialize any lazy device runs in place (tuples stay)."""
        mem = self._mem
        for i in range(len(mem)):
            if not isinstance(mem[i], tuple):
                mem[i] = mem[i].materialize()

    @staticmethod
    def _fold_runs(mem) -> bool:
        """Whether a flush folds `mem` on the device: every batch a lazy
        run, none materialized yet."""
        return bool(mem) and all(
            not isinstance(m, tuple) and not m.materialized for m in mem
        )

    def prefetch_lazy_one(self) -> bool:
        """Materialize ONE pending device run (oldest first), the store
        stage's idle poll: the device-to-host copy moves into idle gaps so
        the flush never waits on it. Content and flush timing are
        unchanged (materialize is idempotent); True while more remain.

        It pulls only where the flush's device fold will not run: while
        the fold is intact an early copy would waste the transfer and turn
        the fold into the host merge. Once a read barrier materialized any
        run (lookup_range -> _resolve_mem) the flush takes the host merge
        anyway, and pulling the rest forward is pure gain; barrier timing
        follows the op stream, so the routing stays deterministic."""
        pending = [
            m for m in self._mem
            if not isinstance(m, tuple) and not m.materialized
        ]
        if not pending or self._fold_runs(self._mem):
            return False
        pending[0].materialize()
        return len(pending) > 1

    def _sort_mem_lazily(self) -> None:
        """Point-lookup prerequisite: every memtable batch lo-major sorted
        (unsorted ones arrive via insert_unsorted). Operates on local
        snapshots, FLAGS FIRST: the writer publishes flag-before-batch
        (inserts) and clears mem-before-flags (flush), so a flags-then-mem
        read can never observe a batch without its flag — a tree whose
        batches are all insert-time sorted therefore never enters the
        mutation loop, and the drain-free concurrent reader cannot race
        the store thread's appends (unsorted-batch trees are only ever
        read behind a full store barrier)."""
        self._resolve_mem()  # no-op unless lazy device runs are present
        flags = self._mem_sorted
        mem = self._mem
        if len(flags) >= len(mem) and all(flags):
            return
        for i in range(len(mem)):
            if i >= len(flags) or not flags[i]:
                k, v = mem[i]
                order = sort_lo_major(k)
                mem[i] = (k[order], v[order])
        self._mem_sorted = [True] * len(mem)

    def flush_memtable(self) -> None:
        """Write the memtable as one sorted level-0 table (one table
        build, never a level fold)."""
        if self._mem_count == 0:
            return
        keys, vals = self._flush_sorted_kv()
        with self._flush_span("build"):
            table = self._build_table(keys, vals)
        self.levels[0].append(table)
        self._mem = []
        self._mem_sorted = []
        self._mem_count = 0
        tracer.count("lsm.memtable_flushes")
        self._publish_level_gauges()

    def _flush_span(self, phase: str):
        """Flush-phase span for named trees (`lsm.<name>.flush.<phase>`)
        — profile_e2e splits the query tree's store row on these."""
        if self.name is None or not tracer.enabled():
            return tracer.null_span()
        return tracer.span(f"lsm.{self.name}.flush.{phase}")

    def _flush_sorted_kv(self) -> Tuple[np.ndarray, np.ndarray]:
        """The memtable as ONE lo-major stable-sorted (keys, vals) run.

        Route by what the batches already are: when every batch is a
        sorted run, a stable k-way MERGE (oldest first — identical bytes
        to the radix sort of the concatenation, enforced by property
        tests) replaces the full re-sort; sorted device runs that no read
        has materialized fold through the tiled merge kernel on the device
        and come back only here, at the table-build boundary. Unsorted
        batches (insert_unsorted trees) keep the fused C radix path."""
        mem = self._mem
        flags = self._mem_sorted
        all_sorted = len(flags) >= len(mem) and all(flags)
        if all_sorted and len(mem) == 1:
            self._resolve_mem()
            return mem[0]
        if all_sorted and len(mem) > 1:
            if self._fold_runs(mem):
                return self._fold_on_device(mem)
            self._resolve_mem()
            if self.merge_hint == "dups" or len(mem) <= 8:
                with self._flush_span("merge"):
                    return merge_host_kway(
                        [k for k, _ in mem], [v for _, v in mem]
                    )
        self._resolve_mem()
        with self._flush_span("sort"):
            keys = np.concatenate([k for k, _ in self._mem])
            vals = np.concatenate([v for _, v in self._mem])
            return sort_kv(keys, vals)  # fused C sort+gather

    def _fold_on_device(self, runs) -> Tuple[np.ndarray, np.ndarray]:
        """The device fold of sorted lazy runs: pairwise tiled merges on
        the device, then the one sync (the sanctioned table-build
        boundary) that brings back the real rows."""
        from tigerbeetle_tpu_torch.ops import qindex

        with self._flush_span("merge"):
            t_disp = tracer.device_dispatch("merge_kernel_tiled")
            kd, pd, n_real = qindex.fold_runs_device(runs)
            keys, vals = qindex.materialize_fold(kd, pd, n_real)
            tracer.device_finish(
                "merge_kernel_tiled", t_disp,
                d2h_bytes=keys.nbytes + vals.nbytes,
            )
            # The fold consumed the runs on the device: close each run's
            # key-build window at this one sync.
            for r in runs:
                r.finish_dispatch()
        return keys, vals

    def _publish_level_gauges(self) -> None:
        if self.name is not None and tracer.enabled():
            for lvl, tables in enumerate(self.levels):
                tracer.gauge(f"lsm.{self.name}.tables_l{lvl}", len(tables))

    def _build_table(self, keys: np.ndarray, vals: np.ndarray) -> TableInfo:
        """Write sorted entries as data blocks + one index block."""
        epb = self.entries_per_block
        n = len(keys)
        assert n > 0
        n_blocks = -(-n // epb)
        assert n_blocks <= self.fences_per_index, "table exceeds one index block"
        fences = np.zeros(n_blocks, dtype=INDEX_ENTRY_DTYPE)
        for b in range(n_blocks):
            part_k = keys[b * epb : (b + 1) * epb]
            part_v = vals[b * epb : (b + 1) * epb]
            payload = (
                np.uint32(len(part_k)).tobytes()
                + b"\x00" * 12
                + part_k.tobytes()
                + part_v.tobytes()
            )
            block = self.grid.write_block(payload, BLOCK_TYPE_DATA)
            fences[b]["first_hi"], fences[b]["first_lo"] = part_k[0]["hi"], part_k[0]["lo"]
            fences[b]["last_hi"], fences[b]["last_lo"] = part_k[-1]["hi"], part_k[-1]["lo"]
            fences[b]["block"] = block
            fences[b]["count"] = len(part_k)
        index_payload = (
            np.uint32(n_blocks).tobytes()
            + np.uint32(0).tobytes()
            + np.uint64(n).tobytes()
            + fences.tobytes()
        )
        index_block = self.grid.write_block(index_payload, BLOCK_TYPE_INDEX)
        tracer.count("lsm.table_builds")
        return TableInfo(
            index_block=index_block,
            count=n,
            key_min=(int(keys[0]["hi"]), int(keys[0]["lo"])),
            key_max=(int(keys[-1]["hi"]), int(keys[-1]["lo"])),
            _fences=fences,
        )

    def _table_fences(self, table: TableInfo) -> np.ndarray:
        if table._fences is None:
            payload = self.grid.read_block(table.index_block)
            n_blocks = int(np.frombuffer(payload[:4], dtype="<u4")[0])
            table._fences = np.frombuffer(
                payload[16 : 16 + n_blocks * INDEX_ENTRY_DTYPE.itemsize],
                dtype=INDEX_ENTRY_DTYPE,
            )
        return table._fences

    def _read_data_block(self, block: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
        payload = self.grid.read_block(block)
        n = int(np.frombuffer(payload[:4], dtype="<u4")[0])
        assert n == count
        koff = 16
        voff = koff + n * KEY_DTYPE.itemsize
        keys = np.frombuffer(payload[koff:voff], dtype=KEY_DTYPE)
        vals = np.frombuffer(payload[voff : voff + n * 4], dtype=np.uint32)
        return keys, vals

    # --- read path ------------------------------------------------------

    def _tables_newest_first(self) -> List[TableInfo]:
        out: List[TableInfo] = []
        for level in self.levels:
            out.extend(reversed(level))
        return out

    # Whole-table decoded-mirror budget, shared across the tree (rows).
    # 8M rows ≈ 160 MB — the bottom level of a benchmark-scale store.
    DECODE_BUDGET_ROWS = 1 << 23
    # Only tables at least this large are worth mirroring; small level-0
    # tables churn too fast.
    DECODE_MIN_ROWS = 1 << 16

    def _decode_table(self, table: TableInfo) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Concatenated (keys, vals) mirror of an immutable table, LRU
        budgeted tree-wide. Block reads and the mirror build run outside
        the LRU lock; only the bookkeeping is serialized."""
        with self._lru_lock:
            decoded = table._decoded
            if decoded is not None:
                # LRU touch.
                try:
                    self._decoded_lru.remove(table)
                except ValueError:
                    pass
                self._decoded_lru.append(table)
                return decoded
        if table.count < self.DECODE_MIN_ROWS or table.count > self.DECODE_BUDGET_ROWS:
            return None
        parts_k, parts_v = [], []
        for f in self._table_fences(table):
            bk, bv = self._read_data_block(int(f["block"]), int(f["count"]))
            parts_k.append(bk)
            parts_v.append(bv)
        decoded = (np.concatenate(parts_k), np.concatenate(parts_v))
        # The mirror build is the first time the table's keys are in RAM
        # — bloom them now so later miss-heavy lookups can skip the run
        # without touching it at all.
        bloom = _key_bloom(decoded[0]) if table.bloom is None else None
        with self._lru_lock:
            if table._decoded is None:
                while (
                    self._decoded_rows + table.count > self.DECODE_BUDGET_ROWS
                    and self._decoded_lru
                ):
                    victim = self._decoded_lru.pop(0)
                    self._decoded_rows -= victim.count
                    victim._decoded = None
                table._decoded = decoded
                if bloom is not None and table.bloom is None:
                    table.bloom = bloom
                self._decoded_rows += table.count
                self._decoded_lru.append(table)
            return table._decoded

    def _stream_bloom(self, table: TableInfo) -> Bloom:
        """Bloom a table that exceeds the decode budget: one streaming
        pass over its data blocks (paid once, on first probe — from then
        on misses skip the table without IO)."""
        b = Bloom(2 * table.count)
        for f in self._table_fences(table):
            bk, _bv = self._read_data_block(int(f["block"]), int(f["count"]))
            b.add(bk["lo"], bk["hi"])
        table.bloom = b
        return b

    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        n = len(keys)
        out = np.full(n, NOT_FOUND, dtype=np.uint32)
        if n == 0:
            return out
        pending = np.ones(n, dtype=bool)
        # Memtable first (newest writes win for unique indexes); batches
        # are lo-major-sorted at insert time (or lazily, for the unsorted
        # write-heavy path).
        self._sort_mem_lazily()
        for mem_keys, mem_vals in reversed(self._mem):
            search_run(mem_keys, mem_vals, keys, out, pending)
        if not pending.any():
            return out
        for table in self._tables_newest_first():
            if not pending.any():
                break
            # Per-run bloom gate: probe the table only for keys it might
            # hold — a miss-heavy batch (dup-check of fresh ids) skips
            # cold runs without a single block read. Blooms materialize
            # on a run's FIRST probe (never during ingest): piggybacked
            # on the decoded mirror, or one streaming pass when the
            # table exceeds the mirror budget.
            bloom = table.bloom
            decoded = None
            if bloom is None and table.count >= self.DECODE_MIN_ROWS:
                decoded = self._decode_table(table)
                bloom = table.bloom  # built with the mirror (when installed)
                if decoded is None and bloom is None:
                    bloom = self._stream_bloom(table)
            if bloom is not None:
                traced = tracer.enabled()
                if traced:
                    tracer.count("lsm.bloom.probes", int(pending.sum()))
                flagged = pending & bloom.maybe(keys["lo"], keys["hi"])
                if not flagged.any():
                    continue
                # Compact to the flagged keys: the probe's searchsorted
                # passes then scale with the bloom hits (~1.6% FP), not
                # the whole batch.
                ix = np.nonzero(flagged)[0]
                sub_out = out[ix]
                sub_pending = np.ones(len(ix), dtype=bool)
                if decoded is None:
                    decoded = self._decode_table(table)
                if decoded is not None:
                    search_run(decoded[0], decoded[1], keys[ix], sub_out, sub_pending)
                else:
                    self._lookup_table(table, keys[ix], sub_out, sub_pending)
                resolved = ix[~sub_pending]
                if traced:
                    # A flagged key the table does not hold is a bloom
                    # false positive by definition (the filter is per-run).
                    tracer.count("lsm.bloom.passes", len(ix))
                    tracer.count("lsm.bloom.hits", len(resolved))
                    tracer.count(
                        "lsm.bloom.false_positives", len(ix) - len(resolved)
                    )
                out[resolved] = sub_out[~sub_pending]
                pending[resolved] = False
                continue
            if decoded is None:
                decoded = self._decode_table(table)
            if decoded is not None:
                search_run(decoded[0], decoded[1], keys, out, pending)
            else:
                self._lookup_table(table, keys, out, pending)
        return out

    def _lookup_table(self, table, keys, out, pending) -> None:
        fences = self._table_fences(table)
        # Candidate data block per key: first block whose last_lo >= lo.
        # A lo-tie run can span blocks, so walk forward while unresolved
        # keys still fall inside a block whose range covers their lo.
        n_blocks = len(fences)
        q_lo = keys["lo"]
        cand = np.searchsorted(fences["last_lo"], q_lo, side="left")
        active = pending.copy()
        off = 0
        while True:
            blk = cand + off
            in_range = active & (blk < n_blocks)
            if not in_range.any():
                break
            blkc = np.minimum(blk, n_blocks - 1)
            covered = in_range & (fences["first_lo"][blkc] <= q_lo)
            if not covered.any():
                break
            for b in np.unique(blkc[covered]):
                # Compact to this block's queries so search_run's passes
                # scale with the block's hits, not the whole batch.
                ix = np.nonzero(covered & (blkc == b))[0]
                bk, bv = self._read_data_block(
                    int(fences[b]["block"]), int(fences[b]["count"])
                )
                sub_out = out[ix]
                sub_pending = np.ones(len(ix), dtype=bool)
                search_run(bk, bv, keys[ix], sub_out, sub_pending)
                resolved = ix[~sub_pending]
                out[resolved] = sub_out[~sub_pending]
                pending[resolved] = False
                active[resolved] = False
            off += 1

    def contains_any(self, keys: np.ndarray) -> bool:
        return bool(np.any(self.lookup_batch(keys) != NOT_FOUND))

    def lookup_range(self, key: np.void) -> np.ndarray:
        """All values stored under `key` (non-unique index), ascending."""
        assert not self.unique
        self._resolve_mem()
        k_lo = key["lo"]
        k_hi = key["hi"]
        parts: List[np.ndarray] = []
        for table in self._tables_newest_first():
            fences = self._table_fences(table)
            b_lo = int(np.searchsorted(fences["last_lo"], k_lo, side="left"))
            b_hi = int(np.searchsorted(fences["first_lo"], k_lo, side="right"))
            for b in range(b_lo, min(b_hi, len(fences))):
                bk, bv = self._read_data_block(
                    int(fences[b]["block"]), int(fences[b]["count"])
                )
                s = np.searchsorted(bk["lo"], k_lo, side="left")
                e = np.searchsorted(bk["lo"], k_lo, side="right")
                if e > s:
                    sel = bk["hi"][s:e] == k_hi
                    if sel.any():
                        parts.append(bv[s:e][sel])
        for mem_keys, mem_vals in self._mem:
            hit = (mem_keys["lo"] == k_lo) & (mem_keys["hi"] == k_hi)
            if hit.any():
                parts.append(mem_vals[hit])
        if not parts:
            return np.zeros(0, dtype=np.uint32)
        return np.sort(np.concatenate(parts), kind="stable")

    def scan_lo_capped(
        self, k_lo: int, hi_min: int = 0, hi_max: int = U64_MAX,
        cap: int = 1 << 16,
    ) -> Tuple[np.ndarray, bool]:
        """scan_lo with an abandon threshold: once more than `cap` values
        have accumulated the scan stops and reports incomplete (False) —
        an unselective predicate is cheaper to re-verify on the gathered
        candidate rows than to materialize and sort in full (reference
        scan_builder picks scan order by selectivity; this is the
        batch-vectorized analog)."""
        assert not self.unique
        k_lo = np.uint64(k_lo)
        parts: List[np.ndarray] = []
        total = 0
        for table in self._tables_newest_first():
            fences = self._table_fences(table)
            b_lo = int(np.searchsorted(fences["last_lo"], k_lo, side="left"))
            b_hi = int(np.searchsorted(fences["first_lo"], k_lo, side="right"))
            for b in range(b_lo, min(b_hi, len(fences))):
                bk, bv = self._read_data_block(
                    int(fences[b]["block"]), int(fences[b]["count"])
                )
                s = np.searchsorted(bk["lo"], k_lo, side="left")
                e = np.searchsorted(bk["lo"], k_lo, side="right")
                if e > s:
                    # Tables are LO-major ordered only: a merge drains
                    # equal-lo ties oldest-stream-first with within-run
                    # order preserved (_merge_tables), so hi need NOT
                    # ascend inside the segment — window by mask, never
                    # searchsorted.
                    run_hi = bk["hi"][s:e]
                    sel = (run_hi >= np.uint64(hi_min)) & (
                        run_hi <= np.uint64(hi_max)
                    )
                    n_sel = int(np.count_nonzero(sel))
                    if n_sel:
                        parts.append(
                            bv[s:e] if n_sel == e - s else bv[s:e][sel]
                        )
                        total += n_sel
                        if total > cap:
                            return np.concatenate(parts), False
        self._sort_mem_lazily()
        for mem_keys, mem_vals in self._mem:
            hit = (
                (mem_keys["lo"] == k_lo)
                & (mem_keys["hi"] >= np.uint64(hi_min))
                & (mem_keys["hi"] <= np.uint64(hi_max))
            )
            if hit.any():
                parts.append(mem_vals[hit])
                total += int(hit.sum())
                if total > cap:
                    return np.concatenate(parts), False
        if not parts:
            return np.zeros(0, dtype=np.uint32), True
        return np.sort(np.concatenate(parts), kind="stable"), True

    def scan_lo(self, k_lo: int, hi_min: int = 0, hi_max: int = U64_MAX) -> np.ndarray:
        """All values whose key.lo == k_lo and key.hi ∈ [hi_min, hi_max],
        ascending by value. The composite-key scan primitive (reference
        scan_tree.zig:31 range scans over (field, timestamp) keys,
        composite_key.zig): key.lo carries the field prefix, key.hi the
        timestamp, so this is 'rows matching field=value in a timestamp
        window'."""
        vals, complete = self.scan_lo_capped(k_lo, hi_min, hi_max, cap=1 << 62)
        assert complete
        return vals

    # --- multi-predicate scan engine support ---------------------------
    #
    # The ScanBuilder planner (lsm/scan.py) needs two primitives beyond
    # the materializing scans above: a zero-IO cardinality ESTIMATE (to
    # order predicates by selectivity, reference scan_builder.zig) and a
    # candidate PROBE (gallop the driver predicate's sorted row list
    # through this index's fence-selected segments instead of
    # materializing the whole scan — scan_merge.zig's probe side).

    def scan_estimate(self, k_lo: int) -> int:
        """Fence-only upper bound on a key.lo prefix scan's row count:
        the summed entry count of every fence-selected candidate block,
        plus this tree's resident memtable rows (identical for every
        predicate of a query, so it never perturbs the ranking). Zero
        block reads — monotone enough in the true scan size to ORDER
        predicates by, which is all the planner needs."""
        k_lo = np.uint64(k_lo)
        est = 0
        for table in self._tables_newest_first():
            fences = self._table_fences(table)
            b_lo = int(np.searchsorted(fences["last_lo"], k_lo, side="left"))
            b_hi = min(
                int(np.searchsorted(fences["first_lo"], k_lo, side="right")),
                len(fences),
            )
            if b_hi > b_lo:
                est += int(fences["count"][b_lo:b_hi].sum())
        return est

    def scan_probe_lo(
        self, k_lo: int, cand: np.ndarray, hit: np.ndarray,
        hi_min: int = 0, hi_max: int = U64_MAX,
    ) -> int:
        """Mark (hit[i] = 1) every ascending candidate row that this
        index holds under key.lo == k_lo with key.hi ∈ [hi_min, hi_max].
        Fence-pruned block walk + per-segment membership probe
        (_mark_seg: C gallop on ascending segments, one vectorized
        searchsorted otherwise) — the run is never materialized, so an
        UNSELECTIVE predicate costs O(|cand| · log gap) per touched
        segment instead of a full scan + sort. Tables are LO-major
        ordered only (equal-lo merge ties drain oldest-stream-first,
        within-run order preserved — _merge_tables), so the hi window is
        a MASK and the segment's values need not ascend (flush-fresh
        segments do: commit order IS row order). Returns newly marked
        count; counts pruned/probed runs on lsm.scan.* (satellite:
        Bloom/fence prune-rate observability)."""
        k_lo = np.uint64(k_lo)
        marked = 0
        probed = pruned = 0
        for table in self._tables_newest_first():
            if marked >= len(cand):
                break
            fences = self._table_fences(table)
            b_lo = int(np.searchsorted(fences["last_lo"], k_lo, side="left"))
            b_hi = min(
                int(np.searchsorted(fences["first_lo"], k_lo, side="right")),
                len(fences),
            )
            if b_hi <= b_lo:
                pruned += 1
                continue
            probed += 1
            for b in range(b_lo, b_hi):
                bk, bv = self._read_data_block(
                    int(fences[b]["block"]), int(fences[b]["count"])
                )
                s = np.searchsorted(bk["lo"], k_lo, side="left")
                e = np.searchsorted(bk["lo"], k_lo, side="right")
                if e > s:
                    run_hi = bk["hi"][s:e]
                    sel = (run_hi >= np.uint64(hi_min)) & (
                        run_hi <= np.uint64(hi_max)
                    )
                    if sel.any():
                        marked += _mark_seg(cand, bv[s:e][sel], hit)
        self._sort_mem_lazily()
        for mem_keys, mem_vals in self._mem:
            if marked >= len(cand):
                break
            sel = (
                (mem_keys["lo"] == k_lo)
                & (mem_keys["hi"] >= np.uint64(hi_min))
                & (mem_keys["hi"] <= np.uint64(hi_max))
            )
            if sel.any():
                marked += _mark_seg(cand, mem_vals[sel], hit)
        if tracer.enabled():
            tracer.count("lsm.scan.runs_probed", probed)
            tracer.count("lsm.scan.runs_pruned", pruned)
        return marked

    def range_estimate(self, key: np.void) -> int:
        """scan_estimate for an exact (lo, hi) key over a non-unique
        index (the account_rows probe side): fence window narrowed like
        lookup_range, with per-run Blooms — where one is already built —
        pruning whole tables for free (no false negatives, full-key
        probe). Zero block reads either way."""
        assert not self.unique
        k_lo, k_hi = key["lo"], key["hi"]
        est = 0
        for table in self._tables_newest_first():
            bloom = table.bloom
            if bloom is not None and not bool(
                bloom.maybe(
                    np.asarray([k_lo], dtype=np.uint64),
                    np.asarray([k_hi], dtype=np.uint64),
                )[0]
            ):
                continue
            fences = self._table_fences(table)
            b_lo = int(np.searchsorted(fences["last_lo"], k_lo, side="left"))
            b_hi = min(
                int(np.searchsorted(fences["first_lo"], k_lo, side="right")),
                len(fences),
            )
            if b_hi > b_lo:
                est += int(fences["count"][b_lo:b_hi].sum())
        return est

    def range_probe(
        self, key: np.void, cand: np.ndarray, hit: np.ndarray
    ) -> int:
        """scan_probe_lo for an exact (lo, hi) key (lookup_range's probe
        twin): per-run Blooms gate the block walk — a bloom-negative
        table is skipped without IO and counted as pruned. Blooms build
        lazily on first probe exactly like lookup_batch (with the
        decoded mirror, or one streaming pass over-budget), so repeated
        hot-account probes stop paying for cold runs. Segment values
        need not ascend (account_rows interleaves debit-then-credit row
        runs per commit and merges only keep lo order) — _mark_seg
        gallops ascending segments and searchsorted-marks the rest."""
        assert not self.unique
        self._resolve_mem()
        k_lo, k_hi = key["lo"], key["hi"]
        lo1 = np.asarray([k_lo], dtype=np.uint64)
        hi1 = np.asarray([k_hi], dtype=np.uint64)
        marked = 0
        probed = pruned = 0
        for table in self._tables_newest_first():
            if marked >= len(cand):
                break
            bloom = table.bloom
            if bloom is None and table.count >= self.DECODE_MIN_ROWS:
                if self._decode_table(table) is None and table.bloom is None:
                    bloom = self._stream_bloom(table)
                else:
                    bloom = table.bloom
            if bloom is not None and not bool(bloom.maybe(lo1, hi1)[0]):
                pruned += 1
                continue
            fences = self._table_fences(table)
            b_lo = int(np.searchsorted(fences["last_lo"], k_lo, side="left"))
            b_hi = min(
                int(np.searchsorted(fences["first_lo"], k_lo, side="right")),
                len(fences),
            )
            if b_hi <= b_lo:
                pruned += 1
                continue
            probed += 1
            for b in range(b_lo, b_hi):
                bk, bv = self._read_data_block(
                    int(fences[b]["block"]), int(fences[b]["count"])
                )
                s = np.searchsorted(bk["lo"], k_lo, side="left")
                e = np.searchsorted(bk["lo"], k_lo, side="right")
                if e > s:
                    sel = bk["hi"][s:e] == k_hi
                    if sel.any():
                        marked += _mark_seg(cand, bv[s:e][sel], hit)
        for mem_keys, mem_vals in self._mem:
            if marked >= len(cand):
                break
            sel = (mem_keys["lo"] == k_lo) & (mem_keys["hi"] == k_hi)
            if sel.any():
                marked += _mark_seg(cand, mem_vals[sel], hit)
        if tracer.enabled():
            tracer.count("lsm.scan.runs_probed", probed)
            tracer.count("lsm.scan.runs_pruned", pruned)
        return marked
