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
  - *Compaction* merges a level into the next when it holds more than
    `growth` tables, one beat-paced k-way job at a time (compact_step,
    driven once per op by the state machine's beat), streamed block by
    block: the reference's k-way merge pacing (k_way_merge.zig:8), with
    memory O(block), not O(level). A forced major compaction (a storm,
    request_major) folds every level into one bottom run through the same
    beats. Each chunk of a job merges on the host (the C k-way merge,
    store.merge_host_kway_bloom) or, for a tree given a device, through
    ops/merge.compact_fold_kernel, split-phase; both write the same bytes.

Free-space discipline: replaced tables are released to the grid free set,
which stages frees until the next checkpoint commits where the grid
defers releases, so crash recovery can always rewind to the last durable
manifest. A job's output goes to a private block reservation, so its
progress spans checkpoints (job_state / restore_job).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.io.grid import Grid, GridReadFault
from tigerbeetle_tpu_torch.lsm.store import (
    KEY_DTYPE,
    NOT_FOUND,
    Bloom,
    _bloom_fill,
    merge_host_kway,
    merge_host_kway_bloom,
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

# One table's row in a persisted manifest.
MANIFEST_DTYPE = np.dtype(
    [
        ("level", "<u4"),
        ("index_block", "<u4"),
        ("count", "<u8"),
        ("min_hi", "<u8"), ("min_lo", "<u8"),
        ("max_hi", "<u8"), ("max_lo", "<u8"),
    ]
)

BLOCK_TYPE_DATA = 1
BLOCK_TYPE_INDEX = 2

# The default beat quota (entries merged per compact_step call).
# constants.py cannot import this module, so Config.compact_quota_entries
# repeats the literal, asserted equal here.
DEFAULT_COMPACT_QUOTA = 1 << 15

# job_state() level sentinel for a storm job, whose inputs span every
# level (oldest first) instead of prefixing one.
_STORM_LEVEL = 0xFFFFFFFF

from tigerbeetle_tpu_torch.constants import Config as _Config  # noqa: E402

assert _Config.compact_quota_entries == DEFAULT_COMPACT_QUOTA
del _Config

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
    # Set by _release_table (compaction retire): a reader racing the
    # retire may still probe the table, but must not install its mirror
    # into the LRU budget, since the table is unreachable from the levels.
    _released: bool = False


def _key_bloom(keys: np.ndarray) -> Bloom:
    """Per-run Bloom over a table's keys (RAM-only read acceleration —
    results are identical with or without it: no false negatives).
    Sized at ~16 bits/key (2 bytes RAM per table row): per-key FP ~1.6%,
    so an 8190-key miss batch probes a flagged table with ~130 keys
    instead of the whole batch."""
    b = Bloom(2 * len(keys))
    b.add(keys["lo"], keys["hi"])
    return b


class _TableReader:
    """Sequential block cursor over a table (compaction input stream)."""

    def __init__(self, tree: "DurableIndex", table: TableInfo) -> None:
        self.tree = tree
        self.fences = tree._table_fences(table)
        self.pos = 0
        self.prefetch_pos = 0

    def exhausted(self) -> bool:
        return self.pos >= len(self.fences)

    def next_block(self) -> Tuple[np.ndarray, np.ndarray]:
        f = self.fences[self.pos]
        self.pos += 1
        return self.tree._read_data_block(int(f["block"]), int(f["count"]))

    def prefetch_block(self) -> bool:
        """Warm the next unread block into the grid cache (bounded two
        blocks ahead of the merge cursor). Cache-temperature only."""
        p = max(self.prefetch_pos, self.pos)
        if p >= len(self.fences) or p - self.pos >= 2:
            return False
        self.tree.grid.read_block(int(self.fences[p]["block"]))
        self.prefetch_pos = p + 1
        return True


class _MergeStream:
    """Buffered stream over a sequence of tables (oldest-precedence side).

    `depth` is the refill read-ahead in blocks: a k-way merge's chunk size
    is governed by the SMALLEST buffered tail across streams, so buffering
    one block caps every chunk near one block's rows no matter how many
    streams feed it — per-chunk costs (bound searchsorted × k, the C call,
    the writer append) then dominate a wide merge. Deeper buffers trade
    bounded memory (k × depth × epb rows, budgeted by the job) for chunks
    that amortize those costs; the merge output is identical either way."""

    def __init__(
        self, tree: "DurableIndex", tables: List[TableInfo], depth: int = 1
    ) -> None:
        self.readers = [_TableReader(tree, t) for t in tables]
        self.depth = depth
        self.keys = np.zeros(0, dtype=KEY_DTYPE)
        self.vals = np.zeros(0, dtype=np.uint32)

    def refill(self) -> None:
        if len(self.keys) or not self.readers:
            return
        parts_k, parts_v = [], []
        blocks = 0
        while blocks < self.depth and self.readers:
            if self.readers[0].exhausted():
                self.readers.pop(0)
                continue
            k, v = self.readers[0].next_block()
            parts_k.append(k)
            parts_v.append(v)
            blocks += 1
        if len(parts_k) == 1:
            self.keys, self.vals = parts_k[0], parts_v[0]
        elif parts_k:
            # Within one stream blocks are already key-ordered end to end.
            self.keys = np.concatenate(parts_k)
            self.vals = np.concatenate(parts_v)

    def exhausted(self) -> bool:
        self.refill()
        return len(self.keys) == 0

    def take(self, upto_key: Optional[np.void]) -> Tuple[np.ndarray, np.ndarray]:
        """Pop the buffered prefix with keys <= upto_key (or all if None)."""
        if upto_key is None:
            k, v = self.keys, self.vals
            self.keys = np.zeros(0, dtype=KEY_DTYPE)
            self.vals = np.zeros(0, dtype=np.uint32)
            return k, v
        # np.uint64 needle, NOT a python int: numpy promotes uint64 vs
        # int to float64, whose 53-bit mantissa collapses composite keys
        # (tag byte => every key >= 2^56) that differ only in low bits —
        # the cut then overshoots the bound and the merge emits an
        # out-of-order chunk (disordered table tails at bench scale).
        cut = int(np.searchsorted(
            self.keys["lo"], np.uint64(upto_key), side="right"
        ))
        k, v = self.keys[:cut], self.vals[:cut]
        self.keys, self.vals = self.keys[cut:], self.vals[cut:]
        return k, v

    def last_buffered_lo(self) -> int:
        return int(self.keys[-1]["lo"])

    def bound_lo(self, target_rows: int) -> int:
        """A safe chunk bound ~target_rows into the buffer. Any buffered
        key qualifies: the unbuffered remainder sorts past the tail, so
        every row <= it is already here."""
        i = min(max(target_rows, 1), len(self.keys)) - 1
        return int(self.keys[i]["lo"])



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
        device=None,
    ) -> None:
        self.grid = grid
        # The device of the compaction fold (ops/merge.compact_fold_kernel
        # and merge_device): a torch.device runs every multi-run chunk
        # there (its plain version on the CPU), None merges on the host.
        # Both routes write the same bytes.
        self.device = device
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
        # Compaction state: touched only between beats or behind a
        # full store barrier (checkpoint/restore).
        self._job: Optional["_CompactionJob"] = None  # tidy: owner=commit|store
        # (level, captured input tables, reservation, owed, is_storm) of a
        # fault-aborted job, recreated verbatim on retry.
        self._aborted_resv: Optional[tuple] = None  # tidy: owner=commit|store
        # A queued but not started major compaction (request_major): the
        # next free compact_step beat plans it as one all-level job.
        self._storm_requested = False  # tidy: owner=commit|store
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

    def release_device(self) -> None:
        """Give back the device memory this tree holds (its machine was
        replaced by a state-sync install): close every lazy run's
        dispatch window and return its ledger bytes, and discard a
        dispatched compaction fold. The tree is not used afterwards."""
        for m in self._mem:
            if not isinstance(m, tuple):
                m.finish_dispatch()
        if self._job is not None:
            self._job.discard_pending()

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

    def _release_table(self, table: TableInfo) -> None:
        tracer.count("lsm.table_retires")
        with self._lru_lock:
            table._released = True
            if table._decoded is not None:
                table._decoded = None
                self._decoded_rows -= table.count
                try:
                    self._decoded_lru.remove(table)
                except ValueError:
                    pass
        for f in self._table_fences(table):
            self.grid.release(int(f["block"]))
        self.grid.release(table.index_block)

    # --- compaction -----------------------------------------------------
    #
    # Incremental k-way leveled compaction (upstream's bar/beat pacing,
    # compaction.zig:1-31 + k_way_merge.zig:8, re-shaped for
    # batch-vectorized hosts): when a level exceeds the growth factor, a
    # _CompactionJob captures its tables and merges all of them in one
    # k-way streaming pass (every row moves once) in bounded per-beat
    # steps (compact_step), so a major merge never stalls the commit
    # path. Reads keep using the captured input tables until the job
    # installs its output atomically.

    def compact_step(self, quota_entries: int) -> bool:
        """One beat of compaction work (≤ ~quota_entries merged entries).
        Returns True while more compaction work remains queued."""
        if self._job is None:
            if self._aborted_resv is not None:
                # Retry after a repaired fault: recreate the SAME job —
                # captured inputs, reservation, and completed progress —
                # so the restarted merge rewrites the same blocks and
                # installs at the op peers do. It must run before any
                # OTHER level's job is considered, or its reservation
                # would leak and the eventual re-reserve would pick
                # different indices.
                level, tables, resv, p0, storm = self._aborted_resv
                self._aborted_resv = None
                self._job = _CompactionJob(
                    self, level, tables, reservation=resv, is_storm=storm
                )
                self._job.pending_ff = p0
            elif self._storm_requested:
                self._plan_storm_job()
            else:
                for level, tables in enumerate(self.levels):
                    if len(tables) > self.growth:
                        self._job = _CompactionJob(self, level, list(tables))
                        break
        if self._job is None:
            return False
        tracer.count("lsm.compaction_beats")
        try:
            # A restored job's deferred fast-forward folds into this
            # step's quota (see restore_job) — same stopping point as a
            # replica that ran the forward and the beat separately. The
            # owed forward is only consumed on SUCCESS: a fault mid-step
            # discards the step's merges, so the retry still owes it.
            quota = quota_entries + self._job.pending_ff
            if self._job.pending_ff:
                with tracer.span("lsm.compact.forward"):
                    exhausted = self._job.step(quota)
            else:
                exhausted = self._job.step(quota)
            self._job.pending_ff = 0
            if self.name is not None and self._job.is_storm:
                tracer.gauge(
                    f"lsm.{self.name}.storm_remaining",
                    max(0, self._job.total_rows - self._job.progress),
                )
            if exhausted:
                if self.name is not None and self._job.is_storm:
                    tracer.gauge(f"lsm.{self.name}.storm_remaining", 0)
                self._install_job()
        except GridReadFault:
            # A corrupt input block: the step is NOT resumable (streams
            # were partially consumed), but abort-and-retry is exactly
            # deterministic — inputs, reservation, AND the owed position
            # (completed progress + any unconsumed fast-forward) are
            # kept, so the retried job forwards to the position peers
            # hold and stays install-op aligned.
            owed = self._job.progress_at_step_start + self._job.pending_ff
            self._job.discard_pending()
            self._job.writer.abort()
            self._aborted_resv = (
                self._job.level, self._job.tables, self._job.reservation,
                owed, self._job.is_storm,
            )
            self._job = None
            raise
        return (
            self._job is not None
            or self._storm_requested
            or any(len(t) > self.growth for t in self.levels)
        )

    def request_major(self) -> int:
        """Queue a forced all-level major compaction (the reference's
        compaction-storm shape) to run INCREMENTALLY through compact_step
        beats, so the tree keeps serving lookups and inserts while the
        whole keyspace merges down to one bottom run. Returns the rows
        queued (0 if the tree is too small to bother, or a storm is
        already queued/running).

        Maintenance/single-node API: the request itself is not a
        committed op, so a cluster must send it identically to every
        replica — but the storm JOB, once planned, checkpoints and
        restores like any other compaction job."""
        if self.storm_active():
            return 0
        self.flush_memtable()
        if sum(len(lvl) for lvl in self.levels) < 2:
            return 0
        self._storm_requested = True
        return sum(t.count for lvl in self.levels for t in lvl)

    def storm_active(self) -> bool:
        """True while a storm is queued, running, or awaiting fault retry."""
        return (
            self._storm_requested
            or (self._job is not None and self._job.is_storm)
            or (self._aborted_resv is not None and self._aborted_resv[4])
        )

    def _plan_storm_job(self) -> None:
        """Start the queued storm as ONE beat-paced job over every table,
        oldest-first across levels (deeper level = older data; append
        order is age order within a level). The k-way merge folds ≤64
        streams per pass in the C core and buffers one block per stream,
        so even a whole-tree merge is O(tables) memory. Output becomes
        the new bottom level at install. Runs only when no other job is
        in flight — a regular job finishes first and its output joins
        the storm's inputs."""
        self._storm_requested = False
        self.flush_memtable()
        tables = [t for level in reversed(self.levels) for t in level]
        if len(tables) < 2:
            return
        self._job = _CompactionJob(self, 0, tables, is_storm=True)

    def compact_backlog(self) -> int:
        """Entries of compaction work outstanding. This is the pacing
        input for the adaptive beat quota, so it must be a pure function
        of committed state: levels content and job progress are
        beat-paced, and a fault-aborted job counts its owed position
        (total − owed equals a non-faulting peer's total − progress), so
        replicas and WAL replay compute identical backlogs."""
        backlog = 0
        j = self._job
        if j is not None:
            backlog += max(0, j.total_rows - j.progress - j.pending_ff)
        elif self._aborted_resv is not None:
            _lvl, tables, _resv, owed, _storm = self._aborted_resv
            backlog += max(0, sum(t.count for t in tables) - owed)
        elif self._storm_requested:
            backlog += sum(t.count for lvl in self.levels for t in lvl)
        for level, tables in enumerate(self.levels):
            if len(tables) <= self.growth:
                continue
            # Tables captured by the running job still sit in their level;
            # skip them rather than double-count (a storm captured all).
            if j is not None and (j.is_storm or level == j.level):
                continue
            backlog += sum(t.count for t in tables)
        return backlog

    def compact_prefetch_one(self) -> bool:
        """Warm ONE upcoming compaction-input block into the grid cache
        (idle-slot read-ahead). Content-neutral: only cache temperature
        changes, never merge order or output bytes, so it is safe to
        drive from timing-dependent idle detection. Faults are swallowed
        here — the real read takes the normal repair path. Storm jobs
        only: routine level merges touch a handful of blocks per beat and
        their inputs are usually still cache-hot from ingest, so the
        read-ahead would mostly queue cold reads behind the WAL's writes
        (which the commit path is latency-bound on); a storm's all-level
        fold is the case where warm inputs pay for that contention."""
        j = self._job
        if j is None or not j.is_storm:
            return False
        try:
            return j.prefetch_one()
        except GridReadFault:
            return False

    def _install_job(self) -> None:
        job = self._job
        self._job = None
        out = job.writer.finish()
        for b in job.writer.unused_reservation():
            self.grid.free_set.release(b)  # forfeit (usually empty)
        # Publish-then-retire: the merged output becomes visible BEFORE
        # the input tables leave their level, so a concurrent drain-free
        # reader walking newest-first always finds every entry in at
        # least one of the two (merges preserve content; transient double
        # visibility resolves to the same values).
        captured = set(id(t) for t in job.tables)  # tidy: allow=id-key — identity membership within one process, never ordered or serialized
        if job.is_storm:
            # Storm install: the merged run becomes the new BOTTOM level,
            # every captured input (which spanned all levels) retires, and
            # emptied interior levels compress away — level indices are
            # not persisted identities, and no other job is in flight.
            self.levels.append(out)
            self.levels = [
                [t for t in lvl if id(t) not in captured]  # tidy: allow=id-key — identity membership within one process, never ordered or serialized
                for lvl in self.levels
            ]
            self.levels = [self.levels[0]] + [
                lvl for lvl in self.levels[1:] if lvl
            ]
            tracer.count("lsm.compaction_storms")
        else:
            if job.level + 1 >= len(self.levels):
                self.levels.append([])
            self.levels[job.level + 1].extend(out)
            self.levels[job.level] = [
                t for t in self.levels[job.level] if id(t) not in captured  # tidy: allow=id-key — identity membership within one process, never ordered or serialized
            ]
        for t in job.tables:
            self._release_table(t)
        tracer.count("lsm.compaction_installs")
        self._publish_level_gauges()

    def drain_compaction(self) -> None:
        """Run every queued compaction to completion (checkpoint barrier:
        a manifest must never reference a half-written merge)."""
        while self.compact_step(1 << 62):
            pass

    def _merge_chunk(self, ka, va, kb, vb) -> Tuple[np.ndarray, np.ndarray]:
        if self.device is not None:
            from tigerbeetle_tpu_torch.ops import merge as merge_ops

            return merge_ops.merge_device(ka, va, kb, vb, device=self.device)
        return merge_host_kway([ka, kb], [va, vb])

    def _merge_tables(
        self, tables_a: List[TableInfo], tables_b: List[TableInfo]
    ) -> List[TableInfo]:
        """Streaming stable merge of two key-ordered table sequences,
        O(block) memory; emits one or more non-overlapping tables."""
        a = _MergeStream(self, tables_a)
        b = _MergeStream(self, tables_b)
        out = _TableWriter(self)
        while True:
            a_empty, b_empty = a.exhausted(), b.exhausted()
            if a_empty and b_empty:
                break
            if b_empty:
                out.append(*a.take(None))
                continue
            if a_empty:
                out.append(*b.take(None))
                continue
            # Emit everything up to the smaller of the two buffered tail
            # lo-keys — all later input sorts at or past it; a lo-tie run
            # split across windows is fine (point lookups verify hi, and
            # the non-unique read path sorts values per key).
            bound = min(a.last_buffered_lo(), b.last_buffered_lo())
            ka, va = a.take(bound)
            kb, vb = b.take(bound)
            if len(ka) and len(kb):
                mk, mv = self._merge_chunk(ka, va, kb, vb)
                out.append(mk, mv)
            elif len(ka):
                out.append(ka, va)
            elif len(kb):
                out.append(kb, vb)
        return out.finish()

    def compact_all(self) -> None:
        """Forced major compaction: merge every level into one bottom run
        (the reference's compaction-storm shape, BASELINE config 5).
        Hierarchical k-way: groups of ≤64 streams per pass — the C
        merge core's heap selection is O(log k) per row, so the wide
        group costs the same per row as a narrow one but a whole
        benchmark-scale tree collapses in ONE pass (every row moves
        once) where the old 16-wide grouping needed two."""
        # Finish only the IN-FLIGHT job (a manifest must never reference
        # a half-written merge) — but do NOT drain_compaction(): that
        # would plan fresh level merges whose whole output the all-level
        # fold below immediately re-merges, doubling every row's moves.
        # The big fold absorbs any queued level work in the same pass.
        while self._job is not None or self._aborted_resv is not None:
            self.compact_step(1 << 62)
        self.flush_memtable()
        # Oldest-first: deeper levels hold older data; within a level,
        # append order is age order. Group merges keep age order because
        # groups are formed and concatenated in order and the chunk
        # combine is stable.
        tables: List[TableInfo] = [
            t for level in reversed(self.levels) for t in level
        ]
        while len(tables) > 1:
            one_group = len(tables) <= 64
            next_round: List[TableInfo] = []
            for g in range(0, len(tables), 64):
                group = tables[g : g + 64]
                if len(group) == 1:
                    next_round.extend(group)
                    continue
                job = _CompactionJob(self, 0, group)
                job.step(1 << 62)
                next_round.extend(job.writer.finish())
                for b in job.writer.unused_reservation():
                    self.grid.free_set.release(b)
                for t in group:
                    self._release_table(t)
            tables = next_round
            if one_group:
                break  # a single merge's outputs are already disjoint
        self.levels = [[], tables]
        # The fold above IS a completed major: a still-queued storm
        # request would only re-merge the single bottom run.
        self._storm_requested = False


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
            if table._released:
                # Retired while we were building (compaction racing a
                # reader): serve this probe from the local mirror but
                # never install it, so a dead table takes no decode
                # budget and evicts no live mirror.
                return decoded
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

    # --- checkpoint -----------------------------------------------------

    def checkpoint(self) -> np.ndarray:
        """Flush the memtable and return the manifest (MANIFEST_DTYPE rows).

        An in-flight compaction job is NOT drained (a checkpoint landing
        on a deep backlog would otherwise stall the commit stream for the
        whole merge). The manifest references the
        job's INPUT tables (still live, still serving reads); the job's
        descriptor — inputs prefix + private block reservation — is
        persisted alongside (job_state), so a restarted replica re-runs
        the job into the same blocks while a running one just continues:
        both install identical outputs at identical indices."""
        self.flush_memtable()
        rows = []
        for level, tables in enumerate(self.levels):
            for t in tables:
                rows.append(
                    (level, t.index_block, t.count,
                     t.key_min[0], t.key_min[1], t.key_max[0], t.key_max[1])
                )
        return np.array(rows, dtype=MANIFEST_DTYPE)

    def checkpoint_fences(self) -> Tuple[np.ndarray, np.ndarray]:
        """(concatenated fence rows, per-table fence counts) in manifest
        row order. Persisted alongside the manifest so a restored tree
        knows every data-block address WITHOUT grid reads — checkpoint
        encoding (snapshot.referenced_blocks) then never touches storage,
        and a restored-from-blob tree is fence-complete immediately."""
        fences = []
        counts = []
        for tables in self.levels:
            for t in tables:
                f = self._table_fences(t)
                fences.append(f)
                counts.append(len(f))
        if not fences:
            return (
                np.zeros(0, dtype=INDEX_ENTRY_DTYPE),
                np.zeros(0, dtype=np.uint32),
            )
        return np.concatenate(fences), np.array(counts, dtype=np.uint32)

    def attach_fences(self, fences: np.ndarray, counts: np.ndarray) -> None:
        """Re-attach checkpointed fence arrays after restore() (same
        manifest row order as checkpoint_fences)."""
        off = 0
        i = 0
        for tables in self.levels:
            for t in tables:
                c = int(counts[i])
                t._fences = fences[off : off + c]
                off += c
                i += 1

    def job_state(self) -> Optional[Tuple[int, int, int, List[int]]]:
        """(level, n_inputs, progress, reservation) of the in-flight
        compaction job, for checkpoint persistence. Every replica at the
        same checkpoint has the same descriptor — jobs start, step, and
        install at deterministic beats, so progress (cumulative merged
        entries) is identical too; the storage checker byte-compares it."""
        j = self._job
        if j is None:
            return None
        n = len(j.tables)
        if j.is_storm:
            # A storm job's inputs span EVERY level, oldest-first — and
            # stay a prefix of that order across checkpoints, because
            # flushes only APPEND to level 0 (newest position) while the
            # storm runs and no other job restructures levels. The
            # sentinel level tells restore_job to rebuild the same list.
            flat = [t for level in reversed(self.levels) for t in level]
            assert flat[:n] == j.tables, (
                "storm inputs must be the oldest-first prefix across levels"
            )
            return (_STORM_LEVEL, n, j.progress, list(j.reservation))
        assert self.levels[j.level][:n] == j.tables, (
            "job inputs must be a prefix of their level"
        )
        return (j.level, n, j.progress, list(j.reservation))

    def restore_job(
        self, level: int, n_inputs: int, progress: int,
        reservation: List[int],
    ) -> None:
        """Recreate a checkpointed job descriptor. The re-merge is
        FAST-FORWARDED to the checkpointed progress LAZILY, on the first
        compact_step (pending_ff): install() may run on block-sync paths
        where the input blocks are not locally present yet, and commits
        (hence beats) are gated until they are. Folding the forward into
        the first beat's quota lands on the identical chunk-stream
        crossing a running replica reached (first crossing >= p, then
        >= p+q, equals first crossing >= p+q when p is itself a
        crossing), so the restarted job installs at the same future op
        as a replica that never restarted — and a fault during the
        forward takes compact_step's abort path like any other."""
        storm = level == _STORM_LEVEL
        if storm:
            flat = [t for lvl in reversed(self.levels) for t in lvl]
            tables = flat[:n_inputs]
        else:
            tables = self.levels[level][:n_inputs]
        assert len(tables) == n_inputs
        self._job = _CompactionJob(
            self, 0 if storm else level, tables,
            reservation=list(reservation), is_storm=storm,
        )
        self._job.pending_ff = progress

    def storm_state(self) -> int:
        """1 if a storm is queued but not yet planned as a job (the
        request_major → first-beat window), for checkpoint persistence.
        A PLANNED storm persists via job_state's sentinel instead."""
        return 1 if self._storm_requested else 0

    def restore_storm(self, requested: int) -> None:
        """Re-queue a checkpointed not-yet-planned storm request. Call
        BEFORE restore_job (a restored job descriptor supersedes it)."""
        self._storm_requested = bool(requested)

    def restore(self, manifest: np.ndarray) -> None:  # tidy: allow=unlocked-access — open/state-sync path: stages are reset/quiesced, no concurrent reader exists
        self._mem = []
        self._mem_sorted = []
        self._mem_count = 0
        self.levels = [[]]
        self.count = 0
        self._job = None
        self._aborted_resv = None
        self._storm_requested = False
        self._decoded_lru = []
        self._decoded_rows = 0
        for rec in manifest:
            level = int(rec["level"])
            while level >= len(self.levels):
                self.levels.append([])
            t = TableInfo(
                index_block=int(rec["index_block"]),
                count=int(rec["count"]),
                key_min=(int(rec["min_hi"]), int(rec["min_lo"])),
                key_max=(int(rec["max_hi"]), int(rec["max_lo"])),
            )
            self.levels[level].append(t)
            self.count += t.count


class _CompactionJob:
    """Resumable k-way merge of a captured table list into one key-ordered
    output run (k_way_merge.zig:8's role). Work is metered in entries per
    `step` call; between steps the tree keeps serving reads from the input
    tables. The chunk combine is stable with streams ordered oldest-first,
    preserving the age precedence the lookup path relies on."""

    def __init__(
        self, tree: DurableIndex, level: int, tables: List[TableInfo],
        reservation: Optional[List[int]] = None, is_storm: bool = False,
    ) -> None:
        self.tree = tree
        self.level = level
        self.tables = tables
        self.is_storm = is_storm
        # Read-ahead depth budget: ~2M buffered rows across all streams
        # (≈40 MB at benchmark block sizes, transient, small next to the
        # decoded-mirror budget) — wide merges get multi-block chunks
        # without unbounded memory. Deterministic: a pure function of the
        # captured table count and the grid geometry.
        depth = max(1, min(8, (1 << 21) // max(1, len(tables) * tree.entries_per_block)))
        self.streams = [_MergeStream(tree, [t], depth=depth) for t in tables]
        self.total_rows = sum(t.count for t in tables)
        if reservation is None:
            # Reserve the EXACT output block count up front (merges
            # preserve entry counts): the job owns these blocks privately,
            # so its progress can span checkpoints — and a replica that
            # restarts the job from its checkpointed descriptor writes
            # the same content at the same indices (reference
            # free_set.zig:28-45 reservations).
            epb = tree.entries_per_block
            n_data = -(-self.total_rows // epb)
            n_index = -(-n_data // tree.fences_per_index)
            reservation = tree.grid.free_set.reserve(n_data + n_index)
        self.reservation = reservation
        # Fused Bloom plan: output table boundaries are known UP FRONT
        # (merges preserve counts; every data block except the run's last
        # is epb-full, so tables split at exact multiples of span), so
        # per-table filters sized exactly as the lazy builds would size
        # them (2*count) can be populated inside the merge's output pass
        # — the filters are bit-identical to a post-hoc build, and the
        # first-probe full-table scan (_stream_bloom) never runs for
        # compacted tables.
        self._span = tree.fences_per_index * tree.entries_per_block
        n_tables = -(-self.total_rows // self._span) if self.total_rows else 0
        self._blooms = [
            Bloom(2 * min(self._span, self.total_rows - t * self._span))
            for t in range(n_tables)
        ]
        self._out_pos = 0
        # Split-phase double buffer: a dispatched-but-unmaterialized
        # device merge chunk (flushed in dispatch order; never outlives
        # one step call).
        self._pending = None
        self.writer = _TableWriter(tree, reservation, blooms=self._blooms)
        # Cumulative entries merged — persisted with the checkpoint
        # descriptor so a restarted replica fast-forwards to the SAME
        # position and installs at the same op as peers that kept
        # running (chunk boundaries are deterministic, so progress is
        # always a reproducible crossing point of the chunk stream).
        self.progress = 0
        # Deferred fast-forward amount for a descriptor-restored job
        # (consumed by compact_step's first beat; see restore_job).
        self.pending_ff = 0
        # Progress as of the last completed step — the retry position
        # after a fault-aborted step (its partial merges are discarded).
        self.progress_at_step_start = 0

    def step(self, quota_entries: int) -> bool:
        """Merge ≥1 chunk, up to ~quota_entries; True when exhausted."""
        self.progress_at_step_start = self.progress
        merged = 0
        use_device = self.tree.device is not None
        while merged < quota_entries:
            live = [s for s in self.streams if not s.exhausted()]
            if not live:
                self._flush_pending()
                return True
            if len(live) == 1:
                k, v = live[0].take(None)
                self._append(k, v)
                merged += len(k)
                self.progress += len(k)
                continue
            # Everything at or below the smallest buffered tail key can be
            # ordered now — later input in any stream sorts past it. Cut
            # near the remaining quota so beats stay bounded even with
            # deep read-ahead buffers; drain-style quotas (compact_all,
            # storm drain) degenerate to the full-buffer bound.
            per = max(1, (quota_entries - merged) // len(live))
            bound = min(s.bound_lo(per) for s in live)
            parts_k, parts_v = [], []
            for s in live:  # oldest-first order
                k, v = s.take(bound)
                if len(k):
                    parts_k.append(k)
                    parts_v.append(v)
            n_chunk = sum(len(k) for k in parts_k)
            if use_device and len(parts_k) > 1:
                # Split-phase: dispatch THIS chunk's device fold before
                # materializing the PREVIOUS one, so the device merge
                # overlaps the previous chunk's host-side bloom feed and
                # table build (the streaming engine's double buffer).
                # Chunks append strictly in dispatch order, so output
                # bytes are identical to the synchronous path.
                from tigerbeetle_tpu_torch.ops import merge as merge_ops

                with tracer.span("lsm.compact.merge"):
                    handle = merge_ops.compact_fold_dispatch(
                        parts_k, parts_v, self.tree.device
                    )
                self._flush_pending()
                self._pending = handle
            else:
                with tracer.span("lsm.compact.merge"):
                    ck, cv, prefilled = self._combine(parts_k, parts_v)
                self._append(ck, cv, prefilled=prefilled)
            merged += n_chunk
            self.progress += n_chunk
        self._flush_pending()
        return False

    def _combine(
        self, parts_k: List[np.ndarray], parts_v: List[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Host k-way combine → (keys, vals, bloom_prefilled)."""
        if len(parts_k) == 1:
            return parts_k[0], parts_v[0], False
        # Host path: each part is sorted and parts arrive oldest-first,
        # so the stable galloping k-way merge (C shim) produces the
        # radix sort's exact bytes at merge cost instead of sort cost —
        # and the fused variant sets the output tables' Bloom bits on the
        # rows while they are cache-hot from the copy, erasing the
        # separate build pass.
        if self._blooms:
            ends, blooms = self._segments(sum(len(k) for k in parts_k))
            mk, mv = merge_host_kway_bloom(parts_k, parts_v, ends, blooms)
            return mk, mv, True
        mk, mv = merge_host_kway(parts_k, parts_v)
        return mk, mv, False

    def _segments(
        self, n: int
    ) -> Tuple[List[int], List[Optional[Bloom]]]:
        """Output-table boundary splits of the next n output rows,
        relative to the chunk start (the fused merge's segment plan)."""
        pos = self._out_pos
        ends: List[int] = []
        blooms: List[Optional[Bloom]] = []
        while n > 0:
            t = pos // self._span
            take = min(self._span - pos % self._span, n)
            ends.append(pos + take - self._out_pos)
            blooms.append(self._blooms[t] if t < len(self._blooms) else None)
            pos += take
            n -= take
        return ends, blooms

    def _append(
        self, keys: np.ndarray, vals: np.ndarray, prefilled: bool = False
    ) -> None:
        """Feed output rows to the writer, populating table Blooms for
        any path that did not fuse them (single-stream passthrough,
        device-fold chunks). Flushes a pending device chunk first so
        output rows land in merge order."""
        self._flush_pending()
        if len(keys) == 0:
            return
        if not prefilled and self._blooms:
            with tracer.span("lsm.compact.bloom"):
                ends, blooms = self._segments(len(keys))
                _bloom_fill(keys, ends, blooms)
        self._out_pos += len(keys)
        with tracer.span("lsm.compact.build"):
            self.writer.append(keys, vals)

    def _flush_pending(self) -> None:
        """Materialize + append the previously dispatched device chunk
        (the back half of the split-phase double buffer)."""
        if self._pending is None:
            return
        from tigerbeetle_tpu_torch.ops import merge as merge_ops

        handle, self._pending = self._pending, None
        with tracer.span("lsm.compact.merge"):
            k, v = merge_ops.compact_fold_materialize(handle)
        self._append(k, v)

    def discard_pending(self) -> None:
        """Drop a dispatched-but-unappended device chunk (fault abort
        path): closes its tracer dispatch token and releases its
        memory-ledger bytes; the retried job simply re-merges the
        chunk."""
        if self._pending is None:
            return
        from tigerbeetle_tpu_torch.ops import merge as merge_ops

        handle, self._pending = self._pending, None
        merge_ops.compact_fold_discard(handle)

    def prefetch_one(self) -> bool:
        """Warm one upcoming input block (idle read-ahead); see
        DurableIndex.compact_prefetch_one."""
        for stream in self.streams:
            for reader in stream.readers:
                if reader.prefetch_block():
                    return True
        return False


class _TableWriter:
    """Accumulates merged output, flushing full data blocks incrementally;
    rolls over into a new table when the index block's fence capacity is
    reached (output tables are key-ordered and non-overlapping).

    With a `reservation` (a compaction job's private block list from
    FreeSet.reserve), blocks are consumed from it IN ORDER instead of
    acquired from the shared free set — the mapping from output content
    to block index is then a pure function of the merge inputs, so a job
    restarted from scratch (crash recovery) writes byte-identical blocks
    at identical indices no matter what else allocated in between."""

    def __init__(
        self, tree: DurableIndex, reservation: Optional[List[int]] = None,
        blooms: Optional[List[Bloom]] = None,
    ) -> None:
        self.tree = tree
        self.reservation = reservation
        self._resv_next = 0
        self.parts_k: List[np.ndarray] = []
        self.parts_v: List[np.ndarray] = []
        self.buffered = 0
        self.fences: List[tuple] = []
        self.total = 0
        self.done: List[TableInfo] = []
        # Per-output-table Bloom filters populated by the owning
        # compaction job's merge passes (ordinal == position in `done`);
        # attached at table close so the lazy builds never run.
        self._blooms = blooms

    def _write(self, payload: bytes, block_type: int) -> int:
        if self.reservation is None:
            return self.tree.grid.write_block(payload, block_type)
        block = self.reservation[self._resv_next]
        self._resv_next += 1
        self.tree.grid.write_block_at(block, payload, block_type)
        return block

    def abort(self) -> None:
        """Drop every block this writer has produced (aborted compaction
        job): none is referenced by any manifest yet. Reserved blocks
        stay reserved (the retried job reuses them in the same order);
        free-set-acquired blocks are un-acquired immediately so the
        retried job re-acquires the same indices."""
        if self.reservation is None:
            for _fh, _fl, _lh, _ll, block, _c in self.fences:
                self.tree.grid.abort_block(block)
            for t in self.done:
                for f in self.tree._table_fences(t):
                    self.tree.grid.abort_block(int(f["block"]))
                self.tree.grid.abort_block(t.index_block)
        else:
            for t in self.done:
                self.tree.grid._cache.pop(t.index_block, None)
            self._resv_next = 0
        self.fences = []
        self.done = []
        self.parts_k, self.parts_v, self.buffered = [], [], 0

    def append(self, keys: np.ndarray, vals: np.ndarray) -> None:
        if len(keys) == 0:
            return
        epb = self.tree.entries_per_block
        if self.buffered:
            if self.buffered + len(keys) < epb:
                self.parts_k.append(keys)
                self.parts_v.append(vals)
                self.buffered += len(keys)
                return
            # Only the leftover-completion pays a concatenate; full
            # blocks below are sliced straight out of the chunk.
            need = epb - self.buffered
            self._flush_block(
                np.concatenate(self.parts_k + [keys[:need]]),
                np.concatenate(self.parts_v + [vals[:need]]),
            )
            keys, vals = keys[need:], vals[need:]
            self.parts_k, self.parts_v, self.buffered = [], [], 0
        n_full = len(keys) // epb
        for i in range(n_full):
            self._flush_block(
                keys[i * epb:(i + 1) * epb], vals[i * epb:(i + 1) * epb]
            )
        rem = len(keys) - n_full * epb
        if rem:
            self.parts_k = [keys[n_full * epb:]]
            self.parts_v = [vals[n_full * epb:]]
            self.buffered = rem

    def _flush_block(self, keys: np.ndarray, vals: np.ndarray) -> None:
        payload = (
            np.uint32(len(keys)).tobytes() + b"\x00" * 12
            + keys.tobytes() + np.ascontiguousarray(vals).tobytes()
        )
        block = self._write(payload, BLOCK_TYPE_DATA)
        self.fences.append(
            (int(keys[0]["hi"]), int(keys[0]["lo"]),
             int(keys[-1]["hi"]), int(keys[-1]["lo"]),
             block, len(keys))
        )
        self.total += len(keys)
        if len(self.fences) >= self.tree.fences_per_index:
            self._close_table()

    def _close_table(self) -> None:
        assert self.fences
        fences = np.zeros(len(self.fences), dtype=INDEX_ENTRY_DTYPE)
        for i, (fh, fl, lh, ll, b, c) in enumerate(self.fences):
            fences[i] = (fh, fl, lh, ll, b, c)
        index_payload = (
            np.uint32(len(fences)).tobytes()
            + np.uint32(0).tobytes()
            + np.uint64(self.total).tobytes()
            + fences.tobytes()
        )
        index_block = self._write(index_payload, BLOCK_TYPE_INDEX)
        bloom = None
        if self._blooms is not None and len(self.done) < len(self._blooms):
            bloom = self._blooms[len(self.done)]
            tracer.count("lsm.compact.bloom_tables_fused")
        self.done.append(
            TableInfo(
                index_block=index_block,
                count=self.total,
                key_min=(int(fences[0]["first_hi"]), int(fences[0]["first_lo"])),
                key_max=(int(fences[-1]["last_hi"]), int(fences[-1]["last_lo"])),
                bloom=bloom,
                _fences=fences,
            )
        )
        self.fences = []
        self.total = 0

    def finish(self) -> List[TableInfo]:
        if self.buffered:
            k = np.concatenate(self.parts_k)
            v = np.concatenate(self.parts_v)
            if len(k):
                self._flush_block(k, v)
        if self.fences:
            self._close_table()
        assert self.done, "empty merge output"
        return self.done

    def unused_reservation(self) -> List[int]:
        """Reserved blocks the finished output did not consume (forfeit)."""
        if self.reservation is None:
            return []
        return self.reservation[self._resv_next :]
