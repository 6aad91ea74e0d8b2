"""The accounting state machine: host orchestration over the commit kernels.

The port of the reference package's models/state_machine.py, which
re-expresses upstream's StateMachine (src/state_machine.zig:34):

  - Account balances live on the device as uint32-limb tables
    (ops/commit.py LedgerState).
  - The host resolves ids → slots (upstream's prefetch phase,
    state_machine.zig:514-655) with the C staging pass and the in-RAM
    account index (lsm/).
  - Each batch is classified: simple batches (no linked chains, no
    post/void/balancing, no duplicate ids, no limit/history accounts
    touched) commit through the device kernel
    (ops/commit.create_transfers_fast); order-dependent batches (linked
    chains, post/void of earlier pendings, balancing, limit and history
    accounts) through the fixed-point sweep kernel
    (ops/commit_exact.create_transfers_exact); batches with duplicate or
    stored ids, or a post/void of a pending created in the same batch, run
    through the byte-exact serial oracle over lazily-prefetched state, then
    write balances back to the device. `stats` counts the batches of each
    route.

  - The store stage's secondary query index (`_store_query_index`) takes
    the device route on CUDA: each batch's composite keys are built and
    sorted on the device (ops/qindex.build_run) and handed to the query
    tree as a lazy run, and memtable flushes fold those runs on the
    device (lsm/tree.py, ops/merge.merge_kernel_tiled); the query path's
    AND-merges use the device intersect (ops/scanops). The route follows
    ops/merge.device_merge_pays (on CUDA, not on the CPU, as the
    reference's policy keeps it off on XLA's CPU backend);
    `device_query_index=True`
    or `False` picks it for one machine. Both routes store the same
    table bytes.

  - Storage work that the commit path defers runs in `compact_beat`, once
    per committed op: the object logs' pending blocks reach the grid, and
    each of the five LSM trees takes one bounded compaction step, paced by
    a quota read from committed state alone (`_compact_quota`).
    `request_major_compaction` queues a major compaction (a storm) on
    every tree, which later beats drain while the machine keeps serving.
    The trees fold multi-run chunks on the device on the route the query
    index takes (ops/merge.compact_fold_kernel), else with the host's
    C k-way merge; both
    write the same bytes.

The device is CUDA unless the caller passes `device="cpu"`, where every
kernel entry runs its plain PyTorch version. With `mesh=` (a Mesh of
parallel/sharding.py) the balance tables live sharded by slot over the
mesh's devices and the commits run their sharded versions
(parallel/sharded_ops.py); every batch then runs at its op's turn. Results are byte-identical to
the reference package and to models/oracle.py (tests/test_torch_*.py).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tigerbeetle_tpu_torch import devicestats, tracer, types
from tigerbeetle_tpu_torch.constants import (
    Config, PIPELINE_PREPARE_QUEUE_MAX, PRODUCTION,
)
from tigerbeetle_tpu_torch.flags import AccountFlags, TransferFlags
from tigerbeetle_tpu_torch.lsm.store import (
    KEY_DTYPE,
    NOT_FOUND,
    Bloom,
    NativeU128Map,
    _hostops,
    make_u128_index,
    pack_keys,
)
from tigerbeetle_tpu_torch.models import oracle as oracle_mod
from tigerbeetle_tpu_torch.models.oracle import Oracle
from tigerbeetle_tpu_torch.ops import commit as commit_ops
from tigerbeetle_tpu_torch.ops import commit_exact
from tigerbeetle_tpu_torch.results import CreateAccountResult as AR
from tigerbeetle_tpu_torch.results import CreateTransferResult as TR
from tigerbeetle_tpu_torch.tidy import manifest
from tigerbeetle_tpu_torch.tidy import runtime as tidy_runtime

U64_MAX = types.U64_MAX

# Hard cap on dispatched-but-unfinished split-phase handles — the
# commit pipeline's cross-batch window (vsr/replica.py commit_depth)
# can never exceed it. Equals the protocol's prepare-queue depth AND
# the dispatch scratch ring size: slot i and slot i+WINDOW share host
# staging buffers, so a slot is only rewritten after its previous
# occupant's kernel has been finished (finish syncs before returning).
DISPATCH_WINDOW_MAX = PIPELINE_PREPARE_QUEUE_MAX

# Object-log blocks each log writes to the grid per beat.
BEAT_LOG_BLOCKS = 8


class _LazyDict(dict):
    """dict that faults entries in from a fetch function on miss.

    Lets the serial oracle run against lazily-materialized store state; keys
    it loaded (vs created) are tracked so writeback knows what is new.
    """

    def __init__(self, fetch) -> None:
        super().__init__()
        self._fetch = fetch
        self.fetched_keys: set = set()

    def get(self, k, default=None):
        if dict.__contains__(self, k):
            return dict.__getitem__(self, k)
        v = self._fetch(k)
        if v is None:
            return default
        self.fetched_keys.add(k)
        dict.__setitem__(self, k, v)
        return v

    def __getitem__(self, k):
        v = self.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __contains__(self, k) -> bool:
        return self.get(k) is not None

    def preload(self, k, v) -> None:
        if not dict.__contains__(self, k):
            self.fetched_keys.add(k)
            dict.__setitem__(self, k, v)


def _results_array(pairs: List[Tuple[int, int]]) -> np.ndarray:
    out = np.zeros(len(pairs), dtype=types.EVENT_RESULT_DTYPE)
    for i, (index, result) in enumerate(pairs):
        out[i] = (index, result)
    return out


def _codes_to_results(codes: np.ndarray) -> np.ndarray:
    nz = np.nonzero(codes)[0]
    out = np.zeros(len(nz), dtype=types.EVENT_RESULT_DTYPE)
    out["index"] = nz.astype(np.uint32)
    out["result"] = codes[nz].astype(np.uint32)
    return out


# Each machine's tag in the device memory ledger: its owners are
# `<tag>.balances` and `<tag>.scratch.b<n>`, so the replicas of one process
# count apart and a replaced machine's entries can be retired.
_MACHINE_IDS = itertools.count()

_PV_FLAGS = int(
    TransferFlags.POST_PENDING_TRANSFER | TransferFlags.VOID_PENDING_TRANSFER
)


def _names_batch_id(events: np.ndarray, is_pv: np.ndarray) -> bool:
    """Does a post/void event's pending_id name an id of this batch?"""
    p_lo = events["pending_id_lo"][is_pv]
    cand = np.isin(p_lo, events["id_lo"])
    if not cand.any():
        return False
    ids = set(zip(events["id_lo"].tolist(), events["id_hi"].tolist()))
    p_hi = events["pending_id_hi"][is_pv][cand]
    return any(k in ids for k in zip(p_lo[cand].tolist(), p_hi.tolist()))


def _staged_nbytes(batch, host_code) -> int:
    """Host→device byte volume of a staged kernel call (the device-step
    profiler's h2d counter). Shape metadata only — `.nbytes` never
    materializes a device value."""
    return sum(getattr(a, "nbytes", 0) for a in batch) + getattr(
        host_code, "nbytes", 0
    )


class StateMachine:
    """Single-replica accounting state machine (device-accelerated).

    Operations mirror the reference's Operation enum
    (state_machine.zig:318-326): create_accounts, create_transfers,
    lookup_accounts, lookup_transfers, get_account_transfers,
    get_account_history.
    """

    def __init__(
        self, config: Config = PRODUCTION, device=None, grid=None,
        device_query_index: Optional[bool] = None, mesh=None,
    ) -> None:
        from tigerbeetle_tpu_torch.io.grid import MemGrid

        if mesh is not None:
            # Multi-device: the same dispatcher over balance tables sharded
            # by slot on the mesh (parallel/sharded_ops.py). Batch staging,
            # the trees and the query index live on its first device.
            if device is not None and torch.device(device) != mesh.first:
                raise ValueError(
                    f"StateMachine: device {device} is not the mesh's first, {mesh.first}"
                )
            device = mesh.first
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StateMachine: no CUDA device; pass device='cpu' to run "
                    "the kernels' plain PyTorch versions on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # Pin the index: worker threads bind to it (bind_thread), and
            # a fresh thread's current device is 0.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if _hostops() is None:
            raise RuntimeError(
                "StateMachine: the C host shim (csrc/hostops.c) did not build; "
                "the batch staging pass needs a C compiler"
            )
        self.config = config
        # The durable LSM tier (grid blocks + tables): replicas pass a grid
        # over their data file's grid zone; standalone use gets a lazy
        # in-memory grid with the same code path.
        self.grid = grid if grid is not None else MemGrid(
            config.grid_block_count,
            config.lsm_block_size,
            config.grid_cache_blocks,
        )
        a = config.accounts_max
        self.mesh = mesh
        if mesh is None:
            self._ops = commit_ops
            self.state = commit_ops.init_state(a, self.device)
            tensors = list(self.state)
        else:
            from tigerbeetle_tpu_torch.parallel.sharded_ops import ShardedOps

            self._ops = ShardedOps(mesh, a)
            self.state = self._ops.init_state(a)
            tensors = self.state.tensors()
        # Device memory ledger: the resident balance tables (every shard
        # and replica on a mesh).
        self._mem_tag = f"sm{next(_MACHINE_IDS)}"
        self._balances_nbytes = sum(  # tidy: owner=commit
            x.numel() * x.element_size() for x in tensors
        )
        tracer.device_mem_set(f"{self._mem_tag}.balances", self._balances_nbytes)

        # Host mirrors of immutable per-account fields (slot-indexed).
        self.acc_key = np.zeros(a, dtype=KEY_DTYPE)
        self.acc_user_data_128_lo = np.zeros(a, dtype=np.uint64)
        self.acc_user_data_128_hi = np.zeros(a, dtype=np.uint64)
        self.acc_user_data_64 = np.zeros(a, dtype=np.uint64)
        self.acc_user_data_32 = np.zeros(a, dtype=np.uint32)
        self.acc_ledger = np.zeros(a, dtype=np.uint32)
        self.acc_code = np.zeros(a, dtype=np.uint32)
        self.acc_flags = np.zeros(a, dtype=np.uint32)
        self.acc_timestamp = np.zeros(a, dtype=np.uint64)
        self.account_count = 0

        from tigerbeetle_tpu_torch.lsm.log import DurableLog
        from tigerbeetle_tpu_torch.lsm.tree import DurableIndex

        # id → slot for accounts stays a RAM index (bounded by accounts_max);
        # the transfer id index, account secondary index, and the object log
        # live on the grid (reference groove.zig: id tree + indexes + object
        # tree).
        self.account_index = make_u128_index(config.accounts_max)
        # The device query-index route (ops/qindex.py): key build and sort
        # on the device, lazy runs in the tree, the flush's fold and the
        # query intersect on the device, and every tree's compaction fold
        # (ops/merge.compact_fold_kernel). None takes the route policy
        # (ops/merge.device_merge_pays: on CUDA, not on the CPU); True runs it on
        # the CPU too (the plain versions drive the same code), False
        # keeps the host route on the card. Both write the same bytes.
        if device_query_index is None:
            from tigerbeetle_tpu_torch.ops.merge import device_merge_pays

            device_query_index = device_merge_pays(self.device)
        self._qindex_device = bool(device_query_index)
        tree_device = self.device if self._qindex_device else None
        self.transfer_index = DurableIndex(
            self.grid, unique=True,
            memtable_max=config.index_memtable_rows,
            name="transfer_id", device=tree_device,
        )
        self.account_rows = DurableIndex(
            self.grid, unique=False,
            memtable_max=config.index_memtable_rows,
            name="account_rows", device=tree_device,
        )
        # Combined secondary query index: (tag<<56 | fold56(field value),
        # timestamp) -> row, for the 8 indexed transfer fields beyond
        # id/dr/cr (reference: one LSM tree per field,
        # state_machine.zig:198-219; see lsm/scan.py for the re-shape).
        # merge_hint="dups": the composite keys are low-cardinality by
        # construction (5 tag blocks over mostly-constant columns), which
        # is the galloping k-way merge's best case at flush.
        self.query_rows = DurableIndex(
            self.grid, unique=False,
            memtable_max=config.index_memtable_rows,
            name="query_rows", merge_hint="dups", device=tree_device,
        )
        self.transfer_log = DurableLog(self.grid, types.TRANSFER_DTYPE)
        # Transfer-id membership pre-filter (no false negatives): keeps the
        # per-batch duplicate-id check O(batch) instead of O(tables).
        # tidy: owner=commit|store — adds are commit-side only (the store job passes add_bloom=False); probes are commit-side
        self.transfer_seen = Bloom(config.transfers_max)
        # Durable grooves (reference PostedGroove + account_history groove,
        # state_machine.zig:167-303): bounded RAM, LSM-backed.
        from tigerbeetle_tpu_torch.lsm.groove import HistoryGroove, PostedGroove

        self.posted = PostedGroove(
            self.grid, memtable_max=config.index_memtable_rows // 8 or 512,
            device=tree_device,
        )
        self.history = HistoryGroove(
            self.grid, memtable_max=config.index_memtable_rows // 8 or 512,
            device=tree_device,
        )

        self.prepare_timestamp = 0
        self.commit_timestamp = 0

        # Deferred object-store work for the LAST committed batch:
        # (records, ts override). The reply depends only on validate+post,
        # so the commit path answers before storing; flush_deferred runs
        # before anything that reads the store (every public operation
        # guards), so stores land in strict op order.
        self._deferred_store = None  # tidy: owner=commit
        # The replica's async store stage (vsr/pipeline.StoreExecutor),
        # when attached: store jobs then run on its thread, and reads
        # drain it first (store_barrier).
        self._store_stage = None  # tidy: owner=commit|loop — written at attach (stage quiescent), read on the commit path
        # Resume point within compact_beat's stage list after a
        # GridReadFault was repaired (see compact_beat).
        self._beat_stage = 0  # tidy: owner=commit|store
        # Event count of the last committed batch: the adaptive beat
        # quota's load signal (a pure function of the committed op
        # stream, so replicas and WAL replay pace identically).
        self._beat_events = 0  # tidy: owner=commit|store

        # Split-phase device dispatch (the overlapped commit pipeline,
        # vsr/pipeline.py): FIFO of outstanding handles whose kernels are
        # dispatched but not yet synced (finish pops strictly in dispatch
        # order); _state_gen fences handles that chained off a state token
        # a serial bail rolled back. Depth is bounded by
        # DISPATCH_WINDOW_MAX (dispatch refuses past it — a pipeline
        # stall, never corruption).
        self._ct_pending: list = []  # tidy: owner=commit
        self._state_gen = 0  # tidy: owner=commit
        # Dispatch scratch ring: one host staging-buffer slot per
        # in-flight generation (keyed seq % DISPATCH_WINDOW_MAX), each
        # lazily holding the padded SoA block per pow-2 bucket size.
        # Shapes depend ONLY on the bucket, never on the ring slot or
        # window depth, so the compile-count gate is depth-independent.
        # A slot is reused only once its previous occupant finished
        # (ring size == the window cap), so even a zero-copy h2d alias
        # could never see a concurrent rewrite.
        # tidy: owner=commit — filled and handed to the kernel on the commit thread only
        self._disp_scratch: list = [
            {} for _ in range(DISPATCH_WINDOW_MAX)
        ]
        self._disp_seq = 0  # tidy: owner=commit
        # The balance read's host buffers per pow-2 bucket (_read_balances):
        # its padded slots and the (4, bucket, 4) block it reads back.
        self._read_bufs: dict = {}
        # Last-use dispatch seq per scratch bucket (pow-2 pad size): a
        # bucket idle for SCRATCH_STALE_AFTER dispatches is retired —
        # buffers freed from every ring slot, its device.mem.<tag>.scratch.*
        # gauges and devicestats cost rows dropped — so a workload
        # shift can't grow the ring (or the registry) unbounded.
        self._scratch_last_use: Dict[int, int] = {}  # tidy: owner=commit

        # telemetry: how many batches took which path
        self.stats = {
            "fast_batches": 0, "exact_batches": 0, "serial_batches": 0,
            "bail_batches": 0,
        }

    def attach_store_stage(self, stage) -> None:  # tidy: thread=loop
        """Wire the replica's async store stage (replica
        attach_store_executor, and the state-sync install). Reads then
        drain it through store_barrier."""
        self._store_stage = stage

    def store_barrier(self) -> None:  # tidy: thread=commit
        """Read-your-writes guard: every queued async store job and the
        current op's deferred store are applied before a store read. A
        stage parked on a corrupt block re-raises its GridReadFault here,
        so the caller's op aborts cleanly (requeued behind the repair)
        instead of reading half-stored state."""
        stage = self._store_stage
        if stage is not None:
            tracer.count("sm.store_barrier_drains")
            with tracer.span("sm.store.barrier"):
                while True:
                    stage.drain()
                    # drain() returns idle or parked. Re-check in a loop:
                    # the loop thread may repair and resume() (requeueing
                    # the faulted job) between the return and this read,
                    # and the queue must then be drained anew.
                    fault = stage.fault
                    if fault is not None and stage.parked:
                        raise fault
                    if stage.idle:
                        break
        self.flush_deferred()

    def flush_deferred(self) -> None:  # tidy: thread=commit
        """Apply the last committed batch's deferred store (read-your-writes
        guard before any store read)."""
        tidy_runtime.assert_role("commit", "loop")
        d = self._deferred_store
        if d is not None:
            self._deferred_store = None
            recs, ts = d
            with tracer.span("sm.ct.store"):
                # Bloom membership was already published at defer time.
                self._store_new_transfers(recs, ts=ts, add_bloom=False)

    def _defer_store(self, recs: np.ndarray, ts=None) -> None:  # tidy: thread=commit
        """Schedule the batch's store work for the next flush_deferred or
        the replica's async store job. Bloom membership is published NOW,
        on the commit thread, so the next batch's duplicate-id pre-filter
        is accurate without a store barrier — the only store state the
        hot path consults ahead of the queued writes."""
        tidy_runtime.assert_role("commit", "loop")
        self.transfer_seen.add(recs["id_lo"], recs["id_hi"])
        self._deferred_store = (recs, ts)

    def take_deferred_store(self):  # tidy: thread=commit
        """Pop the deferred batch for an async store job (replica
        _finish_commit). None when the op stored inline (exact/serial
        paths) or wrote nothing."""
        tidy_runtime.assert_role("commit", "loop")
        d = self._deferred_store
        self._deferred_store = None
        return d

    def _confirm_maybe_ids(self, flagged_keys: np.ndarray) -> bool:  # tidy: thread=commit
        """Duplicate confirm for bloom maybe-hits WITHOUT draining the
        async store stage: the pending write buffer (queued and in-flight
        store jobs) is consulted first, then the durable id index, which
        at that instant misses at most the batches still in the buffer.
        Safe to read concurrently with the store thread: the id index's
        memtable batches are insert-time sorted and flush/compaction
        publish-then-retire (lsm/tree.py). The buffer probe is
        conservative on id_lo alone: a false positive only routes the
        batch to the byte-exact serial path."""
        stage = self._store_stage
        if stage is not None:
            for recs, _ts in stage.unapplied_stores():
                if bool(np.isin(flagged_keys["lo"], recs["id_lo"]).any()):
                    return True
        return self.transfer_index.contains_any(flagged_keys)

    # tidy: thread=commit|store
    def _store_new_transfers(
        self, recs: np.ndarray, ts=None, add_bloom: bool = True
    ) -> None:
        """Append committed transfers to the object log and both indexes
        (reference groove insert: object tree + id tree + secondary
        indexes, groove.zig:138). `ts` optionally overrides the stored
        timestamp column during the log's copy (zero-copy path: the
        caller's event array is not mutated)."""
        tracer.count("sm.stored_transfers", len(recs))
        with tracer.span("sm.store.log"):
            rows = self.transfer_log.append_batch(recs, ts=ts)
            if add_bloom:
                self.transfer_seen.add(recs["id_lo"], recs["id_hi"])
        if not self._store_native(recs, int(rows[0]) if len(rows) else 0):
            with tracer.span("sm.store.idx"):
                self.transfer_index.insert_batch(
                    pack_keys(recs["id_lo"], recs["id_hi"]), rows
                )
            with tracer.span("sm.store.rows"):
                # One coalesced unsorted append (like the native path):
                # account_rows is non-unique and write-heavy — the flush
                # re-sorts the whole memtable, so a per-commit radix pass
                # here is pure waste, and the stable flush sort makes the
                # table bytes identical either way.
                acct_keys = np.concatenate([
                    pack_keys(recs["debit_account_id_lo"], recs["debit_account_id_hi"]),
                    pack_keys(recs["credit_account_id_lo"], recs["credit_account_id_hi"]),
                ])
                self.account_rows.insert_unsorted(
                    acct_keys, np.concatenate([rows, rows])
                )
        self._store_query_index(recs, rows, ts)

    def _store_query_index(self, recs: np.ndarray, rows: np.ndarray, ts) -> None:
        """One batched append of the secondary-index entries for the
        committed rows (tagged composite keys — lsm/scan.py).

        Exactly the QueryFilter-queryable fields are indexed (ud128/64/32,
        ledger, code). The reference also indexes amount, pending_id, and
        timeout (state_machine.zig:207-212) for internal scans this build
        answers elsewhere: pending expiry via the posted groove,
        pending_id resolution via the transfer-id index. Index entries are
        the dominant ingest write-amplification, so unqueryable tags are
        deliberately not maintained."""
        from tigerbeetle_tpu_torch.lsm import scan

        with tracer.span("sm.store.query"):
            tstamp = (
                np.asarray(ts, dtype=np.uint64)
                if ts is not None else recs["timestamp"]
            )
            if self._qindex_device:
                # Stage and dispatch the key build and sort and hand the
                # tree a lazy run: no device-to-host sync here. The bytes
                # come back at a flush (the device fold), a read barrier
                # or the idle prefetch.
                from tigerbeetle_tpu_torch.ops import qindex

                with tracer.span("sm.store.query.keys"):
                    run = qindex.build_run(recs, rows, tstamp, self.device)
                self.query_rows.insert_run_lazy(run)
                return
            # Host route: one preallocated key block filled slice-wise.
            with tracer.span("sm.store.query.keys"):
                tags = (
                    (scan.TAG_UD128, scan.fold56(
                        recs["user_data_128_lo"], recs["user_data_128_hi"]
                    )),
                    (scan.TAG_UD64, scan.fold56(recs["user_data_64"])),
                    (scan.TAG_UD32, scan.fold56(recs["user_data_32"])),
                    (scan.TAG_LEDGER, scan.fold56(recs["ledger"])),
                    (scan.TAG_CODE, scan.fold56(recs["code"])),
                )
                n = len(recs)
                keys = np.empty(len(tags) * n, dtype=scan.KEY_DTYPE)
                klo, khi = keys["lo"], keys["hi"]
                for i, (tag, folded) in enumerate(tags):
                    klo[i * n : (i + 1) * n] = (
                        np.uint64(tag) << np.uint64(56)
                    ) | folded
                    khi[i * n : (i + 1) * n] = tstamp
                vals = np.tile(rows, len(tags))
            if scan.query_columns_constant(recs):
                # Constant queryable columns (fixed ledger/code, unset
                # user_data — the common ingest shape): each tag block
                # holds ONE repeated lo, blocks ascend by tag, so the
                # batch is already lo-major sorted in insertion order.
                # Flagging it sorted routes the flush through the
                # galloping k-way merge (≈ memcpy on dup runs) instead
                # of the full radix re-sort — identical bytes (stable
                # merge of per-batch stable order == stable sort of the
                # concatenation, property-tested).
                self.query_rows.insert_sorted(keys, vals)
            else:
                self.query_rows.insert_unsorted(keys, vals)

    def _store_native(self, recs: np.ndarray, row_base: int) -> bool:
        """C-fused index staging (hostops_build_sorted_kv): builds the
        lo-major sorted (key, row) arrays for both the transfer-id index
        and the account secondary index straight from the wire records —
        one pass each instead of pack/concat/argsort/gather numpy passes.
        Sorted-batch order is bit-identical to the numpy path (same stable
        radix order, same dr-then-cr concat order)."""

        lib = _hostops()
        n = len(recs)
        if n <= 256 or recs.strides[0] != recs.dtype.itemsize:
            return False
        import ctypes

        u32p = ctypes.POINTER(ctypes.c_uint32)
        rec_ptr = ctypes.c_char_p(recs.ctypes.data)
        stride = recs.strides[0]
        with tracer.span("sm.store.idx"):
            id_keys = np.empty(n, dtype=KEY_DTYPE)
            id_vals = np.empty(n, dtype=np.uint32)
            rc = lib.hostops_build_sorted_kv(
                rec_ptr, n, stride, 0, 8, -1, -1, row_base,
                ctypes.c_char_p(id_keys.ctypes.data),
                id_vals.ctypes.data_as(u32p),
            )
            if rc != 0:
                return False
            self.transfer_index.insert_sorted(id_keys, id_vals)
        with tracer.span("sm.store.rows"):
            # Unsorted extraction: account_rows is non-unique and
            # write-heavy — lookup_range scans memtable batches with a
            # mask and the flush re-sorts, so the per-commit radix pass
            # is pure waste here.
            acct_keys = np.empty(2 * n, dtype=KEY_DTYPE)
            acct_vals = np.empty(2 * n, dtype=np.uint32)
            rc = lib.hostops_extract_kv(
                rec_ptr, n, stride, 16, 24, 32, 40, row_base,
                ctypes.c_char_p(acct_keys.ctypes.data),
                acct_vals.ctypes.data_as(u32p),
            )
            if rc != 0:
                # The id insert already landed; finish the account index via
                # the numpy path to stay consistent.
                rows = row_base + np.arange(n, dtype=np.uint32)
                ak = np.concatenate([
                    pack_keys(recs["debit_account_id_lo"], recs["debit_account_id_hi"]),
                    pack_keys(recs["credit_account_id_lo"], recs["credit_account_id_hi"]),
                ])
                self.account_rows.insert_batch(ak, np.concatenate([rows, rows]))
                return True
            self.account_rows.insert_unsorted(acct_keys, acct_vals)
        return True

    # ------------------------------------------------------------------
    # prepare (timestamp assignment, reference state_machine.zig:503-511)

    def prepare(self, operation: str, event_count: int) -> int:
        if operation in ("create_accounts", "create_transfers"):
            self.prepare_timestamp += event_count
        return self.prepare_timestamp

    # ------------------------------------------------------------------
    # compaction beat (upstream forest.compact, forest.zig:319): bounded
    # background storage work between commits, so the commit and its
    # reply do no grid IO.

    def compact_beat(  # tidy: thread=commit|store
        self, max_blocks: int = BEAT_LOG_BLOCKS, flush: bool = True,
    ) -> None:
        """One beat of deferred storage work, driven once per committed op:
        the op's deferred store, then up to `max_blocks` of each object
        log's pending blocks and one bounded compaction step on each
        durable index. Replaying the same ops replays the same beats, so
        grid allocation order (and with it the checkpoint's bytes) is the
        same on every replica.

        flush=False (the replica's async store jobs, which apply their
        op's store before the beat): _deferred_store belongs to the commit
        thread, and reading it from the store thread would race the next
        op's defer."""
        if flush:
            self.flush_deferred()  # the op's store precedes its beat, always
        # Resumable by stage: a GridReadFault in a stage (a corrupt
        # compaction input) aborts that stage, and the retry after repair
        # resumes there; re-running completed stages would give their
        # trees extra beats for this op and change the allocation order.
        quota = self._compact_quota()
        tracer.gauge("sm.compact.quota", quota)
        stages = (
            lambda: self.transfer_log.flush_pending(max_blocks),
            lambda: self.history.flush_pending(max_blocks),
            lambda: self.transfer_index.compact_step(quota),
            lambda: self.account_rows.compact_step(quota),
            lambda: self.query_rows.compact_step(quota),
            lambda: self.posted.compact_step(quota),
            lambda: self.history.compact_step(quota),
        )
        with tracer.span("sm.beat"):
            while self._beat_stage < len(stages):
                stages[self._beat_stage]()
                self._beat_stage += 1
            self._beat_stage = 0

    def _compact_quota(self) -> int:
        """Adaptive beat quota from committed state only: the last batch's
        fill fraction and the trees' compaction backlog, both pure
        functions of the committed op stream, so every replica (and WAL
        replay) computes the same quota for an op. It must not read a
        wall-clock queue depth, which differs between machines."""
        base = self.config.compact_quota_entries
        backlog = self._compact_backlog()
        if backlog == 0:
            return base
        if backlog >= base << 3:
            # Far behind (a storm, or a stalled stretch): catch up hard;
            # commits pay more per op for a while, which costs less than
            # the read amplification of an over-deep tree.
            return base << 2
        fill = self._beat_events / self.config.batch_max
        if fill >= 0.5:
            # Saturated ingest: halve the allowance to keep the beat off
            # the commit path (the backlog bound above limits how long).
            return base >> 1
        if fill <= 0.125:
            return base << 2  # mostly idle: drain the backlog
        return base

    def _compact_backlog(self) -> int:
        return (
            self.transfer_index.compact_backlog()
            + self.account_rows.compact_backlog()
            + self.query_rows.compact_backlog()
            + self.posted.compact_backlog()
            + self.history.compact_backlog()
        )

    def request_major_compaction(self) -> int:
        """Queue a major compaction (storm) on every content tree; returns
        the rows queued. The storms then run through the normal per-op
        beats while the machine keeps serving. A maintenance call, not a
        committed op: a cluster must send it alike to every replica
        (DurableIndex.request_major)."""
        self.store_barrier()
        return (
            self.transfer_index.request_major()
            + self.account_rows.request_major()
            + self.query_rows.request_major()
            + self.posted.request_major()
            + self.history.request_major()
        )

    def compaction_storm_active(self) -> bool:
        return (
            self.transfer_index.storm_active()
            or self.account_rows.storm_active()
            or self.query_rows.storm_active()
            or self.posted.storm_active()
            or self.history.storm_active()
        )

    def bind_thread(self) -> None:
        """Make this machine's device the calling thread's current CUDA
        device (the replica's stage workers call it once, at start). No
        stream is set: every thread launches on the device's default
        stream, which orders the threads' kernels and copies."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def release(self) -> None:  # tidy: thread=commit — the loop calls it only at a state-sync install, with the commit stage quiesced
        """Let go of this machine's device state: a state-sync install
        replaced it with another machine. Closes the open dispatch
        windows, returns the lazy query runs' and a pending compaction
        fold's bytes to the memory ledger and retires its balance and
        scratch entries there, and drops the balance tables and the host
        blocks, so the card holds one set of tables per replica. The
        machine is unusable afterwards."""
        self.create_transfers_abandon_all()
        for tree in (
            self.transfer_index, self.account_rows, self.query_rows,
            self.posted.index, self.history.rows,
        ):
            tree.release_device()
        tracer.device_mem_retire_prefix(f"{self._mem_tag}.")
        self.state = None
        self._disp_scratch = [{} for _ in range(DISPATCH_WINDOW_MAX)]
        self._read_bufs = {}

    def compact_prefetch_one(self) -> bool:
        """Warm one upcoming compaction-input block (idle read-ahead;
        content-neutral, see DurableIndex.compact_prefetch_one)."""
        for tree in (
            self.transfer_index, self.account_rows, self.query_rows,
            self.posted, self.history,
        ):
            if tree.compact_prefetch_one():
                return True
        return False

    # ------------------------------------------------------------------
    # balances access (the balance-table kernels)

    @staticmethod
    def _pad_slots(arrs, k: int, fills) -> list:
        """Pad per-slot arrays to a power-of-two bucket (≥16), as the
        reference does, so the kernels see few distinct shapes. Fill
        values must be inert for the kernel (an out-of-range slot under
        drop mode, a False mask)."""
        n_pad = 1 << max(4, (max(k, 1) - 1).bit_length())
        out = []
        for a, fill in zip(arrs, fills):
            a = np.atleast_1d(np.asarray(a))
            if len(a) == n_pad:
                out.append(a)
                continue
            p = np.full((n_pad, *a.shape[1:]), fill, dtype=a.dtype)
            p[:k] = a
            out.append(p)
        return out

    def _entry(self, name: str) -> str:
        """The device window and call-shape name of kernel entry `name`:
        `sharded.<name>` on a mesh."""
        return name if self.mesh is None else manifest.MESH_ENTRY_PREFIX + name

    def _to_device(self, *arrs) -> list:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrs]

    def _read_balances(self, slots: np.ndarray):
        """The four (k, 4) balance blocks at `slots`, as fresh host arrays
        (views of one (4, k, 4) block of their own). One copy of the padded
        slots in from a pinned buffer, one launch that stores the (4,
        n_pad, 4) block straight into pinned host memory, one sync on an
        event. A mesh whose first dp row spans cards combines the row on
        its first card and copies the four blocks back, with the same one
        sync."""
        k = len(np.atleast_1d(slots))
        n_pad = 1 << max(4, (max(k, 1) - 1).bit_length())
        bufs = self._read_bufs.get(n_pad)
        if bufs is None:
            pin = self.device.type == "cuda"
            bufs = self._read_bufs[n_pad] = (
                torch.empty(n_pad, dtype=torch.int32, pin_memory=pin),
                torch.empty((4, n_pad, 4), dtype=torch.uint32, pin_memory=pin),
            )
        slots_h, block_h = bufs
        # Pad slot 0 (clipped gather rows are sliced away below). The
        # previous call's copy out of the slots and its stores into the
        # block ended at its sync.
        staged = slots_h.numpy()
        staged[:k] = np.atleast_1d(slots)
        staged[k:] = 0
        slots_t = slots_h.to(self.device, non_blocking=True)
        devicestats.note_call(self._entry("read_balances"), (self.state, slots_t))
        with tracer.device_step(self._entry("read_balances")):
            rows = self._ops.read_balances(self.state, slots_t, out=block_h)
            if rows[0].device != block_h.device:
                for dst, r in zip(block_h, rows):
                    dst.copy_(r, non_blocking=True)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
            out = block_h.numpy()[:, :k].copy()
        tracer.device_bytes(h2d=slots_h.nbytes, d2h=block_h.nbytes)
        return tuple(out)

    def _write_balances(self, slots, dp, dpo, cp, cpo) -> None:
        k = len(np.atleast_1d(slots))
        # Pad rows scatter at slot=accounts_max → dropped.
        oob = self.config.accounts_max
        padded = self._pad_slots(
            [np.asarray(slots, dtype=np.int32), dp, dpo, cp, cpo],
            k, [oob, 0, 0, 0, 0],
        )
        args = self._to_device(*padded)
        devicestats.note_call(self._entry("write_balances"), (self.state, *args))
        with tracer.device_step(self._entry("write_balances")):
            self.state = self._ops.write_balances(self.state, *args)
        tracer.device_bytes(h2d=sum(a.nbytes for a in padded))

    def _register_accounts(self, slots, ledger, flags, mask) -> None:
        k = len(np.atleast_1d(slots))
        # Pad rows carry mask=False → never installed.
        padded = self._pad_slots(
            [
                np.asarray(slots, dtype=np.int32),
                np.asarray(ledger, dtype=np.uint32),
                np.asarray(flags, dtype=np.uint32),
                np.asarray(mask),
            ],
            k, [-1, 0, 0, False],
        )
        args = self._to_device(*padded)
        devicestats.note_call(self._entry("register_accounts"), (self.state, *args))
        with tracer.device_step(self._entry("register_accounts")):
            self.state = self._ops.register_accounts(self.state, *args)
        tracer.device_bytes(h2d=sum(a.nbytes for a in padded))

    # ------------------------------------------------------------------
    # create_accounts

    def create_accounts(self, events: np.ndarray, timestamp: Optional[int] = None) -> np.ndarray:
        self.flush_deferred()
        events = np.atleast_1d(events)
        n = len(events)
        self._beat_events = n
        if timestamp is None:
            timestamp = self.prepare("create_accounts", n)
        if n == 0:
            return np.zeros(0, dtype=types.EVENT_RESULT_DTYPE)
        ts = np.uint64(timestamp) - np.uint64(n) + 1 + np.arange(n, dtype=np.uint64)

        flags = events["flags"].astype(np.uint32)
        keys = pack_keys(events["id_lo"], events["id_hi"])

        hard = bool(np.any(flags & np.uint32(AccountFlags.LINKED)))
        if not hard:
            order = np.lexsort((keys["lo"], keys["hi"]))
            sk = keys[order]
            hard = bool(np.any(sk[1:] == sk[:-1])) if n > 1 else False
        if hard:
            return self._create_accounts_serial(events, timestamp)

        code = np.zeros(n, dtype=np.uint32)

        def ladder(cond, result):
            np.copyto(code, np.uint32(int(result)), where=(code == 0) & cond)

        ladder(events["timestamp"] != 0, AR.TIMESTAMP_MUST_BE_ZERO)
        ladder(events["reserved"] != 0, AR.RESERVED_FIELD)
        ladder((flags & np.uint32(AccountFlags.padding_mask())) != 0, AR.RESERVED_FLAG)
        id_zero = (events["id_lo"] == 0) & (events["id_hi"] == 0)
        id_max = (events["id_lo"] == U64_MAX) & (events["id_hi"] == U64_MAX)
        ladder(id_zero, AR.ID_MUST_NOT_BE_ZERO)
        ladder(id_max, AR.ID_MUST_NOT_BE_INT_MAX)
        both = np.uint32(
            AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS
            | AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS
        )
        ladder((flags & both) == both, AR.FLAGS_ARE_MUTUALLY_EXCLUSIVE)
        ladder(
            (events["debits_pending_lo"] != 0) | (events["debits_pending_hi"] != 0),
            AR.DEBITS_PENDING_MUST_BE_ZERO,
        )
        ladder(
            (events["debits_posted_lo"] != 0) | (events["debits_posted_hi"] != 0),
            AR.DEBITS_POSTED_MUST_BE_ZERO,
        )
        ladder(
            (events["credits_pending_lo"] != 0) | (events["credits_pending_hi"] != 0),
            AR.CREDITS_PENDING_MUST_BE_ZERO,
        )
        ladder(
            (events["credits_posted_lo"] != 0) | (events["credits_posted_hi"] != 0),
            AR.CREDITS_POSTED_MUST_BE_ZERO,
        )
        ladder(events["ledger"] == 0, AR.LEDGER_MUST_NOT_BE_ZERO)
        ladder(events["code"] == 0, AR.CODE_MUST_NOT_BE_ZERO)

        # exists ladder (reference state_machine.zig _create_account_exists)
        slots = self.account_index.lookup_batch(keys)
        found = (slots != NOT_FOUND) & (code == 0)
        if np.any(found):
            s = slots[found].astype(np.int64)
            fcode = np.zeros(len(s), dtype=np.uint32)

            def fladder(cond, result):
                np.copyto(fcode, np.uint32(int(result)), where=(fcode == 0) & cond)

            fladder(flags[found] != self.acc_flags[s], AR.EXISTS_WITH_DIFFERENT_FLAGS)
            fladder(
                (events["user_data_128_lo"][found] != self.acc_user_data_128_lo[s])
                | (events["user_data_128_hi"][found] != self.acc_user_data_128_hi[s]),
                AR.EXISTS_WITH_DIFFERENT_USER_DATA_128,
            )
            fladder(
                events["user_data_64"][found] != self.acc_user_data_64[s],
                AR.EXISTS_WITH_DIFFERENT_USER_DATA_64,
            )
            fladder(
                events["user_data_32"][found] != self.acc_user_data_32[s],
                AR.EXISTS_WITH_DIFFERENT_USER_DATA_32,
            )
            fladder(events["ledger"][found] != self.acc_ledger[s], AR.EXISTS_WITH_DIFFERENT_LEDGER)
            fladder(events["code"][found] != self.acc_code[s], AR.EXISTS_WITH_DIFFERENT_CODE)
            fladder(np.ones(len(s), dtype=bool), AR.EXISTS)
            code[found] = fcode

        ok = code == 0
        k = int(ok.sum())
        if self.account_count + k > self.config.accounts_max:
            raise RuntimeError("accounts table full (accounts_max exceeded)")
        if k:
            new_slots = np.arange(self.account_count, self.account_count + k, dtype=np.int64)
            s_all = np.full(n, -1, dtype=np.int32)
            s_all[ok] = new_slots
            self.acc_key[new_slots] = keys[ok]
            self.acc_user_data_128_lo[new_slots] = events["user_data_128_lo"][ok]
            self.acc_user_data_128_hi[new_slots] = events["user_data_128_hi"][ok]
            self.acc_user_data_64[new_slots] = events["user_data_64"][ok]
            self.acc_user_data_32[new_slots] = events["user_data_32"][ok]
            self.acc_ledger[new_slots] = events["ledger"][ok]
            self.acc_code[new_slots] = events["code"][ok]
            self.acc_flags[new_slots] = flags[ok]
            self.acc_timestamp[new_slots] = ts[ok]
            self.account_count += k
            self.account_index.insert_batch(keys[ok], new_slots.astype(np.uint32))
            self._register_accounts(s_all, events["ledger"].astype(np.uint32), flags, ok)
            self.commit_timestamp = int(ts[ok][-1])
        return _codes_to_results(code)

    # ------------------------------------------------------------------
    # create_transfers

    def _ct_stage(self, events: np.ndarray, timestamp: int):
        """One C pass (csrc/hostops.c hostops_ct_stage) over the batch:
        duplicate-id set, bloom pre-filter, slot lookups, the host rungs
        of the fast-path validation ladder, and exact-route bits."""
        import ctypes

        lib = _hostops()
        assert isinstance(self.account_index, NativeU128Map)
        events = np.ascontiguousarray(events)

        n = len(events)
        code = np.empty(n, dtype=np.uint32)
        host_code = np.empty(n, dtype=np.uint32)
        dr_slots = np.empty(n, dtype=np.int64)
        cr_slots = np.empty(n, dtype=np.int64)
        amt_lo = np.empty(n, dtype=np.uint64)
        amt_hi = np.empty(n, dtype=np.uint64)
        pend = np.empty(n, dtype=np.uint8)
        maybe = np.empty(n, dtype=np.uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        bloom = self.transfer_seen
        bloom_ptr = (
            bloom.words.ctypes.data_as(u64p) if bloom.count else None
        )
        acc_ledger = self.acc_ledger
        acc_flags = self.acc_flags
        bits = lib.hostops_ct_stage(
            ctypes.c_char_p(events.ctypes.data), n, events.strides[0],
            int(timestamp) - n + 1,
            self.account_index._h,
            acc_ledger.ctypes.data_as(u32p), acc_flags.ctypes.data_as(u32p),
            bloom_ptr, int(bloom._mask),
            code.ctypes.data_as(u32p), host_code.ctypes.data_as(u32p),
            dr_slots.ctypes.data_as(i64p), cr_slots.ctypes.data_as(i64p),
            amt_lo.ctypes.data_as(u64p), amt_hi.ctypes.data_as(u64p),
            pend.ctypes.data_as(u8p), maybe.ctypes.data_as(u8p),
        )
        if bits < 0:
            raise MemoryError("hostops_ct_stage: scratch allocation failed")
        return (code, host_code, dr_slots, cr_slots, amt_lo, amt_hi,
                pend, maybe, bits)

    def create_transfers(self, events: np.ndarray, timestamp: Optional[int] = None) -> np.ndarray:
        # The overlapped pipeline must finish (or abandon) its dispatched
        # handles before any op takes the single-phase path — interleaving
        # would reorder stores against the kernel chain. (The stale-gen
        # refire inside create_transfers_finish is the one sanctioned
        # exception: it gen-fences every outstanding handle first and
        # enters through _create_transfers_impl.)
        assert not self._ct_pending, "unfinished split-phase dispatch"
        return self._create_transfers_impl(events, timestamp)

    def _create_transfers_impl(
        self, events: np.ndarray, timestamp: Optional[int] = None
    ) -> np.ndarray:
        self.flush_deferred()
        events = np.atleast_1d(events)
        n = len(events)
        self._beat_events = n
        if timestamp is None:
            timestamp = self.prepare("create_transfers", n)
        if n == 0:
            return np.zeros(0, dtype=types.EVENT_RESULT_DTYPE)

        with tracer.span("sm.ct.stage"):
            staged = self._ct_stage(events, timestamp)
        return self._create_transfers_staged(events, timestamp, staged)

    def _commit_fast_device(
        self, events, ts, dr_slots, cr_slots, host_code, timestamp
    ) -> np.ndarray:
        """Tail of the single-phase device route: pack, run the fast
        kernel, bail to serial on overflow, store OK rows."""
        n = len(events)
        b, host_code_p = self._device_batch(events, ts, dr_slots, cr_slots, host_code)
        devicestats.note_call(
            self._entry("create_transfers_fast"), (self.state, b, host_code_p),
            bucket=len(host_code_p),
        )
        t_disp = tracer.device_dispatch(
            self._entry("create_transfers_fast"), h2d_bytes=_staged_nbytes(b, host_code_p)
        )
        with tracer.span("sm.create_transfers.fast"):
            new_state, codes_dev, bail = self._ops.create_transfers_fast(
                self.state, b, host_code_p
            )
        if bool(bail):  # waits for the kernel: the step's sync point
            # The bail sync ends the device step: close the window here
            # or the dispatch/step counters diverge on bail-heavy loads.
            tracer.device_finish(self._entry("create_transfers_fast"), t_disp)
            self.stats["bail_batches"] += 1
            return self._create_transfers_serial(events, timestamp)
        self.state = new_state
        self.stats["fast_batches"] += 1
        codes_h = codes_dev.cpu().numpy()
        tracer.device_finish(self._entry("create_transfers_fast"), t_disp, d2h_bytes=codes_h.nbytes)
        codes = codes_h[:n]

        ok = codes == 0
        if np.any(ok):
            if ok.all():
                # Zero-copy defer: the log's append stamps timestamps
                # during its own copy.
                self._defer_store(events, ts)
            else:
                recs = events[ok].copy()
                recs["timestamp"] = ts[ok]
                self._defer_store(recs)
            self.commit_timestamp = int(ts[ok][-1])
        return _codes_to_results(codes)

    # --- split-phase device dispatch (double-buffered commit pipeline) --
    #
    # The serial device path strictly alternates: pack batch N, dispatch
    # its kernel, BLOCK on np.asarray(codes) device→host sync, store, then
    # batch N+1. The split-phase pair lets the commit pipeline dispatch
    # batch N+1's validate/balance kernel while batch N's sync is still in
    # flight — device compute overlaps host post-processing. Determinism:
    # results are byte-identical to the serial path because (a) only
    # batches whose routing is INDEPENDENT of the outstanding batch are
    # dispatched ahead (id-disjointness guard below — the dup check of
    # batch N+1 must see batch N's stored ids), and (b) stores still land
    # strictly in op order (dispatch writes nothing; finish stores).

    def create_transfers_dispatch(self, events: np.ndarray, timestamp: int):
        """Stage + dispatch the device fast kernel WITHOUT syncing.
        Returns a handle for create_transfers_finish, or None when the
        batch routes anywhere but the fast device path (duplicates,
        exact-kernel flags, pending/post-void, id overlap with the
        outstanding handle) — the caller then runs the
        ordinary create_transfers at its op's turn. Nothing here waits for
        the device: the staging copy is asynchronous from pinned memory and
        the kernel is queued behind it on the current stream. On a mesh
        every batch runs at its op's turn (None), as in the reference."""
        if self.mesh is not None:
            return None
        if len(self._ct_pending) >= DISPATCH_WINDOW_MAX:
            # Window full: refuse — the caller settles the oldest batch
            # first (a pipeline stall, never corruption). Also keeps the
            # scratch ring's slot-reuse distance ≥ the in-flight count.
            return None
        events = np.atleast_1d(events)
        n = len(events)
        if n == 0:
            return None
        self.flush_deferred()
        staged = self._ct_stage(events, timestamp)
        (code, host_code, dr_slots, cr_slots, _alo, _ahi,
         _pend, maybe_u8, bits) = staged
        # bit 1: in-batch duplicate ids → serial; bit 2: exact route;
        # bit 8: post/void (their batches are exact or serial). The exact
        # route is synchronous: its batches run at their op's turn.
        if bits & (1 | 2 | 8):
            return None
        if self._ct_pending:
            # An outstanding batch's OK ids are not in the bloom/index yet
            # (its store happens at finish): any id overlap (or a
            # post/void naming one) would mis-validate — refuse to
            # dispatch ahead. Conservative on id_lo alone: false positives
            # only cost the overlap, never correctness. One concatenated
            # membership probe over every outstanding handle (two scans
            # total), not two scans per handle — this runs per dispatch
            # on the hot commit path at window depth up to 8.
            outstanding = (
                self._ct_pending[0]["id_lo"] if len(self._ct_pending) == 1
                else np.concatenate([p["id_lo"] for p in self._ct_pending])
            )
            if bool(np.isin(events["id_lo"], outstanding).any()) or bool(
                np.isin(events["pending_id_lo"], outstanding).any()
            ):
                return None
        if bits & 4:
            # Bloom maybe-hits: confirm against the durable id index (a
            # GridReadFault here aborts the dispatch cleanly; nothing was
            # mutated).
            m = maybe_u8.astype(bool)
            if self._confirm_maybe_ids(
                pack_keys(events["id_lo"][m], events["id_hi"][m])
            ):
                return None
        ts = np.uint64(timestamp) - np.uint64(n) + 1 + np.arange(n, dtype=np.uint64)
        b, host_code_p = self._device_batch(events, ts, dr_slots, cr_slots, host_code)
        devicestats.note_call(
            "create_transfers_fast", (self.state, b, host_code_p),
            bucket=len(host_code_p),
        )
        with tracer.span("sm.ct.dispatch"):
            new_state, codes_dev, bail_dev = self._ops.create_transfers_fast(
                self.state, b, host_code_p
            )
        handle = {
            "events": events, "ts": ts, "timestamp": timestamp, "n": n,
            "codes": codes_dev, "bail": bail_dev,
            "prev_state": self.state, "gen": self._state_gen,
            "id_lo": events["id_lo"],
            # Device-step profiler: dispatch timestamp; finish closes the
            # dispatch→finish window — device time isolated from the host
            # work between the two calls. (No materialization here: this
            # function never synchronises with the device.)
            "t_disp": tracer.device_dispatch(
                "create_transfers_fast",
                h2d_bytes=_staged_nbytes(b, host_code_p),
            ),
        }
        # Chain optimistically: batch N+1's kernel may consume this token
        # before N's sync lands (the device orders the data dependency).
        self.state = new_state
        self._ct_pending.append(handle)
        return handle

    def create_transfers_finish(self, handle) -> np.ndarray:
        """Sync + store the dispatched batch; byte-identical results to
        the single-phase path (bail falls back to serial exactly as
        _commit_fast_device does)."""
        assert self._ct_pending and handle is self._ct_pending[0], (
            "split-phase finish out of dispatch order"
        )
        self._ct_pending.pop(0)
        events, timestamp, n = handle["events"], handle["timestamp"], handle["n"]
        self._beat_events = n
        if handle["gen"] != self._state_gen:
            # An earlier batch in the chain bailed and rolled the state
            # token back: this kernel consumed a revoked token — discard
            # and re-execute from the current (correct) state. The refire
            # mutates state that any LATER outstanding handle's kernel
            # did not observe, so fence those too (they will refire in
            # turn at their own finish).
            tracer.device_finish("create_transfers_fast", handle.get("t_disp", 0))
            self._state_gen += 1
            return self._create_transfers_impl(events, timestamp)
        if bool(handle["bail"]):  # waits for the kernel: the sync point
            tracer.device_finish("create_transfers_fast", handle.get("t_disp", 0))
            self.state = handle["prev_state"]
            self._state_gen += 1
            self.stats["bail_batches"] += 1
            return self._create_transfers_serial(events, timestamp)
        self.stats["fast_batches"] += 1
        ts = handle["ts"]
        codes_h = handle["codes"].cpu().numpy()
        tracer.device_finish(
            "create_transfers_fast", handle.get("t_disp", 0),
            d2h_bytes=codes_h.nbytes,
        )
        codes = codes_h[:n]
        ok = codes == 0
        if np.any(ok):
            if ok.all():
                self._defer_store(events, ts)
            else:
                recs = events[ok].copy()
                recs["timestamp"] = ts[ok]
                self._defer_store(recs)
            self.commit_timestamp = int(ts[ok][-1])
        return _codes_to_results(codes)

    def create_transfers_abandon_all(self) -> None:
        """Discard EVERY dispatched-but-unfinished handle (depth-N window
        reclaim behind a grid repair): roll the state token back to the
        oldest LIVE handle's pre-dispatch value — live handles form a
        suffix of the FIFO (gen only moves forward), and the oldest live
        base is the state before any abandoned kernel in the current
        chain ran. Stale handles' bases predate a rollback that already
        happened below them (a bail refire rebuilt state past their
        base), so restoring one would clobber the corrected state."""
        if not self._ct_pending:
            return
        live = next(
            (h for h in self._ct_pending if h["gen"] == self._state_gen),
            None,
        )
        for h in self._ct_pending:
            tracer.device_finish("create_transfers_fast", h.get("t_disp", 0))
        self._ct_pending.clear()
        if live is not None:
            self.state = live["prev_state"]
            self._state_gen += 1

    def dispatch_depth_default(self) -> int:
        """Adaptive cross-batch commit-window depth (the replica's
        commit_depth): min(pipeline_max, 4) on CUDA, where dispatch-ahead
        buys real overlap (the card executes batch N+1 while the host
        drains batch N's store/reply); 1 on the CPU, where the "device"
        work shares the host cores and dispatch-ahead only reorders
        work, and on a mesh, whose batches never take the split-phase
        path."""
        if self.device.type == "cuda" and self.mesh is None:
            return min(self.config.pipeline_max, 4)
        return 1

    def _create_transfers_staged(
        self, events: np.ndarray, timestamp: int, staged
    ) -> np.ndarray:
        """Routing + commit from the C-staged batch."""
        (code, host_code, dr_slots, cr_slots, amt_lo, amt_hi,
         pend_u8, maybe_u8, bits) = staged
        n = len(events)
        ts = np.uint64(timestamp) - np.uint64(n) + 1 + np.arange(n, dtype=np.uint64)

        # bit 1: duplicate ids within the batch → serial.
        hard = bool(bits & 1)
        if not hard and (bits & 4):
            # Bloom hits: stored ids (or ~2% false positives) — confirm
            # against the durable id index for just the flagged keys.
            with tracer.span("sm.ct.dupcheck"):
                m = maybe_u8.astype(bool)
                hard = self._confirm_maybe_ids(
                    pack_keys(events["id_lo"][m], events["id_hi"][m])
                )
        is_pv = None
        if not hard and (bits & 8):
            # bit 8: post/void events. One naming a pending created in this
            # same batch → serial (the store cannot resolve it yet).
            is_pv = (events["flags"] & np.uint16(_PV_FLAGS)) != 0
            hard = _names_batch_id(events, is_pv)
        if hard:
            self.stats["serial_batches"] += 1
            with tracer.span("sm.create_transfers.serial"):
                return self._create_transfers_serial(events, timestamp)
        # bit 2: exact-route flags or limit/history accounts.
        if bits & 2:
            if is_pv is None:
                is_pv = (events["flags"] & np.uint16(_PV_FLAGS)) != 0
            with tracer.span("sm.create_transfers.exact"):
                return self._create_transfers_exact(
                    events, ts, dr_slots, cr_slots, host_code, timestamp, is_pv
                )
        return self._commit_fast_device(
            events, ts, dr_slots, cr_slots, host_code, timestamp
        )

    # The staged batch block: (column, uint32 words per event), in
    # order. One pinned host buffer per (ring slot, bucket) holds them
    # all, so a batch crosses to the device in one asynchronous copy.
    _BATCH_COLS = (
        ("id", 4), ("dr_slot", 1), ("cr_slot", 1), ("amount", 4),
        ("pending_id", 4), ("timeout", 1), ("ledger", 1), ("code", 1),
        ("flags", 1), ("timestamp", 2), ("host_code", 1),
    )

    def _staging(self, scratch: dict, kind: str, spec, n_pad: int):
        """The pinned host block of `spec` (column, uint32 words per
        event) for `kind` in one scratch-ring slot, allocated at first
        use per bucket: (buffer, {column: (n_pad, words) numpy view})."""
        buf = scratch.get((kind, n_pad))
        if buf is None:
            buf = scratch[(kind, n_pad)] = torch.empty(
                sum(w for _, w in spec) * n_pad, dtype=torch.uint32,
                pin_memory=self.device.type == "cuda",
            )
        host = buf.numpy()
        cols = {}
        off = 0
        for name, w in spec:
            cols[name] = host[off * n_pad:(off + w) * n_pad].reshape(n_pad, w)
            off += w
        return buf, cols

    def _to_device_cols(self, buf: torch.Tensor, spec, n_pad: int) -> dict:
        """One non-blocking copy of a staging block to the device, cut
        into its columns ((n_pad,) for one word, (n_pad, w) otherwise)."""
        dev = buf.to(self.device, non_blocking=True)
        out = {}
        off = 0
        for name, w in spec:
            t = dev[off * n_pad:(off + w) * n_pad]
            out[name] = t.view(n_pad, w) if w > 1 else t
            off += w
        return out

    def _device_batch(self, events, ts, dr_slots, cr_slots, host_code):
        """Pack events into the kernel's SoA form, padded to a power-of-two
        bucket. Padding events carry a nonzero host code (never applied)
        and are stripped from the results.

        The padded block is written into the dispatch scratch ring's next
        slot (one pinned host buffer per in-flight generation, lazily
        allocated per bucket size) and copied to the device with one
        non-blocking copy on the current stream, ahead of the kernel that
        reads it. The depth-N commit window stages up to
        DISPATCH_WINDOW_MAX batches before the oldest finishes, and slot
        reuse only comes around after that many later dispatches — by
        which point the slot's previous copy has completed (finish
        synchronises before returning)."""
        n = len(events)
        n_pad = 1 << max(4, (n - 1).bit_length())
        scratch = self._disp_scratch[self._disp_seq % DISPATCH_WINDOW_MAX]
        self._disp_seq += 1
        buf, cols = self._staging(scratch, "batch", self._BATCH_COLS, n_pad)
        with tracer.span("sm.ct.pack"):
            for name in ("id", "amount", "pending_id"):
                pair = cols[name][:n].view(np.uint64)  # (n, 2): lo, hi
                pair[:, 0] = events[f"{name}_lo"]
                pair[:, 1] = events[f"{name}_hi"]
            cols["timestamp"][:n].view(np.uint64)[:, 0] = ts
            cols["dr_slot"].view(np.int32)[:n, 0] = dr_slots
            cols["cr_slot"].view(np.int32)[:n, 0] = cr_slots
            for name in ("timeout", "ledger", "code", "flags"):
                cols[name][:n, 0] = events[name]
            cols["host_code"][:n, 0] = host_code
            if n_pad != n:  # padding rows stay inert
                for name, _ in self._BATCH_COLS:
                    cols[name][n:] = 0
                cols["dr_slot"].view(np.int32)[n:] = commit_ops.NOT_FOUND
                cols["cr_slot"].view(np.int32)[n:] = commit_ops.NOT_FOUND
                cols["host_code"][n:] = int(TR.ID_MUST_NOT_BE_ZERO)
        out = self._to_device_cols(buf, self._BATCH_COLS, n_pad)
        for name in ("dr_slot", "cr_slot"):
            out[name] = out[name].view(torch.int32)
        host_code_p = out.pop("host_code")
        self._scratch_note(n_pad)
        return self._ops.TransferBatch(**out), host_code_p

    # The exact route's pending context and chains, staged like the batch:
    # (column, uint32 words per event), in one pinned block per (ring
    # slot, bucket), crossing to the device in one asynchronous copy.
    _EXACT_COLS = (
        ("found", 1), ("amount", 4), ("dr_slot", 1), ("cr_slot", 1),
        ("timestamp", 2), ("timeout", 1), ("base_fulfillment", 1),
        ("group", 1), ("chain_id", 1),
    )

    def _device_exact(self, pinfo: Dict[str, np.ndarray], chain_id: np.ndarray, n_pad: int):
        """PendingInfo and chain_id padded to the bucket (padding events:
        not found, no accounts, their own chain, group n_pad) and copied
        to the device from the scratch slot `_device_batch` just used."""
        n = len(chain_id)
        scratch = self._disp_scratch[(self._disp_seq - 1) % DISPATCH_WINDOW_MAX]
        buf, cols = self._staging(scratch, "exact", self._EXACT_COLS, n_pad)
        with tracer.span("sm.ct.pack"):
            cols["found"][:n, 0] = pinfo["found"]
            cols["amount"][:n] = pinfo["amount"]
            cols["timestamp"][:n].view(np.uint64)[:, 0] = pinfo["timestamp"]
            for name in ("dr_slot", "cr_slot", "timeout", "base_fulfillment", "group"):
                cols[name][:n, 0] = pinfo[name].view(np.uint32)
            cols["chain_id"][:n, 0] = chain_id
            if n_pad != n:
                for name, _ in self._EXACT_COLS:
                    cols[name][n:] = 0
                for name in ("dr_slot", "cr_slot"):
                    cols[name].view(np.int32)[n:] = -1
                cols["base_fulfillment"].view(np.int32)[n:] = commit_exact.FULFILL_NONE
                cols["group"][n:] = n_pad
                cols["chain_id"][n:, 0] = np.arange(n, n_pad, dtype=np.uint32)
        out = self._to_device_cols(buf, self._EXACT_COLS, n_pad)
        for name in ("dr_slot", "cr_slot", "base_fulfillment", "group", "chain_id"):
            out[name] = out[name].view(torch.int32)
        out["found"] = out["found"].view(torch.int32) != 0
        chain_t = out.pop("chain_id")
        return commit_exact.PendingInfo(**out), chain_t

    def _exact_prefetch(self, events: np.ndarray, is_pv: np.ndarray):
        """Host prefetch of post/void events: resolve pending_id against
        the id index and object log, and evaluate the store-dependent
        rungs (codes 25-30) the device cannot (upstream prefetch,
        state_machine.zig:560-655).

        Returns (pv_code, pinfo dict of per-event numpy arrays,
        pending_recs, p_rec_idx), where p_rec_idx maps each event to its
        row of pending_recs (-1 for other and not-found events)."""
        n = len(events)
        found = np.zeros(n, dtype=bool)
        amount = np.zeros((n, 4), dtype=np.uint32)
        p_dr = np.full(n, -1, dtype=np.int32)
        p_cr = np.full(n, -1, dtype=np.int32)
        p_ts = np.zeros(n, dtype=np.uint64)
        p_timeout = np.zeros(n, dtype=np.uint32)
        base = np.full(n, commit_exact.FULFILL_NONE, dtype=np.int32)
        group = np.full(n, n, dtype=np.int32)
        pv_code = np.zeros(n, dtype=np.uint32)
        p_rec_idx = np.full(n, -1, dtype=np.int64)
        pending_recs = np.zeros(0, dtype=types.TRANSFER_DTYPE)
        pinfo = dict(
            found=found, amount=amount, dr_slot=p_dr, cr_slot=p_cr,
            timestamp=p_ts, timeout=p_timeout, base_fulfillment=base, group=group,
        )
        if not np.any(is_pv):
            return pv_code, pinfo, pending_recs, p_rec_idx

        pv_ix = np.nonzero(is_pv)[0]
        pkeys = pack_keys(events["pending_id_lo"][is_pv], events["pending_id_hi"][is_pv])
        # Same referenced pending ⇒ same fulfillment group (the first
        # successful post/void wins).
        _, inv = np.unique(pkeys, return_inverse=True)
        group[pv_ix] = inv.astype(np.int32)
        rows = self.transfer_index.lookup_batch(pkeys)
        has = rows != NOT_FOUND
        pv_code[pv_ix[~has]] = np.uint32(int(TR.PENDING_TRANSFER_NOT_FOUND))
        if np.any(has):
            hit = pv_ix[has]
            urows, uinv = np.unique(rows[has].astype(np.int64), return_inverse=True)
            pending_recs = self.transfer_log.gather(urows)
            p_rec_idx[hit] = uinv
            prec = pending_recs[uinv]
            c = np.zeros(len(hit), dtype=np.uint32)

            def fl(cond, result):
                np.copyto(c, np.uint32(int(result)), where=(c == 0) & cond)

            fl((prec["flags"] & np.uint16(TransferFlags.PENDING)) == 0,
               TR.PENDING_TRANSFER_NOT_PENDING)
            for side, result in (
                ("debit", TR.PENDING_TRANSFER_HAS_DIFFERENT_DEBIT_ACCOUNT_ID),
                ("credit", TR.PENDING_TRANSFER_HAS_DIFFERENT_CREDIT_ACCOUNT_ID),
            ):
                lo = events[f"{side}_account_id_lo"][hit]
                hi = events[f"{side}_account_id_hi"][hit]
                given = (lo != 0) | (hi != 0)
                differs = (lo != prec[f"{side}_account_id_lo"]) | (hi != prec[f"{side}_account_id_hi"])
                fl(given & differs, result)
            for f, result in (
                ("ledger", TR.PENDING_TRANSFER_HAS_DIFFERENT_LEDGER),
                ("code", TR.PENDING_TRANSFER_HAS_DIFFERENT_CODE),
            ):
                fl((events[f][hit] != 0) & (events[f][hit] != prec[f]), result)
            pv_code[hit] = c

            found[hit] = True
            amount[hit] = types.u64_pair_to_limbs(prec["amount_lo"], prec["amount_hi"])
            for out, side in ((p_dr, "debit"), (p_cr, "credit")):
                slots = self.account_index.lookup_batch(
                    pack_keys(prec[f"{side}_account_id_lo"], prec[f"{side}_account_id_hi"])
                )
                out[hit] = np.where(slots == NOT_FOUND, -1, slots.astype(np.int64))
            p_ts[hit] = prec["timestamp"]
            p_timeout[hit] = prec["timeout"]
            base_u = self.posted.get_many(pending_recs["timestamp"], commit_exact.FULFILL_NONE)
            base[hit] = base_u[uinv]
        return pv_code, pinfo, pending_recs, p_rec_idx

    def _create_transfers_exact(
        self, events, ts, dr_slots, cr_slots, host_code, timestamp, is_pv
    ) -> np.ndarray:
        """Order-dependent batches through the fixed-point sweep kernel
        (ops/commit_exact.py): balancing clamps, limit flags, history,
        linked chains and pending post/void. The device builds the batch's
        sort plan (the kernel's plan=None branch); a bail re-runs the
        batch serially."""
        # The prefetch reads the id index, object log and posted groove,
        # and the tail writes grooves inline: queued async store jobs land
        # first (the stage is then idle for the inline writes too).
        self.store_barrier()
        n = len(events)
        pv_code, pinfo_np, pending_recs, p_rec_idx = self._exact_prefetch(events, is_pv)

        # The post/void store rungs (25-30) sit between the host ladder's
        # early rungs and the device's late ones: nonzero minimum.
        big = np.uint32(0xFFFFFFFF)
        merged = np.minimum(
            np.where(host_code == 0, big, host_code), np.where(pv_code == 0, big, pv_code)
        )
        host_code = np.where(merged == big, np.uint32(0), merged)

        # Linked-chain segments: contiguous, chain id = head index. An
        # unterminated trailing chain fails with CHAIN_OPEN before any other
        # rung (oracle._execute).
        linked = (events["flags"] & np.uint16(TransferFlags.LINKED)) != 0
        new_chain = np.ones(n, dtype=bool)
        new_chain[1:] = ~linked[:-1]
        chain_id = np.maximum.accumulate(np.where(new_chain, np.arange(n), 0)).astype(np.int32)
        if linked[n - 1]:
            host_code[n - 1] = np.uint32(int(TR.LINKED_EVENT_CHAIN_OPEN))

        b, host_code_p = self._device_batch(events, ts, dr_slots, cr_slots, host_code)
        n_pad = int(b.flags.shape[0])
        pinfo, chain_t = self._device_exact(pinfo_np, chain_id, n_pad)
        has_pv, has_chains = bool(np.any(is_pv)), bool(np.any(linked))
        devicestats.note_call(
            self._entry("create_transfers_exact"),
            (self.state, b, host_code_p, pinfo, chain_t, None),
            {"has_pv": has_pv, "has_chains": has_chains}, bucket=n_pad,
        )
        # Without a host plan the exact entry first launches the device
        # sort plan (ops/commit_exact.sort_plan) on the same batch.
        devicestats.note_call(
            self._entry("exact_sort_plan"),
            (b, pinfo, chain_t, self.config.accounts_max), bucket=n_pad,
        )
        t_disp = tracer.device_dispatch(
            self._entry("create_transfers_exact"),
            h2d_bytes=_staged_nbytes(b, host_code_p) + _staged_nbytes(pinfo, chain_t),
        )
        new_state, codes_dev, amounts_dev, dr_after, cr_after, bail = (
            self._ops.create_transfers_exact(
                self.state, b, host_code_p, pinfo, chain_t, None,
                has_pv=has_pv, has_chains=has_chains,
            )
        )
        if bool(bail):  # waits for the kernel: the step's sync point
            tracer.device_finish(self._entry("create_transfers_exact"), t_disp)
            self.stats["bail_batches"] += 1
            return self._create_transfers_serial(events, timestamp)
        self.state = new_state
        self.stats["exact_batches"] += 1
        codes_h = codes_dev.cpu().numpy()
        amounts_h = amounts_dev.cpu().numpy()
        tracer.device_finish(
            self._entry("create_transfers_exact"), t_disp,
            d2h_bytes=codes_h.nbytes + amounts_h.nbytes,
        )
        codes = codes_h[:n]
        ok = codes == 0
        if not np.any(ok):
            return _codes_to_results(codes)

        # Transfers are stored with their post-clamp amounts
        # (state_machine.zig:1330); post/void records take their accounts,
        # ledger, code and unset user data from the pending
        # (state_machine.zig:1462-1480).
        amt_lo, amt_hi = types.limbs_to_u64_pair(amounts_h[:n])
        recs = events[ok].copy()
        recs["timestamp"] = ts[ok]
        recs["amount_lo"] = amt_lo[ok]
        recs["amount_hi"] = amt_hi[ok]
        sel = is_pv[ok]
        if np.any(sel):
            pi = p_rec_idx[ok][sel]
            assert np.all(pi >= 0), "an ok post/void resolved its pending"
            prec = pending_recs[pi]
            for f in (
                "debit_account_id_lo", "debit_account_id_hi",
                "credit_account_id_lo", "credit_account_id_hi", "ledger", "code",
            ):
                recs[f][sel] = prec[f]
            recs["timeout"][sel] = 0
            ud128_zero = (recs["user_data_128_lo"][sel] == 0) & (recs["user_data_128_hi"][sel] == 0)
            for f in ("user_data_128_lo", "user_data_128_hi"):
                recs[f][sel] = np.where(ud128_zero, prec[f], recs[f][sel])
            for f in ("user_data_64", "user_data_32"):
                recs[f][sel] = np.where(recs[f][sel] == 0, prec[f], recs[f][sel])
        self._store_new_transfers(recs)
        self.commit_timestamp = int(ts[ok][-1])

        # Posted-groove updates (upstream PostedGroove insert).
        pv_ok_ix = np.nonzero(ok & is_pv)[0]
        if len(pv_ok_ix):
            posted_ok = (
                events["flags"][pv_ok_ix] & np.uint16(TransferFlags.POST_PENDING_TRANSFER)
            ) != 0
            self.posted.insert_arrays(
                pending_recs["timestamp"][p_rec_idx[pv_ok_ix]],
                np.where(
                    posted_ok, np.uint32(oracle_mod.FULFILLMENT_POSTED),
                    np.uint32(oracle_mod.FULFILLMENT_VOIDED),
                ),
            )

        # History rows from the kernel's post-event balances
        # (state_machine.zig:1342-1364), in event order; post/void writes
        # no history row.
        hist_flag = np.uint32(AccountFlags.HISTORY)
        dr_hist = np.zeros(n, dtype=bool)
        cr_hist = np.zeros(n, dtype=bool)
        dr_valid, cr_valid = dr_slots >= 0, cr_slots >= 0
        dr_hist[dr_valid] = (self.acc_flags[dr_slots[dr_valid]] & hist_flag) != 0
        cr_hist[cr_valid] = (self.acc_flags[cr_slots[cr_valid]] & hist_flag) != 0
        need = ok & (dr_hist | cr_hist) & ~is_pv
        if np.any(need):
            from tigerbeetle_tpu_torch.lsm.groove import HISTORY_DTYPE

            ix = np.nonzero(need)[0]
            rows = np.zeros(len(ix), dtype=HISTORY_DTYPE)
            rows["timestamp"] = ts[ix]
            for side, side_hist, slots_all, after in (
                ("dr", dr_hist, dr_slots, dr_after), ("cr", cr_hist, cr_slots, cr_after),
            ):
                m = side_hist[ix]
                if not m.any():
                    continue
                s = slots_all[ix[m]]
                rows[f"{side}_account_id_lo"][m] = self.acc_key["lo"][s]
                rows[f"{side}_account_id_hi"][m] = self.acc_key["hi"][s]
                for fld, limbs in zip(commit_ops.BALANCE_FIELDS, after):
                    lo_c, hi_c = types.limbs_to_u64_pair(limbs.cpu().numpy()[:n][ix[m]])
                    rows[f"{side}_{fld}_lo"][m] = lo_c
                    rows[f"{side}_{fld}_hi"][m] = hi_c
            self.history.append_batch(rows)
        return _codes_to_results(codes)

    # Dispatches a scratch bucket may sit idle before retirement. Large
    # enough that a bucket in ANY live dispatch window (≤ DISPATCH_
    # WINDOW_MAX old) can never be reclaimed under a kernel; small
    # enough that a workload shift frees the old buckets within one
    # bench section. Class attribute so tests can force fast churn.
    SCRATCH_STALE_AFTER = 512

    def _scratch_note(self, n_pad: int) -> None:
        """Device-memory-ledger upkeep per dispatch: stamp the bucket's
        last use, publish its live bytes (summed over every ring slot)
        as the `device.mem.<tag>.scratch.b<n_pad>.bytes` gauge, and retire
        buckets the workload stopped using (satellite: the registry and
        the ring stay bounded under bucket churn)."""
        self._scratch_last_use[n_pad] = self._disp_seq
        if tracer.enabled():
            nbytes = sum(
                a.nbytes
                for slot in self._disp_scratch
                for (_, bkt), a in slot.items()
                if bkt == n_pad
            )
            tracer.device_mem_set(f"{self._mem_tag}.scratch.b{n_pad}", nbytes)
            tracer.device_mem_set(f"{self._mem_tag}.balances", self._balances_nbytes)
        if len(self._scratch_last_use) > 1:
            stale = [
                b for b, last in self._scratch_last_use.items()
                if self._disp_seq - last > self.SCRATCH_STALE_AFTER
            ]
            for b in stale:
                self._scratch_retire(b)

    def _scratch_retire(self, n_pad: int) -> None:
        """Free one stale bucket: its staging buffers in every ring
        slot, its owner gauge, and its devicestats shape/cost rows.
        Safe by construction — a bucket referenced by an in-flight
        handle was used within DISPATCH_WINDOW_MAX dispatches, far
        inside SCRATCH_STALE_AFTER."""
        for slot in self._disp_scratch:
            for key in [k for k in slot if k[1] == n_pad]:
                del slot[key]
        self._scratch_last_use.pop(n_pad, None)
        tracer.device_mem_retire_prefix(f"{self._mem_tag}.scratch.b{n_pad}")
        devicestats.retire_bucket(n_pad)

    # ------------------------------------------------------------------
    # serial (exact) path — runs the oracle over lazily-prefetched state

    def _account_by_slot(self, slot: int, bal: Tuple) -> oracle_mod.Account:
        key = self.acc_key[slot]
        return oracle_mod.Account(
            id=int(key["lo"]) | (int(key["hi"]) << 64),
            debits_pending=bal[0],
            debits_posted=bal[1],
            credits_pending=bal[2],
            credits_posted=bal[3],
            user_data_128=int(self.acc_user_data_128_lo[slot])
            | (int(self.acc_user_data_128_hi[slot]) << 64),
            user_data_64=int(self.acc_user_data_64[slot]),
            user_data_32=int(self.acc_user_data_32[slot]),
            ledger=int(self.acc_ledger[slot]),
            code=int(self.acc_code[slot]),
            flags=int(self.acc_flags[slot]),
            timestamp=int(self.acc_timestamp[slot]),
        )

    def _slot_of_id(self, ident: int) -> int:
        keys = pack_keys(
            np.array([ident & U64_MAX], dtype=np.uint64),
            np.array([ident >> 64], dtype=np.uint64),
        )
        slot = self.account_index.lookup_batch(keys)[0]
        return -1 if slot == NOT_FOUND else int(slot)

    def _fetch_account(self, ident: int) -> Optional[oracle_mod.Account]:
        slot = self._slot_of_id(ident)
        if slot < 0:
            return None
        dp, dpo, cp, cpo = self._read_balances(np.array([slot]))
        bal = (
            types.limbs_to_int(dp[0]), types.limbs_to_int(dpo[0]),
            types.limbs_to_int(cp[0]), types.limbs_to_int(cpo[0]),
        )
        return self._account_by_slot(slot, bal)

    def _fetch_transfer(self, ident: int) -> Optional[oracle_mod.Transfer]:
        keys = pack_keys(
            np.array([ident & U64_MAX], dtype=np.uint64),
            np.array([ident >> 64], dtype=np.uint64),
        )
        row = self.transfer_index.lookup_batch(keys)[0]
        if row == NOT_FOUND:
            return None
        rec = self.transfer_log.gather(np.array([row]))[0]
        return oracle_mod.transfer_from_numpy(rec)

    def _preload_accounts(self, orc: Oracle, keys: np.ndarray) -> None:
        """Batch-prefetch accounts by packed keys into the oracle's lazy dict."""
        if len(keys) == 0:
            return
        slots = self.account_index.lookup_batch(keys)
        found = slots != NOT_FOUND
        if not np.any(found):
            return
        s = slots[found].astype(np.int64)
        s_unique = np.unique(s)
        dp, dpo, cp, cpo = self._read_balances(s_unique)
        for i, slot in enumerate(s_unique):
            bal = (
                types.limbs_to_int(dp[i]), types.limbs_to_int(dpo[i]),
                types.limbs_to_int(cp[i]), types.limbs_to_int(cpo[i]),
            )
            acct = self._account_by_slot(int(slot), bal)
            orc.accounts.preload(acct.id, acct)

    def _make_oracle(self) -> Oracle:
        from tigerbeetle_tpu_torch.lsm.groove import _PostedView

        orc = Oracle()
        orc.accounts = _LazyDict(self._fetch_account)
        orc.transfers = _LazyDict(self._fetch_transfer)
        # Batch-scoped views over the durable grooves: oracle writes land
        # in overlays (rollback-able), reads fall through; the serial
        # paths drain them into the grooves after the batch commits.
        orc.posted = _PostedView(self.posted)
        orc.history = []
        orc.prepare_timestamp = self.prepare_timestamp
        orc.commit_timestamp = self.commit_timestamp
        return orc

    def _drain_oracle_grooves(self, orc: Oracle) -> None:
        orc.posted.drain()
        if orc.history:
            from tigerbeetle_tpu_torch.lsm.groove import HISTORY_DTYPE

            rows = np.zeros(len(orc.history), dtype=HISTORY_DTYPE)
            for i, r in enumerate(orc.history):
                rec = rows[i]
                rec["timestamp"] = r.timestamp
                for side in ("dr", "cr"):
                    for f in (
                        "account_id",
                        "debits_pending", "debits_posted",
                        "credits_pending", "credits_posted",
                    ):
                        v = getattr(r, f"{side}_{f}")
                        rec[f"{side}_{f}_lo"] = v & U64_MAX
                        rec[f"{side}_{f}_hi"] = v >> 64
            self.history.append_batch(rows)

    def _writeback_accounts(self, orc: Oracle) -> None:
        ids = list(dict.keys(orc.accounts))
        if not ids:
            return
        keys = pack_keys(
            np.array([i & U64_MAX for i in ids], dtype=np.uint64),
            np.array([i >> 64 for i in ids], dtype=np.uint64),
        )
        slots = self.account_index.lookup_batch(keys)
        assert not np.any(slots == NOT_FOUND), "serial path cannot touch unknown accounts"
        dps, dpos, cps, cpos = [], [], [], []
        for ident in ids:
            a = dict.__getitem__(orc.accounts, ident)
            dps.append(types.int_to_limbs(a.debits_pending))
            dpos.append(types.int_to_limbs(a.debits_posted))
            cps.append(types.int_to_limbs(a.credits_pending))
            cpos.append(types.int_to_limbs(a.credits_posted))
        self._write_balances(
            slots.astype(np.int32),
            np.stack(dps), np.stack(dpos), np.stack(cps), np.stack(cpos),
        )

    def _create_transfers_serial(self, events: np.ndarray, timestamp: int) -> np.ndarray:
        # The oracle reads (and its writeback writes) the whole store
        # tier: the async stage must be idle.
        self.store_barrier()
        orc = self._make_oracle()
        # Prefetch round 1: dr/cr accounts, existing transfers by event id
        # and by pending_id (reference prefetch, state_machine.zig:560-655).
        acct_keys = np.concatenate([
            pack_keys(events["debit_account_id_lo"], events["debit_account_id_hi"]),
            pack_keys(events["credit_account_id_lo"], events["credit_account_id_hi"]),
        ])
        xfer_keys = np.concatenate([
            pack_keys(events["id_lo"], events["id_hi"]),
            pack_keys(events["pending_id_lo"], events["pending_id_hi"]),
        ])
        rows = self.transfer_index.lookup_batch(xfer_keys)
        found_rows = np.unique(rows[rows != NOT_FOUND])
        pend_acct_keys = np.zeros(0, dtype=acct_keys.dtype)
        if len(found_rows):
            recs = self.transfer_log.gather(found_rows)
            for rec in recs:
                orc.transfers.preload(
                    types.u128_of(rec, "id"), oracle_mod.transfer_from_numpy(rec)
                )
            # Prefetch round 2: accounts referenced by prefetched (pending)
            # transfers — post/void resolves p.debit/credit_account_id.
            pend_acct_keys = np.concatenate([
                pack_keys(recs["debit_account_id_lo"], recs["debit_account_id_hi"]),
                pack_keys(recs["credit_account_id_lo"], recs["credit_account_id_hi"]),
            ])
        self._preload_accounts(orc, np.concatenate([acct_keys, pend_acct_keys]))

        ev_objs = [oracle_mod.transfer_from_numpy(events[i]) for i in range(len(events))]
        pairs = orc.create_transfers(ev_objs, timestamp)

        # Writeback: balances to the device, new transfers to the log,
        # groove overlays into the durable grooves.
        self._writeback_accounts(orc)
        new_ids = [
            i for i in dict.keys(orc.transfers) if i not in orc.transfers.fetched_keys
        ]
        if new_ids:
            new_ts = sorted(new_ids, key=lambda i: dict.__getitem__(orc.transfers, i).timestamp)
            recs = np.concatenate([
                np.atleast_1d(oracle_mod.transfer_to_numpy(dict.__getitem__(orc.transfers, i)))
                for i in new_ts
            ])
            self._store_new_transfers(recs)
        self._drain_oracle_grooves(orc)
        self.commit_timestamp = orc.commit_timestamp
        return _results_array(pairs)

    def _create_accounts_serial(self, events: np.ndarray, timestamp: int) -> np.ndarray:
        self.store_barrier()
        orc = self._make_oracle()
        self._preload_accounts(orc, pack_keys(events["id_lo"], events["id_hi"]))
        ev_objs = [oracle_mod.account_from_numpy(events[i]) for i in range(len(events))]
        pairs = orc.create_accounts(ev_objs, timestamp)

        new_ids = [
            i for i in dict.keys(orc.accounts) if i not in orc.accounts.fetched_keys
        ]
        if new_ids:
            new_sorted = sorted(
                new_ids, key=lambda i: dict.__getitem__(orc.accounts, i).timestamp
            )
            k = len(new_sorted)
            if self.account_count + k > self.config.accounts_max:
                raise RuntimeError("accounts table full (accounts_max exceeded)")
            slots = np.arange(self.account_count, self.account_count + k, dtype=np.int64)
            ledgers = np.zeros(k, dtype=np.uint32)
            aflags = np.zeros(k, dtype=np.uint32)
            lo = np.zeros(k, dtype=np.uint64)
            hi = np.zeros(k, dtype=np.uint64)
            for j, ident in enumerate(new_sorted):
                a = dict.__getitem__(orc.accounts, ident)
                slot = int(slots[j])
                lo[j] = a.id & U64_MAX
                hi[j] = a.id >> 64
                self.acc_user_data_128_lo[slot] = a.user_data_128 & U64_MAX
                self.acc_user_data_128_hi[slot] = a.user_data_128 >> 64
                self.acc_user_data_64[slot] = a.user_data_64
                self.acc_user_data_32[slot] = a.user_data_32
                self.acc_ledger[slot] = a.ledger
                self.acc_code[slot] = a.code
                self.acc_flags[slot] = a.flags
                self.acc_timestamp[slot] = a.timestamp
                ledgers[j] = a.ledger
                aflags[j] = a.flags
            keys = pack_keys(lo, hi)
            self.acc_key[slots] = keys
            self.account_count += k
            self.account_index.insert_batch(keys, slots.astype(np.uint32))
            self._register_accounts(
                slots.astype(np.int32), ledgers, aflags, np.ones(k, dtype=bool)
            )
        # Existing accounts are never mutated by create_accounts; only new
        # ones appear — nothing else to write back.
        self.commit_timestamp = orc.commit_timestamp
        return _results_array(pairs)

    # ------------------------------------------------------------------
    # read operations

    def lookup_accounts(self, ids_lo: np.ndarray, ids_hi: np.ndarray) -> np.ndarray:
        keys = pack_keys(
            np.asarray(ids_lo, dtype=np.uint64), np.asarray(ids_hi, dtype=np.uint64)
        )
        slots = self.account_index.lookup_batch(keys)
        found = slots != NOT_FOUND
        s = slots[found].astype(np.int64)
        return self._accounts_at(s)

    def _accounts_at(self, s: np.ndarray) -> np.ndarray:
        """Pack wire ACCOUNT records for an array of slots."""
        out = np.zeros(len(s), dtype=types.ACCOUNT_DTYPE)
        if len(s) == 0:
            return out
        dp, dpo, cp, cpo = self._read_balances(s)
        dp_lo, dp_hi = types.limbs_to_u64_pair(dp)
        dpo_lo, dpo_hi = types.limbs_to_u64_pair(dpo)
        cp_lo, cp_hi = types.limbs_to_u64_pair(cp)
        cpo_lo, cpo_hi = types.limbs_to_u64_pair(cpo)
        out["id_lo"] = self.acc_key["lo"][s]
        out["id_hi"] = self.acc_key["hi"][s]
        out["debits_pending_lo"], out["debits_pending_hi"] = dp_lo, dp_hi
        out["debits_posted_lo"], out["debits_posted_hi"] = dpo_lo, dpo_hi
        out["credits_pending_lo"], out["credits_pending_hi"] = cp_lo, cp_hi
        out["credits_posted_lo"], out["credits_posted_hi"] = cpo_lo, cpo_hi
        out["user_data_128_lo"] = self.acc_user_data_128_lo[s]
        out["user_data_128_hi"] = self.acc_user_data_128_hi[s]
        out["user_data_64"] = self.acc_user_data_64[s]
        out["user_data_32"] = self.acc_user_data_32[s]
        out["ledger"] = self.acc_ledger[s]
        out["code"] = self.acc_code[s]
        out["flags"] = self.acc_flags[s]
        out["timestamp"] = self.acc_timestamp[s]
        return out

    def query_transfers(self, f: np.void) -> np.ndarray:
        """Multi-predicate equality query over transfers via the scan
        engine (reference ScanBuilder range scans per index + boolean
        merge, scan_builder.zig:454, scan_merge.zig:252): nonzero filter
        fields become predicates over the combined query index (field
        tags) and the exact-key account index (v2 debit/credit
        predicates), the planner orders them by fence-estimated
        cardinality, the cheapest drives a galloping probe of the rest
        (lsm/scan.ScanBuilder), and the gathered rows are re-verified
        exactly (fold56 collisions and account side-blindness
        over-select, never mis-answer). The sm.query.* spans feed the
        gated query_p50_ms/query_p99_ms lifecycle keys."""
        from tigerbeetle_tpu_torch.lsm import scan

        with tracer.span("sm.query"):
            return self._query_transfers_inner(f, scan)

    def scan_builder(self, ts_min: int, ts_max: int):
        """A ScanBuilder over this machine's query and account indexes in
        the timestamp window [ts_min, ts_max]; its AND-merges run on the
        device where the device query-index route is on. Callers flush the
        deferred store first (query_transfers does)."""
        from tigerbeetle_tpu_torch.lsm import scan

        return scan.ScanBuilder(
            self.query_rows, self.account_rows, ts_min, ts_max,
            log_stats=(
                self.transfer_log.count,
                len(self.transfer_log.blocks),
                self.transfer_log.resident_fraction(),
            ),
            device=self.device if self._qindex_device else None,
        )

    def _query_transfers_inner(self, f: np.void, scan) -> np.ndarray:
        self.store_barrier()
        names = f.dtype.names
        ud128_lo = int(f["user_data_128_lo"])
        ud128_hi = int(f["user_data_128_hi"])
        ud64 = int(f["user_data_64"])
        ud32 = int(f["user_data_32"])
        ledger = int(f["ledger"])
        code = int(f["code"])
        limit = int(f["limit"])
        flags = int(f["flags"])
        # v2 filter shape (size-discriminated at decode): account-id
        # equality predicates, absent fields read as 0 (= unset).
        dr_lo = int(f["debit_account_id_lo"]) if "debit_account_id_lo" in names else 0
        dr_hi = int(f["debit_account_id_hi"]) if "debit_account_id_hi" in names else 0
        cr_lo = int(f["credit_account_id_lo"]) if "credit_account_id_lo" in names else 0
        cr_hi = int(f["credit_account_id_hi"]) if "credit_account_id_hi" in names else 0
        ts_min_raw, ts_max_raw = int(f["timestamp_min"]), int(f["timestamp_max"])
        if not Oracle._query_filter_valid(ts_min_raw, ts_max_raw, limit, flags):
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        ts_min = ts_min_raw if ts_min_raw else 1
        ts_max = ts_max_raw if ts_max_raw else U64_MAX - 1

        builder = self.scan_builder(ts_min, ts_max)
        if ud128_lo or ud128_hi:
            builder.where_field(scan.TAG_UD128, ud128_lo, ud128_hi)
        if ud64:
            builder.where_field(scan.TAG_UD64, ud64)
        if ud32:
            builder.where_field(scan.TAG_UD32, ud32)
        if ledger:
            builder.where_field(scan.TAG_LEDGER, ledger)
        if code:
            builder.where_field(scan.TAG_CODE, code)
        if dr_lo or dr_hi:
            builder.where_account(dr_lo, dr_hi)
        if cr_lo or cr_hi:
            builder.where_account(cr_lo, cr_hi)

        def verify(t: np.ndarray) -> np.ndarray:
            keep = (t["timestamp"] >= np.uint64(ts_min)) & (
                t["timestamp"] <= np.uint64(ts_max)
            )
            if ud128_lo or ud128_hi:
                keep &= (t["user_data_128_lo"] == np.uint64(ud128_lo)) & (
                    t["user_data_128_hi"] == np.uint64(ud128_hi)
                )
            if ud64:
                keep &= t["user_data_64"] == np.uint64(ud64)
            if ud32:
                keep &= t["user_data_32"] == np.uint32(ud32)
            if ledger:
                keep &= t["ledger"] == np.uint32(ledger)
            if code:
                keep &= t["code"] == np.uint16(code)
            if dr_lo or dr_hi:
                keep &= (t["debit_account_id_lo"] == np.uint64(dr_lo)) & (
                    t["debit_account_id_hi"] == np.uint64(dr_hi)
                )
            if cr_lo or cr_hi:
                keep &= (t["credit_account_id_lo"] == np.uint64(cr_lo)) & (
                    t["credit_account_id_hi"] == np.uint64(cr_hi)
                )
            return keep

        if not builder._preds:
            # No equality predicate: bounded walk of the timestamp-ordered
            # object log (newest-first under REVERSED), stopping at limit.
            t = self._log_window(ts_min, ts_max, limit, bool(flags & 1))
            ix = np.nonzero(verify(t))[0]  # row order IS timestamp order
            if flags & 1:
                ix = ix[::-1]
            return t[ix[:limit]]

        # The engine: fence-estimated plan, driver scan, galloping
        # probes. `rows` is an ascending candidate SUPERSET; the chunked
        # gather below re-verifies every predicate exactly.
        with tracer.span("sm.query.plan"):
            plan = builder.plan()
        with tracer.span("sm.query.scan"):
            cand = np.ascontiguousarray(
                builder._materialize(plan[0]), dtype=np.uint32
            )
        with tracer.span("sm.query.probe"):
            # Probes exist only to shrink the gather: each runs while
            # its index walk costs less than the block reads + row
            # copies it saves (builder._probe_pays, buffer-aware), and
            # verify() re-checks every predicate exactly either way.
            for p in plan[1:]:
                if not builder._probe_pays(p, len(cand)):
                    break
                hit = np.zeros(len(cand), dtype=np.uint8)
                builder._probe(p, cand, hit)
                cand = cand[hit.view(bool)]
        rows = cand

        # Limit-aware chunked gather: candidates are timestamp-ordered, so
        # walk them from the answering end in chunks, verify, and stop as
        # soon as `limit` rows survive — a limit-100 query gathers ~100
        # candidates' blocks, not the full candidate set (whose scattered
        # rows could touch most of the log).
        reversed_ = bool(flags & 1)
        chunk = max(256, 4 * limit)
        parts: list = []
        got = 0
        pos = len(rows) if reversed_ else 0
        with tracer.span("sm.query.gather"):
            while got < limit and (pos > 0 if reversed_ else pos < len(rows)):
                if reversed_:
                    lo_ix = max(0, pos - chunk)
                    sel_rows = rows[lo_ix:pos]
                    pos = lo_ix
                else:
                    sel_rows = rows[pos : pos + chunk]
                    pos += chunk
                t = self.transfer_log.gather(sel_rows)
                hit = t[verify(t)]
                if len(hit):
                    parts.append(hit)
                    got += len(hit)
        if not parts:
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        if reversed_:
            out = np.concatenate(parts[::-1])
            return out[::-1][:limit]
        out = np.concatenate(parts)
        return out[:limit]

    def _log_window(
        self, ts_min: int, ts_max: int, limit: int, reversed_: bool
    ) -> np.ndarray:
        """≤limit log records inside [ts_min, ts_max], walking whole blocks
        lazily from the matching end (timestamps are monotone with row) —
        a limit-10 newest-first query touches one block, never the log."""
        log = self.transfer_log
        count = log.count
        if count == 0:
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        rpb = log.records_per_block
        out: list = []
        got = 0
        blocks = range((count - 1) // rpb, -1, -1) if reversed_ else range(
            0, (count - 1) // rpb + 1
        )
        for b in blocks:
            base = b * rpb
            for _base2, recs in log.scan_range(base, min(base + rpb, count)):
                sel = recs[
                    (recs["timestamp"] >= np.uint64(ts_min))
                    & (recs["timestamp"] <= np.uint64(ts_max))
                ]
                if len(sel):
                    out.append(sel)
                    got += len(sel)
            if got >= limit:
                break
        if not out:
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        # Ascending row order either way (the caller applies limit and
        # direction); a superset is fine — it only re-verifies and trims.
        return np.concatenate(out[::-1] if reversed_ else out)

    def query_accounts(self, f: np.void) -> np.ndarray:
        """Equality query over accounts. The accounts table is bounded
        (accounts_max) and RAM/device-resident, so the device-first answer is
        a vectorized column filter — no index trees needed (the reference
        builds 5 LSM index trees because its account table is
        disk-resident; ours is the batch-parallel axis)."""
        self.flush_deferred()
        limit = int(f["limit"])
        flags = int(f["flags"])
        ts_min_raw, ts_max_raw = int(f["timestamp_min"]), int(f["timestamp_max"])
        if not Oracle._query_filter_valid(ts_min_raw, ts_max_raw, limit, flags):
            return np.zeros(0, dtype=types.ACCOUNT_DTYPE)
        ts_min = ts_min_raw if ts_min_raw else 1
        ts_max = ts_max_raw if ts_max_raw else U64_MAX - 1
        n = self.account_count
        keep = (self.acc_timestamp[:n] >= np.uint64(ts_min)) & (
            self.acc_timestamp[:n] <= np.uint64(ts_max)
        )
        if int(f["user_data_128_lo"]) or int(f["user_data_128_hi"]):
            keep &= (
                self.acc_user_data_128_lo[:n] == f["user_data_128_lo"]
            ) & (self.acc_user_data_128_hi[:n] == f["user_data_128_hi"])
        if int(f["user_data_64"]):
            keep &= self.acc_user_data_64[:n] == f["user_data_64"]
        if int(f["user_data_32"]):
            keep &= self.acc_user_data_32[:n] == f["user_data_32"]
        if int(f["ledger"]):
            keep &= self.acc_ledger[:n] == f["ledger"]
        if int(f["code"]):
            keep &= self.acc_code[:n] == f["code"]
        s = np.nonzero(keep)[0]  # slot order IS creation-timestamp order
        if flags & 1:
            s = s[::-1]
        return self._accounts_at(s[:limit].astype(np.int64))

    def lookup_transfers(self, ids_lo: np.ndarray, ids_hi: np.ndarray) -> np.ndarray:
        self.store_barrier()
        keys = pack_keys(
            np.asarray(ids_lo, dtype=np.uint64), np.asarray(ids_hi, dtype=np.uint64)
        )
        rows = self.transfer_index.lookup_batch(keys)
        found = rows != NOT_FOUND
        return self.transfer_log.gather(rows[found])

    def _account_records(self, account_id: int) -> np.ndarray:
        """All transfers touching the account, in commit (timestamp) order —
        an account-index range read + gather, O(account's transfers), not
        O(history) (reference ScanTree over the secondary index,
        scan_tree.zig:31)."""
        self.store_barrier()
        key = pack_keys(
            np.array([account_id & U64_MAX], dtype=np.uint64),
            np.array([account_id >> 64], dtype=np.uint64),
        )[0]
        rows = self.account_rows.lookup_range(key)
        return self.transfer_log.gather(rows)

    def get_account_transfers(
        self,
        account_id: int,
        timestamp_min: int = 0,
        timestamp_max: int = 0,
        limit: int = 8190,
        flags: int = 0x3,
    ) -> np.ndarray:
        from tigerbeetle_tpu_torch.flags import AccountFilterFlags as FF

        if not Oracle._filter_valid(account_id, timestamp_min, timestamp_max, limit, flags):
            return np.zeros(0, dtype=types.TRANSFER_DTYPE)
        t = self._account_records(account_id)
        ts_min = np.uint64(timestamp_min if timestamp_min else 1)
        ts_max = np.uint64(timestamp_max if timestamp_max else U64_MAX - 1)
        lo = np.uint64(account_id & U64_MAX)
        hi = np.uint64(account_id >> 64)
        mask = (t["timestamp"] >= ts_min) & (t["timestamp"] <= ts_max)
        m_dr = (t["debit_account_id_lo"] == lo) & (t["debit_account_id_hi"] == hi)
        m_cr = (t["credit_account_id_lo"] == lo) & (t["credit_account_id_hi"] == hi)
        side = np.zeros(len(t), dtype=bool)
        if flags & FF.DEBITS:
            side |= m_dr
        if flags & FF.CREDITS:
            side |= m_cr
        rows = np.nonzero(mask & side)[0]
        if flags & FF.REVERSED:
            rows = rows[::-1]
        return t[rows[:limit]]

    def get_account_history(
        self,
        account_id: int,
        timestamp_min: int = 0,
        timestamp_max: int = 0,
        limit: int = 8190,
        flags: int = 0x3,
    ) -> List[Tuple[int, int, int, int, int]]:
        """Balance history of a HISTORY-flagged account: an index
        range-read over the history groove + vectorized side selection —
        no oracle join, no per-row Python (reference ScanLookup over the
        account_history groove, state_machine.zig get_account_history)."""
        from tigerbeetle_tpu_torch.flags import AccountFilterFlags as FF

        if not Oracle._filter_valid(account_id, timestamp_min, timestamp_max, limit, flags):
            return []
        slot = self._slot_of_id(account_id)
        if slot < 0 or not (int(self.acc_flags[slot]) & int(AccountFlags.HISTORY)):
            return []
        self.store_barrier()  # history groove rows may still be queued
        recs = self.history.account_rows(account_id)
        if len(recs) == 0:
            return []
        lo = np.uint64(account_id & U64_MAX)
        hi = np.uint64(account_id >> 64)
        ts_min = np.uint64(timestamp_min if timestamp_min else 1)
        ts_max = np.uint64(timestamp_max if timestamp_max else U64_MAX - 1)
        keep = (recs["timestamp"] >= ts_min) & (recs["timestamp"] <= ts_max)
        # Side filter (oracle semantics: DEBITS selects rows where this
        # account is the transfer's debit side — which is exactly the rows
        # whose dr side carries it, and symmetrically for CREDITS).
        is_dr = (recs["dr_account_id_lo"] == lo) & (recs["dr_account_id_hi"] == hi)
        is_cr = (recs["cr_account_id_lo"] == lo) & (recs["cr_account_id_hi"] == hi)
        side = np.zeros(len(recs), dtype=bool)
        if flags & FF.DEBITS:
            side |= is_dr
        if flags & FF.CREDITS:
            side |= is_cr
        ix = np.nonzero(keep & side)[0]
        if flags & FF.REVERSED:
            ix = ix[::-1]
        ix = ix[:limit]
        r = recs[ix]
        use_dr = is_dr[ix]

        def u128(field):
            l = np.where(use_dr, r[f"dr_{field}_lo"], r[f"cr_{field}_lo"])
            h = np.where(use_dr, r[f"dr_{field}_hi"], r[f"cr_{field}_hi"])
            return l, h

        cols = [u128(f) for f in (
            "debits_pending", "debits_posted", "credits_pending", "credits_posted"
        )]
        return [
            (
                int(r["timestamp"][j]),
                *(int(l[j]) | (int(h[j]) << 64) for l, h in cols),
            )
            for j in range(len(r))
        ]
